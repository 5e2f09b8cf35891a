"""Potential-based sphere sampling on the host (seggroup_tpu/data/potentials.py;
reference kpconv/datasets/Scannet.py:701-819).

Every scene keeps a potential on a uniform-grid subsample of its points;
each draw centres an in-radius sphere at the global minimum-potential point
(jittered) and adds a Tukey bump to the potentials inside the sphere, so
later draws go to unvisited regions and every point is covered eventually.

The JAX package finds the points inside a sphere with scipy's
`cKDTree.query_ball_point`; here a numpy grid of cells a little larger than
the radius gives the candidates, and the same test keeps the same set:
the squared distance in float64 from the float32 points, summed over the
axes in order, at most the squared radius. The random draws (the initial
jitter, the centre jitter) come in the same order from the same generator,
so one seed gives the JAX sampler's centres and potentials exactly."""

from __future__ import annotations

import numpy as np

__all__ = ["PotentialSampler", "BallGrid"]


class BallGrid:
    """Fixed-radius neighbour search over one point set (N, 3): the rows
    whose float64 squared distance to a query is at most radius^2, in
    ascending order."""

    def __init__(self, points: np.ndarray, radius: float):
        self.points = np.asarray(points, np.float64)
        self.r2 = float(radius) * float(radius)
        # cells a hair wider than the radius: a ball then never reaches past
        # the 27 cells around its centre's, whatever the rounding of floor()
        self.cell = float(radius) * (1.0 + 1e-6)
        cells = np.floor(self.points / self.cell).astype(np.int64)
        self.lo = cells.min(0) - 1  # one cell of margin on each side
        self.dims = cells.max(0) + 2 - self.lo
        keys = self._key(cells)
        self.order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[self.order]

    def _key(self, cells: np.ndarray) -> np.ndarray:
        c = cells - self.lo
        return (c[..., 0] * self.dims[1] + c[..., 1]) * self.dims[2] + c[..., 2]

    def query(self, center: np.ndarray) -> np.ndarray:
        c = np.floor(np.asarray(center, np.float64) / self.cell).astype(np.int64)
        off = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(27, 3)
        nb = c + off
        inside = np.all((nb >= self.lo) & (nb < self.lo + self.dims), axis=1)
        keys = self._key(nb[inside])
        start = np.searchsorted(self.sorted_keys, keys, side="left")
        stop = np.searchsorted(self.sorted_keys, keys, side="right")
        cand = np.concatenate([self.order[a:b] for a, b in zip(start, stop)]
                              + [np.zeros(0, np.int64)])
        d = self.points[cand] - np.asarray(center, np.float64)
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        return np.sort(cand[d2 <= self.r2])


class PotentialSampler:
    """Min-potential sphere sampler over a set of scenes.

    coords_per_scene: list of (N_i, 3) float arrays (scene point clouds).
    in_radius:        sphere radius (reference in_radius=2.0 m).
    grid:             potential-subsample cell size in metres.
    seed:             seed of the potential init jitter and the centre
                      jitter (Scannet.py:735-745)."""

    def __init__(self, coords_per_scene, in_radius: float = 2.0,
                 grid: float = 0.08, seed: int = 0):
        self.in_radius = float(in_radius)
        self.rng = np.random.default_rng(seed)
        self.sub_points: list[np.ndarray] = []
        self.grids: list[BallGrid] = []
        self.potentials: list[np.ndarray] = []
        for c in coords_per_scene:
            c = np.asarray(c, np.float32)
            # uniform-grid subsample: first point per cell
            cell = np.floor(c / grid).astype(np.int64)
            key = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791)
            _, first = np.unique(key, return_index=True)
            sub = c[np.sort(first)]
            self.sub_points.append(sub)
            self.grids.append(BallGrid(sub, self.in_radius))
            # tiny random init so that ties break randomly (Scannet.py:733)
            self.potentials.append(self.rng.random(len(sub)).astype(np.float32) * 1e-3)
        self._mins = np.array([p.min() for p in self.potentials], np.float32)

    def __len__(self):
        return len(self.sub_points)

    def state(self) -> dict:
        """A copy of what the draws change: the potentials and the
        generator's state."""
        return {"rng": self.rng.bit_generator.state,
                "potentials": [p.copy() for p in self.potentials]}

    def set_state(self, state: dict) -> None:
        """Continue from `state()`'s copy (arrays or tensors of the same
        lengths)."""
        self.rng.bit_generator.state = state["rng"]
        self.potentials = [np.array(p, np.float32) for p in state["potentials"]]
        self._mins = np.array([p.min() for p in self.potentials], np.float32)

    def min_potential(self) -> float:
        """The global minimum potential; >= 1.0 once every potential point
        has been inside a drawn sphere."""
        return float(self._mins.min())

    def next_center(self) -> tuple[int, np.ndarray]:
        """The (scene, centre) at the global potential minimum, jittered; the
        potentials of the points inside its sphere grow by the Tukey
        profile (Scannet.py:779-791)."""
        si = int(np.argmin(self._mins))
        pots = self.potentials[si]
        pi = int(np.argmin(pots))
        center = self.sub_points[si][pi].copy()
        center += self.rng.normal(scale=self.in_radius / 10.0, size=3).astype(np.float32)
        idx = self.grids[si].query(center)
        if len(idx):
            d2 = np.sum((self.sub_points[si][idx] - center) ** 2, axis=1)
            tukey = np.square(1.0 - d2 / self.in_radius ** 2)
            pots[idx] += tukey.astype(np.float32)
        else:  # the jitter pushed the centre off the cloud: bump the seed point
            pots[pi] += 1.0
        self._mins[si] = pots.min()
        return si, center
