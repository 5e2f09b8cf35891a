"""The port's potential sampler (seggroup_tpu_torch.data.potentials) against
the JAX package's (seggroup_tpu.data.potentials) on the CPU: the same
centres and potentials, exactly, draw for draw; and its grid ball search
against scipy's cKDTree.query_ball_point, which the JAX sampler uses, on
points placed on the sphere's boundary and one float32 step either side."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

from seggroup_tpu.data.potentials import PotentialSampler as JaxSampler
from seggroup_tpu.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.data.potentials import BallGrid, PotentialSampler


def _scenes(n_scenes):
    out = []
    for i in range(n_scenes):
        pts = np.asarray(make_synthetic_scene(seed=i, num_points=6000).points)[:, :3]
        out.append((pts * (1.0 + i)).astype(np.float32))  # rooms of different sizes
    return out


@pytest.mark.parametrize("n_scenes,radius,grid", [(1, 2.0, 0.08), (2, 0.5, 0.08),
                                                  (3, 1.0, 0.2)])
def test_sampler_matches_jax(n_scenes, radius, grid):
    scenes = _scenes(n_scenes)
    want = JaxSampler(scenes, in_radius=radius, grid=grid, seed=3)
    got = PotentialSampler(scenes, in_radius=radius, grid=grid, seed=3)
    for a, b in zip(want.sub_points, got.sub_points):
        np.testing.assert_array_equal(b, a)
    draws = 0
    while want.min_potential() < 2.0 and draws < 3000:
        si_w, c_w = want.next_center()
        si_g, c_g = got.next_center()
        assert si_g == si_w
        np.testing.assert_array_equal(c_g, c_w)
        assert got.min_potential() == want.min_potential()
        draws += 1
    assert want.min_potential() >= 2.0  # every point covered twice
    for a, b in zip(want.potentials, got.potentials):
        np.testing.assert_array_equal(b, a)
    assert draws > 3


def test_ball_grid_keeps_cKDTrees_set_on_the_boundary():
    """Points at distance r from the centre along axes and diagonals (as
    float32 rounds them), each with its neighbours one float32 step in and
    out, and a random cloud: the same set as query_ball_point."""
    rng = np.random.default_rng(0)
    r = 0.7
    center = np.array([0.31, -0.2, 1.05], np.float32)
    dirs = np.concatenate([np.eye(3), -np.eye(3), rng.normal(size=(200, 3))])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    on = (center + r * dirs).astype(np.float32)
    pts = np.concatenate([on, np.nextafter(on, center), np.nextafter(on, on + dirs),
                          (center + rng.normal(size=(3000, 3))).astype(np.float32)])
    for c in (center, center + np.float32(0.05), np.array([9.0, 9.0, 9.0], np.float32)):
        want = np.sort(np.asarray(cKDTree(pts).query_ball_point(c, r), np.int64))
        got = BallGrid(pts, r).query(c)
        np.testing.assert_array_equal(got, want)
    got = BallGrid(pts, r).query(center)
    assert 200 < len(set(got) & set(range(3 * len(on)))) < 3 * len(on)  # the boundary splits
