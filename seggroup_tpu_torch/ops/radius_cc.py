"""Windowed radius-graph connected components
(seggroup_tpu/ops/pallas_cc.py, everything but the kernel).

Connected components of the graph that joins two valid points of one batch
id and one semantic class when they lie within `radius`, without ever
materialising neighbour lists:

  1. `_prep` sorts the points by a (batch, cell) linear key with cells of
     1x, 2x or 4x the radius (the smallest whose key space fits int32), so
     that for a tile of TILE consecutive rows and each of the 9 (dx, dy)
     column groups of the 27-cell stencil every candidate lies in ONE
     contiguous row range [lo, hi) (the 3 dz cells of a column are adjacent
     keys);
  2. one sweep gives every row the least label among the rows of its 9
     ranges that pass the distance, class and key-delta tests: kernel K4
     (ops/cuda_cc.py) on CUDA tensors, `sweep_plain` on CPU tensors;
  3. `_cc_loop` repeats sweep, hooking by segment min and two pointer jumps
     until nothing changes, reading one flag from the device per sweep.

While the recorder is bound (utils/profiling.py), the sweeps are counted
as "count.cc.sweeps", a loop that ran out of sweeps before its fixpoint as
"count.cc.unconverged", and each run of the fallback as "count.cc.fallback".

A range longer than `window` rows, a key space past int32 or an N that is
not a multiple of 8 * tile takes the exact fallback (ops/knn.py's ball
query + ops/cc.py). Both branches canonicalise labels to the minimum
ORIGINAL index of each component, so they are interchangeable, and both
equal the JAX side's labels exactly. `window=None` lifts the range rule
(PointGroup's clustering): K4 and its plain version walk a range of any
length, so the sweep is exact at any density, where the fallback keeps a
point's `max_neighbors_fallback` nearest neighbours alone; the JAX
package's window is its kernel's fixed 1,024-row fetch.

The JAX side packs rows, keys and labels into a lane-major float32 slab and
fetches a fixed, 128-aligned `window` of it per range; here they are plain
int32 and float32 columns and a sweep scans exactly [lo, hi): a row outside
it fails the key-delta test for every query of the tile, so the result is
the same."""

from __future__ import annotations

from typing import NamedTuple

import torch

from seggroup_tpu_torch.ops import cuda_cc
from seggroup_tpu_torch.ops.cc import hook_and_jump, semantic_connected_components
from seggroup_tpu_torch.ops.fma import sqdist_fma
from seggroup_tpu_torch.ops.knn import ball_query_pair_fast
from seggroup_tpu_torch.ops.segment_ops import invert_permutation, segment_min
from seggroup_tpu_torch.utils import profiling

TILE = 256
WINDOW = 1024
PAD_XYZ = 1.0e8   # coordinates of invalid rows
PAD_SEM = -3      # class of invalid rows: matches no valid row
PAD_KEY = 2 ** 30  # key of invalid rows: they sort last


class Prep(NamedTuple):
    """The sorted problem one sweep reads."""

    order: torch.Tensor       # (N,) int32: sorted position -> original row
    xyz: torch.Tensor         # (N, 3) float32, PAD_XYZ on invalid rows
    sem: torch.Tensor         # (N,) int32, PAD_SEM on invalid rows
    key: torch.Tensor         # (N,) int32 sorted keys, PAD_KEY on invalid rows
    lo: torch.Tensor          # (n_tiles, 9) int32: first row of each range
    hi: torch.Tensor          # (n_tiles, 9) int32: one past its last row
    offs: torch.Tensor        # (9,) int32: key offset of each (dx, dy) group
    use_window: torch.Tensor  # () bool: the windowed sweep is exact here


def _prep(coords: torch.Tensor, radius: torch.Tensor, batch_ids: torch.Tensor,
          valid: torch.Tensor, semantics: torch.Tensor, tile: int,
          window: int | None) -> Prep:
    """Sort by (batch, cell) key and find each (tile, group)'s row range.
    `radius` is a () float32 tensor; `window` None takes ranges of any
    length."""
    n = coords.shape[0]
    dev = coords.device
    batch_ids = batch_ids.to(torch.int32)
    nb = torch.where(valid, batch_ids, 0).max() + 1

    def grid_at(mul: float):
        """Cells and dims at cell size mul * radius. Any cell >= radius
        keeps every in-radius pair within one cell per axis, and the sweep
        tests true distances, so the result does not depend on `mul`."""
        cell = radius * mul
        cells = torch.floor(coords / cell).to(torch.int32)
        cmin = torch.where(valid[:, None], cells, 2 ** 30).min(dim=0).values
        cells = cells - cmin + 1
        cmax = torch.where(valid[:, None], cells, 0).max(dim=0).values
        # invalid rows' cells are garbage after the shift; their keys are
        # replaced below, but keep the arithmetic in range
        cells = torch.minimum(torch.clamp(cells, min=0), torch.clamp(cmax, min=1))
        # at least 5 cells per axis: the key-delta test cannot then alias
        # two cells of different rows that are within the radius
        dims = torch.clamp(cmax + 2, min=5)
        d = dims.to(torch.float32)
        prodf = d[0] * d[1] * d[2] * nb.to(torch.float32)
        off_mag = d[1] * d[2] + d[2]
        ok = (prodf < 2.0 ** 30) & (off_mag + 2.0 < 2.0 ** 22)
        return cells, dims, ok

    c1, d1, ok1 = grid_at(1.0)
    c2, d2, ok2 = grid_at(2.0)
    c4, d4, ok4 = grid_at(4.0)
    cells = torch.where(ok1, c1, torch.where(ok2, c2, c4))
    dims = torch.where(ok1, d1, torch.where(ok2, d2, d4))
    ok_range = ok1 | ok2 | ok4

    key = ((batch_ids * dims[0] + cells[:, 0]) * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    key = torch.where(valid, key, PAD_KEY)
    order = torch.argsort(key, stable=True)
    skey = key[order]

    xyz = torch.where(valid[:, None], coords, PAD_XYZ)[order]
    sem = torch.where(valid, semantics.to(torch.int32), PAD_SEM)[order]

    plane = dims[1] * dims[2]
    offs = (torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], dtype=torch.int32, device=dev) * plane
            + torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], dtype=torch.int32, device=dev)
            * dims[2])

    sk2 = skey.reshape(n // tile, tile)
    real = sk2 < PAD_KEY
    t_first = torch.where(real, sk2, PAD_KEY).min(dim=1).values
    t_last = torch.where(real, sk2, -1).max(dim=1).values
    lo_key = t_first[:, None] + offs[None, :] - 1
    hi_key = t_last[:, None] + offs[None, :] + 1
    lo = torch.searchsorted(skey, lo_key).to(torch.int32)
    hi = torch.searchsorted(skey, hi_key, right=True).to(torch.int32)
    # the reference fetches `window` rows from the 128-aligned base below lo
    base = lo & ~127
    overflow = (torch.zeros((), dtype=torch.bool, device=dev) if window is None else
                ((hi - base > window) & (t_last[:, None] >= 0)).any())
    return Prep(order.to(torch.int32), xyz.contiguous(), sem.contiguous(), skey.contiguous(),
                lo.contiguous(), hi.contiguous(), offs, ok_range & ~overflow)


# (tile, range) elements per batch of sweep_plain's mask
_PLAIN_ELEMS = 1 << 24


def sweep_plain(labels: torch.Tensor, prep: Prep, r2: torch.Tensor,
                tile: int = TILE) -> torch.Tensor:
    """K4's plain version: one masked label-min sweep in torch ops. For
    each sorted row, the least of its own label and the labels of the rows
    in its tile's 9 ranges [lo, hi) that lie within sqrt(r2) (the squared
    distance formed as the reference forms it, ops/fma.sqdist_fma), have
    its class, and whose key is within 1 of its own plus the group's
    offset. labels (N,) int32 in the sorted domain -> (N,) int32."""
    n = labels.shape[0]
    n_tiles = n // tile
    dev = labels.device
    width = max(int((prep.hi - prep.lo).max()), 1)
    cols = torch.arange(width, device=dev)
    q_xyz = prep.xyz.reshape(n_tiles, tile, 3)
    q_sem = prep.sem.reshape(n_tiles, tile)
    q_key = prep.key.reshape(n_tiles, tile)
    out = labels.reshape(n_tiles, tile).clone()
    per_batch = max(1, _PLAIN_ELEMS // (tile * width))
    for t0 in range(0, n_tiles, per_batch):
        ts = slice(t0, t0 + per_batch)
        qx, qs, qk = q_xyz[ts], q_sem[ts], q_key[ts]
        for g in range(9):
            lo, hi = prep.lo[ts, g].long(), prep.hi[ts, g].long()
            rows = lo[:, None] + cols  # (T, width)
            inside = rows < hi[:, None]
            rows = torch.clamp(rows, max=n - 1)
            wx = prep.xyz[rows]
            d2 = sqdist_fma(*(qx[:, :, None, c] - wx[:, None, :, c] for c in range(3)))
            delta = prep.key[rows][:, None, :] - qk[:, :, None]
            off = prep.offs[g]
            mask = (inside[:, None, :] & (delta >= off - 1) & (delta <= off + 1)
                    & (d2 <= r2) & (prep.sem[rows][:, None, :] == qs[:, :, None]))
            cand = torch.where(mask, labels[rows][:, None, :], n)
            out[ts] = torch.minimum(out[ts], cand.min(dim=2).values)
    return out.reshape(n)


def key_runs(prep: Prep) -> tuple[torch.Tensor, ...]:
    """Each (row, group)'s candidates as K4 walks them: the rows of its
    tile's range [lo, hi) whose key lies in key + off - 1 .. key + off + 1
    form one run of the sorted keys, [start, end) (empty where end <=
    start). Returns start, end and the range's lo, hi, each (N, 9) int64."""
    tile = prep.key.shape[0] // prep.lo.shape[0]
    key = prep.key.long()
    target = key[:, None] + prep.offs.long()[None, :]
    lo = prep.lo.long().repeat_interleave(tile, dim=0)
    hi = prep.hi.long().repeat_interleave(tile, dim=0)
    start = torch.maximum(torch.searchsorted(key, target - 1), lo)
    end = torch.minimum(torch.searchsorted(key, target + 1, right=True), hi)
    return start, end, lo, hi


def sweep(labels: torch.Tensor, prep: Prep, r2: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """One sweep: kernel K4 on CUDA tensors, `sweep_plain` on CPU tensors."""
    if labels.is_cuda:
        return cuda_cc.cc_sweep_cuda(labels, prep.xyz, prep.sem, prep.key, prep.lo, prep.hi,
                                     prep.offs, r2, tile)
    return sweep_plain(labels, prep, r2, tile)


def _canonicalize(labels: torch.Tensor, n: int) -> torch.Tensor:
    """Any per-component representative -> its minimum ORIGINAL index."""
    rep = segment_min(torch.arange(n, dtype=torch.int32, device=labels.device), labels, n + 1,
                      fill_value=n)
    lab = rep[torch.clamp(labels, max=n).long()]
    return torch.where(labels < n, lab, n)


def _cc_loop(prep: Prep, r2: torch.Tensor, valid: torch.Tensor, tile: int = TILE,
             max_sweeps: int = 64, jumps: int = 2, sweep_fn=sweep) -> torch.Tensor:
    """Sweep to the fixpoint over prepped inputs -> original-domain
    canonical labels. Each sweep is followed by the hooking and pointer
    jumping of ops/cc.py; at most `max_sweeps` sweeps."""
    n = valid.shape[0]
    dev = valid.device
    order = prep.order.long()
    s_valid = valid[order]
    lab = torch.where(s_valid, torch.arange(n, dtype=torch.int32, device=dev), n)
    for _ in range(max_sweeps):
        new = torch.minimum(lab, sweep_fn(lab, prep, r2, tile))
        new = hook_and_jump(new, lab, s_valid, jumps)
        changed = bool((new != lab).any())
        profiling.count("cc.sweeps")
        lab = new
        if not changed:
            break
    else:
        profiling.count("cc.unconverged")
    # sorted-domain representative -> original-domain member, per original row
    rep_orig = torch.cat([prep.order, prep.order.new_full((1,), n)])[
        torch.clamp(lab, max=n).long()]
    lab_o = torch.where(lab < n, rep_orig, n)[invert_permutation(prep.order).long()]
    return _canonicalize(lab_o, n)


def semantic_radius_cc(coords: torch.Tensor, radius, batch_ids: torch.Tensor,
                       valid: torch.Tensor, semantics: torch.Tensor,
                       max_neighbors_fallback: int = 32, tile: int = TILE,
                       window: int | None = WINDOW, fused_halves: bool = False,
                       return_use_window: bool = False):
    """Connected components of the radius graph restricted to equal
    `semantics`, batch-local, over `valid` points. Returns (N,) int32
    labels = the minimum original point index of the component (N for
    invalid points); with `return_use_window`, (labels, use_window), the
    () bool that chose the windowed sweep over the fallback (false when
    the shape rules the sweep out).

    The fallback (a range past `window` rows, unless `window` is None; a
    key space past int32; or N not a multiple of 8 * tile) is
    ops/knn.ball_query_pair_fast + ops/cc.semantic_connected_components:
    the same partition up to the ball query's `max_neighbors_fallback`
    nearest neighbours. A `window` exists only for parity with the JAX
    kernel's fixed fetch (its parity tests and the multichip dry run);
    PointGroup's clustering passes None.

    fused_halves: the input is two equal stacked half-problems whose batch
    ids interleave (first half 2b, second half 2b + 1: PointGroup's dual
    clustering). The sweep handles the doubled id space directly; the
    fallback runs the halves separately with the ids back at b, so that the
    ball query's int32 key keeps the single-problem range."""
    n = coords.shape[0]
    dev = coords.device
    batch_ids = batch_ids.to(torch.int32)

    def one_fallback(c, b, v, s):
        m = c.shape[0]
        nbrs, _, _ = ball_query_pair_fast(c, b, v, c, b, v, radius,
                                          max_neighbors=max_neighbors_fallback)
        # empty slots hold index m: mask them
        lab = semantic_connected_components(torch.clamp(nbrs, max=m - 1), nbrs < m, v, s)
        return _canonicalize(torch.where(v, lab, m), m)

    def fallback():
        profiling.count("cc.fallback")
        if not fused_halves:
            return one_fallback(coords, batch_ids, valid, semantics)
        h = n // 2
        la = one_fallback(coords[:h], batch_ids[:h] >> 1, valid[:h], semantics[:h])
        lb = one_fallback(coords[h:], batch_ids[h:] >> 1, valid[h:], semantics[h:])
        return torch.cat([torch.where(la < h, la, n), torch.where(lb < h, lb + h, n)])

    if fused_halves and n % 2:
        raise ValueError("fused_halves requires two equal stacked halves")
    if n % (8 * tile) != 0:
        out = fallback()
        return (out, torch.zeros((), dtype=torch.bool, device=dev)) if return_use_window else out

    radius_f = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    prep = _prep(coords, radius_f, batch_ids, valid, semantics, tile, window)
    if bool(prep.use_window):
        out = _cc_loop(prep, radius_f * radius_f, valid, tile=tile)
    else:
        out = fallback()
    return (out, prep.use_window) if return_use_window else out
