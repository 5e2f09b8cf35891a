"""Windowed sorted join: the merge-join path of the kernel-3 rulebook
(seggroup_tpu/sparse/merge_join.py).

For one (dx, dy) offset group the queries (hi + c, z - 1) of lexsorted keys
are themselves sorted, so each tile of `tile` queries finds all of its
matches inside one window of 2 * kw consecutive keys, starting at the
kw-block of its first query's lower bound. `ok` says whether every tile's
window held its last query's matches; where it does not, the positions are
not trustworthy and the caller takes the searched path.

The JAX side resolves a window with broadcast compares and counts over
(tile, 2 * kw) blocks, `chunk_tiles` tiles at a time (a bound on its
transient memory). The port computes the same counts in closed form from
lower bounds into the padded key array: within a window [b, b + 2 kw) of a
sorted array, the keys below q are clamp(lower_bound(q), b, b + 2 kw) - b,
and the window holds q where its lower bound lies inside and matches. So
every output, the untrustworthy positions of an overflowing tile included,
is the JAX function's. The JAX module's `lower_bound_pair` is
`sparse/hashing.lower_bound` here."""

from __future__ import annotations

import torch

from seggroup_tpu_torch.sparse.hashing import INT32_MAX, lower_bound, pair_key

__all__ = ["windowed_join3"]


def windowed_join3(hi_s: torch.Tensor, lo_s: torch.Tensor, q_hi: torch.Tensor,
                   q_lo: torch.Tensor, tile: int = 512, kw: int = 1024,
                   chunk_tiles: int = 8):
    """3-consecutive-target join of sorted queries into sorted unique keys.

    hi_s, lo_s: (M,) int32, strictly increasing over the valid prefix,
        INT32_MAX on padding rows.
    q_hi, q_lo: (Nq,) int32, sorted (nondecreasing) within every aligned
        `tile`-sized block; Nq % tile == 0. Padding queries use
        (INT32_MAX, INT32_MAX - 4) so that q_lo + 3 cannot overflow.

    Returns (pos_m1, pos_0, pos_p1, ok): for each query the key position
    matching (q_hi, q_lo + t) for t = 0, 1, 2 inside its tile's window, or M
    if absent; `ok` a bool tensor, False when some tile's window overflowed
    (the positions are then not trustworthy). `chunk_tiles` bounded the JAX
    side's transient memory; the results do not depend on it."""
    m = hi_s.shape[0]
    nq = q_hi.shape[0]
    assert nq % tile == 0, (nq, tile)
    assert chunk_tiles >= 1
    n_tiles = nq // tile
    dev = hi_s.device

    # keys padded so that any window start in [0, mp - 2 kw] is in bounds
    mp = (-(-m // kw) + 2) * kw
    big = torch.full((mp - m,), INT32_MAX, dtype=torch.int32, device=dev)
    khp = torch.cat([hi_s.to(torch.int32), big])
    klp = torch.cat([lo_s.to(torch.int32), big])

    q_hi2 = q_hi.reshape(n_tiles, tile)
    q_lo2 = q_lo.reshape(n_tiles, tile)
    lb_head = lower_bound(hi_s, lo_s, q_hi2[:, 0], q_lo2[:, 0])
    need_end = lower_bound(hi_s, lo_s, q_hi2[:, -1], q_lo2[:, -1] + 3)
    s_blk = torch.clamp(torch.div(lb_head, kw, rounding_mode="floor"), max=mp // kw - 2)
    ok = torch.all(need_end <= s_blk * kw + 2 * kw)

    base = (s_blk.to(torch.int64) * kw)[:, None].expand(n_tiles, tile).reshape(nq)
    end = base + 2 * kw
    keys = pair_key(khp, klp)
    pos = []
    hits = []
    for t in range(3):
        q = pair_key(q_hi, q_lo + t)
        lb = torch.searchsorted(keys, q)
        if t == 0:
            c0 = torch.clamp(lb, min=base, max=end) - base
        inside = (lb >= base) & (lb < end)
        hits.append((inside & (keys[torch.clamp(lb, max=mp - 1)] == q)).to(torch.int64))
    p_m1 = base + c0
    p_0 = p_m1 + hits[0]
    p_p1 = p_0 + hits[1]
    for p, e in zip((p_m1, p_0, p_p1), hits):
        pos.append(torch.where(e > 0, p, m).to(torch.int32))
    return pos[0], pos[1], pos[2], ok
