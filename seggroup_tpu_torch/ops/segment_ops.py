"""Masked segment reductions (seggroup_tpu/ops/segment_ops.py:53-143).

All ops take a `num_segments` bound and treat ids outside [0, num_segments)
as padding (dropped); empty segments give 0 (sum, mean) or `fill_value`
(max, min). They are `scatter_reduce` over flat segment ids, which serves
for both of the JAX side's engines ("scatter" and the sort-and-scan
"sorted" of segment_sorted.py). Float sums on the card accumulate in atomic
order, so they agree with the JAX side to rounding, not bit for bit, and
differ from run to run; integer reductions and max/min are exact.

`segment_mean_sorted` is for float sums that decide integers downstream
(PointGroup's proposal centres, which decide voxel coordinates): it adds in
the order of segment_sorted.py's stable sort and pairwise segmented scan, so
it equals the JAX side bit for bit and is the same on every run and
device."""

from __future__ import annotations

import torch

__all__ = [
    "invert_permutation",
    "lexsort",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_mean_sorted",
]


def invert_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation, int32."""
    inv = torch.empty_like(order, dtype=torch.int32)
    inv[order.long()] = torch.arange(order.shape[0], dtype=torch.int32,
                                     device=order.device)
    return inv


def lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexsort as numpy/jnp order it: the LAST key is the primary."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _clean_ids(segment_ids: torch.Tensor, num_segments: int,
               data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int64 ids clipped into range and broadcast to data's shape, validity
    mask broadcast likewise). Out-of-range ids are padding."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    shape = valid.shape + (1,) * (data.ndim - valid.ndim)
    return ids.reshape(shape).expand_as(data), valid.reshape(shape).expand_as(data)


def _reduce(data, segment_ids, num_segments, reduce, identity):
    ids, valid = _clean_ids(segment_ids, num_segments, data)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    src = torch.where(valid, data, torch.full_like(data, identity))
    return out.scatter_reduce_(0, ids, src, reduce=reduce, include_self=True)


def _extreme(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum `data[i]` into row `segment_ids[i]`. Invalid ids contribute nothing."""
    return _reduce(data, segment_ids, num_segments, "sum", 0)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments)
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    count = segment_sum(valid.to(data.dtype), segment_ids, num_segments)
    count = count.reshape(count.shape + (1,) * (data.ndim - valid.ndim))
    return total / torch.clamp(count, min=1)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, fill_value=None) -> torch.Tensor:
    """Per-segment max. Empty segments get `fill_value` (default 0)."""
    low = _extreme(data.dtype, high=False)
    out = _reduce(data, segment_ids, num_segments, "amax", low)
    return torch.where(out == low, 0 if fill_value is None else fill_value, out)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, fill_value=None) -> torch.Tensor:
    """Per-segment min. Empty segments get `fill_value` (default 0)."""
    high = _extreme(data.dtype, high=True)
    out = _reduce(data, segment_ids, num_segments, "amin", high)
    return torch.where(out == high, 0 if fill_value is None else fill_value, out)


def _segmented_scan(flags: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of `vals` (N, C) along rows, a segment
    starting at each set flag, in the order of `jax.lax.associative_scan`:
    adjacent pairs are combined, the halved problem is scanned recursively,
    and the even rows are completed from the odd results."""

    def comb(fa, va, fb, vb):
        return fa | fb, torch.where(fb[:, None], vb, va + vb)

    def scan(f, v):
        n = v.shape[0]
        if n < 2:
            return f, v
        of, ov = scan(*comb(f[0:-1:2], v[0:-1:2], f[1::2], v[1::2]))
        if n % 2 == 0:
            ef, ev = comb(of[:-1], ov[:-1], f[2::2], v[2::2])
        else:
            ef, ev = comb(of, ov, f[2::2], v[2::2])
        out_f, out_v = torch.empty_like(f), torch.empty_like(v)
        out_f[0], out_v[0] = f[0], v[0]
        out_f[2::2], out_v[2::2] = ef, ev
        out_f[1::2], out_v[1::2] = of, ov
        return out_f, out_v

    return scan(flags, vals)[1]


def segment_mean_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """`segment_mean` of float data in the sorted engine's summation order:
    rows stably sorted by segment, a pairwise segmented scan, each segment's
    sum read at its last row."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    key = torch.where(valid, segment_ids, num_segments).to(torch.int32)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    probe = torch.arange(num_segments, dtype=torch.int32, device=key.device)
    starts = torch.searchsorted(sk, probe)
    ends = torch.searchsorted(sk, probe, right=True)
    d2 = data.reshape(data.shape[0], -1)
    sd = torch.where(valid[order][:, None], d2[order], 0)
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device), sk[1:] != sk[:-1]])
    run = _segmented_scan(flags, sd)
    total = torch.where((ends > starts)[:, None], run[torch.clamp(ends - 1, min=0)], 0)
    count = torch.clamp(ends - starts, min=1).to(data.dtype)
    return (total / count[:, None]).reshape((num_segments,) + tuple(data.shape[1:]))
