"""Masked segment reductions (seggroup_tpu/ops/segment_ops.py:53-143).

All ops take a `num_segments` bound and treat ids outside [0, num_segments)
as padding (dropped). They are `scatter_reduce` over flat segment ids; the
TPU-only sorted engine (segment_sorted.py) has no counterpart here. Float
sums on the card accumulate in atomic order, so they agree with the JAX
side to rounding, not bit for bit; integer reductions and max/min are
exact."""

from __future__ import annotations

import torch

__all__ = [
    "invert_permutation",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
]


def invert_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation, int32."""
    inv = torch.empty_like(order, dtype=torch.int32)
    inv[order.long()] = torch.arange(order.shape[0], dtype=torch.int32,
                                     device=order.device)
    return inv


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
