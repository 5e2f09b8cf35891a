"""Sorted-key coordinate lookup for rulebook construction
(seggroup_tpu/sparse/hashing.py).

Key packing, in int32 with the same wrapping arithmetic as the JAX side:
hi = (batch << (x_bits + y_bits)) | (x << y_bits) | y, lo = z; 5-column
spatio-temporal coords (batch, x, y, z, t) pack the frame index into the low
key, lo = (z << 9) | t, for t < 512. Invalid rows take the key (INT32_MAX,
INT32_MAX). The (hi, lo) pair order is carried by
one int64 key, (hi << 32) + (lo + 2^31), so a stable argsort is the stable
lexsort of (lo, hi) and `torch.searchsorted` is the lower bound of the JAX
binary search, position for position."""

from __future__ import annotations

import torch

__all__ = ["pack_keys", "sort_coords", "lookup", "pair_key"]

INT32_MAX = 2 ** 31 - 1


def pack_keys(coords: torch.Tensor,
              xy_bits: tuple[int, int] = (14, 14)) -> tuple[torch.Tensor, torch.Tensor]:
    """coords (M, 4) or (M, 5) int32 -> (hi, lo) int32 keys; a 5th column
    is a frame index t < 512."""
    c = coords.to(torch.int32)
    xb, yb = xy_bits
    hi = (c[:, 0] << (xb + yb)) | (c[:, 1] << yb) | c[:, 2]
    if c.shape[1] == 5:
        return hi, (c[:, 3] << 9) | c[:, 4]
    return hi, c[:, 3]


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 whose order is the (hi, lo) int32 pair order."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2 ** 31)


def sort_coords(coords: torch.Tensor, valid: torch.Tensor,
                xy_bits: tuple[int, int] = (14, 14)):
    """(order, hi_sorted, lo_sorted): lexicographic order, stable, with
    invalid rows last (their keys are INT32_MAX)."""
    hi, lo = pack_keys(coords, xy_bits)
    hi = torch.where(valid, hi, INT32_MAX)
    lo = torch.where(valid, lo, INT32_MAX)
    order = torch.argsort(pair_key(hi, lo), stable=True).to(torch.int32)
    return order, hi[order.long()], lo[order.long()]


def lower_bound(hi_sorted: torch.Tensor, lo_sorted: torch.Tensor,
                q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """First sorted position with key >= (q_hi, q_lo); in [0, M], int32."""
    keys = pair_key(hi_sorted, lo_sorted)
    q = pair_key(q_hi, q_lo)
    return torch.searchsorted(keys, q.reshape(-1)).reshape(q.shape).to(torch.int32)


def lookup(hi_sorted: torch.Tensor, lo_sorted: torch.Tensor,
           q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """For each query key pair, the sorted position holding an exact match,
    or M (capacity) if absent."""
    m = hi_sorted.shape[0]
    lb = lower_bound(hi_sorted, lo_sorted, q_hi, q_lo)
    pos = torch.clamp(lb, max=m - 1).long()
    hit = (hi_sorted[pos] == q_hi) & (lo_sorted[pos] == q_lo)
    return torch.where(hit, lb, m).to(torch.int32)
