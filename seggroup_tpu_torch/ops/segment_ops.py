"""Masked segment reductions (seggroup_tpu/ops/segment_ops.py:53-143).

All ops take a `num_segments` bound and treat ids outside [0, num_segments)
as padding (dropped); empty segments give 0 (sum, mean) or `fill_value`
(max, min). They are `scatter_reduce` over flat segment ids, which serves
for both of the JAX side's engines ("scatter" and the sort-and-scan
"sorted" of segment_sorted.py). Float sums on the card accumulate in atomic
order, so they agree with the JAX side to rounding, not bit for bit, and
differ from run to run; integer reductions and max/min are exact.

`segment_mean_sorted` is for float sums that must equal the JAX side's
sorted engine (PointGroup's proposal centres, which decide voxel
coordinates, and the ScoreNet's voxel features): it adds in the order of
segment_sorted.py's stable sort and pairwise segmented scan, so it equals
the JAX side bit for bit and is the same on every run and device; its
gradient is that engine's gather of g / count. `segment_max_sorted` is the
sorted engine's max: the same values as `segment_max`, but its gradient
goes whole to one row of each segment, the earliest among equal maxima,
where the scatter max shares it among them (PointGroup's roipool, whose
ReLU leaves ties at 0 everywhere).

`set_default_method` takes the JAX side's engine names and validates them;
the port's reductions are the same for both. `segment_argmax` (the
smallest row index among a segment's maxima) and `csr_segment_reduce`
(segments given by CSR offsets) are the JAX functions' counterparts."""

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
    "segment_max_sorted",
    "segment_argmax",
    "csr_segment_reduce",
    "set_default_method",
]

_DEFAULT_METHOD = "scatter"


def set_default_method(method: str) -> None:
    """Select the reduction engine by the JAX side's names ("scatter" |
    "sorted"; anything else raises). The port's reductions give the same
    results under either, as the JAX side's two engines do."""
    global _DEFAULT_METHOD
    if method not in ("scatter", "sorted"):
        raise ValueError(method)
    _DEFAULT_METHOD = method


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


class _MeanSorted(torch.autograd.Function):
    """The sorted engine's segment mean with its custom VJP
    (segment_sorted.py `_mean_bwd`): the backward gathers g / count."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        valid = (segment_ids >= 0) & (segment_ids < num_segments)
        key = torch.where(valid, segment_ids, num_segments).to(torch.int32)
        order = torch.argsort(key, stable=True)
        sk = key[order]
        probe = torch.arange(num_segments, dtype=torch.int32, device=key.device)
        starts = torch.searchsorted(sk, probe)
        ends = torch.searchsorted(sk, probe, right=True)
        d2 = data.reshape(data.shape[0], -1)
        sd = torch.where(valid[order][:, None], d2[order], 0)
        flags = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                           sk[1:] != sk[:-1]])
        run = _segmented_scan(flags, sd)
        total = torch.where((ends > starts)[:, None], run[torch.clamp(ends - 1, min=0)], 0)
        count = torch.clamp(ends - starts, min=1).to(data.dtype)
        ctx.save_for_backward(segment_ids, count)
        ctx.num_segments = num_segments
        return (total / count[:, None]).reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        segment_ids, count = ctx.saved_tensors
        valid = (segment_ids >= 0) & (segment_ids < ctx.num_segments)
        ids = torch.where(valid, segment_ids, 0).long()
        g2 = g.reshape(g.shape[0], -1)
        gd = torch.where(valid[:, None], g2[ids] / count[ids][:, None], 0)
        return gd.reshape((segment_ids.shape[0],) + tuple(g.shape[1:])), None, None


def segment_mean_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """`segment_mean` of float data in the sorted engine's summation order:
    rows stably sorted by segment, a pairwise segmented scan, each segment's
    sum read at its last row. Differentiable in `data`: row i gets
    g[seg(i)] / count(seg(i))."""
    return _MeanSorted.apply(data, segment_ids, num_segments)


def segment_max_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, fill_value=None) -> torch.Tensor:
    """Per-segment max (N, ...) -> (num_segments, ...) as the sorted engine
    computes it (segment_sorted.py `_extreme`): each output element is the
    input element of its segment's winning row, the earliest row among
    equal maxima, gathered, so the gradient goes to that row alone. Empty
    segments get `fill_value` (default 0)."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    d2 = data.reshape(data.shape[0], -1)
    with torch.no_grad():
        best = _reduce(d2, segment_ids, num_segments, "amax", _extreme(d2.dtype, high=False))
        ids = torch.where(valid, segment_ids, 0).long()
        rows = torch.arange(d2.shape[0], device=d2.device)[:, None].expand_as(d2)
        wins = valid[:, None] & (d2 == best[ids])
        arg = _reduce(torch.where(wins, rows, d2.shape[0]), segment_ids, num_segments,
                      "amin", d2.shape[0])
        nonempty = arg < d2.shape[0]
    out = torch.where(nonempty, d2.gather(0, torch.where(nonempty, arg, 0)),
                      0 if fill_value is None else fill_value)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def segment_argmax(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Per segment and per feature column, the index into data's leading
    axis of the segment's maximum, the smallest index among equal maxima;
    0 for an empty segment. int32, (num_segments, ...)."""
    n = data.shape[0]
    ids, valid = _clean_ids(segment_ids, num_segments, data)
    best = segment_max(data, segment_ids, num_segments)
    rows = torch.arange(n, dtype=torch.int32, device=data.device)
    rows = rows.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    cand = torch.where(valid & (data == best.gather(0, ids)), rows, n)
    arg = _reduce(cand, segment_ids, num_segments, "amin", n)
    return torch.where(arg >= n, 0, arg)


def csr_segment_reduce(data: torch.Tensor, offsets: torch.Tensor, num_segments: int,
                       mode: str = "max") -> torch.Tensor:
    """The reduction over segments given as CSR offsets ((num_segments + 1,),
    possibly padded with trailing repeats of the total): row i belongs to
    the segment of the last offset <= i; rows at or past segment
    num_segments are padding. `mode`: "sum", "mean", "max" or "min"."""
    rows = torch.arange(data.shape[0], dtype=offsets.dtype, device=data.device)
    ids = torch.searchsorted(offsets, rows, right=True) - 1
    ids = torch.where(ids >= num_segments, -1, ids)
    reduce = {"sum": segment_sum, "mean": segment_mean, "max": segment_max,
              "min": segment_min}.get(mode)
    if reduce is None:
        raise ValueError(f"unknown mode {mode!r}")
    return reduce(data, ids, num_segments)
