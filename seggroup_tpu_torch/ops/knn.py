"""Neighbour search (seggroup_tpu/ops/knn.py:47-338).

  * dense brute-force kNN over small point sets -> `knn_brute` /
    `masked_knn`, over the |x|^2 - 2<x,y> + |y|^2 expansion;
  * per-cluster kNN over the full scene -> `cluster_knn`: points sorted by
    (cluster id, Morton code) so each cluster is a contiguous block, and an
    exact top-k over a fixed candidate window per row block.

Every distance is formed in XLA's CPU order (ops/fma.py) and every top-k
orders equal distances by ascending index, as `lax.top_k` does, so indices
equal the JAX ones exactly. The approximate top-k (`approx=True`) and the
ball queries are not ported."""

from __future__ import annotations

import torch

from seggroup_tpu_torch.ops.fma import dot_fma
from seggroup_tpu_torch.ops.segment_ops import invert_permutation

__all__ = [
    "pairwise_sqdist",
    "knn_brute",
    "masked_knn",
    "cluster_knn",
    "morton3d",
]


def morton3d(points: torch.Tensor, valid: torch.Tensor | None = None,
             bits: int = 10) -> torch.Tensor:
    """Morton (Z-order) code of 3-D points, (N,) int32. Points are quantized
    to `bits` per axis over their (valid-)bounding box."""
    if bits * 3 > 31:
        raise ValueError(f"bits={bits} does not fit an int32 code")
    if valid is None:
        lo = points.min(dim=0).values
        hi = points.max(dim=0).values
    else:
        big = 3e38
        lo = torch.where(valid[:, None], points, big).min(dim=0).values
        hi = torch.where(valid[:, None], points, -big).max(dim=0).values
    # a tensor numerator: `float / tensor` multiplies by a rounded reciprocal
    scale = lo.new_tensor(2.0 ** bits - 1.0) / torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((points - lo) * scale, 0, 2.0 ** bits - 1).to(torch.int32)

    def spread(x):
        # 10-bit -> every 3rd bit (magic-number bit spreading)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, (..., N, D) x (..., M, D) -> (..., N, M),
    as |x|^2 - 2<x,y> + |y|^2 clamped at 0."""
    xx = dot_fma(x, x)[..., :, None]
    yy = dot_fma(y, y)[..., None, :]
    cross = dot_fma(x[..., :, None, :], y[..., None, :, :])
    return torch.clamp(xx - 2.0 * cross + yy, min=0.0)


def _smallest_k(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k smallest entries of each row, equal
    values in ascending index order (= lax.top_k(-d, k) negated)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def knn_brute(points: torch.Tensor, k: int) -> torch.Tensor:
    """kNN indices over small batched point sets: (B, P, D) -> (B, P, k).
    Includes self (distance 0)."""
    return _smallest_k(pairwise_sqdist(points, points), k)[1]


def masked_knn(points: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """kNN with per-point validity: invalid points are never neighbours, and
    rows with < k valid candidates repeat the self index."""
    big = 1e30
    d = torch.where(valid[..., None, :], pairwise_sqdist(points, points), big)
    vals, idx = _smallest_k(d, k)
    self_idx = torch.arange(points.shape[-2], dtype=torch.int32,
                            device=points.device)[:, None]
    return torch.where(vals >= big, self_idx, idx)


def _iter_min_topk(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """top_k(-d, k) over the last axis via k rounds of (argmin, mask): the
    same values and tie order as lax.top_k (argmin takes the first minimum).
    Returns (negated values, int32 indices)."""
    d = d.clone()
    vals, idxs = [], []
    for _ in range(k):
        j = torch.argmin(d, dim=-1, keepdim=True)
        vals.append(-torch.gather(d, -1, j))
        idxs.append(j)
        d.scatter_(-1, j, 3e38)
    return torch.cat(vals, -1), torch.cat(idxs, -1).to(torch.int32)


def cluster_knn(
    points: torch.Tensor,
    cluster_ids: torch.Tensor,
    k: int = 20,
    row_block: int = 1024,
    window: int = 16384,
    approx: bool = False,
    valid: torch.Tensor | None = None,
    small_window: int | None = None,
) -> torch.Tensor:
    """Per-point kNN restricted to points sharing `cluster_ids` (self included).

    points:      (N, D) float32; N must be a multiple of row_block.
    cluster_ids: (N,) int32; a large sentinel (> any real id) marks padding.
    window:      candidate budget per row block. The window is centred on the
                 block in (cluster, Morton) sorted order and clamped to the
                 first row's cluster start; clusters larger than the window
                 get the kNN of their spatial neighbourhood.
    valid:       (N,) bool, keeps padding rows out of the Morton bounding box.
    small_window: tier for row blocks whose rows' clusters all fit
                 row_block + small_window candidates starting at the first
                 row's cluster start; bit-identical to the big window there.
                 None = window // 4 when window >= 4096; 0 disables.

    Returns (N, k) int32 indices in the original point order. Rows whose
    cluster has < k members repeat the self index. Row blocks are processed
    in batches (the result of each block is independent of the others)."""
    n, dim = points.shape
    if n % row_block:
        raise ValueError(f"pad N={n} to a multiple of row_block={row_block}")
    if approx:
        raise NotImplementedError("approximate top-k is not ported")
    if small_window is None:
        small_window = window // 4 if window >= 4096 else 0
    small_window = 0 if small_window >= window else small_window
    dev = points.device

    # two-key stable sort: cluster id major, Morton code minor
    m_order = torch.argsort(morton3d(points, valid), stable=True)
    order = m_order[torch.argsort(cluster_ids[m_order], stable=True)]
    s_cid_n = cluster_ids[order]
    big = 1e30
    w = row_block + window
    # pad the sorted layout so windows never need clamping
    s_pts = torch.cat([points[order], points.new_zeros((w, dim))])
    s_cid = torch.cat([s_cid_n, s_cid_n.new_full((w,), -0x7FFFFFFF)])

    r0 = torch.arange(0, n, row_block, device=dev)
    c0 = torch.searchsorted(s_cid_n, s_cid_n[r0], side="left")
    tiers = [(torch.maximum(c0, r0 - window // 2), w)]
    fits = torch.zeros_like(r0, dtype=torch.bool)
    if small_window:
        c_end = torch.searchsorted(s_cid_n, s_cid_n[r0 + row_block - 1],
                                   side="right")
        w0s = torch.maximum(c0, r0 - small_window // 2)
        fits = (w0s == c0) & (c_end - c0 <= row_block + small_window)
        tiers.append((w0s, row_block + small_window))

    knn_sorted = torch.empty((n, k), dtype=torch.int64, device=dev)
    rows_off = torch.arange(row_block, device=dev)
    for tier, (w0_all, width) in enumerate(tiers):
        blocks = torch.nonzero(fits if tier else ~fits)[:, 0]
        per_batch = max(1, (1 << 26) // (row_block * width))
        for b0 in range(0, blocks.shape[0], per_batch):
            bl = blocks[b0:b0 + per_batch]
            w0 = w0_all[bl]
            rows = r0[bl][:, None] + rows_off  # (nb, row_block) sorted positions
            cols = w0[:, None] + torch.arange(width, device=dev)
            d = pairwise_sqdist(s_pts[rows], s_pts[cols])
            d = torch.where(s_cid[rows][:, :, None] == s_cid[cols][:, None, :],
                            d, big)
            neg_d, bi = _iter_min_topk(d, k)
            best = bi.long() + w0[:, None, None]
            knn_sorted[rows.reshape(-1)] = torch.where(
                neg_d <= -big, rows[:, :, None], best).reshape(-1, k)
    # map sorted positions -> original ids, and rows back to original order
    knn_orig = order[knn_sorted]
    return knn_orig[invert_permutation(order).long()].to(torch.int32)
