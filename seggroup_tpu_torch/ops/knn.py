"""Neighbour search (seggroup_tpu/ops/knn.py:47-338).

  * dense brute-force kNN over small point sets -> `knn_brute` /
    `masked_knn`, over the |x|^2 - 2<x,y> + |y|^2 expansion;
  * per-cluster kNN over the full scene -> `cluster_knn`: points sorted by
    (cluster id, Morton code) so each cluster is a contiguous block, and an
    exact top-k over a fixed candidate window per row block.

  * fixed-radius neighbour lists between two point sets over a uniform
    grid of radius-sized cells -> `ball_query_pair` (27-cell stencil,
    per-cell bucket caps), `ball_query_pair_windowed` (queries in cell-key
    order, one contiguous support window per tile of queries) and
    `ball_query_pair_fast` (the windowed form, falling back to the bucket
    form when a window or the int32 key space overflows), and `ball_query`,
    one set with itself.

Every distance is formed in XLA's CPU order (ops/fma.py) and every top-k
orders equal distances by ascending index, as `lax.top_k` does, so indices
equal the JAX ones exactly. The JAX side's approximate top-k
(`approx=True`) is the exact one off the TPU, so `cluster_knn` has no such
option."""

from __future__ import annotations

import torch

from seggroup_tpu_torch.ops.fma import dot_fma, sqdist_fma
from seggroup_tpu_torch.ops.segment_ops import invert_permutation

__all__ = [
    "pairwise_sqdist",
    "knn_brute",
    "masked_knn",
    "cluster_knn",
    "morton3d",
    "grid_hash",
    "ball_query_pair",
    "ball_query_pair_windowed",
    "ball_query_pair_fast",
    "ball_query",
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

    The JAX side's `approx=True` branch (`lax.approx_max_k(-d, k,
    recall_target=0.95)`) has no counterpart here: XLA approximates only on
    the TPU, and elsewhere computes the exact top-k, values and indices equal
    to `lax.top_k`'s with the lowest index first on ties (checked on
    tie-heavy rows by tests/test_torch_knn.py). So that branch is this
    function. The top-k is `_iter_min_topk`, whose ties go as `lax.top_k`'s;
    `torch.topk` leaves the order of ties open.

    Returns (N, k) int32 indices in the original point order. Rows whose
    cluster has < k members repeat the self index. Row blocks are processed
    in batches (the result of each block is independent of the others)."""
    n, dim = points.shape
    if n % row_block:
        raise ValueError(f"pad N={n} to a multiple of row_block={row_block}")
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


# ---------------------------------------------------------------------------
# uniform-grid hashing + fixed-radius neighbour lists
# (seggroup_tpu/ops/knn.py:346-617)
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1


def grid_hash(coords: torch.Tensor, cell_size) -> torch.Tensor:
    """Quantize (N, 3) coords to int32 cell coords (a true division, as XLA
    divides). The caller offsets to >= 0."""
    return torch.floor(coords / cell_size).to(torch.int32)


def _cell_key(cells: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Row-major linear int32 key for 3-D integer cells (cells >= 0)."""
    return (cells[..., 0] * dims[1] + cells[..., 1]) * dims[2] + cells[..., 2]


def _masked_min(x: torch.Tensor, valid: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.where(valid[:, None], x, fill).min(dim=0).values


def _masked_max(x: torch.Tensor, valid: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.where(valid[:, None], x, fill).max(dim=0).values


def _pair_grid(support, support_valid, queries, query_valid, radius, query_extent: bool):
    """Shifted cells of both sets and the grid dims (3,) int32; the dims
    cover the queries too with `query_extent` (the windowed form)."""
    s_cells = grid_hash(support, radius)
    q_cells = grid_hash(queries, radius)
    cmin = torch.minimum(_masked_min(s_cells, support_valid, 2 ** 30),
                         _masked_min(q_cells, query_valid, 2 ** 30))
    s_cells = s_cells - cmin + 1
    q_cells = q_cells - cmin + 1
    cmax = _masked_max(s_cells, support_valid, 0)
    if query_extent:
        cmax = torch.maximum(cmax, _masked_max(q_cells, query_valid, 0))
    return s_cells, q_cells, cmax + 2


# query rows per batch of ball_query_pair's (rows, 27 * bucket_cap) candidate
# block, and (tile, window) elements per batch of the windowed form
_BUCKET_ROWS = 1 << 15
_WINDOW_ELEMS = 1 << 25


def ball_query_pair(support: torch.Tensor, support_batch: torch.Tensor,
                    support_valid: torch.Tensor, queries: torch.Tensor,
                    query_batch: torch.Tensor, query_valid: torch.Tensor,
                    radius, max_neighbors: int = 64, bucket_cap: int = 16
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-radius neighbours of `queries` among `support`, same batch id
    only. Candidates are the first `bucket_cap` rows of each of the 27
    stencil cells; the nearest `max_neighbors` in-radius ones are kept,
    nearest first. Returns (neighbors (Nq, K) int32 into support, Ns for
    empty slots; counts (Nq,) int32; overflow (Nq,) bool: a cell held more
    than `bucket_cap` rows or the ball more than K)."""
    ns, nq, k = support.shape[0], queries.shape[0], max_neighbors
    dev = support.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    s_cells, q_cells, dims = _pair_grid(support, support_valid, queries, query_valid,
                                        radius, False)
    span = dims[0] * dims[1] * dims[2]
    s_key = _cell_key(s_cells, dims) + support_batch.to(torch.int32) * span
    s_key = torch.where(support_valid, s_key, INT32_MAX)
    order = torch.argsort(s_key, stable=True)
    s_key_sorted = s_key[order]

    r = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    offsets = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    base_key = _cell_key(q_cells, dims) + query_batch.to(torch.int32) * span
    off_key = (offsets[:, 0] * dims[1] + offsets[:, 1]) * dims[2] + offsets[:, 2]
    slot = torch.arange(bucket_cap, device=dev)
    r2 = radius * radius
    big = 1e30

    nbrs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    counts = torch.empty(nq, dtype=torch.int32, device=dev)
    overflow = torch.empty(nq, dtype=torch.bool, device=dev)
    for q0 in range(0, nq, _BUCKET_ROWS):
        sl = slice(q0, q0 + _BUCKET_ROWS)
        qv = query_valid[sl]
        nb_key = base_key[sl, None] + off_key[None, :]  # (B, 27)
        start = torch.searchsorted(s_key_sorted, nb_key)
        stop = torch.searchsorted(s_key_sorted, nb_key, right=True)
        # rows past bucket_cap are never gathered and may be in the ball
        bucket_overflow = ((stop - start) > bucket_cap).any(dim=1) & qv
        b = nb_key.shape[0]
        slots_raw = (start[:, :, None] + slot).reshape(b, 27 * bucket_cap)
        # a past-the-end slot must not alias row ns-1
        slots = torch.clamp(slots_raw, max=ns - 1)
        nb_key_flat = nb_key[:, :, None].expand(b, 27, bucket_cap).reshape(b, -1)
        cand_ok = (s_key_sorted[slots] == nb_key_flat) & (slots_raw < ns)
        cand_idx = order[slots]
        q = queries[sl]
        d = sqdist_fma(*(support[:, c][cand_idx] - q[:, c, None] for c in range(3)))
        in_ball = cand_ok & (d <= r2) & qv[:, None] & support_valid[cand_idx]
        d = torch.where(in_ball, d, big)
        vals, sel = _smallest_k(d, k)
        got = vals < big
        picked = torch.gather(cand_idx, 1, sel.long()).to(torch.int32)
        nbrs[sl] = torch.where(got, picked, ns)
        counts[sl] = got.sum(dim=1, dtype=torch.int32)
        overflow[sl] = (in_ball.sum(dim=1) > k) | bucket_overflow
    return nbrs, counts, overflow


def ball_query(coords: torch.Tensor, radius, batch_ids: torch.Tensor, valid: torch.Tensor,
               max_neighbors: int = 64, bucket_cap: int = 16
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-radius neighbours of every point among the points of its own
    batch id (seggroup_tpu/ops/knn.py `ball_query`): `ball_query_pair` of
    the set with itself, whose empty slots hold the point's own index
    instead of N. Self is included. Returns (neighbors (N, K) int32,
    counts (N,) int32, overflow (N,) bool)."""
    nbrs, counts, overflow = ball_query_pair(coords, batch_ids, valid, coords, batch_ids,
                                             valid, radius, max_neighbors, bucket_cap)
    n = coords.shape[0]
    own = torch.arange(n, dtype=torch.int32, device=coords.device)[:, None]
    return torch.where(nbrs == n, own, nbrs), counts, overflow


def ball_query_pair_windowed(support: torch.Tensor, support_batch: torch.Tensor,
                             support_valid: torch.Tensor, queries: torch.Tensor,
                             query_batch: torch.Tensor, query_valid: torch.Tensor,
                             radius, max_neighbors: int = 32, tile: int = 256,
                             window: int = 4096
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ball_query_pair` without per-cell caps: queries go in cell-key
    order, so the whole 27-cell stencil of a tile of `tile` queries lies in
    one contiguous range of the key-sorted support, of which `window` rows
    are tested. Exact while no range exceeds the window.

    Returns (neighbors, counts, overflow, window_overflow_any); the last is
    a () bool, true when some tile's range exceeded `window` or the key
    space exceeds int32: the caller must then take `ball_query_pair`."""
    ns, nq, k = support.shape[0], queries.shape[0], max_neighbors
    dev = support.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    s_cells, q_cells, dims = _pair_grid(support, support_valid, queries, query_valid,
                                        radius, True)
    span = dims[0] * dims[1] * dims[2]
    # stencil key extremes: off_key(dx, dy, dz) = (dx * d1 + dy) * d2 + dz
    off_max = (dims[1] + 1) * dims[2] + 1
    sb32, qb32 = support_batch.to(torch.int32), query_batch.to(torch.int32)
    num_batches = torch.maximum(torch.where(support_valid, sb32, 0).max(),
                                torch.where(query_valid, qb32, 0).max()) + 1
    dimsf = dims.to(torch.float32)
    prodf = dimsf[0] * dimsf[1] * dimsf[2] * num_batches.to(torch.float32)
    key_space_overflow = prodf >= 2.0 ** 31

    s_key = torch.where(support_valid, _cell_key(s_cells, dims) + sb32 * span, INT32_MAX)
    q_key = torch.where(query_valid, _cell_key(q_cells, dims) + qb32 * span, INT32_MAX)

    order_s = torch.argsort(s_key, stable=True)
    sk = s_key[order_s]
    # a window wider than the support tests only pad rows past its end: the
    # first `width` columns hold every real candidate, at the same columns
    width = min(window, ns)
    # sorted, window-padded support (pad rows: key MAX, far coords)
    sxyz = torch.cat([support[order_s], support.new_full((width, 3), 3e38)])
    sb = torch.cat([sb32[order_s], sb32.new_full((width,), -1)])
    skp = torch.cat([sk, sk.new_full((width,), INT32_MAX)])
    ord_pad = torch.cat([order_s.to(torch.int32),
                         torch.full((width,), ns, dtype=torch.int32, device=dev)])

    order_q = torch.argsort(q_key, stable=True)
    n_tiles = -(-nq // tile)
    qpad = n_tiles * tile - nq
    qk = torch.cat([q_key[order_q], q_key.new_full((qpad,), INT32_MAX)])
    qxyz = torch.cat([queries[order_q], queries.new_zeros((qpad, 3))])
    qb = torch.cat([qb32[order_q], qb32.new_full((qpad,), -2)])
    qv = torch.cat([query_valid[order_q], query_valid.new_zeros((qpad,))])

    qk_t = qk.reshape(n_tiles, tile)
    real = qk_t != INT32_MAX
    lo_key = qk_t[:, 0] - off_max  # a sorted tile: the first key is the least
    hi_key = torch.where(real, qk_t, -(2 ** 30)).max(dim=1).values + off_max
    w0 = torch.searchsorted(sk, lo_key)
    w_end = torch.searchsorted(sk, hi_key, right=True)
    ovf_t = (w_end - w0) > window

    r2 = radius * radius
    big = 1e30
    cols = torch.arange(width, device=dev)
    nbrs = torch.empty((n_tiles, tile, k), dtype=torch.int32, device=dev)
    counts = torch.empty((n_tiles, tile), dtype=torch.int32, device=dev)
    over = torch.empty((n_tiles, tile), dtype=torch.bool, device=dev)
    per_batch = max(1, _WINDOW_ELEMS // (tile * width))
    for t0 in range(0, n_tiles, per_batch):
        ts = slice(t0, t0 + per_batch)
        win = w0[ts, None] + cols  # (T, window) rows of the padded support
        rows = slice(t0 * tile, min(t0 + per_batch, n_tiles) * tile)
        q = qxyz[rows].reshape(-1, tile, 3)
        wx = sxyz[win]
        # per-axis differences, the distance of ball_query_pair
        d = sqdist_fma(*(q[:, :, None, c] - wx[:, None, :, c] for c in range(3)))
        qv_t = qv[rows].reshape(-1, tile)
        ok = ((skp[win] != INT32_MAX)[:, None, :]
              & (qb[rows].reshape(-1, tile)[:, :, None] == sb[win][:, None, :])
              & qv_t[:, :, None] & (d <= r2))
        d = torch.where(ok, d, big)
        neg_d, sel = _iter_min_topk(d, k)
        got = neg_d > -big
        orig = torch.gather(ord_pad[win][:, None, :].expand(-1, tile, -1), 2, sel.long())
        nbrs[ts] = torch.where(got, orig, ns)
        counts[ts] = got.sum(dim=2, dtype=torch.int32)
        over[ts] = ((ok.sum(dim=2) > k) | ovf_t[ts, None]) & qv_t
    # rows are in sorted-query order (pad rows last): restore the original
    inv = invert_permutation(order_q).long()
    return (nbrs.reshape(-1, k)[:nq][inv], counts.reshape(-1)[:nq][inv],
            over.reshape(-1)[:nq][inv], ovf_t.any() | key_space_overflow)


def ball_query_pair_fast(support, support_batch, support_valid, queries, query_batch,
                         query_valid, radius, max_neighbors: int = 32,
                         bucket_cap: int = 16, tile: int = 256, window: int = 4096):
    """`ball_query_pair` through the windowed form; the bucket form when a
    window or the key space overflowed (one flag read from the device)."""
    nbrs, counts, over, any_ovf = ball_query_pair_windowed(
        support, support_batch, support_valid, queries, query_batch, query_valid, radius,
        max_neighbors=max_neighbors, tile=tile, window=window)
    if bool(any_ovf):
        return ball_query_pair(support, support_batch, support_valid, queries, query_batch,
                               query_valid, radius, max_neighbors=max_neighbors,
                               bucket_cap=bucket_cap)
    return nbrs, counts, over
