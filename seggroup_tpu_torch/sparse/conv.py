"""Gather-GEMM-scatter sparse convolution engine
(seggroup_tpu/sparse/conv.py).

  * Rulebooks: an (M, K) neighbour-row table per kernel, built from sorted
    coordinate keys (sparse/hashing.py); absent neighbours and invalid rows
    hold M. They are exactly the JAX side's.
  * `subm_conv`: out[i] = sum_k W[k]^T feats[nbr[i,k]], bf16 operands by
    default, float32 sums, differentiable as the JAX custom VJP is
    (`_subm_fwd`/`_subm_bwd`): the data gradient is the same conv over the
    SAME rulebook with flipped, transposed weights, and the weight gradient
    dW[k] = sum_i feats[nbr[i,k]] (x) dout[i]. On CUDA tensors the forward
    and the data gradient launch kernel K2 (sparse/cuda_subm_conv.py) and
    the weight gradient kernel K3 (sparse/cuda_subm_dw.py), or raise; on CPU
    tensors they run the plain versions `subm_conv_plain` and
    `subm_dw_plain`.
  * Stride-2 kernel-2 down and up convs partition the fine voxels: down is a
    segment sum over out = in // 2, up one gather. They run in float32 with
    torch ops (and differentiate through them), as the JAX side runs them
    outside any Pallas kernel.

5-column spatio-temporal coords (batch, x, y, z, t) take the explicit
offsets path over `region_offsets(conv_type, k, 4)`, and the stride-2 maps
carry t through unchanged. `global_pool` is the per-scene mean or max.

Pyramid plans (sparse/plan.py on the host, sparse/device_plan.py on the
card) feed the rest: `build_subm_rulebook(assume_sorted=True)` takes rows
already in lexicographic order and skips the sort;
`strided_conv_down_planned` takes a precomputed down map;
`subm_conv(windows=...)` accepts a plan's window layout.

Where the JAX side joins sorted rows by its windowed merge join
(sparse/merge_join.py), the port runs the lower-bound search it runs for
any order, over the identity order. The join finds the same rulebook with
three searches over all keys for nine groups of queries, where the search
takes one for eight, and its overflow flag would cost a host sync a level.
`sparse/merge_join.windowed_join3` ports the join's own outputs; no path
of the port calls it.

The window layout is the JAX package's: there it routes `subm_conv` to its
Pallas kernels, which gather rows through contiguous windows because
random row gathers are slow on the TPU. The port's kernels K2 and K3 gather
straight from the rulebook (csrc/subm_conv.cu), so on the card, as on the
CPU, the windows select nothing: `subm_conv` computes the same function
with or without them. `windows_to_rulebook` decodes a window layout, for
the tests that hold a plan's windows against its rulebooks."""

from __future__ import annotations

import numpy as np
import torch

from seggroup_tpu_torch.ops.segment_ops import (invert_permutation, lexsort, segment_max,
                                                segment_mean, segment_sum)
from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw
from seggroup_tpu_torch.sparse.hashing import (INT32_MAX, lookup, lower_bound,
                                               pack_keys, sort_coords)
from seggroup_tpu_torch.sparse.tensor import SparseTensor


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """(K, 3) integer offsets, centered for odd kernels ({-1,0,1} for 3)."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.int32)


def region_offsets(conv_type: str, kernel_size: int = 3,
                   ndim: int = 3) -> np.ndarray:
    """(K, ndim) kernel-region offsets for the reference's ConvType zoo:
    'hypercube', 'hypercross', 'spatial_hypercube',
    'spatial_hypercube_temporal_hypercross' (and the spatio_temporal_*
    names), sorted lexicographically."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    if conv_type in ("hypercube", "spatio_temporal_hypercube"):
        grids = np.meshgrid(*([r] * ndim), indexing="ij")
        offs = np.stack(grids, -1).reshape(-1, ndim)
    elif conv_type in ("hypercross", "spatio_temporal_hypercross"):
        offs = [np.zeros(ndim, np.int64)]
        for d in range(ndim):
            for s in r[r != 0]:
                o = np.zeros(ndim, np.int64)
                o[d] = s
                offs.append(o)
        offs = np.stack(offs)
    elif conv_type in ("spatial_hypercube", "spatial_hypercube_temporal_hypercross"):
        cube = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        if ndim == 3:
            offs = cube
        else:
            offs = np.concatenate([cube, np.zeros((len(cube), 1), np.int64)], 1)
            if conv_type == "spatial_hypercube_temporal_hypercross":
                t_arm = np.asarray([[0, 0, 0, -1], [0, 0, 0, 1]], np.int64)
                offs = np.concatenate([offs, t_arm], 0)
    else:
        raise ValueError(f"unknown conv_type {conv_type!r}")
    order = np.lexsort(offs.T[::-1])
    return offs[order].astype(np.int32)


_CUBE_TYPES = ("hypercube", "spatial_hypercube", "spatial_hypercube_temporal_hypercross")


def rulebook_volume(kernel_size: int, conv_type: str, ndim: int) -> int:
    """K of the (M, K) rulebook that `build_subm_rulebook` builds for
    (kernel_size, conv_type) over (M, 1 + ndim) coords."""
    if ndim == 3 and conv_type in _CUBE_TYPES:
        return kernel_size ** 3
    return len(region_offsets(conv_type, kernel_size, ndim))


def build_subm_rulebook(st: SparseTensor, kernel_size: int = 3,
                        assume_sorted: bool = False,
                        conv_type: str = "spatial_hypercube",
                        xy_bits: tuple[int, int] = (14, 14)) -> torch.Tensor:
    """(M, K) int32 neighbour row per kernel offset; == M where absent.
    Output sites == input sites (submanifold semantics). On 4-column coords
    kernel 3 takes the grouped z-run search (8 lower bounds for 27
    offsets), other cube kernels the generic per-offset lookup; 5-column
    coords and the cross regions the per-offset lookup over
    `region_offsets(conv_type, kernel_size, 4)` (29 offsets for the hybrid
    region, 81 for the hypercube).

    assume_sorted: the rows are already in lexicographic (batch, x, y, z)
    order with the valid prefix first (the host voxelizer's and the down
    maps' contract), so kernel 3 skips the sort: the searched path over
    the identity order, the rulebook the JAX side's merge join gives."""
    ndim = st.coords.shape[1] - 1
    if ndim == 3 and kernel_size == 3 and conv_type in _CUBE_TYPES:
        return _build_subm_rulebook_k3(st, assume_sorted, xy_bits)
    if ndim == 3 and conv_type in _CUBE_TYPES:
        return build_subm_rulebook_offsets(st, kernel_offsets(kernel_size))
    return build_subm_rulebook_offsets(st, region_offsets(conv_type, kernel_size, ndim))


def _build_subm_rulebook_k3(st: SparseTensor, assume_sorted: bool = False,
                            xy_bits=(14, 14)) -> torch.Tensor:
    m = st.capacity
    dev = st.coords.device
    hi, lo = pack_keys(st.coords, xy_bits)
    if assume_sorted:
        order = torch.arange(m, dtype=torch.int32, device=dev)
        rank = order
        hi_s = torch.where(st.valid, hi, INT32_MAX)
        lo_s = torch.where(st.valid, lo, INT32_MAX)
    else:
        order, hi_s, lo_s = sort_coords(st.coords, st.valid, xy_bits)
        rank = invert_permutation(order)
    big = torch.full((1,), INT32_MAX, dtype=torch.int32, device=dev)
    order_pad = torch.cat([order, torch.full((1,), m, dtype=torch.int32, device=dev)])
    hi_pad = torch.cat([hi_s, big])
    lo_pad = torch.cat([lo_s, big])
    cols = _k3_cols_searched(st, hi, lo, hi_s, lo_s, order_pad, hi_pad, lo_pad,
                             rank, xy_bits)
    return cols.T.contiguous().to(torch.int32)


def _k3_cols_searched(st, hi, lo, hi_s, lo_s, order_pad, hi_pad, lo_pad,
                      rank, xy_bits=(14, 14)):
    """(27, M) columns via the binary-search path (any row order)."""
    m = st.capacity
    x, y, z = st.coords[:, 1], st.coords[:, 2], st.coords[:, 3]

    def resolve(p0, q_hi):
        """Given p0 = lower_bound(q_hi, lo - 1), match dz in {-1, 0, +1}:
        valid keys strictly increase, so the (up to) three hits sit at
        consecutive positions from p0. Returns three (..., M) row tensors."""
        cand = [torch.clamp(p0 + t, 0, m).long() for t in range(3)]
        ch = [hi_pad[c] for c in cand]
        cl = [lo_pad[c] for c in cand]
        cols = []
        for dz in (-1, 0, 1):
            tgt = lo + dz
            row = torch.full(q_hi.shape, m, dtype=torch.int32, device=q_hi.device)
            for t in range(3):
                hit = (ch[t] == q_hi) & (cl[t] == tgt)
                row = torch.where((row == m) & hit, order_pad[cand[t]], row)
            ok = st.valid & (z + dz >= 0)
            cols.append(torch.where(ok, row, m))
        return cols

    cols_by_offset = {}
    # centre (dx, dy) group: positions are self rank -1 / self / +1, no search
    for dz, col in zip((-1, 0, 1), resolve(rank - 1, hi)):
        cols_by_offset[(0, 0, dz)] = col
    # the 8 off-centre (dx, dy) groups, one lower bound each, all at once;
    # the query keys wrap in int32 exactly as on the JAX side
    dxy = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)]
    yb = xy_bits[1]
    shift = torch.tensor([(dx << yb) + dy for dx, dy in dxy], dtype=torch.int32,
                         device=hi.device)
    q_hi = hi[None, :] + shift[:, None]  # (8, M)
    p0 = lower_bound(hi_s, lo_s, q_hi, (lo - 1)[None, :].expand_as(q_hi))
    rows = resolve(p0, q_hi)  # 3 x (8, M)
    for gi, (dx, dy) in enumerate(dxy):
        ok_xy = (x + dx >= 0) & (y + dy >= 0)
        for t, dz in enumerate((-1, 0, 1)):
            cols_by_offset[(dx, dy, dz)] = torch.where(ok_xy, rows[t][gi], m)
    return torch.stack([cols_by_offset[tuple(int(v) for v in o)]
                        for o in kernel_offsets(3)])  # (27, M)


def build_subm_rulebook_offsets(st: SparseTensor, offsets: np.ndarray) -> torch.Tensor:
    """(M, K) rulebook for an explicit (K, ndim) offset list over
    (M, 1 + ndim) coords: one exact lookup per offset."""
    order, hi_s, lo_s = sort_coords(st.coords, st.valid)
    m = st.capacity
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int32, device=st.coords.device)
    cols = []
    for off in offs:
        q = st.coords.clone()
        q[:, 1:] += off[None, :]
        in_range = torch.all(q[:, 1:] >= 0, dim=1)  # negative coords never pack
        q_hi, q_lo = pack_keys(q)
        pos = lookup(hi_s, lo_s, q_hi, q_lo)  # sorted positions or M
        idx = torch.where(pos < m, order[torch.clamp(pos, max=m - 1).long()], m)
        cols.append(torch.where(st.valid & in_range, idx, m))
    return torch.stack(cols, dim=1).to(torch.int32)


# --- submanifold conv --------------------------------------------------------

# rows per gather + matmul tile of the plain version: bounds the transient
# (chunk, K, Cin) block, as the JAX side's lax.map does
SUBM_CHUNK = 16384


def subm_conv_plain(feats: torch.Tensor, weights: torch.Tensor, rulebook: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K2's plain version (`_subm_apply` of the JAX side): feats (M, Cin)
    and weights (K, Cin, Cout) rounded to `compute_dtype`, absent neighbours
    reading a zero pad row M, products summed in float32, SUBM_CHUNK rows at
    a time. Returns (M, Cout) float32."""
    m, cin = feats.shape
    kvol, _, cout = weights.shape
    feats_pad = torch.cat([feats.to(compute_dtype),
                           feats.new_zeros((1, cin), dtype=compute_dtype)])
    w = weights.to(compute_dtype).to(torch.float32).reshape(kvol * cin, cout)
    out = torch.empty((m, cout), dtype=torch.float32, device=feats.device)
    for s in range(0, m, SUBM_CHUNK):
        rb = rulebook[s:s + SUBM_CHUNK].long()
        g = feats_pad[rb].to(torch.float32)  # (chunk, K, Cin)
        out[s:s + SUBM_CHUNK] = g.reshape(len(rb), kvol * cin) @ w
    return out


def subm_dw_plain(feats: torch.Tensor, dout: torch.Tensor, rulebook: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K3's plain version (the weight gradient of `_subm_bwd` on the JAX
    side): dW[k] = sum_i feats[nbr[i,k]] (x) dout[i], both operands rounded
    to `compute_dtype`, absent neighbours reading a zero pad row M, products
    summed in float32 over SUBM_CHUNK rows at a time. Returns (K, Cin, Cout)
    float32."""
    m, cin = feats.shape
    kvol = rulebook.shape[1]
    feats_pad = torch.cat([feats.to(compute_dtype),
                           feats.new_zeros((1, cin), dtype=compute_dtype)])
    do = dout.to(compute_dtype).to(torch.float32)
    dw = torch.zeros((kvol * cin, dout.shape[1]), dtype=torch.float32, device=feats.device)
    for s in range(0, m, SUBM_CHUNK):
        rb = rulebook[s:s + SUBM_CHUNK].long()
        g = feats_pad[rb].to(torch.float32).reshape(len(rb), kvol * cin)
        dw += g.T @ do[s:s + SUBM_CHUNK]
    return dw.reshape(kvol, cin, -1)


def _subm_apply(feats, weights, rulebook, compute_dtype):
    """K2 on the card (bf16 only), the plain version on the CPU."""
    if feats.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise ValueError("the CUDA subm_conv kernels compute in bfloat16 only")
        return cuda_subm_conv.subm_conv_cuda(feats.to(torch.bfloat16),
                                             weights.to(torch.bfloat16), rulebook)
    return subm_conv_plain(feats, weights, rulebook, compute_dtype)


def _subm_dw(feats, dout, rulebook, compute_dtype):
    """K3 on the card (bf16 only), the plain version on the CPU."""
    if feats.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise ValueError("the CUDA subm_conv kernels compute in bfloat16 only")
        return cuda_subm_dw.subm_dw_cuda(feats.to(torch.bfloat16),
                                         dout.to(torch.bfloat16), rulebook)
    return subm_dw_plain(feats, dout, rulebook, compute_dtype)


class SubmConvFunction(torch.autograd.Function):
    """The submanifold conv with the JAX custom VJP's backward. It saves
    (feats, weights, rulebook), as the JAX residuals are; the gathered
    block is recomputed, never stored."""

    @staticmethod
    def forward(ctx, feats, weights, rulebook, compute_dtype):
        ctx.save_for_backward(feats, weights, rulebook)
        ctx.compute_dtype = compute_dtype
        return _subm_apply(feats, weights, rulebook, compute_dtype)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, rulebook = ctx.saved_tensors
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            # nbr[i,k] = j  <=>  nbr[j,K-1-k] = i (the offset set is symmetric
            # for odd kernels): the data gradient is a gather over the same
            # rulebook, not a scatter
            w_t = weights.flip(0).transpose(1, 2)
            dfeats = _subm_apply(dout, w_t, rulebook, ctx.compute_dtype).to(feats.dtype)
        if ctx.needs_input_grad[1]:
            dw = _subm_dw(feats, dout, rulebook, ctx.compute_dtype).to(weights.dtype)
        return dfeats, dw, None, None


# the window layout of the JAX package's Pallas kernels
# (seggroup_tpu/sparse/pallas_conv.py TILE, WINDOW): a plan's windows are
# compared with the JAX plans' bit for bit
TILE = 256
WINDOW = 512


def takes_windows(capacity: int) -> bool:
    """Whether a level of this capacity carries a window plan (the JAX
    side's windowed branch): capacity a multiple of TILE, at least 8 tiles."""
    return capacity % TILE == 0 and capacity >= 8 * TILE


def windows_to_rulebook(rb_win: torch.Tensor, win_base: torch.Tensor, tile: int = TILE,
                        window: int = WINDOW) -> torch.Tensor:
    """The (M, 27) rulebook a window layout encodes (M = rb_win rows / 3):
    row t*tile + i, offset 3g + dz reads win_base[t, g] + rb_win[(t*3 + dz)
    * tile + i, g], absent (M) where that local index is `window`. It equals
    the plan's rulebook where the plan's `use_window` is true (an entry that
    did not fit its window is also `window`)."""
    m = rb_win.shape[0] // 3
    n_tiles = m // tile
    local = rb_win.reshape(n_tiles, 3, tile, 9).permute(0, 2, 3, 1)  # (t, i, g, dz)
    rows = win_base.reshape(n_tiles, 1, 9, 1) + local
    rb = torch.where(local == window, m, rows)
    return rb.reshape(m, 27).to(torch.int32)


def subm_conv(st: SparseTensor, weights: torch.Tensor, rulebook: torch.Tensor,
              compute_dtype: torch.dtype = torch.bfloat16,
              windows: dict | None = None) -> torch.Tensor:
    """weights (K, Cin, Cout); returns (M, Cout) float32, zero on invalid
    rows. out[i] = sum_k W[k]^T feats[nbr[i,k]] over present neighbours.
    Differentiable in the features and the weights (`SubmConvFunction`).

    On the card the kernels K2 and K3 take bf16 operands only; on the CPU
    the plain versions run at `compute_dtype`. `windows`, a plan's
    {"rb_win", "win_base", "use_window"} for this level, is accepted and
    selects nothing: K2 and K3 read the rulebook itself (module
    docstring)."""
    if windows is not None and set(windows) != {"rb_win", "win_base", "use_window"}:
        raise ValueError(f"a window plan holds rb_win, win_base and use_window, got "
                         f"{sorted(windows)}")
    if weights.shape[0] % 2 != 1:
        raise ValueError("subm_conv needs an odd (symmetric) kernel")
    feats = torch.where(st.valid[:, None], st.feats, 0.0)
    out = SubmConvFunction.apply(feats, weights, rulebook, compute_dtype)
    return torch.where(st.valid[:, None], out, 0.0)


# --- stride-2 down / up -----------------------------------------------------


def downsample_coords(st: SparseTensor, cap_out: int):
    """Unique coords // 2 (stride-2 output sites) + the per-input output row
    and kernel index. Returns (coords_out (cap_out, 4), valid_out, num_out,
    out_row (M,), delta (M,)); rows whose output site lies past cap_out get
    out_row == cap_out, and num_out counts every unique site."""
    c = st.coords.to(torch.int32)
    half = torch.cat([c[:, :1], c[:, 1:4] >> 1, c[:, 4:]], dim=1)
    delta = c[:, 1] % 2 * 4 + c[:, 2] % 2 * 2 + c[:, 3] % 2  # in {0..7}

    invalid = (~st.valid).to(torch.int32)
    order = lexsort([half[:, j] for j in range(half.shape[1] - 1, -1, -1)] + [invalid])
    s_half = half[order]
    s_ok = st.valid[order]
    prev_same = torch.all(s_half[1:] == s_half[:-1], dim=1)
    firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=c.device), ~prev_same]) & s_ok
    compact_sorted = torch.cumsum(firsts.to(torch.int32), 0, dtype=torch.int32) - 1
    num_out = torch.sum(firsts.to(torch.int32), dtype=torch.int32)
    row_sorted = torch.where(s_ok & (compact_sorted < cap_out), compact_sorted, cap_out)
    out_row = row_sorted[invert_permutation(order).long()]

    coords_out = segment_sum(torch.where(firsts[:, None], s_half, 0),
                             torch.where(firsts, row_sorted, -1), cap_out).to(torch.int32)
    valid_out = torch.arange(cap_out, device=c.device) < num_out
    return coords_out, valid_out, num_out, out_row.to(torch.int32), delta.to(torch.int32)


def strided_conv_down(st: SparseTensor, weights: torch.Tensor, cap_out: int,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> tuple[SparseTensor, dict]:
    """Kernel-2 stride-2 sparse conv; weights (8, Cin, Cout). Also returns
    the `indice_key` dict the matching inverse conv needs."""
    coords_out, valid_out, num_out, out_row, delta = downsample_coords(st, cap_out)
    return _strided_apply(st, weights, cap_out, coords_out, valid_out, num_out, out_row,
                          delta, compute_dtype)


def _strided_apply(st, weights, cap_out, coords_out, valid_out, num_out, out_row, delta,
                   compute_dtype):
    feats = torch.where(st.valid[:, None], st.feats, 0.0).to(compute_dtype)
    w = weights.to(compute_dtype)
    # contrib[i] = feats[i] @ W[delta_i], one masked matmul per kernel index
    contrib = torch.zeros((st.capacity, weights.shape[2]), dtype=torch.float32,
                          device=feats.device)
    for kk in range(8):
        sel = (delta == kk)[:, None]
        contrib += (torch.where(sel, feats, 0) @ w[kk]).to(torch.float32)
    out = segment_sum(contrib, torch.where(st.valid, out_row, -1), cap_out)
    key = {"out_row": out_row, "delta": delta, "fine_coords": st.coords,
           "fine_valid": st.valid, "fine_num": st.num}
    return SparseTensor(coords_out, out, valid_out, num_out), key


def strided_conv_down_planned(st: SparseTensor, weights: torch.Tensor, down_plan: dict,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> tuple[SparseTensor, dict]:
    """strided_conv_down with a precomputed down map (a plan's
    {"coords", "num", "out_row", "delta"}): no sort or compaction."""
    coords_out = down_plan["coords"]
    num_out = down_plan["num"]
    cap_out = coords_out.shape[0]
    valid_out = torch.arange(cap_out, device=coords_out.device) < num_out
    return _strided_apply(st, weights, cap_out, coords_out, valid_out, num_out,
                          down_plan["out_row"], down_plan["delta"], compute_dtype)


def inverse_conv_up(st_coarse: SparseTensor, weights: torch.Tensor, indice_key: dict,
                    compute_dtype: torch.dtype = torch.float32) -> SparseTensor:
    """Kernel-2 stride-2 transposed conv back to the saved fine sites;
    weights (8, Cin, Cout). Each fine voxel reads exactly one coarse voxel."""
    out_row = indice_key["out_row"]
    delta = indice_key["delta"]
    fine_valid = indice_key["fine_valid"]
    cap_c = st_coarse.capacity
    feats = torch.where(st_coarse.valid[:, None], st_coarse.feats, 0.0)
    feats_pad = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    g = feats_pad[torch.clamp(out_row, max=cap_c).long()].to(compute_dtype)
    w = weights.to(compute_dtype)
    out = torch.zeros((g.shape[0], weights.shape[2]), dtype=torch.float32, device=g.device)
    for kk in range(8):
        sel = (delta == kk)[:, None]
        out += (torch.where(sel, g, 0) @ w[kk]).to(torch.float32)
    out = torch.where((fine_valid & (out_row < cap_c))[:, None], out, 0.0)
    return SparseTensor(indice_key["fine_coords"], out, fine_valid, indice_key["fine_num"])


def global_pool(st: SparseTensor, num_batches: int, mode: str = "mean") -> torch.Tensor:
    """(num_batches, C) per-scene mean or max of the valid rows' features
    (MinkowskiGlobalPooling); an empty scene gives 0."""
    ids = torch.where(st.valid, st.coords[:, 0], num_batches)
    if mode == "mean":
        return segment_mean(st.feats, ids, num_batches)
    return segment_max(st.feats, ids, num_batches)
