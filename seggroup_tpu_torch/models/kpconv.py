"""KPConv networks (seggroup_tpu/models/kpconv.py): KPFCNN segmentation and
KPCNN classification, in inference and in training.

The same networks as the JAX module over the same fixed-shape tensors:

  * kernel point dispositions from the reference's repulsive-potential
    optimisation, a numpy copy of the JAX function, so one seed gives the
    same points bit for bit (cached per process);
  * the multiscale pyramid built on the device: per level, radius
    neighbourhoods by the grid-hash ball query (ops.knn), 2x grid pooling
    to voxel barycentres (ops.voxelize and the sorted segment mean), the
    pooling neighbourhoods and the upsample map; the integer arrays equal
    the JAX side's exactly. `calibrate_neighbor_caps` sets its per-level
    neighbour caps from data, `sample_sphere_sizes` and
    `calibrate_batch_limit` (numpy copies) the point cap;
  * the conv as influence-weighted neighbour sums per kernel point (a
    batched matmul) and then the (P, Cin, Cout) weight contraction (a
    matmul); rigid, deformable v1, deformable v2 and modulated layers, the
    deformable ones with the fitting and repulsive regularisers;
  * TFBatchNorm (batch statistics in training), the resnet bottleneck
    blocks (strided ones with the max-pooled shortcut), KPFCNN with the
    nearest-upsample decoder and KPCNN with the global average and the
    dropout head.

The influence distances are rounded as jitted XLA:CPU rounds them: the
squared distance as the fused chain of ops/fma.py, the square root correctly
rounded, and `1 - sqrt(d2) / extent` as one fused multiply-add with the
float32 reciprocal of the extent (tests/test_torch_kpconv.py pins both).
That rounding is emulated in float64; under autograd the distances and the
influences are autograd Functions whose backward is the plain float32
derivative, so that no float64 temporary is kept for the backward. Ties
take the gradient as jax.grad gives it: a tied min or max reduction splits
it evenly, `max(0, .)` and the clips give half of it to each side.

Module and parameter names are the flax ones, so models.convert maps a JAX
checkpoint across."""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.minkunet import variance_scaling_init_
from seggroup_tpu_torch.ops.fma import dot_fma, fma32
from seggroup_tpu_torch.ops.knn import ball_query_pair, ball_query_pair_fast
from seggroup_tpu_torch.ops.segment_ops import segment_mean, segment_mean_sorted, segment_sum
from seggroup_tpu_torch.ops.voxelize import voxelize

__all__ = ["kernel_point_positions", "kpconv_op", "PyramidLevel", "build_pyramid",
           "calibrate_neighbor_caps", "sample_sphere_sizes", "calibrate_batch_limit",
           "TFBatchNorm", "KPConvLayer", "capture_deformed_kp", "ResnetBottleneck", "KPFCNN",
           "KPCNN", "SCANNET_ARCHITECTURE", "MODELNET_ARCHITECTURE"]

# ---------------------------------------------------------------------------
# kernel point dispositions (numpy, as the JAX package computes them)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def kernel_point_positions(num_points: int = 15, dim: int = 3,
                           num_iters: int = 10000, seed: int = 42,
                           fixed: str = "center",
                           n_restarts: int = 8) -> np.ndarray:
    """Kernel point placement by the reference's repulsive-potential
    optimisation (kernels/kernel_points.py:41-180): `n_restarts` runs from
    seeds seed, seed + 1, ..., the lowest-potential disposition kept.
    'center' pins point 0 at the origin (the ScanNet configuration);
    'verticals' also pins points 1-2 on the z axis; 'none' moves all."""
    best, best_pot = None, np.inf
    for restart in range(n_restarts):
        pts = _optimize_kernel_points(num_points, dim, num_iters, seed + restart, fixed)
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        pot = float((1.0 / d[np.isfinite(d)]).sum() / 2
                    + 5.0 * (np.linalg.norm(pts, axis=1) ** 2).sum())
        if fixed == "verticals" and pts[1, -1] * pts[2, -1] >= 0:
            pot += 1e6  # both z-pinned points on one side
        if pot < best_pot:
            best, best_pot = pts, pot
    return best


def _optimize_kernel_points(num_points: int, dim: int, num_iters: int,
                            seed: int, fixed: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = np.empty((0, dim))
    while len(pts) < num_points:
        cand = rng.uniform(-1, 1, size=(4 * num_points, dim))
        cand = cand[np.sum(cand ** 2, axis=1) < 0.5]
        pts = np.concatenate([pts, cand])
    pts = pts[:num_points].copy()
    if fixed == "center":
        pts[0] = 0.0
    elif fixed == "verticals":
        pts[:3] = 0.0
        pts[1, -1] = 2.0 / 3.0
        pts[2, -1] = -2.0 / 3.0

    lr, decay, clip, thresh = 1e-2, 0.9995, 0.05, 1e-5
    old_norms = np.zeros(num_points)
    for _ in range(num_iters):
        diff = pts[:, None, :] - pts[None, :, :]
        d2 = np.sum(diff ** 2, axis=-1)
        grad = (diff / (d2[..., None] ** 1.5 + 1e-6)).sum(axis=1)
        grad += 10.0 * pts
        if fixed == "verticals":
            grad[1:3, :-1] = 0.0
        norms = np.linalg.norm(grad, axis=-1)
        moving = np.arange(num_points) >= {"center": 1, "verticals": 3}.get(fixed, 0)
        if np.max(np.abs(old_norms[moving] - norms[moving])) < thresh:
            break
        old_norms = norms
        step = np.minimum(lr * norms, clip)
        if fixed in ("center", "verticals"):
            step[0] = 0.0
        pts -= (step[:, None] * grad) / (norms[:, None] + 1e-6)
        lr *= decay
    r = np.linalg.norm(pts, axis=-1)
    pts = pts / np.mean(r[1:])
    return pts.astype(np.float32)


# ---------------------------------------------------------------------------
# the conv op
# ---------------------------------------------------------------------------


def _recip(x: torch.Tensor, c: float) -> torch.Tensor:
    """The float32 reciprocal of the constant `c`, as XLA forms it to divide
    by a constant."""
    return x.new_tensor(1.0) / x.new_tensor(c)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded (torch's float32 CPU kernel
    is not, XLA's is)."""
    return torch.sqrt(x.double()).float()


class _GatherRows(torch.autograd.Function):
    """Rows of `x` below one padding row of value `fill` (index len(x)),
    gathered at `idx`. The backward adds each real row's gradient with
    index_add_ and drops the padding row's: PyTorch's own index backward
    sorts the indices and walks the repeats of each one serially, which
    takes seconds on the card when the padding row stands in for millions
    of empty neighbour slots."""

    @staticmethod
    def forward(ctx, x, idx, fill):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), fill)])[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = g.reshape((flat.shape[0],) + tuple(g.shape[idx.ndim:]))
        real = flat < ctx.rows
        gx = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        return gx.index_add_(0, flat[real], g[real]), None, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """x (N, C) padded with a row of `fill` at index N, gathered at idx
    (any shape, values in [0, N])."""
    return _GatherRows.apply(x, idx.long(), fill)


def _neighbour_offsets(queries, supports, neighbors):
    """(Nq, K, 3) neighbour positions relative to their query; shadow
    neighbours (index Ns) sit at 1e6, out of every kernel point's reach."""
    ns = supports.shape[0]
    sup_pad = torch.cat([supports, supports.new_full((1, 3), 1e6)])
    nbr = torch.clamp(neighbors, max=ns).long()
    return sup_pad[nbr] - queries[:, None, :], nbr


class _KernelSqDist(torch.autograd.Function):
    """Squared distances of neighbours to kernel points: the forward rounded
    as jitted XLA rounds it (ops/fma.py's chain, float64 temporaries that
    are freed at once), the backward the plain float32 derivative, which is
    what jax.grad differentiates. Saves the (Nq, K, 3) and (Nq, P, 3)
    inputs only, not (Nq, K, P, 3) differences."""

    @staticmethod
    def forward(ctx, rel, kp):
        ctx.save_for_backward(rel, kp)
        k = kp[None, None] if kp.ndim == 2 else kp[:, None]
        d = rel[:, :, None, :] - k
        return dot_fma(d, d)

    @staticmethod
    def backward(ctx, g):
        # d2[n,k,p] = |rel[n,k] - kp[n,p]|^2
        rel, kp = ctx.saved_tensors
        kpq = kp if kp.ndim == 3 else kp.expand(rel.shape[0], *kp.shape)
        g_rel = g_kp = None
        if ctx.needs_input_grad[0]:
            g_rel = 2 * (rel * g.sum(2)[..., None] - torch.bmm(g, kpq))
        if ctx.needs_input_grad[1]:
            g_kp = 2 * (kpq * g.sum(1)[..., None] - torch.bmm(g.transpose(1, 2), rel))
            if kp.ndim == 2:
                g_kp = g_kp.sum(0)
        return g_rel, g_kp


def kernel_sqdist(rel: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """(Nq, K, P) squared distances of neighbours `rel` (Nq, K, 3) to kernel
    points `kp` ((P, 3) shared or (Nq, P, 3) per query), as jitted XLA
    rounds `jnp.sum((rel[:, :, None] - kp) ** 2, -1)`."""
    return _KernelSqDist.apply(rel, kp)


def _influence_value(d2: torch.Tensor, extent: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - sqrt(d2 + 1e-12) / extent before the clamp, the root) as jitted
    XLA rounds them: one fused multiply-add with the float32 reciprocal of
    `extent`."""
    s = _sqrt(d2 + 1e-12)
    inv = _recip(s, extent).expand_as(s)
    return fma32(-s, inv, torch.ones_like(s)), s


class _LinearInfluence(torch.autograd.Function):
    """max(0, 1 - sqrt(d2 + 1e-12) / extent). Saves the float32 d2 alone;
    the backward is the float32 derivative -0.5 / (extent * sqrt(d2 +
    1e-12)), and at an exact zero of the influence half the cotangent
    passes, as `jnp.maximum(0, .)` gives half of a tie to each side."""

    @staticmethod
    def forward(ctx, d2, extent):
        ctx.save_for_backward(d2)
        ctx.extent = extent
        return torch.clamp(_influence_value(d2, extent)[0], min=0.0)

    @staticmethod
    def backward(ctx, g):
        (d2,) = ctx.saved_tensors
        y, s = _influence_value(d2, ctx.extent)
        share = torch.where(y > 0, 1.0, torch.where(y == 0, 0.5, 0.0))
        return -(g * share) / ctx.extent * (0.5 / s), None


def _linear_influence(d2: torch.Tensor, extent: float) -> torch.Tensor:
    """max(0, 1 - sqrt(d2 + 1e-12) / extent) as jitted XLA rounds it."""
    return _LinearInfluence.apply(d2, extent)


def _aggregate(infl: torch.Tensor, feats: torch.Tensor, nbr: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """einsum('nkp,nkc->npc') of the influences and the neighbour features
    (shadow rows zero), then the (P, Cin, Cout) contraction."""
    g = gather_rows(feats, nbr)  # (Nq, K, Cin), shadow rows zero
    weighted = torch.bmm(infl.transpose(1, 2), g)  # (Nq, P, Cin)
    return weighted.reshape(weighted.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])


def kpconv_op(queries: torch.Tensor, supports: torch.Tensor, neighbors: torch.Tensor,
              feats: torch.Tensor, kernel_pts: torch.Tensor, weights: torch.Tensor,
              extent: float) -> torch.Tensor:
    """KPConv with linear influence and sum aggregation (reference
    convolution_ops.py:161-249): queries (Nq, 3), supports (Ns, 3),
    neighbors (Nq, K) into supports (Ns = shadow), feats (Ns, Cin),
    kernel_pts already scaled, (P, 3) shared (rigid) or (Nq, P, 3) per
    query (deformable, the JAX side's `_deformable_apply`), weights
    (P, Cin, Cout) -> (Nq, Cout)."""
    rel, nbr = _neighbour_offsets(queries, supports, neighbors)
    infl = _linear_influence(kernel_sqdist(rel, kernel_pts), extent)
    return _aggregate(infl, feats, nbr, weights)


# ---------------------------------------------------------------------------
# device-side multiscale pyramid
# ---------------------------------------------------------------------------


class PyramidLevel(NamedTuple):
    points: torch.Tensor     # (N_l, 3)
    batch: torch.Tensor      # (N_l,)
    valid: torch.Tensor      # (N_l,)
    neighbors: torch.Tensor  # (N_l, K) within-level, N_l = shadow
    pools: torch.Tensor      # (N_{l+1}, K) coarse query -> fine support (last level: (1, K) zeros)
    upsamples: torch.Tensor  # (N_l,) fine row -> its coarse cell row (last level: zeros)


def _pool(points, batch, valid, dl: float, cap: int):
    """2x grid pooling: the barycentres of the occupied cells of size 2 *
    dl, at most `cap` rows. Returns (points, batch, valid, fine -> coarse
    row)."""
    # a division by a constant: a multiplication by its float32 reciprocal
    ic = torch.floor(points * _recip(points, 2 * dl)).to(torch.int32)
    ic = ic - torch.where(valid[:, None], ic, 2 ** 30).min(dim=0).values
    vm = voxelize(ic, batch, valid, cap)
    return (segment_mean_sorted(points, vm.point2voxel, cap), vm.voxel_coords[:, 0],
            vm.voxel_valid, vm.point2voxel)


def _level_caps(n0: int, num_layers: int, level_caps: Sequence[int] | None) -> list[int]:
    return list(level_caps or [max(256, n0 >> i) for i in range(1, num_layers + 1)])


def build_pyramid(points: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                  num_layers: int, dl0: float, conv_radius: float = 2.5,
                  neighbor_cap: int | Sequence[int] = 32,
                  level_caps: Sequence[int] | None = None, bucket_cap: int = 16,
                  return_overflow: bool = False):
    """Per layer: within-level radius neighbourhoods (radius dl *
    conv_radius), 2x grid pooling to the barycentres of the occupied cells
    of size 2 * dl (at most level_caps[l] rows), the pooling neighbourhoods
    of the coarse points among the fine ones, and the fine -> coarse map.
    `neighbor_cap` is one cap or one per layer. With `return_overflow`,
    returns (levels, rates): per level the share of valid queries whose
    ball held more than its cap (a () tensor each)."""
    if isinstance(neighbor_cap, int):
        nbr_caps = [neighbor_cap] * num_layers
    else:
        nbr_caps = list(neighbor_cap)
        if len(nbr_caps) != num_layers:
            raise ValueError(f"{len(nbr_caps)} neighbour caps for {num_layers} layers")
    levels, over_rates = [], []
    cur_p, cur_b, cur_v = points, batch, valid
    dl = dl0
    caps = _level_caps(points.shape[0], num_layers, level_caps)
    for layer in range(num_layers):
        r = dl * conv_radius
        nbrs, _, over = ball_query_pair_fast(cur_p, cur_b, cur_v, cur_p, cur_b, cur_v, r,
                                             max_neighbors=nbr_caps[layer],
                                             bucket_cap=bucket_cap)
        over_rates.append((over & cur_v).sum().float()
                          / torch.clamp(cur_v.sum(), min=1).float())
        if layer + 1 < num_layers:
            nxt_p, nxt_b, nxt_v, ups = _pool(cur_p, cur_b, cur_v, dl, caps[layer])
            pools, _, _ = ball_query_pair_fast(cur_p, cur_b, cur_v, nxt_p, nxt_b, nxt_v, r,
                                               max_neighbors=nbr_caps[layer],
                                               bucket_cap=bucket_cap)
        else:
            pools = torch.zeros((1, nbr_caps[layer]), dtype=torch.int32, device=points.device)
            ups = torch.zeros((cur_p.shape[0],), dtype=torch.int32, device=points.device)
        levels.append(PyramidLevel(cur_p, cur_b, cur_v, nbrs, pools, ups))
        if layer + 1 < num_layers:
            cur_p, cur_b, cur_v = nxt_p, nxt_b, nxt_v
            dl *= 2
    if return_overflow:
        return levels, over_rates
    return levels


# ---------------------------------------------------------------------------
# calibration of the neighbour caps and the batch limit (numpy on the host
# but for the probe, which runs the pyramid's ops on `device`)
# ---------------------------------------------------------------------------


def calibrate_neighbor_caps(sample_batches, num_layers: int, dl0: float,
                            conv_radius: float = 2.5, keep_ratio: float = 0.8,
                            probe_cap: int = 192, probe_bucket: int = 64,
                            level_caps: Sequence[int] | None = None,
                            device: str | torch.device = "cuda"
                            ) -> tuple[list[int], list[float]]:
    """Per-level neighbour caps from data (the reference's
    calibrate_neighbors, common.py:551-656): probe the batches with
    generous caps (`ball_query_pair` at `probe_cap` neighbours and
    `probe_bucket` rows a cell), take the `keep_ratio` quantile of the true
    neighbourhood sizes per level, rounded up to a multiple of 8, at most
    `probe_cap`. Returns (caps, overflow rate at the probe caps); a
    nonzero rate means even the probe truncated and the quantile is a lower
    bound, which a saturated cap also warns.

    sample_batches: iterable of (points (N, 3), batch ids (N,), valid (N,))
    numpy arrays."""
    dev = resolve_device(device)
    all_counts = [[] for _ in range(num_layers)]
    over_n = np.zeros(num_layers)
    over_d = np.zeros(num_layers)
    for pts, bids, valid in sample_batches:
        cur_p = torch.from_numpy(np.asarray(pts, np.float32)).to(dev)
        cur_b = torch.from_numpy(np.asarray(bids, np.int32)).to(dev)
        cur_v = torch.from_numpy(np.asarray(valid, bool)).to(dev)
        caps = _level_caps(cur_p.shape[0], num_layers, level_caps)
        dl = dl0
        for lv in range(num_layers):
            _, cnt, over = ball_query_pair(cur_p, cur_b, cur_v, cur_p, cur_b, cur_v,
                                           dl * conv_radius, max_neighbors=probe_cap,
                                           bucket_cap=probe_bucket)
            c = torch.where(cur_v, cnt, -1).cpu().numpy()
            all_counts[lv].append(c[c >= 0])
            over_n[lv] += int((over & cur_v).sum())
            over_d[lv] += max((c >= 0).sum(), 1)
            if lv + 1 < num_layers:
                cur_p, cur_b, cur_v, _ = _pool(cur_p, cur_b, cur_v, dl, caps[lv])
                dl *= 2
    caps_out, over_rate = [], []
    for lv in range(num_layers):
        c = np.concatenate(all_counts[lv]) if all_counts[lv] else np.array([1])
        q = int(np.quantile(c, keep_ratio)) if len(c) else 8
        caps_out.append(int(min(max(8, -(-q // 8) * 8), probe_cap)))
        over_rate.append(float(over_n[lv] / max(over_d[lv], 1)))
        if caps_out[-1] >= probe_cap:
            warnings.warn(
                f"calibrate_neighbor_caps: level {lv} quantile saturated at "
                f"probe_cap={probe_cap} (overflow rate "
                f"{over_rate[-1]:.3f}); the calibrated cap is a LOWER bound "
                f"— re-run with a larger probe_cap for dense scans",
                stacklevel=2)
    return caps_out, over_rate


def sample_sphere_sizes(clouds, in_radius: float, samples_per_cloud: int = 30,
                        rng=None) -> np.ndarray:
    """Sorted point counts of in_radius spheres (the reference's batch
    calibration statistics, common.py:497-512): per cloud
    `samples_per_cloud` random points as centres, jittered by in_radius / 4,
    each ball counted by brute force in chunks of 2^17 points."""
    rng = rng or np.random.default_rng(0)
    sizes = []
    r2 = in_radius * in_radius
    for pts in clouds:
        pts = np.asarray(pts, np.float32)
        n = len(pts)
        take = min(samples_per_cloud, n)
        centers = pts[rng.choice(n, size=take, replace=False)]
        centers = centers + rng.normal(
            scale=in_radius / 4, size=centers.shape).astype(np.float32)
        for c in centers:
            cnt = 0
            for lo in range(0, n, 1 << 17):
                d2 = ((pts[lo:lo + (1 << 17)] - c) ** 2).sum(1)
                cnt += int((d2 < r2).sum())
            sizes.append(cnt)
    return np.sort(np.asarray(sizes))


def calibrate_batch_limit(sphere_sizes, batch_num: int, rng=None,
                          iters: int = 10000, gain: float = 10.0,
                          round_to: int = 1024) -> tuple[float, int]:
    """The batch limit at which greedily packing random spheres until the
    running sum crosses it gives about `batch_num` spheres a batch (the
    reference's calibrate_batches, common.py:487-549: a proportional
    corrector over sampled sphere sizes, deterministic under `rng`).
    Returns (limit, point cap), the cap the limit rounded up to
    `round_to`."""
    sizes = np.sort(np.asarray(sphere_sizes, np.float64))
    if sizes.size == 0:
        raise ValueError("calibrate_batch_limit: no sphere sizes sampled")
    rng = rng or np.random.default_rng(0)
    lim = float(sizes[-1]) * batch_num
    # the most spheres that could fit under lim, smallest first
    max_b = int(np.searchsorted(np.cumsum(sizes), lim, side="right"))
    max_b = max(max_b, 1)
    estim = 0.0
    for i in range(iters):
        pick = rng.choice(sizes, size=min(max_b, sizes.size), replace=False)
        fit = int(np.sum(np.cumsum(pick) < lim))
        estim += (fit - estim) / min(i + 1, 100)
        lim += gain * (batch_num - estim)
    lim = max(lim, float(sizes[-1]))
    point_cap = int(-(-int(lim) // round_to) * round_to)
    return lim, point_cap


# ---------------------------------------------------------------------------
# blocks + KPFCNN, KPCNN
# ---------------------------------------------------------------------------


class TFBatchNorm(nn.Module):
    """BatchNorm with the TF decay convention (running = 0.98 * running +
    0.02 * batch), flax names `scale`/`bias` and running `mean`/`var`.
    Training normalises by the mean and the biased variance of the valid
    rows (two passes) and moves the running statistics on every forward;
    inference normalises by the running statistics."""

    def __init__(self, c: int, momentum: float = 0.98, epsilon: float = 1e-6):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, valid: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            m = valid.to(x.dtype)[:, None]
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(0) / cnt
            var = (torch.square(x - mean) * m).sum(0) / cnt
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale + self.bias


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.1 * x)


class KPConvLayer(nn.Module):
    """One rigid or deformable KPConv, `kernel` (P, Cin, Cout). Returns
    (features, regulariser): the fitting plus repulsive loss of the
    deformed kernel points (KPFCNN_model.py:217-296), 0 for a rigid layer.

    deformable:    v1, `offset_kernel` (P, Cin, 3P), a rigid KPConv head
                   whose output moves each query's kernel points
                   (convolution_ops.py:252-502).
    deformable_v2: `offset_mlp`, a Linear on the query features (for a
                   strided layer read at the nearest support row,
                   `neighbors[:, 0]`), 3 (P - 1) offsets with the centre
                   point's fixed at 0 (convolution_ops.py:503-626).
    modulated:     v2 only; the MLP also gives P - 1 modulations 2 *
                   sigmoid(.), the centre's 0, which scale the influences.
    Offset weights are zero at initialisation, as the reference's. Inside
    `capture_deformed_kp` the deformed points are recorded."""

    def __init__(self, cin: int, cout: int, num_kernel_points: int = 15,
                 kp_extent: float = 1.0, deformable: bool = False,
                 deformable_v2: bool = False, modulated: bool = False):
        super().__init__()
        p = num_kernel_points
        self.num_kernel_points = p
        self.kp_extent = kp_extent
        self.deformable = deformable and not deformable_v2
        self.deformable_v2 = deformable_v2
        self.modulated = modulated and deformable_v2
        self.kernel = nn.Parameter(torch.empty(p, cin, cout))
        if self.deformable:
            self.offset_kernel = nn.Parameter(torch.zeros(p, cin, 3 * p))
        if deformable_v2:
            self.offset_mlp = nn.Linear(cin, (3 + int(self.modulated)) * (p - 1))
        self.capture: dict | None = None
        self.capture_name = ""

    def _kernel_points(self, queries, supports, neighbors, feats, base, extent):
        """(Nq, P, 3) deformed kernel points and (Nq, P) modulations or None."""
        p = self.num_kernel_points
        if self.deformable:
            off = kpconv_op(queries, supports, neighbors, feats, base, self.offset_kernel,
                            extent)
            return base[None] + off.reshape(-1, p, 3) * extent, None
        if queries.shape[0] == supports.shape[0]:
            qfeats = feats
        else:  # strided: the nearest support row carries the query feature
            qfeats = gather_rows(feats, torch.clamp(neighbors[:, 0], max=supports.shape[0]))
        f0 = self.offset_mlp(qfeats)
        off = f0[:, : 3 * (p - 1)].reshape(-1, p - 1, 3)
        off = torch.cat([torch.zeros_like(off[:, :1]), off], dim=1) * extent
        mods = None
        if self.modulated:
            mods = 2.0 * torch.sigmoid(f0[:, 3 * (p - 1):])
            mods = torch.cat([torch.zeros_like(mods[:, :1]), mods], dim=1)
        return base[None] + off, mods

    def forward(self, queries, supports, neighbors, feats, dl: float):
        p = self.num_kernel_points
        base = queries.new_tensor(kernel_point_positions(p)) * (1.5 * self.kp_extent * dl)
        extent = self.kp_extent * dl
        if not (self.deformable or self.deformable_v2):
            return (kpconv_op(queries, supports, neighbors, feats, base, self.kernel, extent),
                    queries.new_zeros(()))
        kp, mods = self._kernel_points(queries, supports, neighbors, feats, base, extent)
        if self.capture is not None:
            self.capture[self.capture_name] = kp.detach()
        # fitting + repulsive regularisers (KPFCNN_model.py:217-296)
        rel, nbr = _neighbour_offsets(queries, supports, neighbors)
        d2 = kernel_sqdist(rel, kp)
        # amin splits a tied minimum's gradient evenly, as jnp.min does;
        # maximum/minimum give half of a tie to each side, as jnp.clip does
        fit = d2.amin(dim=1) * _recip(d2, extent ** 2)
        fitting = torch.minimum(torch.maximum(fit, fit.new_zeros(())), fit.new_ones(())).mean()
        kpd = kernel_sqdist(kp, kp) + torch.eye(p, device=kp.device)[None] * 1e6
        repulsive = (_linear_influence(kpd, extent) ** 2).mean()
        infl = _linear_influence(d2, extent)
        if mods is not None:
            infl = infl * mods[:, None, :]
        return _aggregate(infl, feats, nbr, self.kernel), fitting + repulsive


@contextmanager
def capture_deformed_kp(model: nn.Module):
    """Inside the block, every deformable layer of `model` records its
    (Nq, P, 3) deformed kernel points of the last forward in the yielded
    dict, under the flax path of the JAX side's `sow` ('b5/kp/deformed_kp')."""
    out: dict = {}
    layers = [(name, m) for name, m in model.named_modules()
              if isinstance(m, KPConvLayer) and (m.deformable or m.deformable_v2)]
    for name, m in layers:
        m.capture, m.capture_name = out, name.replace(".", "/") + "/deformed_kp"
    try:
        yield out
    finally:
        for _, m in layers:
            m.capture = None


class ResnetBottleneck(nn.Module):
    """unary(f/2) -> KPConv(f/2) -> unary(2f) + shortcut (reference
    resnetb_block, network_blocks.py:290-338). The strided variant queries
    the coarse level and max-pools the shortcut over the pooling
    neighbourhood (shadow rows -1e30, an empty pool 0)."""

    def __init__(self, cin: int, fdim: int, deformable: bool = False, strided: bool = False,
                 deformable_v2: bool = False, modulated: bool = False):
        super().__init__()
        f = fdim
        self.strided = strided
        self.conv1 = nn.Linear(cin, f // 2, bias=False)
        self.bn1 = TFBatchNorm(f // 2)
        self.kp = KPConvLayer(f // 2, f // 2, deformable=deformable,
                              deformable_v2=deformable_v2, modulated=modulated)
        self.bn2 = TFBatchNorm(f // 2)
        self.conv3 = nn.Linear(f // 2, 2 * f, bias=False)
        self.bn3 = TFBatchNorm(2 * f)
        if cin != 2 * f:
            self.shortcut = nn.Linear(cin, 2 * f, bias=False)
            self.shortcut_bn = TFBatchNorm(2 * f)

    def forward(self, lvl: PyramidLevel, nxt: PyramidLevel | None, feats, dl: float,
                train: bool):
        if self.strided:
            queries, q_valid, neighbors = nxt.points, nxt.valid, lvl.pools
        else:
            queries, q_valid, neighbors = lvl.points, lvl.valid, lvl.neighbors
        x = _leaky(self.bn1(self.conv1(feats), lvl.valid, train))
        x, reg = self.kp(queries, lvl.points, neighbors, x, dl)
        x = _leaky(self.bn2(x, q_valid, train))
        x = self.bn3(self.conv3(x), q_valid, train)
        sc = feats
        if self.strided:
            sc = _max_pool(sc, neighbors)
        if hasattr(self, "shortcut"):
            sc = self.shortcut_bn(self.shortcut(sc), q_valid, train)
        return torch.where(q_valid[:, None], _leaky(x + sc), 0.0), reg


def _max_pool(feats: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """Max over each query's neighbours (shadow rows -1e30, an empty pool
    0); amax splits a tied maximum's gradient evenly, as jnp.max does."""
    pooled = gather_rows(feats, torch.clamp(neighbors, max=feats.shape[0]), -1e30).amax(dim=1)
    return torch.where(pooled <= -1e30, 0.0, pooled)


SCANNET_ARCHITECTURE = (
    "simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided",
    "resnetb_deformable", "resnetb_deformable_strided", "resnetb_deformable",
    "resnetb_deformable_strided", "resnetb_deformable",
    "nearest_upsample", "unary", "nearest_upsample", "unary",
    "nearest_upsample", "unary", "nearest_upsample", "unary",
)

MODELNET_ARCHITECTURE = (
    "simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided",
    "resnetb_deformable", "resnetb_deformable_strided", "resnetb_deformable",
    "resnetb_deformable_strided", "resnetb_deformable", "global_average",
)


class _KPEncoder(nn.Module):
    """The encoder blocks shared by KPFCNN and KPCNN: block i of the
    architecture is `b{i}` ('resnetb*'), or `b{i}_kp`/`b{i}_bn` ('simple'),
    as the flax modules name them; 'max_pool' has no weights. A
    'deformable_v2' block is modulated when `modulated` is set."""

    def _add_encoder_block(self, i: int, name: str, cin: int, fdim: int,
                           modulated: bool) -> tuple[int, int]:
        """Registers block i; returns (channels, fdim) after it."""
        if name == "simple":
            setattr(self, f"b{i}_kp", KPConvLayer(cin, fdim // 2))
            setattr(self, f"b{i}_bn", TFBatchNorm(fdim // 2))
            return fdim // 2, fdim
        if name == "max_pool":
            return cin, 2 * fdim
        v2 = "deformable_v2" in name
        strided = "strided" in name
        setattr(self, f"b{i}", ResnetBottleneck(cin, fdim, "deformable" in name and not v2,
                                                strided, deformable_v2=v2,
                                                modulated=v2 and modulated))
        return 2 * fdim, 2 * fdim if strided else fdim

    def _init_weights(self, seed: int, device: torch.device) -> None:
        """flax's initializers from `seed`: truncated normal over fan-in,
        zero biases and offset weights; then onto `device`."""
        variance_scaling_init_(self, seed)
        with torch.no_grad():
            for name, w in self.named_parameters():
                if name.endswith(".bias") or "offset_" in name:
                    w.zero_()
        self.to(device)

    def _encoder_block(self, i: int, name: str, pyramid, layer: int, feats, dl: float,
                       train: bool):
        """Runs block i; returns (features, regulariser, layer, dl) after it."""
        lvl = pyramid[layer]
        if name == "simple":
            x, reg = getattr(self, f"b{i}_kp")(lvl.points, lvl.points, lvl.neighbors, feats, dl)
            return _leaky(getattr(self, f"b{i}_bn")(x, lvl.valid, train)), reg, layer, dl
        if name == "max_pool":  # max_pool_block, network_blocks.py:824-831
            return _max_pool(feats, lvl.pools), feats.new_zeros(()), layer + 1, dl * 2
        strided = "strided" in name
        nxt = pyramid[layer + 1] if strided else None
        feats, reg = getattr(self, f"b{i}")(lvl, nxt, feats, dl, train)
        return feats, reg, layer + int(strided), dl * 2 if strided else dl

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


class KPFCNN(_KPEncoder):
    """Segmentation FCNN over a precomputed pyramid (reference
    assemble_FCNN_blocks, network_blocks.py:1018-1148, and KPFCNN_model.py):
    the encoder blocks, then `b{i}_unary`/`b{i}_bn` for 'unary', then
    `head`, `head_bn` and `logits`, as the flax module names them.

    Built on `device`, the card unless the caller asks for the CPU, with
    weights drawn from `seed` as flax's initializers draw them (truncated
    normal over fan-in, zero biases and offset weights), or loaded from a
    JAX tree through models.convert.kpconv_params_from_flax."""

    def __init__(self, num_classes: int = 20,
                 architecture: Sequence[str] = SCANNET_ARCHITECTURE,
                 first_features_dim: int = 64, dl0: float = 0.04,
                 in_features_dim: int = 4, modulated: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.architecture = tuple(architecture)
        self.first_features_dim = first_features_dim
        self.dl0 = dl0
        fdim, cin, skips = first_features_dim, in_features_dim, []
        for i, name in enumerate(self.architecture):
            if name == "simple" or name.startswith("resnetb"):
                if "strided" in name:
                    skips.append(cin)
                cin, fdim = self._add_encoder_block(i, name, cin, fdim, modulated)
            elif name == "nearest_upsample":
                fdim //= 2
                cin += skips.pop()
            elif name == "unary":
                setattr(self, f"b{i}_unary", nn.Linear(cin, fdim, bias=False))
                setattr(self, f"b{i}_bn", TFBatchNorm(fdim))
                cin = fdim
            else:
                raise ValueError(name)
        self.head = nn.Linear(cin, first_features_dim, bias=False)
        self.head_bn = TFBatchNorm(first_features_dim)
        self.logits = nn.Linear(first_features_dim, num_classes)
        self._init_weights(seed, dev)

    def forward(self, pyramid: list[PyramidLevel], in_feats: torch.Tensor,
                train: bool = False, phase_seconds: dict | None = None):
        """(logits (N_0, num_classes), zero on invalid rows; the sum of the
        deformable layers' regularisers). `train` normalises by the batch
        statistics, moves the running ones and records the autograd graph.
        With `phase_seconds`, the wall seconds of "encoder" and "decoder"
        are added to the dict."""
        phase = PhaseClock(self.device, phase_seconds)
        with torch.set_grad_enabled(train or torch.is_grad_enabled()):
            with phase("encoder"):
                feats, regs, skips, layer = self._encoder(pyramid, in_feats, train)
            with phase("decoder"):
                logits = self._decoder(pyramid, feats, skips, layer, train)
        return logits, regs

    def _encoder(self, pyramid, feats, train):
        dl, layer = self.dl0, 0
        regs = feats.new_zeros(())
        skips = []
        for i, name in enumerate(self.architecture):
            if not (name == "simple" or name.startswith("resnetb")):
                break
            if "strided" in name:
                skips.append(feats)
            feats, reg, layer, dl = self._encoder_block(i, name, pyramid, layer, feats, dl,
                                                        train)
            regs = regs + reg
        return feats, regs, skips, layer

    def _decoder(self, pyramid, feats, skips, layer, train):
        for i, name in enumerate(self.architecture):
            if name == "nearest_upsample":
                # gather the coarse features at each fine row's cell
                layer -= 1
                up = gather_rows(feats, torch.clamp(pyramid[layer].upsamples,
                                                    max=feats.shape[0]))
                feats = torch.cat([up, skips.pop()], dim=-1)
            elif name == "unary":
                lvl = pyramid[layer]
                feats = _leaky(getattr(self, f"b{i}_bn")(getattr(self, f"b{i}_unary")(feats),
                                                         lvl.valid, train))
        lvl = pyramid[0]
        head = _leaky(self.head_bn(self.head(feats), lvl.valid, train))
        return torch.where(lvl.valid[:, None], self.logits(head), 0.0)


class KPCNN(_KPEncoder):
    """Classification CNN over KPConv blocks (reference models/KPCNN_model.py
    and classification_head, network_blocks.py:1018-1084, 1151-1174): the
    encoder blocks, a masked 'global_average' over each of `num_batches`
    batch elements, then `fc` (1024) -> `fc_bn` over the present elements
    -> dropout 0.5 -> `softmax` (the logits), as the flax module names
    them. Built and initialised as KPFCNN is (kpcnn_params_from_flax maps
    a JAX tree across).

    In training, dropout keeps a unit where `dropout_keep` holds, or else
    where a uniform draw from `generator` (on the device) falls below 0.5,
    and doubles the kept ones, as flax's Dropout does."""

    rate = 0.5

    def __init__(self, num_classes: int = 40,
                 architecture: Sequence[str] = MODELNET_ARCHITECTURE,
                 first_features_dim: int = 64, dl0: float = 0.04, num_batches: int = 8,
                 in_features_dim: int = 1, modulated: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.architecture = tuple(architecture)
        self.dl0 = dl0
        self.num_batches = num_batches
        if self.architecture[-1:] != ("global_average",):
            raise ValueError("the architecture must end in global_average")
        fdim, cin = first_features_dim, in_features_dim
        for i, name in enumerate(self.architecture[:-1]):
            if not (name in ("simple", "max_pool") or name.startswith("resnetb")):
                raise ValueError(name)
            cin, fdim = self._add_encoder_block(i, name, cin, fdim, modulated)
        self.fc = nn.Linear(cin, 1024, bias=False)
        self.fc_bn = TFBatchNorm(1024)
        self.softmax = nn.Linear(1024, num_classes)
        self._init_weights(seed, dev)

    def forward(self, pyramid: list[PyramidLevel], in_feats: torch.Tensor,
                train: bool = False, dropout_keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """(logits (num_batches, num_classes), zero for absent batch
        elements; the sum of the deformable layers' regularisers)."""
        with torch.set_grad_enabled(train or torch.is_grad_enabled()):
            dl, layer = self.dl0, 0
            feats, regs = in_feats, in_feats.new_zeros(())
            for i, name in enumerate(self.architecture[:-1]):
                feats, reg, layer, dl = self._encoder_block(i, name, pyramid, layer, feats, dl,
                                                            train)
                regs = regs + reg
            lvl, b = pyramid[layer], self.num_batches
            b_ids = torch.where(lvl.valid, lvl.batch, b)
            pooled = segment_mean(feats, b_ids, b)  # global_average_block, network_blocks.py:835-860
            batch_valid = segment_sum(lvl.valid.to(torch.int32), b_ids, b + 1)[:b] > 0
            h = _leaky(self.fc_bn(self.fc(pooled), batch_valid, train))
            if train:
                keep_prob = 1.0 - self.rate
                if dropout_keep is None:
                    dropout_keep = torch.rand(h.shape, generator=generator,
                                              device=h.device) < keep_prob
                h = torch.where(dropout_keep, h / keep_prob, 0.0)
            return torch.where(batch_valid[:, None], self.softmax(h), 0.0), regs
