"""KPConv segmentation network, inference (seggroup_tpu/models/kpconv.py).

The same network as the JAX module over the same fixed-shape tensors:

  * kernel point dispositions from the reference's repulsive-potential
    optimisation, a numpy copy of the JAX function, so one seed gives the
    same points bit for bit (cached per process);
  * the multiscale pyramid built on the device: per level, radius
    neighbourhoods by the grid-hash ball query (ops.knn), 2x grid pooling
    to voxel barycentres (ops.voxelize and the sorted segment mean), the
    pooling neighbourhoods and the upsample map; the integer arrays equal
    the JAX side's exactly;
  * the conv as influence-weighted neighbour sums per kernel point (a
    batched matmul) and then the (P, Cin, Cout) weight contraction (a
    matmul); rigid and deformable v1 layers, the latter with the fitting
    and repulsive regularisers it returns;
  * TFBatchNorm, the resnet bottleneck blocks (strided ones with the
    max-pooled shortcut) and KPFCNN with the nearest-upsample decoder.

The influence distances are rounded as jitted XLA:CPU rounds them: the
squared distance as the fused chain of ops/fma.py, the square root correctly
rounded, and `1 - sqrt(d2) / extent` as one fused multiply-add with the
float32 reciprocal of the extent (tests/test_torch_kpconv.py pins both).

Inference only: TFBatchNorm's training branch, the deformable v2 and
modulated layers, the neighbour and batch calibration and KPCNN raise or
are absent until KPConv training is ported. Module and parameter names are
the flax ones, so models.convert maps a JAX checkpoint across."""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.minkunet import variance_scaling_init_
from seggroup_tpu_torch.ops.fma import dot_fma, fma32
from seggroup_tpu_torch.ops.knn import ball_query_pair_fast
from seggroup_tpu_torch.ops.segment_ops import segment_mean_sorted
from seggroup_tpu_torch.ops.voxelize import voxelize

__all__ = ["kernel_point_positions", "kpconv_op", "PyramidLevel", "build_pyramid",
           "TFBatchNorm", "KPConvLayer", "ResnetBottleneck", "KPFCNN",
           "SCANNET_ARCHITECTURE"]

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


def _neighbour_offsets(queries, supports, neighbors):
    """(Nq, K, 3) neighbour positions relative to their query; shadow
    neighbours (index Ns) sit at 1e6, out of every kernel point's reach."""
    ns = supports.shape[0]
    sup_pad = torch.cat([supports, supports.new_full((1, 3), 1e6)])
    nbr = torch.clamp(neighbors, max=ns).long()
    return sup_pad[nbr] - queries[:, None, :], nbr


def kernel_sqdist(rel: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """(Nq, K, P) squared distances of neighbours `rel` (Nq, K, 3) to kernel
    points `kp` ((P, 3) shared or (Nq, P, 3) per query), as jitted XLA
    rounds `jnp.sum((rel[:, :, None] - kp) ** 2, -1)`."""
    kp = kp[None, None] if kp.ndim == 2 else kp[:, None]
    d = rel[:, :, None, :] - kp
    return dot_fma(d, d)


def _linear_influence(d2: torch.Tensor, extent: float) -> torch.Tensor:
    """max(0, 1 - sqrt(d2 + 1e-12) / extent) as jitted XLA rounds it: one
    fused multiply-add with the float32 reciprocal of `extent`."""
    s = _sqrt(d2 + 1e-12)
    inv = _recip(s, extent).expand_as(s)
    return torch.clamp(fma32(-s, inv, torch.ones_like(s)), min=0.0)


def _aggregate(infl: torch.Tensor, feats: torch.Tensor, nbr: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """einsum('nkp,nkc->npc') of the influences and the neighbour features
    (shadow rows zero), then the (P, Cin, Cout) contraction."""
    feat_pad = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    g = feat_pad[nbr]  # (Nq, K, Cin)
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
    n0 = points.shape[0]
    caps = level_caps or [max(256, n0 >> i) for i in range(1, num_layers + 1)]
    for layer in range(num_layers):
        r = dl * conv_radius
        nbrs, _, over = ball_query_pair_fast(cur_p, cur_b, cur_v, cur_p, cur_b, cur_v, r,
                                             max_neighbors=nbr_caps[layer],
                                             bucket_cap=bucket_cap)
        over_rates.append((over & cur_v).sum().float()
                          / torch.clamp(cur_v.sum(), min=1).float())
        if layer + 1 < num_layers:
            cap = caps[layer]
            # a division by a constant: a multiplication by its float32 reciprocal
            ic = torch.floor(cur_p * _recip(cur_p, 2 * dl)).to(torch.int32)
            ic = ic - torch.where(cur_v[:, None], ic, 2 ** 30).min(dim=0).values
            vm = voxelize(ic, cur_b, cur_v, cap)
            nxt_p = segment_mean_sorted(cur_p, vm.point2voxel, cap)  # barycentres
            nxt_b = vm.voxel_coords[:, 0]
            nxt_v = vm.voxel_valid
            pools, _, _ = ball_query_pair_fast(cur_p, cur_b, cur_v, nxt_p, nxt_b, nxt_v, r,
                                               max_neighbors=nbr_caps[layer],
                                               bucket_cap=bucket_cap)
            ups = vm.point2voxel
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
# blocks + KPFCNN
# ---------------------------------------------------------------------------


class TFBatchNorm(nn.Module):
    """BatchNorm with the TF decay convention (running = 0.98 * running +
    0.02 * batch), flax names `scale`/`bias` and running `mean`/`var`.
    Inference normalises by the running statistics."""

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
            raise NotImplementedError("KPConv training (batch statistics) is not ported")
        return (x - self.mean) * torch.rsqrt(self.var + self.epsilon) * self.scale + self.bias


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.1 * x)


class KPConvLayer(nn.Module):
    """One rigid or deformable (v1) KPConv: `kernel` (P, Cin, Cout) and,
    deformable, `offset_kernel` (P, Cin, 3P), the rigid KPConv head whose
    output moves each query's kernel points (zero at initialisation, as
    the reference's). Returns (features, regulariser): the fitting plus
    repulsive loss of the deformed points, 0 for a rigid layer."""

    def __init__(self, cin: int, cout: int, num_kernel_points: int = 15,
                 kp_extent: float = 1.0, deformable: bool = False,
                 deformable_v2: bool = False, modulated: bool = False):
        super().__init__()
        if deformable_v2 or modulated:
            raise NotImplementedError("deformable v2 and modulated KPConv are not ported")
        p = num_kernel_points
        self.num_kernel_points = p
        self.kp_extent = kp_extent
        self.deformable = deformable
        self.kernel = nn.Parameter(torch.empty(p, cin, cout))
        if deformable:
            self.offset_kernel = nn.Parameter(torch.zeros(p, cin, 3 * p))

    def forward(self, queries, supports, neighbors, feats, dl: float):
        p = self.num_kernel_points
        base = queries.new_tensor(kernel_point_positions(p)) * (1.5 * self.kp_extent * dl)
        extent = self.kp_extent * dl
        reg = queries.new_zeros(())
        if not self.deformable:
            return kpconv_op(queries, supports, neighbors, feats, base, self.kernel,
                             extent), reg
        off = kpconv_op(queries, supports, neighbors, feats, base, self.offset_kernel, extent)
        kp = base[None] + off.reshape(-1, p, 3) * extent  # (Nq, P, 3)
        # fitting + repulsive regularisers (KPFCNN_model.py:217-296)
        rel, _ = _neighbour_offsets(queries, supports, neighbors)
        d2 = kernel_sqdist(rel, kp)
        fitting = torch.clamp(d2.min(dim=1).values * _recip(d2, extent ** 2), 0, 1).mean()
        dk = kp[:, :, None, :] - kp[:, None, :, :]
        kpd = dot_fma(dk, dk) + torch.eye(p, device=kp.device)[None] * 1e6
        repulsive = (_linear_influence(kpd, extent) ** 2).mean()
        out = kpconv_op(queries, supports, neighbors, feats, kp, self.kernel, extent)
        return out, fitting + repulsive


class ResnetBottleneck(nn.Module):
    """unary(f/2) -> KPConv(f/2) -> unary(2f) + shortcut (reference
    resnetb_block, network_blocks.py:290-338). The strided variant queries
    the coarse level and max-pools the shortcut over the pooling
    neighbourhood (shadow rows -1e30, an empty pool 0)."""

    def __init__(self, cin: int, fdim: int, deformable: bool = False, strided: bool = False):
        super().__init__()
        f = fdim
        self.strided = strided
        self.conv1 = nn.Linear(cin, f // 2, bias=False)
        self.bn1 = TFBatchNorm(f // 2)
        self.kp = KPConvLayer(f // 2, f // 2, deformable=deformable)
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
            ns = feats.shape[0]
            pad = torch.cat([sc, sc.new_full((1, sc.shape[1]), -1e30)])
            pooled = pad[torch.clamp(neighbors, max=ns).long()].amax(dim=1)
            sc = torch.where(pooled <= -1e30, 0.0, pooled)
        if hasattr(self, "shortcut"):
            sc = self.shortcut_bn(self.shortcut(sc), q_valid, train)
        return torch.where(q_valid[:, None], _leaky(x + sc), 0.0), reg


SCANNET_ARCHITECTURE = (
    "simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided",
    "resnetb_deformable", "resnetb_deformable_strided", "resnetb_deformable",
    "resnetb_deformable_strided", "resnetb_deformable",
    "nearest_upsample", "unary", "nearest_upsample", "unary",
    "nearest_upsample", "unary", "nearest_upsample", "unary",
)


class KPFCNN(nn.Module):
    """Segmentation FCNN over a precomputed pyramid (reference
    assemble_FCNN_blocks, network_blocks.py:1018-1148, and KPFCNN_model.py):
    block i of the architecture is `b{i}` (`b{i}_kp`/`b{i}_bn` for
    'simple', `b{i}_unary`/`b{i}_bn` for 'unary'), then `head`, `head_bn`
    and `logits`, as the flax module names them.

    Built on `device`, the card unless the caller asks for the CPU, with
    weights drawn from `seed` as flax's initializers draw them (truncated
    normal over fan-in, zero biases and offset kernels), or loaded from a
    JAX tree through models.convert.kpconv_params_from_flax."""

    def __init__(self, num_classes: int = 20,
                 architecture: Sequence[str] = SCANNET_ARCHITECTURE,
                 first_features_dim: int = 64, dl0: float = 0.04,
                 in_features_dim: int = 4, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.architecture = tuple(architecture)
        self.first_features_dim = first_features_dim
        self.dl0 = dl0
        fdim, cin, skips = first_features_dim, in_features_dim, []
        for i, name in enumerate(self.architecture):
            if name == "simple":
                setattr(self, f"b{i}_kp", KPConvLayer(cin, fdim // 2))
                setattr(self, f"b{i}_bn", TFBatchNorm(fdim // 2))
                cin = fdim // 2
            elif name.startswith("resnetb"):
                if "deformable_v2" in name:
                    raise NotImplementedError("deformable v2 KPConv is not ported")
                strided = "strided" in name
                if strided:
                    skips.append(cin)
                setattr(self, f"b{i}", ResnetBottleneck(cin, fdim, "deformable" in name, strided))
                cin = 2 * fdim
                if strided:
                    fdim *= 2
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
        variance_scaling_init_(self, seed)
        with torch.no_grad():
            self.logits.bias.zero_()
            for mod in self.modules():
                if isinstance(mod, KPConvLayer) and mod.deformable:
                    mod.offset_kernel.zero_()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.logits.weight.device

    def forward(self, pyramid: list[PyramidLevel], in_feats: torch.Tensor,
                train: bool = False, phase_seconds: dict | None = None):
        """(logits (N_0, num_classes), zero on invalid rows; the sum of the
        deformable layers' regularisers). With `phase_seconds`, the wall
        seconds of "encoder" and "decoder" are added to the dict."""
        phase = PhaseClock(self.device, phase_seconds)
        with torch.set_grad_enabled(train):
            with phase("encoder"):
                feats, regs, skips, layer, dl = self._encoder(pyramid, in_feats, train)
            with phase("decoder"):
                logits = self._decoder(pyramid, feats, skips, layer, train)
        return logits, regs

    def _encoder(self, pyramid, feats, train):
        dl, layer = self.dl0, 0
        regs = feats.new_zeros(())
        skips = []
        for i, name in enumerate(self.architecture):
            lvl = pyramid[layer]
            if name == "simple":
                x, reg = getattr(self, f"b{i}_kp")(lvl.points, lvl.points, lvl.neighbors,
                                                   feats, dl)
                feats = _leaky(getattr(self, f"b{i}_bn")(x, lvl.valid, train))
                regs = regs + reg
            elif name.startswith("resnetb"):
                strided = "strided" in name
                if strided:
                    skips.append(feats)
                nxt = pyramid[layer + 1] if strided else None
                feats, reg = getattr(self, f"b{i}")(lvl, nxt, feats, dl, train)
                regs = regs + reg
                if strided:
                    layer += 1
                    dl *= 2
            else:
                break
        return feats, regs, skips, layer, dl

    def _decoder(self, pyramid, feats, skips, layer, train):
        for i, name in enumerate(self.architecture):
            if name == "nearest_upsample":
                # gather the coarse features at each fine row's cell
                layer -= 1
                cap = feats.shape[0]
                pad = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
                up = pad[torch.clamp(pyramid[layer].upsamples, max=cap).long()]
                feats = torch.cat([up, skips.pop()], dim=-1)
            elif name == "unary":
                lvl = pyramid[layer]
                feats = _leaky(getattr(self, f"b{i}_bn")(getattr(self, f"b{i}_unary")(feats),
                                                         lvl.valid, train))
        lvl = pyramid[0]
        head = _leaky(self.head_bn(self.head(feats), lvl.valid, train))
        return torch.where(lvl.valid[:, None], self.logits(head), 0.0)
