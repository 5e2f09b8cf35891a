"""MinkowskiNet U-Nets on the sparse engine (seggroup_tpu/models/minkunet.py):
the Res16UNet family (`MinkUNet`, `VARIANTS`, the 4-D `ST_VARIANTS`), the
legacy `ResUNet` family (`RESUNET_VARIANTS`, `ST_RESUNET_VARIANTS`) and
`MinkUNetHyper` (`HYPER_VARIANTS`).

The same forwards as the flax modules with `plan=None`: fixed voxel
capacities per pyramid level, submanifold convs (kernel K2 on the card),
kernel-2 stride-2 down/up convs that reuse the saved fine-level sites,
rulebooks built once per level and reused by the decoder. Module and
attribute names are the flax names, so `models.convert.
minkunet_params_from_flax` reads every tree straight across.

Norms (`norm_type`, the reference NormType): 'batch' is `SparseBatchNorm`
(running statistics, momentum `bn_momentum` in the torch convention),
'instance' is `SparseInstanceNorm` (per scene and channel, named
`{name}_in`), 'instance_batch' the instance norm then the batch norm.

Coordinates are (M, 1 + ndim): ndim 3 for (batch, x, y, z), 4 for (batch,
x, y, z, t), the frame index t in [0, 512). The stem, the strided convs
and the pooling transposes span space only; the blocks' kernel region is
`block_conv_type` ('spatial_hypercube_temporal_hypercross', K = 29 on 4-D
coords, the default; 'hypercube', K = 81, for the Tesseract variants; both
the 27-cube on 3-D coords). The ST variants are built for ndim 4.

With `train=True` BatchNorm normalises by the batch statistics of the valid
voxels and updates its running statistics; with `train=False` it runs on
the running statistics. The forward records the autograd graph unless the
caller turns it off (`torch.no_grad()`, as the inference drivers do).

`MinkUNet` takes a pyramid plan (`plan=`, sparse/plan.py on the host or
sparse/device_plan.py on the card, 3-D coords): the levels' rulebooks and
down maps come from it instead of being built, and the logits are those
of `plan=None`. Its window layouts, where it has them, select nothing on
the port (sparse/conv.py) and are not read."""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.ops.segment_ops import segment_sum
from seggroup_tpu_torch.sparse.conv import (build_subm_rulebook, inverse_conv_up,
                                            rulebook_volume, strided_conv_down,
                                            strided_conv_down_planned, subm_conv)
from seggroup_tpu_torch.sparse.tensor import SparseTensor

INIT_DIM = 32  # the stem's width (Res16UNetBase INIT_DIM)
BN_MOMENTUM = 0.02  # MinkUNet's weight of the batch in the running statistics (bn_momentum)
HYBRID = "spatial_hypercube_temporal_hypercross"  # the blocks' default region
NORM_TYPES = ("batch", "instance", "instance_batch")


def _conv_kernel(k: int, cin: int, cout: int) -> nn.Parameter:
    """A (K, Cin, Cout) kernel; values come from MinkUNet's seeded init."""
    return nn.Parameter(torch.empty(k, cin, cout))


def variance_scaling_init_(module: nn.Module, seed: int) -> None:
    """Draw every conv kernel and Linear weight of `module` from `seed` as
    flax's variance_scaling(1.0, "fan_in", "truncated_normal") does (a
    normal of variance 1 / fan-in cut at two standard deviations); vectors
    (biases, BatchNorm parameters) are left as they are."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for w in module.parameters():
            if w.ndim == 3:  # (K, Cin, Cout): fan-in K * Cin
                fan_in = w.shape[0] * w.shape[1]
            elif w.ndim == 2:  # nn.Linear (out, in)
                fan_in = w.shape[1]
            else:
                continue
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class SparseBatchNorm(nn.Module):
    """BatchNorm over valid voxels, `scale`/`bias` map, running `mean`/`var`
    (the flax names). Training normalises by the masked batch mean and the
    biased variance over the valid rows, and updates the running statistics
    as new = (1 - momentum) * old + momentum * batch (the torch convention),
    the biased variance included (F.batch_norm would keep the unbiased one)."""

    def __init__(self, c: int, momentum: float = BN_MOMENTUM, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, feats: torch.Tensor, valid: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            w = valid.to(feats.dtype)[:, None]
            cnt = torch.clamp(w.sum(), min=1.0)
            mean = (feats * w).sum(0) / cnt
            var = ((feats - mean).square() * w).sum(0) / cnt
            with torch.no_grad():
                self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var + self.momentum * var)
        else:
            mean, var = self.mean, self.var
        y = (feats - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class SparseInstanceNorm(nn.Module):
    """Per-scene norm (MinkowskiInstanceNorm): the mean and the biased
    variance of each (scene, channel) over the scene's valid voxels, two
    passes of segment sums over the batch column (ids clamped to
    max_batches - 1; invalid rows go to an extra segment whose statistics
    are 0), `rsqrt(var + epsilon)`, learned (C,) `scale` and `bias`. Train
    and inference are the same; there are no running statistics.

    The segment sums and the gathers back to the rows are products with
    the (M, max_batches + 1) one-hot of the ids: a few segments take every
    row, and a scatter-add into them (or the index backward of a gather
    from them) serialises on the card's atomics."""

    def __init__(self, c: int, max_batches: int = 16, epsilon: float = 1e-5):
        super().__init__()
        self.max_batches = max_batches
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, feats: torch.Tensor, batch_ids: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        nb = self.max_batches
        ids = torch.where(valid, torch.clamp(batch_ids, max=nb - 1), nb).long()
        onehot = F.one_hot(ids, nb + 1).to(feats.dtype)  # (M, nb + 1); exact gathers
        v = valid[:, None]
        cnt = torch.clamp(onehot.T @ valid.to(feats.dtype), min=1.0)[:, None]
        d = feats - onehot @ (onehot.T @ torch.where(v, feats, 0.0) / cnt)
        var = onehot.T @ torch.where(v, d.square(), 0.0) / cnt
        return d * torch.rsqrt(onehot @ var + self.epsilon) * self.scale + self.bias


def _add_norm(module: nn.Module, name: str, c: int, norm_type: str, momentum: float) -> None:
    """Registers the norm `name` of `norm_type` on `module`, under the flax
    names: `{name}_in` for the instance norm, `name` for the batch norm."""
    if norm_type not in NORM_TYPES:
        raise ValueError(f"norm_type {norm_type!r} is not one of {NORM_TYPES}")
    if norm_type != "batch":
        setattr(module, f"{name}_in", SparseInstanceNorm(c))
    if norm_type != "instance":
        setattr(module, name, SparseBatchNorm(c, momentum))


def _apply_norm(module: nn.Module, name: str, feats: torch.Tensor, st: SparseTensor,
                train: bool) -> torch.Tensor:
    """The norm `name` that `_add_norm` registered: the instance norm, then
    the batch norm, whichever are there (looked up in the submodule dict: a
    missing attribute would raise and catch an exception a call)."""
    mods = module._modules
    if f"{name}_in" in mods:
        feats = mods[f"{name}_in"](feats, st.coords[:, 0], st.valid)
    if name in mods:
        feats = mods[name](feats, st.valid, train)
    return feats


class SubMConv(nn.Module):
    """Submanifold sparse conv over a shared rulebook; `kernel` (K, Cin,
    Cout), K = kernel_size^3 unless `kvol` gives the rulebook's width (a
    non-cube region: 29 or 81 offsets on 4-D coords)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, kvol: int | None = None):
        super().__init__()
        self.kernel = _conv_kernel(kvol or kernel_size ** 3, cin, cout)

    def forward(self, st: SparseTensor, rulebook: torch.Tensor,
                phase: PhaseClock) -> torch.Tensor:
        with phase("subm_conv"):
            return subm_conv(st, self.kernel, rulebook)


class BasicBlock(nn.Module):
    """conv3-norm-relu-conv3-norm + residual (1x1 Dense + norm when widths
    differ); norm_type 'instance_batch' gives BasicBlockINBN."""

    expansion = 1

    def __init__(self, cin: int, planes: int, bn_momentum: float = BN_MOMENTUM,
                 norm_type: str = "batch", kvol: int = 27):
        super().__init__()
        self.conv1 = SubMConv(cin, planes, kvol=kvol)
        _add_norm(self, "norm1", planes, norm_type, bn_momentum)
        self.conv2 = SubMConv(planes, planes, kvol=kvol)
        _add_norm(self, "norm2", planes, norm_type, bn_momentum)
        if cin != planes:
            self.downsample = nn.Linear(cin, planes, bias=False)
            _add_norm(self, "downsample_norm", planes, norm_type, bn_momentum)

    def forward(self, st: SparseTensor, rulebook, train: bool, phase) -> SparseTensor:
        identity = st.feats
        h = F.relu(_apply_norm(self, "norm1", self.conv1(st, rulebook, phase), st,
                               train))
        h = _apply_norm(self, "norm2", self.conv2(st.with_feats(h), rulebook, phase),
                        st, train)
        if hasattr(self, "downsample"):
            identity = _apply_norm(self, "downsample_norm", self.downsample(identity), st, train)
        return st.with_feats(F.relu(h + identity))


class Bottleneck(nn.Module):
    """1x1(planes) -> 3x3 subm(planes) -> 1x1(planes*4) + residual."""

    expansion = 4

    def __init__(self, cin: int, planes: int, bn_momentum: float = BN_MOMENTUM,
                 norm_type: str = "batch", kvol: int = 27):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Linear(cin, planes, bias=False)
        _add_norm(self, "norm1", planes, norm_type, bn_momentum)
        self.conv2 = SubMConv(planes, planes, kvol=kvol)
        _add_norm(self, "norm2", planes, norm_type, bn_momentum)
        self.conv3 = nn.Linear(planes, out, bias=False)
        _add_norm(self, "norm3", out, norm_type, bn_momentum)
        if cin != out:
            self.downsample = nn.Linear(cin, out, bias=False)
            _add_norm(self, "downsample_norm", out, norm_type, bn_momentum)

    def forward(self, st: SparseTensor, rulebook, train: bool, phase) -> SparseTensor:
        identity = st.feats
        h = F.relu(_apply_norm(self, "norm1", self.conv1(st.feats), st, train))
        h = self.conv2(st.with_feats(h), rulebook, phase)
        h = F.relu(_apply_norm(self, "norm2", h, st, train))
        h = _apply_norm(self, "norm3", self.conv3(h), st, train)
        if hasattr(self, "downsample"):
            identity = _apply_norm(self, "downsample_norm", self.downsample(identity), st, train)
        return st.with_feats(F.relu(h + identity))


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class _SparseUNet(nn.Module):
    """What the U-Nets (and SparseResNet) share: the options, the blocks,
    the norms, the rulebooks and the seeded init.

    The stem's rulebook is the spatial cube of conv1_kernel_size; a level's
    blocks take `block_conv_type`'s. Level 0 reuses the stem's rulebook only
    where the two regions agree (`stem_matches_blocks`: a 3^3 stem on 3-D
    coords, or on 4-D coords with spatial_hypercube blocks)."""

    def _setup(self, planes, layers, conv1_kernel_size, bn_momentum, block, norm_type,
               block_conv_type, ndim, level_caps, device) -> torch.device:
        """Stores the options; returns the device the net is built on (a
        missing card raises here, before the build)."""
        if ndim not in (3, 4):
            raise ValueError(f"ndim must be 3 or 4, got {ndim}")
        self.planes, self.layers = tuple(planes), tuple(layers)
        self.block_cls = BLOCKS[block]
        self.bn_momentum, self.norm_type = bn_momentum, norm_type
        self.conv1_kernel_size, self.block_conv_type = conv1_kernel_size, block_conv_type
        self.ndim = ndim
        self.level_caps = None if level_caps is None else list(level_caps)
        self.stem_matches_blocks = conv1_kernel_size == 3 and (
            ndim == 3 or block_conv_type == "spatial_hypercube")
        self.k_blocks = rulebook_volume(3, block_conv_type, ndim)
        self.k_level0 = 27 if self.stem_matches_blocks else self.k_blocks
        return resolve_device(device)

    def _norm(self, name, c):
        _add_norm(self, name, c, self.norm_type, self.bn_momentum)

    def _add_blocks(self, name, n, cin, planes, kvol) -> int:
        """Registers blocks `{name}_0` .. `{name}_{n-1}`; returns their width."""
        for i in range(n):
            setattr(self, f"{name}_{i}", self.block_cls(cin, planes, self.bn_momentum,
                                                        self.norm_type, kvol))
            cin = planes * self.block_cls.expansion
        return cin

    def _blocks(self, st, name, n, rb, train, phase):
        for i in range(n):
            st = getattr(self, f"{name}_{i}")(st, rb, train, phase)
        return st

    def _init_weights(self, seed: int, dev: torch.device) -> None:
        variance_scaling_init_(self, seed)
        with torch.no_grad():
            self.final.bias.zero_()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.final.weight.device

    def _check_coords(self, st: SparseTensor) -> None:
        if st.coords.shape[1] != self.ndim + 1:
            raise ValueError(f"the model is built for {self.ndim + 1}-column coords, got "
                             f"{st.coords.shape[1]} columns")

    def _stem_rulebooks(self, st, phase, rb_level0=None):
        """(the stem's rulebook, level 0's blocks' rulebook); a given
        `rb_level0` (a plan's) is not built again."""
        with phase("rulebooks"):
            rb0 = build_subm_rulebook(st, self.conv1_kernel_size,
                                      conv_type="spatial_hypercube")
            if rb_level0 is not None:
                return rb0, rb_level0
            if self.stem_matches_blocks:
                return rb0, rb0
            return rb0, build_subm_rulebook(st, 3, conv_type=self.block_conv_type)

    def _down(self, st, name, cap, train, phase, norm: bool = True, plan=None,
              lvl: int = 0):
        """The strided conv `{name}_kernel`, then (with `norm`) the norm
        `bn{n}` and ReLU, and the new level's rulebook: (SparseTensor,
        indice key, rulebook). With `plan`, the down map and the rulebook
        of level `lvl` + 1 are the plan's."""
        w = getattr(self, f"{name}_kernel")
        with phase("rulebooks"):
            if plan is None:
                st_dn, key = strided_conv_down(st, w, cap)
            else:
                st_dn, key = strided_conv_down_planned(st, w, plan["down"][lvl])
        if norm:
            st_dn = st_dn.with_feats(F.relu(_apply_norm(self, f"bn{name[4]}", st_dn.feats,
                                                        st_dn, train)))
        if plan is not None:
            return st_dn, key, plan["rulebooks"][lvl + 1]
        with phase("rulebooks"):
            rb = build_subm_rulebook(st_dn, 3, conv_type=self.block_conv_type)
        return st_dn, key, rb

    def _up(self, st, name, key, train):
        """The transposed conv `{name}_kernel` back to the sites of `key`,
        the norm `bntr{n}` and ReLU."""
        st_up = inverse_conv_up(st, getattr(self, f"{name}_kernel"), key)
        return st_up.with_feats(F.relu(_apply_norm(self, f"bntr{name[6]}", st_up.feats,
                                                   st_up, train)))

    def _head(self, feats, st, train):
        """ResUNet's and MinkUNetHyper's head: `final_fc` (512) -> norm
        `final_bn` -> ReLU -> `final`, zero on invalid rows."""
        h = F.relu(_apply_norm(self, "final_bn", self.final_fc(feats), st, train))
        return torch.where(st.valid[:, None], self.final(h), 0.0)


class MinkUNet(_SparseUNet):
    """Res16UNet over SparseTensor; variants select planes/layers/block.

    Built on `device`, the card unless the caller asks for the CPU, with
    weights drawn from `seed` by flax's initializers (variance-scaling
    truncated normal over fan-in, zero biases) or loaded from a JAX tree
    through models.convert."""

    def __init__(self, out_channels: int = 20,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 in_channels: int = 3, init_dim: int = INIT_DIM, conv1_kernel_size: int = 3,
                 bn_momentum: float = BN_MOMENTUM, block: str = "basic",
                 norm_type: str = "batch", block_conv_type: str = HYBRID, ndim: int = 3,
                 level_caps: Sequence[int] | None = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = self._setup(planes, layers, conv1_kernel_size, bn_momentum, block, norm_type,
                          block_conv_type, ndim, level_caps, device)
        p = self.planes

        self.conv0 = SubMConv(in_channels, init_dim, conv1_kernel_size)
        self._norm("bn0", init_dim)
        cur = init_dim
        skip_ch = [init_dim]  # the stem's width, then each encoder level's
        for lvl in range(4):
            setattr(self, f"conv{lvl + 1}s2_kernel", _conv_kernel(8, cur, cur))
            self._norm(f"bn{lvl + 1}", cur)
            cur = self._add_blocks(f"block{lvl + 1}", self.layers[lvl], cur, p[lvl],
                                   self.k_blocks)
            skip_ch.append(cur)
        for lvl in range(4):
            up = p[4 + lvl]
            setattr(self, f"convtr{lvl + 4}s2_kernel", _conv_kernel(8, cur, up))
            self._norm(f"bntr{lvl + 4}", up)
            kvol = self.k_level0 if lvl == 3 else self.k_blocks
            cur = self._add_blocks(f"block{lvl + 5}", self.layers[4 + lvl],
                                   up + skip_ch[3 - lvl], up, kvol)
        self.final = nn.Linear(cur, out_channels, bias=True)
        self._init_weights(seed, dev)

    def forward(self, st: SparseTensor, train: bool = False,
                phase_seconds: dict | None = None, plan: dict | None = None) -> torch.Tensor:
        """(M, out_channels) logits, zero on invalid rows; `train` selects
        BatchNorm's batch statistics. `plan`, a 5-level pyramid plan of the
        batch's coords (sparse/plan.py, sparse/device_plan.py), replaces
        every rulebook and down-map build (the stem's too where its kernel
        is 3). With
        `phase_seconds`, the card is synchronised around the rulebook and
        downsampling builds ("rulebooks") and the submanifold convs
        ("subm_conv"), and their wall seconds are added to the dict."""
        self._check_coords(st)
        phase = PhaseClock(st.coords.device, phase_seconds)
        cap = st.capacity
        caps = self.level_caps or [cap, cap // 2, cap // 4, cap // 8, cap // 8]
        if plan is not None and self.conv1_kernel_size == 3:
            rb0 = rb_level0 = plan["rulebooks"][0]
        else:
            rb0, rb_level0 = self._stem_rulebooks(
                st, phase, None if plan is None else plan["rulebooks"][0])
        h = _apply_norm(self, "bn0", self.conv0(st, rb0, phase), st, train)
        out_p1 = st.with_feats(F.relu(h))

        # encoder; each level's rulebook is reused by the decoder, whose
        # inverse convs restore exactly the encoder's sites
        rbs, skips, keys = [rb_level0], [], []
        cur = out_p1
        for lvl in range(4):
            st_dn, key, rb = self._down(cur, f"conv{lvl + 1}s2", caps[lvl + 1], train, phase,
                                        plan=plan, lvl=lvl)
            keys.append(key)
            rbs.append(rb)
            cur = self._blocks(st_dn, f"block{lvl + 1}", self.layers[lvl], rb, train, phase)
            skips.append(cur)

        # decoder
        for lvl in range(4):
            skip = skips[2 - lvl] if lvl < 3 else out_p1
            st_up = self._up(cur, f"convtr{lvl + 4}s2", keys[3 - lvl], train)
            st_cat = st_up.with_feats(torch.cat([st_up.feats, skip.feats], dim=-1))
            cur = self._blocks(st_cat, f"block{lvl + 5}", self.layers[4 + lvl],
                               rbs[3 - lvl], train, phase)

        logits = self.final(cur.feats)
        return torch.where(cur.valid[:, None], logits, 0.0)


def _pool_transpose(st_coarse: SparseTensor, rows: torch.Tensor,
                    fine_valid: torch.Tensor) -> torch.Tensor:
    """Unpool coarse features to fine sites (MinkowskiPoolingTranspose):
    each fine site reads its coarse ancestor's feature divided by that
    ancestor's child count. `rows` maps fine row -> coarse row (== coarse
    capacity where absent)."""
    capc = st_coarse.capacity
    ok = fine_valid & (rows < capc)
    cnt = segment_sum(ok.to(torch.float32), torch.where(ok, rows, capc), capc + 1)[:capc]
    scaled = st_coarse.feats / torch.clamp(cnt, min=1.0)[:, None]
    pad = torch.cat([scaled, scaled.new_zeros((1, scaled.shape[1]))])
    out = pad[torch.clamp(rows, max=capc).long()]
    return torch.where(ok[:, None], out, 0.0)


class ResUNet(_SparseUNet):
    """The legacy ResUNet family (reference minkowski/models/resunet.py):
    3 levels down and 3 up with a residual group at full resolution before
    the first stride, no blocks after the last concatenation, and a head of
    `final_fc` (512), `final_bn`, ReLU and `final`."""

    hypercolumn = False  # MinkUNetHyper's head also reads block5 and block6

    def __init__(self, out_channels: int = 20,
                 planes: Sequence[int] = (64, 128, 256, 512, 256, 128, 128),
                 layers: Sequence[int] = (2, 2, 2, 2, 2, 2),
                 in_channels: int = 3, init_dim: int = 64, conv1_kernel_size: int = 3,
                 bn_momentum: float = BN_MOMENTUM, block: str = "basic",
                 norm_type: str = "batch", block_conv_type: str = HYBRID, ndim: int = 3,
                 level_caps: Sequence[int] | None = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = self._setup(planes, layers, conv1_kernel_size, bn_momentum, block, norm_type,
                          block_conv_type, ndim, level_caps, device)
        p = self.planes
        self.conv1 = SubMConv(in_channels, init_dim, conv1_kernel_size)
        self._norm("bn1", init_dim)
        cur = self._add_blocks("block1", self.layers[0], init_dim, p[0], self.k_level0)
        skip_ch = [cur]
        for lvl in range(3):
            setattr(self, f"conv{lvl + 2}s2_kernel", _conv_kernel(8, cur, cur))
            self._norm(f"bn{lvl + 2}", cur)
            cur = self._add_blocks(f"block{lvl + 2}", self.layers[lvl + 1], cur, p[lvl + 1],
                                   self.k_blocks)
            skip_ch.append(cur)
        tap_ch = 0
        for lvl in range(3):
            setattr(self, f"convtr{lvl + 4}s2_kernel", _conv_kernel(8, cur, p[4 + lvl]))
            self._norm(f"bntr{lvl + 4}", p[4 + lvl])
            cur = p[4 + lvl] + skip_ch[2 - lvl]
            if lvl < 2:
                cur = self._add_blocks(f"block{lvl + 5}", self.layers[4 + lvl], cur,
                                       p[4 + lvl], self.k_blocks)
                tap_ch += cur
        self.final_fc = nn.Linear(cur + (tap_ch if self.hypercolumn else 0), 512, bias=False)
        self._norm("final_bn", 512)
        self.final = nn.Linear(512, out_channels, bias=True)
        self._init_weights(seed, dev)

    def forward(self, st: SparseTensor, train: bool = False,
                phase_seconds: dict | None = None) -> torch.Tensor:
        """(M, out_channels) logits, zero on invalid rows (see MinkUNet)."""
        self._check_coords(st)
        phase = PhaseClock(st.coords.device, phase_seconds)
        cap = st.capacity
        caps = self.level_caps or [cap, cap // 2, cap // 4, cap // 8]

        rb0, rb_full = self._stem_rulebooks(st, phase)
        h = _apply_norm(self, "bn1", self.conv1(st, rb0, phase), st, train)
        cur = self._blocks(st.with_feats(F.relu(h)), "block1", self.layers[0], rb_full, train,
                           phase)
        skips, keys, rbs = [cur], [], [rb_full]
        for lvl in range(3):
            st_dn, key, rb = self._down(cur, f"conv{lvl + 2}s2", caps[lvl + 1], train, phase)
            keys.append(key)
            rbs.append(rb)
            cur = self._blocks(st_dn, f"block{lvl + 2}", self.layers[lvl + 1], rb, train,
                               phase)
            skips.append(cur)

        taps = []  # block5's (stride 4) and block6's (stride 2) outputs
        for lvl in range(3):
            st_up = self._up(cur, f"convtr{lvl + 4}s2", keys[2 - lvl], train)
            cur = st_up.with_feats(torch.cat([st_up.feats, skips[2 - lvl].feats], dim=-1))
            if lvl < 2:  # block5, block6; the last concatenation feeds the head
                cur = self._blocks(cur, f"block{lvl + 5}", self.layers[4 + lvl],
                                   rbs[2 - lvl], train, phase)
                taps.append(cur)
        feats = cur.feats
        if self.hypercolumn:
            # fine -> coarse ancestor rows: level 0 -> 1, and level 0 -> 2
            # through level 1's row of each level-1 site
            r01 = keys[0]["out_row"]
            r12_pad = torch.cat([keys[1]["out_row"], torch.full(
                (1,), caps[2], dtype=torch.int32, device=r01.device)])
            r02 = r12_pad[torch.clamp(r01, max=caps[1]).long()]
            feats = torch.cat([feats, _pool_transpose(taps[1], r01, st.valid),
                               _pool_transpose(taps[0], r02, st.valid)], dim=-1)
        return self._head(feats, cur, train)


class MinkUNetHyper(ResUNet):
    """MinkUNetHyper (reference resunet.py:270-481): the ResUNet trunk with
    a hypercolumn head. block5's (stride 4) and block6's (stride 2) outputs
    are also unpooled straight to full resolution (`_pool_transpose`) and
    concatenated with the last decoder output and block1's before the
    `final_fc` (512) + norm + ReLU + `final` head. BasicBlocks only: it
    takes ResUNet's options but `block`."""

    hypercolumn = True

    def __init__(self, out_channels: int = 20, **kwargs):
        super().__init__(out_channels, block="basic", **kwargs)


# --- variants (reference res16unet.py:300-376, resunet.py:218-536) ---------

VARIANTS = {
    "Res16UNet14A": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 128, 128, 96, 96)),
    "Res16UNet14B": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 128, 128, 128, 128)),
    "Res16UNet14C": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 192, 192, 128, 128)),
    "Res16UNet14D": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 384, 384, 384, 384)),
    "Res16UNet18A": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 128, 128, 96, 96)),
    "Res16UNet18B": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 128, 128, 128, 128)),
    "Res16UNet18D": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 384, 384, 384, 384)),
    "Res16UNet34A": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 64, 64)),
    "Res16UNet34B": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 64, 32)),
    "Res16UNet34C": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 96, 96)),
    "Res16UNet50": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2),
                        planes=(32, 64, 128, 256, 256, 256, 256, 256), block="bottleneck"),
    "Res16UNet101": dict(layers=(2, 3, 4, 23, 2, 2, 2, 2),
                         planes=(32, 64, 128, 256, 256, 256, 256, 256), block="bottleneck"),
    "Res16UNet14": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 256, 256, 256, 256)),
    "Res16UNet18": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 256, 256, 256, 256)),
    "Res16UNet34": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2),
                        planes=(32, 64, 128, 256, 256, 256, 256, 256)),
}

# 4-D spatio-temporal variants: the same configs on (M, 5) coords with the
# hybrid block region; Tesseract takes the 81-offset 4-D hypercube
ST_VARIANTS = {f"ST{b}": dict(VARIANTS[b], ndim=4)
               for b in ("Res16UNet14", "Res16UNet14A", "Res16UNet18", "Res16UNet34",
                         "Res16UNet50", "Res16UNet101")}
ST_VARIANTS["STRes16UNet18A"] = dict(VARIANTS["Res16UNet18A"], ndim=4)
ST_VARIANTS["STResTesseract16UNet18A"] = dict(ST_VARIANTS["STRes16UNet18A"],
                                               block_conv_type="hypercube")

RESUNET_VARIANTS = {
    "ResUNet14": dict(layers=(1,) * 6),
    "ResUNet18": dict(layers=(2,) * 6),
    "ResUNet18INBN": dict(layers=(2,) * 6, norm_type="instance_batch"),
    "ResUNet34": dict(layers=(3, 4, 6, 3, 2, 2)),
    "ResUNet50": dict(layers=(3, 4, 6, 3, 2, 2), block="bottleneck"),
    "ResUNet101": dict(layers=(3, 4, 23, 3, 2, 2), block="bottleneck"),
    "ResUNet14D": dict(layers=(1,) * 6, planes=(64, 128, 256, 512, 512, 512, 512)),
    "ResUNet18D": dict(layers=(2,) * 6, planes=(64, 128, 256, 512, 512, 512, 512)),
    "ResUNet34D": dict(layers=(3, 4, 6, 3, 2, 2), planes=(64, 128, 256, 512, 512, 512, 512)),
    "ResUNet34E": dict(layers=(3, 4, 6, 3, 2, 2), init_dim=32,
                       planes=(32, 64, 128, 256, 128, 64, 64)),
    "ResUNet34F": dict(layers=(3, 4, 6, 3, 2, 2), init_dim=32,
                       planes=(32, 64, 128, 256, 128, 64, 32)),
}

ST_RESUNET_VARIANTS = {}
for _b in ("ResUNet14", "ResUNet18", "ResUNet34", "ResUNet50", "ResUNet101"):
    ST_RESUNET_VARIANTS[f"ST{_b}"] = dict(RESUNET_VARIANTS[_b], ndim=4)
    ST_RESUNET_VARIANTS[f"STResTesseract{_b[3:]}"] = dict(
        RESUNET_VARIANTS[_b], ndim=4, block_conv_type="hypercube")

HYPER_VARIANTS = {
    "MinkUNetHyper": dict(layers=(2,) * 6),
    "MinkUNetHyper14INBN": dict(layers=(1,) * 6, norm_type="instance_batch"),
}


def make_minkunet(variant: str = "Res16UNet34C", out_channels: int = 20,
                  **kwargs) -> MinkUNet:
    cfg = VARIANTS.get(variant) or ST_VARIANTS[variant]
    return MinkUNet(out_channels=out_channels, **{**cfg, **kwargs})


def make_resunet(variant: str = "ResUNet18", out_channels: int = 20, **kwargs) -> ResUNet:
    cfg = RESUNET_VARIANTS.get(variant) or ST_RESUNET_VARIANTS[variant]
    return ResUNet(out_channels=out_channels, **{**cfg, **kwargs})


def make_hyper(variant: str = "MinkUNetHyper", out_channels: int = 20,
               **kwargs) -> MinkUNetHyper:
    return MinkUNetHyper(out_channels=out_channels, **{**HYPER_VARIANTS[variant], **kwargs})
