"""MinkowskiNet Res16UNet family on the sparse engine
(seggroup_tpu/models/minkunet.py:33-380).

The same forward as the flax `MinkUNet` with `plan=None` over 4-column
coords: fixed voxel capacities per pyramid level, BatchNorm with running
statistics, submanifold convs (kernel K2 on the card), kernel-2 stride-2
down/up convs that reuse the saved fine-level sites, rulebooks built once
per level and reused by the decoder. Module and attribute names are the
flax names, so `models.convert.minkunet_params_from_flax` reads straight
across.

With `train=True` BatchNorm normalises by the batch statistics of the valid
voxels and updates its running statistics (momentum 0.02, the torch
convention); with `train=False` it runs on the running statistics. The
forward records the autograd graph unless the caller turns it off
(`torch.no_grad()`, as the inference drivers do). Not ported:
`SparseInstanceNorm` and the other norm types, the ST/Tesseract variants
(raise), host plans (`plan=`), `ResUNet` and `MinkUNetHyper`."""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.sparse.conv import (build_subm_rulebook, inverse_conv_up,
                                            strided_conv_down, subm_conv)
from seggroup_tpu_torch.sparse.tensor import SparseTensor

INIT_DIM = 32  # the stem's width (Res16UNetBase INIT_DIM)
BN_MOMENTUM = 0.02  # weight of the batch in the running statistics (reference bn_momentum)


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
    as new = (1 - BN_MOMENTUM) * old + BN_MOMENTUM * batch, the biased
    variance included (F.batch_norm would keep the unbiased one)."""

    def __init__(self, c: int, epsilon: float = 1e-5):
        super().__init__()
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
                self.mean.copy_((1 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean)
                self.var.copy_((1 - BN_MOMENTUM) * self.var + BN_MOMENTUM * var)
        else:
            mean, var = self.mean, self.var
        y = (feats - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class SubMConv(nn.Module):
    """Submanifold sparse conv over a shared rulebook; `kernel` (K, Cin, Cout)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.kernel = _conv_kernel(kernel_size ** 3, cin, cout)

    def forward(self, st: SparseTensor, rulebook: torch.Tensor,
                phase: PhaseClock) -> torch.Tensor:
        with phase("subm_conv"):
            return subm_conv(st, self.kernel, rulebook)


class BasicBlock(nn.Module):
    """conv3-bn-relu-conv3-bn + residual (1x1 Dense + bn when widths differ)."""

    expansion = 1

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = SubMConv(cin, planes)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SubMConv(planes, planes)
        self.norm2 = SparseBatchNorm(planes)
        if cin != planes:
            self.downsample = nn.Linear(cin, planes, bias=False)
            self.downsample_norm = SparseBatchNorm(planes)

    def forward(self, st: SparseTensor, rulebook, train: bool, phase) -> SparseTensor:
        identity = st.feats
        h = F.relu(self.norm1(self.conv1(st, rulebook, phase), st.valid, train))
        h = self.norm2(self.conv2(st.with_feats(h), rulebook, phase), st.valid, train)
        if hasattr(self, "downsample"):
            identity = self.downsample_norm(self.downsample(identity), st.valid, train)
        return st.with_feats(F.relu(h + identity))


class Bottleneck(nn.Module):
    """1x1(planes) -> 3x3 subm(planes) -> 1x1(planes*4) + residual."""

    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Linear(cin, planes, bias=False)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SubMConv(planes, planes)
        self.norm2 = SparseBatchNorm(planes)
        self.conv3 = nn.Linear(planes, out, bias=False)
        self.norm3 = SparseBatchNorm(out)
        if cin != out:
            self.downsample = nn.Linear(cin, out, bias=False)
            self.downsample_norm = SparseBatchNorm(out)

    def forward(self, st: SparseTensor, rulebook, train: bool, phase) -> SparseTensor:
        identity = st.feats
        h = F.relu(self.norm1(self.conv1(st.feats), st.valid, train))
        h = self.conv2(st.with_feats(h), rulebook, phase)
        h = F.relu(self.norm2(h, st.valid, train))
        h = self.norm3(self.conv3(h), st.valid, train)
        if hasattr(self, "downsample"):
            identity = self.downsample_norm(self.downsample(identity), st.valid, train)
        return st.with_feats(F.relu(h + identity))


class MinkUNet(nn.Module):
    """Res16UNet over SparseTensor; variants select planes/layers/block.

    Built on `device`, the card unless the caller asks for the CPU, with
    weights drawn from `seed` by flax's initializers (variance-scaling
    truncated normal over fan-in, zero biases) or loaded from a JAX tree
    through models.convert."""

    def __init__(self, out_channels: int = 20,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 in_channels: int = 3, conv1_kernel_size: int = 3, block: str = "basic",
                 level_caps: Sequence[int] | None = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        block_cls = {"basic": BasicBlock, "bottleneck": Bottleneck}[block]
        self.planes, self.layers = tuple(planes), tuple(layers)
        self.conv1_kernel_size = conv1_kernel_size
        self.level_caps = None if level_caps is None else list(level_caps)
        p, e = self.planes, block_cls.expansion

        self.conv0 = SubMConv(in_channels, INIT_DIM, conv1_kernel_size)
        self.bn0 = SparseBatchNorm(INIT_DIM)
        cur = INIT_DIM
        skip_ch = [INIT_DIM]  # the stem's width, then each encoder level's
        for lvl in range(4):
            setattr(self, f"conv{lvl + 1}s2_kernel", _conv_kernel(8, cur, cur))
            setattr(self, f"bn{lvl + 1}", SparseBatchNorm(cur))
            for i in range(self.layers[lvl]):
                setattr(self, f"block{lvl + 1}_{i}", block_cls(cur, p[lvl]))
                cur = p[lvl] * e
            skip_ch.append(cur)
        for lvl in range(4):
            up = p[4 + lvl]
            setattr(self, f"convtr{lvl + 4}s2_kernel", _conv_kernel(8, cur, up))
            setattr(self, f"bntr{lvl + 4}", SparseBatchNorm(up))
            cur = up + skip_ch[3 - lvl]  # block(3-lvl)'s output, or the stem's
            for i in range(self.layers[4 + lvl]):
                setattr(self, f"block{lvl + 5}_{i}", block_cls(cur, up))
                cur = up * e
        self.final = nn.Linear(cur, out_channels, bias=True)
        self._init_weights(seed)
        self.to(dev)

    def _init_weights(self, seed: int) -> None:
        variance_scaling_init_(self, seed)
        with torch.no_grad():
            self.final.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.final.weight.device

    def _blocks(self, st, name, n, rb, train, phase):
        for i in range(n):
            st = getattr(self, f"{name}_{i}")(st, rb, train, phase)
        return st

    def forward(self, st: SparseTensor, train: bool = False,
                phase_seconds: dict | None = None) -> torch.Tensor:
        """(M, out_channels) logits, zero on invalid rows; `train` selects
        BatchNorm's batch statistics. With `phase_seconds`, the card is
        synchronised around the rulebook and downsampling builds
        ("rulebooks") and the submanifold convs ("subm_conv"), and their wall
        seconds are added to the dict."""
        if st.coords.shape[1] != 4:
            raise NotImplementedError("only 4-column (batch, x, y, z) coords are ported")
        phase = PhaseClock(st.coords.device, phase_seconds)
        cap = st.capacity
        caps = self.level_caps or [cap, cap // 2, cap // 4, cap // 8, cap // 8]

        def bn(name, feats, s):
            return getattr(self, name)(feats, s.valid, train)

        with phase("rulebooks"):
            rb0 = build_subm_rulebook(st, self.conv1_kernel_size,
                                      conv_type="spatial_hypercube")
        h = bn("bn0", self.conv0(st, rb0, phase), st)
        out_p1 = st.with_feats(F.relu(h))

        # encoder; each level's rulebook is reused by the decoder, whose
        # inverse convs restore exactly the encoder's sites
        if self.conv1_kernel_size == 3:
            rbs = [rb0]
        else:
            with phase("rulebooks"):
                rbs = [build_subm_rulebook(st, 3)]
        skips, keys = [], []
        cur = out_p1
        for lvl in range(4):
            w = getattr(self, f"conv{lvl + 1}s2_kernel")
            with phase("rulebooks"):
                st_dn, key = strided_conv_down(cur, w, caps[lvl + 1])
            keys.append(key)
            st_dn = st_dn.with_feats(F.relu(bn(f"bn{lvl + 1}", st_dn.feats, st_dn)))
            with phase("rulebooks"):
                rb = build_subm_rulebook(st_dn, 3)
            rbs.append(rb)
            cur = self._blocks(st_dn, f"block{lvl + 1}", self.layers[lvl], rb, train, phase)
            skips.append(cur)

        # decoder
        for lvl in range(4):
            skip = skips[2 - lvl] if lvl < 3 else out_p1
            st_up = inverse_conv_up(cur, getattr(self, f"convtr{lvl + 4}s2_kernel"),
                                    keys[3 - lvl])
            st_up = st_up.with_feats(F.relu(bn(f"bntr{lvl + 4}", st_up.feats, st_up)))
            st_cat = st_up.with_feats(torch.cat([st_up.feats, skip.feats], dim=-1))
            cur = self._blocks(st_cat, f"block{lvl + 5}", self.layers[4 + lvl],
                               rbs[3 - lvl], train, phase)

        logits = self.final(cur.feats)
        return torch.where(cur.valid[:, None], logits, 0.0)


# --- variants (reference res16unet.py:300-332) -----------------------------

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


def make_minkunet(variant: str = "Res16UNet34C", out_channels: int = 20,
                  **kwargs) -> MinkUNet:
    if variant not in VARIANTS:
        raise NotImplementedError(f"variant {variant!r} is not ported (the ST/Tesseract "
                                  "spatio-temporal families wait)")
    cfg = VARIANTS[variant]
    return MinkUNet(out_channels=out_channels, planes=cfg["planes"], layers=cfg["layers"],
                    block=cfg.get("block", "basic"), **kwargs)
