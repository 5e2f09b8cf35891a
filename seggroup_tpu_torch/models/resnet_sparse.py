"""Sparse ResNet classifiers and the KPConv-block KPCNN head
(seggroup_tpu/models/resnet_sparse.py): per-scene classification by a
global pool over the last level.

`SparseResNet`: a 3^3 stem, 4 stages of a stride-2 conv and BasicBlocks
(the submanifold convs are kernel K2 on the card), the per-scene mean and
`final`. `RESNET_VARIANTS` and the 4-D `ST_RESNET_VARIANTS` (hybrid blocks;
Tesseract the 81-offset hypercube) as on the JAX side.

`KPCNN`: the KPFCNN encoder blocks of models.kpconv (a fixed 'simple',
'resnetb', 'resnetb_strided' x 3 stack), the per-scene mean at the last
level and the `head` classifier. It is a different network from
models.kpconv.KPCNN; the registry names this one `kpcnn` and that one
`kpcnn_kp`, as the JAX registry does."""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.kpconv import PyramidLevel, _KPEncoder
from seggroup_tpu_torch.models.minkunet import (HYBRID, BasicBlock, SubMConv, _conv_kernel,
                                                _SparseUNet)
from seggroup_tpu_torch.ops.segment_ops import segment_mean
from seggroup_tpu_torch.sparse.conv import build_subm_rulebook, global_pool
from seggroup_tpu_torch.sparse.tensor import SparseTensor


class SparseResNet(_SparseUNet):
    """conv stem + 4 strided stages of BasicBlocks + global mean pool +
    classifier (reference resnet.py ResNetBase: INIT_DIM 64, PLANES (64,
    128, 256, 512)). Flax names: `conv1`, `bn1`, `down{s}_kernel`,
    `stage{s}_block{b}`, `final`. Built on `device` (the card unless the
    caller asks for the CPU) with weights drawn from `seed`."""

    def __init__(self, out_channels: int = 20, layers: Sequence[int] = (1, 1, 1, 1),
                 planes: Sequence[int] = (64, 128, 256, 512), in_channels: int = 3,
                 init_dim: int = 64, num_batches: int = 8, bn_momentum: float = 0.02,
                 block_conv_type: str = HYBRID, ndim: int = 3,
                 level_caps: Sequence[int] | None = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = self._setup(planes, layers, 3, bn_momentum, "basic", "batch", block_conv_type,
                          ndim, level_caps, device)
        self.num_batches = num_batches
        self.conv1 = SubMConv(in_channels, init_dim)
        self._norm("bn1", init_dim)
        cur = init_dim
        for stage, (n_blocks, p) in enumerate(zip(self.layers, self.planes)):
            setattr(self, f"down{stage}_kernel", _conv_kernel(8, cur, cur))
            for b in range(n_blocks):
                setattr(self, f"stage{stage}_block{b}",
                        BasicBlock(cur, p, bn_momentum, kvol=self.k_blocks))
                cur = p
        self.final = nn.Linear(cur, out_channels)
        self._init_weights(seed, dev)

    def forward(self, st: SparseTensor, train: bool = False) -> torch.Tensor:
        """(num_batches, out_channels) logits of each scene."""
        self._check_coords(st)
        phase = PhaseClock(st.coords.device, None)
        caps = self.level_caps or [st.capacity >> (i + 1) for i in range(4)]
        rb = build_subm_rulebook(st, 3, conv_type="spatial_hypercube")
        h = self.bn1(self.conv1(st, rb, phase), st.valid, train)
        cur = st.with_feats(torch.relu(h))
        for stage, n_blocks in enumerate(self.layers):
            cur, _, rb = self._down(cur, f"down{stage}", caps[stage], train, phase, norm=False)
            for b in range(n_blocks):
                cur = getattr(self, f"stage{stage}_block{b}")(cur, rb, train, phase)
        return self.final(global_pool(cur, self.num_batches, mode="mean"))


RESNET_VARIANTS = {
    "ResNet14": dict(layers=(1, 1, 1, 1)),
    "ResNet18": dict(layers=(2, 2, 2, 2)),
    "ResNet34": dict(layers=(3, 4, 6, 3)),
    "ResNet50": dict(layers=(3, 4, 6, 3), planes=(128, 256, 512, 1024)),
    "ResNet101": dict(layers=(3, 4, 23, 3), planes=(128, 256, 512, 1024)),
}

# 4-D spatio-temporal classifiers: the same configs on (M, 5) coords;
# Tesseract = the 81-offset 4-D hypercube block kernels
ST_RESNET_VARIANTS = {}
for _b in RESNET_VARIANTS:
    ST_RESNET_VARIANTS[f"ST{_b}"] = dict(RESNET_VARIANTS[_b], ndim=4)
    ST_RESNET_VARIANTS[f"STResTesseract{_b[3:]}"] = dict(
        RESNET_VARIANTS[_b], ndim=4, block_conv_type="hypercube")


def make_sparse_resnet(variant: str = "ResNet14", **kwargs) -> SparseResNet:
    cfg = RESNET_VARIANTS.get(variant) or ST_RESNET_VARIANTS[variant]
    return SparseResNet(**{**cfg, **kwargs})


KPCNN_ARCHITECTURE = ("simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided",
                      "resnetb", "resnetb_strided", "resnetb")


class KPCNN(_KPEncoder):
    """KPConv classification network: the KPFCNN encoder blocks
    (`b{i}_kp`/`b{i}_bn`, `b{i}`), the mean over each scene's valid rows at
    the last level, and `head` (with bias). Built on `device` with weights
    drawn from `seed` as models.kpconv's networks are."""

    def __init__(self, num_classes: int = 40, first_features_dim: int = 64, dl0: float = 0.04,
                 num_batches: int = 8, in_features_dim: int = 1, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dl0, self.num_batches = dl0, num_batches
        fdim, cin = first_features_dim, in_features_dim
        for i, name in enumerate(KPCNN_ARCHITECTURE):
            cin, fdim = self._add_encoder_block(i, name, cin, fdim, False)
        self.head = nn.Linear(cin, num_classes)
        self._init_weights(seed, dev)

    def forward(self, pyramid: list[PyramidLevel], in_feats: torch.Tensor,
                batch_of_last_level: torch.Tensor, train: bool = False):
        """(logits (num_batches, num_classes), the sum of the layers'
        regularisers, 0 for these rigid layers)."""
        dl, layer = self.dl0, 0
        feats, regs = in_feats, in_feats.new_zeros(())
        for i, name in enumerate(KPCNN_ARCHITECTURE):
            feats, reg, layer, dl = self._encoder_block(i, name, pyramid, layer, feats, dl,
                                                        train)
            regs = regs + reg
        ids = torch.where(pyramid[layer].valid, batch_of_last_level, self.num_batches)
        return self.head(segment_mean(feats, ids, self.num_batches)), regs
