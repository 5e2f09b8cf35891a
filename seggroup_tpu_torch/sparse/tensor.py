"""Fixed-capacity sparse voxel tensor (seggroup_tpu/sparse/tensor.py).

Rows beyond `num` are padding; every op is masked on `valid`."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SparseTensor(NamedTuple):
    coords: torch.Tensor  # (M, 4) int32: batch, x, y, z (non-negative)
    feats: torch.Tensor   # (M, C) float32
    valid: torch.Tensor   # (M,) bool
    num: torch.Tensor     # () int32

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return self._replace(feats=torch.where(self.valid[:, None], feats, 0.0))

    def to(self, device: str | torch.device) -> "SparseTensor":
        return SparseTensor(*(torch.as_tensor(x).to(device) for x in self))
