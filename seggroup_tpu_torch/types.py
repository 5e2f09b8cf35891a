"""Fixed-shape containers shared across the port (seggroup_tpu/types.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from seggroup_tpu_torch.device import resolve_device


class Scene(NamedTuple):
    """One ScanNet scene, padded to static shapes.

    N = points, S = segment slots, E = segment-adjacency edge slots. Fields
    may be numpy arrays (as `data.synthetic` makes them) or tensors; `to`
    moves them onto a device as tensors."""

    points: torch.Tensor      # (N, 6) float32: xyz, rgb in [-1, 1]
    point2seg: torch.Tensor   # (N,) int32 in [0, S); >= S marks padding points
    weak_ins: torch.Tensor    # (S,) int32 per-segment weak instance label, -1 = none
    weak_sem: torch.Tensor    # (S,) int32 per-segment weak semantic label (0..39), -1
    edges: torch.Tensor       # (E, 2) int32 segment adjacency
    edge_valid: torch.Tensor  # (E,) bool
    real_sem: torch.Tensor    # (N,) int32 GT semantic (1..40, 0 = unannotated)
    real_ins: torch.Tensor    # (N,) int32 GT instance (1.., 0 = none)

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_slots(self) -> int:
        return self.weak_ins.shape[0]

    def to(self, device: str | torch.device = "cuda") -> "Scene":
        dev = resolve_device(device)
        return Scene(*(torch.as_tensor(x).to(dev) for x in self))
