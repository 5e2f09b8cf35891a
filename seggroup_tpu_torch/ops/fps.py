"""Masked farthest-point sampling (seggroup_tpu/ops/fps.py).

Semantics of the reference configuration (initial_idx=0, skip_initial=True,
the only one its callers use): the first pick is the valid point farthest
from candidate 0, and each further pick maximizes the min squared distance
to the picks so far. On a CUDA tensor `masked_fps` launches kernel K1
(ops/cuda_fps.py); on a CPU tensor it runs the plain version below, which
repeats the kernel's arithmetic.

Squared distances are fma(dz,dz, fma(dy,dy, dx*dx)) in float32, the order
in which XLA contracts `jnp.sum(d*d, -1)` on the CPU (ops/fma.py), so picks
equal the JAX ones index for index."""

from __future__ import annotations

import torch

from seggroup_tpu_torch.ops import cuda_fps
from seggroup_tpu_torch.ops.fma import dot_fma

__all__ = ["farthest_point_sampling", "masked_fps", "masked_fps_plain"]


def masked_fps_plain(points: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K1: (B, P, D>=3) + (B, P) bool ->
    (B, k) int32. Rows with fewer than k valid points repeat picks."""
    xyz = points[..., :3].to(torch.float32)
    rows = torch.arange(xyz.shape[0], device=xyz.device)
    neg = torch.tensor(-1.0, device=xyz.device)

    def dist_to(idx):
        d = xyz - xyz[rows, idx][:, None, :]
        return torch.where(valid, dot_fma(d, d), neg)

    cur = torch.argmax(dist_to(torch.zeros_like(rows)), dim=1)
    picks = [cur]
    min_d = dist_to(cur)
    for _ in range(1, k):
        cur = torch.argmax(min_d, dim=1)
        picks.append(cur)
        min_d = torch.minimum(min_d, dist_to(cur))
    return torch.stack(picks, dim=1).to(torch.int32)


def masked_fps(points: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Batched FPS with per-point validity: (B, P, D>=3) candidates, (B, P)
    bool -> (B, k) int32 indices into P. Invalid candidates are never picked
    while a valid one remains; rows with fewer than k valid points repeat
    picks."""
    if points.is_cuda:
        return cuda_fps.masked_fps_cuda(points, valid, k)
    if points.device.type != "cpu":
        raise ValueError(f"masked_fps runs on CUDA or CPU, not {points.device}")
    return masked_fps_plain(points, valid, k)


def farthest_point_sampling(points: torch.Tensor, k: int) -> torch.Tensor:
    """Unmasked convenience wrapper: (P, D) or (B, P, D) -> (k,) or (B, k)."""
    squeeze = points.ndim == 2
    if squeeze:
        points = points[None]
    valid = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    idx = masked_fps(points, valid, k)
    return idx[0] if squeeze else idx
