"""Proposal x ground-truth-instance IoU matrix (seggroup_tpu/ops/iou.py).

Both memberships are flat per-point id vectors; the intersections are one
count over the combined key (proposal, instance) and the union follows by
inclusion-exclusion. The counts are integers held exactly in float32, so
the matrix equals the JAX side's bit for bit on every device."""

from __future__ import annotations

import torch

__all__ = ["proposal_instance_iou"]


def _count(ids: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32 count of the rows with `ok` per id (no host sync)."""
    ok_f = ok.to(torch.float32)
    return ok_f.new_zeros(n).index_add_(0, torch.where(ok, ids.long(), 0), ok_f)


def proposal_instance_iou(proposal_ids: torch.Tensor, instance_ids: torch.Tensor,
                          point_valid: torch.Tensor, num_proposals: int, num_instances: int,
                          instance_sizes: torch.Tensor | None = None) -> torch.Tensor:
    """proposal_ids (N,) in [0, P) (>= P: in no proposal); instance_ids (N,)
    in [0, I) (negative or >= I: in no instance). `instance_sizes` (I,), the
    true point count of each instance, is for a flat membership that lists
    a point under several proposals (PointGroup's dual clustering), where
    counting the instances from it would double them. Returns (P, I)
    float32 IoU."""
    p_ok = (proposal_ids >= 0) & (proposal_ids < num_proposals) & point_valid
    i_ok = (instance_ids >= 0) & (instance_ids < num_instances) & point_valid
    sizes_p = _count(proposal_ids, p_ok, num_proposals)
    if instance_sizes is None:
        sizes_i = _count(instance_ids, i_ok, num_instances)
    else:
        sizes_i = instance_sizes.to(torch.float32)
    both = p_ok & i_ok
    combined = proposal_ids.long() * num_instances + instance_ids.long()
    inter = _count(combined, both, num_proposals * num_instances)
    inter = inter.reshape(num_proposals, num_instances)
    union = sizes_p[:, None] + sizes_i[None, :] - inter
    return inter / torch.clamp(union, min=1.0)
