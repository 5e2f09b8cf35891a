"""Parallel connected components over fixed-cap neighbour lists
(seggroup_tpu/ops/cc.py).

Min-label propagation: each point starts with its own index; a sweep takes
the minimum label over its masked neighbour list in both directions, every
provisional component adopts its members' best discovery (hooking by a
segment min), and two pointer jumps flatten the chains. The loop runs in
Python and reads one flag from the device per sweep. The fixpoint (the
minimum point index of each component) does not depend on the order of the
updates, so the labels equal the JAX side's exactly."""

from __future__ import annotations

import torch

from seggroup_tpu_torch.ops.segment_ops import segment_min, segment_sum

__all__ = [
    "connected_components",
    "semantic_connected_components",
    "compact_labels",
]


def hook_and_jump(new: torch.Tensor, label: torch.Tensor, point_valid: torch.Tensor,
                  jumps: int = 2) -> torch.Tensor:
    """The tail of one sweep, shared with ops/radius_cc.py: rows sharing
    the OLD `label` adopt the least label any of them found in `new`, then
    `jumps` pointer jumps; invalid rows keep label N."""
    n = label.shape[0]
    grp = segment_min(new, torch.where(point_valid, label, -1), n + 1, fill_value=n)
    new = torch.minimum(new, grp[torch.clamp(label, max=n).long()])
    for _ in range(jumps):
        new = torch.minimum(new, new[torch.clamp(new, max=n - 1).long()])
    return torch.where(point_valid, new, n)


def connected_components(neighbors: torch.Tensor, nbr_valid: torch.Tensor,
                         point_valid: torch.Tensor,
                         max_iters: int | None = None) -> torch.Tensor:
    """neighbors (N, K) int32 indices (self-loops fine), nbr_valid (N, K)
    bool edge mask, point_valid (N,) bool. Returns (N,) int32 labels = the
    minimum point index of the component, N for invalid points. `max_iters`
    bounds the sweep count (None: to the fixpoint)."""
    n = neighbors.shape[0]
    dev = neighbors.device
    nbrs = neighbors.long()
    label = torch.where(point_valid, torch.arange(n, dtype=torch.int32, device=dev), n)
    # lists are directed: both endpoints must be valid, and labels travel
    # both ways so that a one-sided (capped) edge still connects
    mask = nbr_valid & point_valid[:, None] & point_valid[nbrs]
    flat = nbrs.reshape(-1)
    it = 0
    while max_iters is None or it < max_iters:
        nbr_lab = torch.where(mask, label[nbrs], n)
        new = torch.minimum(label, nbr_lab.min(dim=1).values)
        push = torch.where(mask, label[:, None].expand_as(mask), n)
        new = new.scatter_reduce(0, flat, push.reshape(-1), reduce="amin")
        new = hook_and_jump(new, label, point_valid)
        changed = bool((new != label).any())
        label = new
        it += 1
        if not changed:
            break
    return label


def semantic_connected_components(neighbors: torch.Tensor, nbr_valid: torch.Tensor,
                                  point_valid: torch.Tensor, semantics: torch.Tensor,
                                  ignore_labels: tuple[int, ...] = ()) -> torch.Tensor:
    """Components restricted to edges between equal `semantics`, skipping
    the classes in `ignore_labels`."""
    nbrs = neighbors.long()
    mask = nbr_valid & (semantics[nbrs] == semantics[:, None])
    pv = point_valid
    for ig in ignore_labels:
        pv = pv & (semantics != ig)
    mask = mask & pv[:, None] & pv[nbrs]
    return connected_components(neighbors, mask, pv)


def compact_labels(labels: torch.Tensor, point_valid: torch.Tensor,
                   max_labels: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Renumber arbitrary int labels to dense ids [0, num) in ascending
    label order. Returns (compact (N,) int32 with invalid and overflowing
    points at `max_labels`, num () int32, sizes (max_labels,) int32)."""
    n = labels.shape[0]
    sentinel = torch.iinfo(torch.int32).max
    lab = torch.where(point_valid, labels.to(torch.int32), sentinel)
    sorted_lab = torch.sort(lab).values
    firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=lab.device),
                        sorted_lab[1:] != sorted_lab[:-1]]) & (sorted_lab != sentinel)
    rank = torch.cumsum(firsts.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.searchsorted(sorted_lab, lab)
    compact = rank[torch.clamp(pos, max=n - 1)]
    num = firsts.sum(dtype=torch.int32)
    compact = torch.where(point_valid & (compact < max_labels), compact, max_labels)
    sizes = segment_sum(torch.ones(n, dtype=torch.int32, device=lab.device), compact,
                        max_labels)
    return compact.to(torch.int32), num, sizes
