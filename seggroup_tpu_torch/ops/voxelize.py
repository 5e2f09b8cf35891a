"""Device-side voxelisation (seggroup_tpu/ops/voxelize.py): points sorted by
(batch, x, y, z), one voxel per run of equal keys, a fixed row capacity.
Voxel rows, the point -> voxel map and the count equal the JAX side's
exactly; the per-voxel mean is a segment mean, whose float sums run in
another order than the reference's sorted scan."""

from __future__ import annotations

from typing import NamedTuple

import torch

from seggroup_tpu_torch.ops.segment_ops import invert_permutation, lexsort, segment_mean

__all__ = ["VoxelMap", "voxelize", "voxel_gather_mean", "point_recover"]


class VoxelMap(NamedTuple):
    voxel_coords: torch.Tensor  # (M, 4) int32: batch, x, y, z (M = the capacity)
    point2voxel: torch.Tensor   # (N,) int32 in [0, M), == M for padding/overflow
    voxel_valid: torch.Tensor   # (M,) bool
    num_voxels: torch.Tensor    # () int32


def voxelize(int_coords: torch.Tensor, batch_ids: torch.Tensor, point_valid: torch.Tensor,
             max_voxels: int) -> VoxelMap:
    """int_coords (N, 3) non-negative quantised coords, batch_ids (N,),
    point_valid (N,) bool -> the point <-> voxel correspondence over
    `max_voxels` rows. Voxels are numbered in (batch, x, y, z) order;
    `num_voxels` counts every voxel, those past the capacity included."""
    n = int_coords.shape[0]
    dev = int_coords.device
    c = int_coords.to(torch.int32)
    b = batch_ids.to(torch.int32)
    invalid = (~point_valid).to(torch.int32)
    order = lexsort([c[:, 2], c[:, 1], c[:, 0], b, invalid])  # invalid points last
    s_c, s_b, s_ok = c[order], b[order], point_valid[order]
    prev_same = torch.all(s_c[1:] == s_c[:-1], dim=1) & (s_b[1:] == s_b[:-1])
    firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~prev_same]) & s_ok
    compact_sorted = torch.cumsum(firsts.to(torch.int32), 0, dtype=torch.int32) - 1
    num = firsts.sum(dtype=torch.int32)
    p2v_sorted = torch.where(s_ok & (compact_sorted < max_voxels), compact_sorted, max_voxels)
    p2v = p2v_sorted[invert_permutation(order).long()]

    # p2v_sorted is nondecreasing, so a voxel's members are one run and its
    # coords are the run's first row
    vc_sorted = torch.cat([s_b[:, None], s_c], dim=1)
    starts = torch.searchsorted(p2v_sorted,
                                torch.arange(max_voxels, dtype=torch.int32, device=dev))
    voxel_valid = torch.arange(max_voxels, device=dev) < num
    voxel_coords = torch.where(voxel_valid[:, None],
                               vc_sorted[torch.clamp(starts, max=n - 1)], 0)
    return VoxelMap(voxel_coords.to(torch.int32), p2v.to(torch.int32), voxel_valid, num)


def voxel_gather_mean(feats: torch.Tensor, vmap: VoxelMap) -> torch.Tensor:
    """Per-voxel mean of the member points' features."""
    return segment_mean(feats, vmap.point2voxel, vmap.voxel_valid.shape[0])


def point_recover(voxel_feats: torch.Tensor, vmap: VoxelMap) -> torch.Tensor:
    """Voxel features back at the points; zero for points without a voxel."""
    m = voxel_feats.shape[0]
    out = voxel_feats[torch.clamp(vmap.point2voxel, max=m - 1).long()]
    return torch.where((vmap.point2voxel < m)[:, None], out, 0.0)
