"""Voxelization: scenes -> fixed-capacity voxel batches
(seggroup_tpu/data/voxel_dataset.py), host-side numpy.

`voxelize_scene` is a numpy copy of the JAX package's native
`voxelize_sorted` (seggroup_tpu/csrc/seggroup_native.cpp:507-542): float32
true division by the voxel size, floor, shift to non-negative, voxels sorted
by the packed 16-bit (x, y, z) key, each voxel's first point as its
representative. It gives the same coords, feats, labels and point2voxel.
With `augment=True` the training recipe of data/transforms.py runs first,
drawing from `rng` in the JAX package's order."""

from __future__ import annotations

from collections.abc import Iterable
from typing import NamedTuple

import numpy as np

from seggroup_tpu_torch.data import transforms as T


class VoxelBatch(NamedTuple):
    coords: np.ndarray   # (M, 4) int32 batch,x,y,z
    feats: np.ndarray    # (M, C) float32
    labels: np.ndarray   # (M,) int32 (ignore = 255)
    valid: np.ndarray    # (M,) bool
    num: np.ndarray      # () int32
    point2voxel: list    # per-scene (N_i,) voxel row of each point; -1 marks
                         # points whose voxel overflowed capacity


IGNORE_LABEL = 255


def voxelize_scene(coords: np.ndarray, colors: np.ndarray, labels: np.ndarray,
                   voxel_size: float):
    """Returns (int_coords (V,3) int32 sorted by (x,y,z), feats (V,3),
    labels (V,), point2voxel (N,) int32)."""
    pts = np.ascontiguousarray(coords, np.float32)
    # a true float32 division (not a multiply by the reciprocal), as the
    # native code divides
    ic = np.floor(pts / np.float32(voxel_size)).astype(np.int32)
    rel = (ic - ic.min(0)).astype(np.int64) & 0xFFFF  # the 16-bit key fields
    key = (rel[:, 0] << 32) | (rel[:, 1] << 16) | rel[:, 2]
    order = np.argsort(key, kind="stable")  # ties keep the lower point index
    s_key = key[order]
    firsts = np.ones(len(order), bool)
    firsts[1:] = s_key[1:] != s_key[:-1]
    p2v = np.empty(len(order), np.int32)
    p2v[order] = np.cumsum(firsts) - 1
    first = order[firsts]
    vk = s_key[firsts]
    ic_s = np.stack([(vk >> 32) & 0xFFFF, (vk >> 16) & 0xFFFF, vk & 0xFFFF],
                    axis=1).astype(np.int32)
    return ic_s, colors[first], labels[first], p2v


def make_voxel_batch(
    scenes: Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]],
    capacity: int,
    voxel_size: float = 0.02,
    rng: np.random.Generator | None = None,
    augment: bool = False,
) -> VoxelBatch:
    """scenes: iterable of (coords (N,3) meters, colors (N,3) 0..255,
    labels (N,) int with IGNORE_LABEL for unlabeled). Voxels past
    `capacity` are dropped; their points get point2voxel -1.

    With augment=True (which needs `rng`) the reference training recipe
    applies to each scene, RandomDropout (minkowski lib/dataset.py:451,
    transforms.py:141-156) before the geometric and chromatic transforms.
    The colors map to [-1, 1] (the stage-1 convention)."""
    if augment and rng is None:
        raise ValueError("augment=True needs an rng")
    all_c, all_f, all_l, p2v_list = [], [], [], []
    total = 0
    for b, (coords, colors, labels) in enumerate(scenes):
        if augment:
            coords, colors, labels = T.random_dropout(coords, colors, labels, rng)
            coords, colors = T.default_train_transform(coords, colors, rng)
        ic, f, l, p2v = voxelize_scene(coords, colors, labels, voxel_size)
        keep = min(len(ic), capacity - total)
        if keep < len(ic):
            ic, f, l = ic[:keep], f[:keep], l[:keep]
            p2v = np.where(p2v < keep, p2v, -1 - total)  # -1 after offset
        bc = np.concatenate([np.full((len(ic), 1), b, np.int32), ic], axis=1)
        all_c.append(bc)
        all_f.append(f)
        all_l.append(l)
        p2v_list.append(p2v + total)
        total += len(ic)
        if total >= capacity:
            break

    coords = np.zeros((capacity, 4), np.int32)
    feats = np.zeros((capacity, 3), np.float32)
    labels = np.full((capacity,), IGNORE_LABEL, np.int32)
    n = min(total, capacity)
    coords[:n] = np.concatenate(all_c)[:n]
    feats[:n] = np.concatenate(all_f)[:n]
    labels[:n] = np.concatenate(all_l)[:n]
    feats = feats / 127.5 - 1.0  # match stage-1 color convention
    valid = np.zeros(capacity, bool)
    valid[:n] = True
    return VoxelBatch(coords, feats, labels, valid, np.int32(n), p2v_list)
