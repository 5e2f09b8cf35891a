"""Pyramid plans built on the device, and the compact wire format of a
voxel batch (seggroup_tpu/sparse/device_plan.py).

`build_unet_plan_device` builds, from nothing but the lexicographically
sorted voxel coordinates, the same plan as the host's `build_unet_plan`
(sparse/plan.py): the same rulebooks, down maps, window layouts and
`use_window` flags, bit for bit. So a batch travels as coordinates,
features and labels (`pack_voxel_batch`: int16, float16, uint8) and the
plan is made where it is used. The rulebooks take the merge-join path
(`build_subm_rulebook(assume_sorted=True)`), the down maps the device's
lexsort."""

from __future__ import annotations

import numpy as np
import torch

from seggroup_tpu_torch.sparse.conv import (TILE, WINDOW, build_subm_rulebook,
                                            downsample_coords, takes_windows)
from seggroup_tpu_torch.sparse.tensor import SparseTensor

WIRE_COORD_LIMIT = 32000  # int16 coordinates, with room to spare


def pack_voxel_batch(vb) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.int32]:
    """The compact wire of a VoxelBatch: (coords int16, feats float16,
    labels uint8, num int32). `valid` does not travel: make_voxel_batch
    puts the valid rows first, so it is arange(cap) < num. Raises on
    coordinates at or beyond +-32,000 and on labels outside uint8."""
    coords = np.asarray(vb.coords)
    if abs(int(coords.max(initial=0))) >= WIRE_COORD_LIMIT or \
            int(coords.min(initial=0)) <= -WIRE_COORD_LIMIT:
        raise ValueError("voxel coords exceed int16 wire range; use the "
                         "host-plan path (--plan_mode host)")
    labels = np.asarray(vb.labels)
    if labels.max(initial=0) > 255 or labels.min(initial=0) < 0:
        raise ValueError("labels exceed uint8 wire range")
    return (coords.astype(np.int16), np.asarray(vb.feats).astype(np.float16),
            labels.astype(np.uint8), np.int32(vb.num))


def unpack_voxel_batch(coords16, feats16, labels8, num,
                       device: str | torch.device) -> tuple[SparseTensor, torch.Tensor]:
    """The inverse of pack_voxel_batch on `device`: (SparseTensor with
    float32 features, labels int32)."""
    def dev(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    coords = dev(coords16).to(torch.int32)
    cap = coords.shape[0]
    n = int(num)
    st = SparseTensor(coords, dev(feats16).to(torch.float32),
                      torch.arange(cap, device=coords.device) < n,
                      torch.tensor(n, dtype=torch.int32, device=coords.device))
    return st, dev(labels8).to(torch.int32)


def build_windows_device(rulebook: torch.Tensor, tile: int = TILE,
                         window: int = WINDOW) -> dict:
    """native.subm_windows on the device: per (tile, dx/dy group) a
    16-aligned window base and the window-local, dz-block-interleaved
    indices. Returns {"rb_win", "win_base", "use_window"}, use_window a
    bool tensor (False where a present neighbour did not fit its window)."""
    m = rulebook.shape[0]
    n_tiles = m // tile
    rb = rulebook.to(torch.int32)
    rb4 = rb.reshape(n_tiles, tile, 9, 3)
    present = rb4 < m
    lo = torch.where(present, rb4, m).amin(dim=(1, 3))  # (n_tiles, 9)
    base = torch.where(lo == m, 0, lo & ~15).to(torch.int32)
    d = rb4 - base[:, None, :, None]
    fits = present & (d >= 0) & (d < window)
    local = torch.where(fits, d, window).to(torch.int32)
    use_window = ~torch.any(present & ~fits)
    rb_win = local.permute(0, 3, 1, 2).reshape(3 * m, 9).contiguous()
    return {"rb_win": rb_win, "win_base": base, "use_window": use_window}


def build_unet_plan_device(coords: torch.Tensor, num, level_caps,
                           with_windows: bool = True, window_levels: int | None = None,
                           xy_bits: tuple[int, int] = (14, 14)) -> dict:
    """sparse/plan.build_unet_plan on the device of `coords` ((cap0, 4)
    int32 in lexicographic order, the first `num` rows valid): the same
    plan, as tensors on that device."""
    caps = tuple(int(c) for c in level_caps)
    assert coords.shape[0] == caps[0], (coords.shape, caps)
    dev = coords.device
    num = torch.as_tensor(num, dtype=torch.int32, device=dev)
    coords = coords.to(torch.int32)
    valid = torch.arange(caps[0], device=dev) < num
    st = SparseTensor(coords, torch.zeros((caps[0], 1), device=dev), valid, num)
    rulebooks = [build_subm_rulebook(st, assume_sorted=True, xy_bits=xy_bits)]
    down = []
    cur = st
    for cap_out in caps[1:]:
        # halving breaks the lexicographic order, so the down map sorts; its
        # output is sorted and unique, so the next rulebook needs no sort
        out_c, valid_out, m_out, out_row, delta = downsample_coords(cur, cap_out)
        down.append({"coords": out_c,
                     "num": torch.clamp(m_out, max=cap_out).to(torch.int32),
                     "out_row": out_row, "delta": delta})
        cur = SparseTensor(out_c, torch.zeros((cap_out, 1), device=dev), valid_out, m_out)
        rulebooks.append(build_subm_rulebook(cur, assume_sorted=True, xy_bits=xy_bits))
    plan = {"rulebooks": rulebooks, "down": down}
    if with_windows:
        plan["windows"] = [
            build_windows_device(rb) if (window_levels is None or lvl < window_levels)
            and takes_windows(rb.shape[0]) else None
            for lvl, rb in enumerate(rulebooks)]
    return plan
