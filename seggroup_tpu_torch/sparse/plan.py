"""Pyramid plans built on the host (seggroup_tpu/sparse/plan.py).

A plan holds, for a U-Net of L stride-2 steps, the L + 1 levels' kernel-3
rulebooks, the L down maps and, where a level takes them, the window
layouts. The host knows the voxel coordinates when it assembles a batch,
so the native library (native.subm_rulebook3, native.downsample_plan,
native.subm_windows) builds them there, beside the card's work; the card
builds the same plan with sparse/device_plan.py. A model given a plan
skips every rulebook and down-map build and computes what it computes
without one (`plan=None`)."""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch import native
from seggroup_tpu_torch.sparse.conv import TILE, WINDOW, takes_windows


def build_unet_plan(coords: np.ndarray, num: int, level_caps: Sequence[int],
                    with_windows: bool = True, window_levels: int | None = None) -> dict:
    """coords: (cap0, 4) int32 (b, x, y, z) with the first `num` rows valid,
    in lexicographic order; level_caps: the L + 1 levels' capacities
    (MinkUNet 5, PointGroup 7).

    Returns a dict of numpy arrays:
      rulebooks: L + 1 (cap_l, 27) int32 kernel-3 rulebooks;
      down: L dicts of coords (cap_{l+1}, 4), num (), out_row (cap_l,),
            delta (cap_l,), the inputs of strided_conv_down_planned;
      windows (with `with_windows`): L + 1 entries, {"rb_win", "win_base",
            "use_window"} (sparse/conv.TILE and WINDOW) for a level whose
            capacity takes them (`takes_windows`), None for the others and
            for levels from `window_levels` on; use_window is False where a
            neighbour did not fit its window."""
    coords = np.ascontiguousarray(coords, np.int32)
    num = int(num)
    rulebooks = [native.subm_rulebook3(coords, num, len(coords))]
    down = []
    cur, n = coords, num
    for cap_out in level_caps[1:]:
        out_c, m, out_row, delta = native.downsample_plan(cur, n, cap_out)
        down.append({"coords": out_c, "num": np.int32(m), "out_row": out_row,
                     "delta": delta})
        rulebooks.append(native.subm_rulebook3(out_c, m, cap_out))
        cur, n = out_c, m
    plan = {"rulebooks": rulebooks, "down": down}
    if with_windows:
        windows = []
        for lvl, rb in enumerate(rulebooks):
            if (window_levels is not None and lvl >= window_levels) \
                    or not takes_windows(len(rb)):
                windows.append(None)
                continue
            base, rb_win, ovf = native.subm_windows(rb, TILE, WINDOW)
            windows.append({"rb_win": rb_win, "win_base": base,
                            "use_window": np.bool_(ovf == 0)})
        plan["windows"] = windows
    return plan


def plan_to_device(plan, device: str | torch.device):
    """The plan's arrays as tensors on `device` (None entries kept)."""
    if plan is None:
        return None
    if isinstance(plan, dict):
        return {k: plan_to_device(v, device) for k, v in plan.items()}
    if isinstance(plan, (list, tuple)):
        return [plan_to_device(v, device) for v in plan]
    return torch.as_tensor(np.asarray(plan)).to(device)
