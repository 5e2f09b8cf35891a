"""Profile one forward of a main path at the bench size on the card.

    python -m seggroup_tpu_torch.profile_forward [--path stage1|stage2] [--seed 0] [--top 15]

stage1: SegGroupGNN ins_infer on a bench scene (150,528 points).
stage2: Res16UNet34C on a bench scene voxelised at 2 cm into 2^17 voxels
(the stage-2 semantic evaluation's forward; random weights from the seed).

Prints the forward's wall seconds with and without the profiler, the summed
device kernel time, the device's busy share (kernel time over the wall time
without the profiler, which does not inflate it, and over the profiled wall
time), the number of kernel launches, and the kernels that take the most
device time; the last line is the same as one JSON object."""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
from seggroup_tpu_torch.device import card_description, resolve_device


def _stage1(seed: int, dev):
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    scene = make_synthetic_scene(seed=seed, **BENCH_SCENE).to(dev)
    model = SegGroupGNN(device=dev)
    return (lambda: model(scene, mode="ins_infer"),
            f"stage-1 ins_infer forward, {BENCH_SCENE['num_points']} points")


def _stage2(seed: int, dev):
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    capacity = 2 ** 17
    c, col, lab = scene_to_training_tuple(make_synthetic_scene(seed=seed, **BENCH_SCENE),
                                          {}, None, "", False)
    vb = make_voxel_batch([(c, col, lab)], capacity, 0.02)
    st = SparseTensor(*(torch.from_numpy(x) for x in (vb.coords, vb.feats, vb.valid)),
                      torch.tensor(int(vb.num))).to(dev)
    model = make_minkunet("Res16UNet34C", level_caps=level_caps(capacity), seed=seed,
                          device=dev)
    return (lambda: model(st),
            f"stage-2 Res16UNet34C forward, {int(vb.num)} voxels of capacity {capacity}")


def _seconds(forward) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["stage1", "stage2"], default="stage1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    card = card_description()
    forward, what = {"stage1": _stage1, "stage2": _stage2}[args.path](args.seed, dev)
    _seconds(forward)  # warm-up
    plain_s = _seconds(forward)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = _seconds(forward)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{what}, on {card}")
    print(f"wall {plain_s:.4f} s without the profiler, {profiled_s:.4f} s with it")
    device_s = device_us / 1e6
    print(f"device kernel time {device_s:.4f} s over {launches} launches; "
          f"busy share {device_s / plain_s:.4f} of the wall time without the "
          f"profiler, {device_s / profiled_s:.4f} of the profiled wall time")
    top = []
    for e in kernels[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  {e.key[:100]}")
        top.append({"kernel": e.key[:100], "ms": e.self_device_time_total / 1e3,
                    "count": e.count})
    print(json.dumps({"card": card, "path": args.path, "wall_s": plain_s,
                      "profiled_wall_s": profiled_s, "device_s": device_s,
                      "busy_share": device_s / plain_s, "launches": launches, "top": top}))


if __name__ == "__main__":
    main()
