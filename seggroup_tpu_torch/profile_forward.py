"""Profile one forward, or one train step, of a main path at the bench size
on the card.

    python -m seggroup_tpu_torch.profile_forward [--path stage1|stage2|train|pointgroup]
        [--seed 0] [--top 15]

stage1: SegGroupGNN ins_infer on a bench scene (150,528 points).
stage2: Res16UNet34C on a bench scene voxelised at 2 cm into 2^17 voxels
(the stage-2 semantic evaluation's forward; random weights from the seed).
train: one Res16UNet34C train step (cli/stage2_train_minkunet.train_step:
forward with BatchNorm batch statistics, backward through K2 and K3, SGD
lr 0.1 PolyLR) on an augmented batch of bench scenes at 2^17 voxels, as the
training driver builds it at its defaults (batch size 8).
pointgroup: one PointGroup forward with clustering at the evaluation
CLI's defaults (m=16, 2^17 points, 2^16 voxels, radius 0.03; random
weights from the seed) on a bench scene, its device time grouped into K2,
K4, sorts and searches, reductions, elementwise kernels and the rest.

Prints the wall seconds with and without the profiler, the summed device
kernel time, the device's busy share (kernel time over the wall time
without the profiler, which does not inflate it, and over the profiled wall
time), the number of kernel launches, the kernels that take the most device
time, and the device time by group (K2, K3, other GEMMs, sum reductions,
the up convs' index backward, rulebook sorts and searches, the rest); for
the train step K2's time is split into the forward's (a forward profiled
alone) and the data gradient's. The last line is the same as one JSON
object."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
from seggroup_tpu_torch.device import card_description, resolve_device


def _stage1(seed: int, dev):
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    scene = make_synthetic_scene(seed=seed, **BENCH_SCENE).to(dev)
    model = SegGroupGNN(device=dev)
    return (lambda: model(scene, mode="ins_infer"),
            f"stage-1 ins_infer forward, {BENCH_SCENE['num_points']} points", None)


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
    def forward():
        with torch.no_grad():
            return model(st)

    return (forward,
            f"stage-2 Res16UNet34C forward, {int(vb.num)} voxels of capacity {capacity}", None)


def _train(seed: int, dev):
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import (batch_to_device,
                                                              make_train_batch, train_step)
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    capacity = 2 ** 17
    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None,
                                      "", False) for i in range(8)]
    vb = make_train_batch(scenes.__getitem__, range(8), 1, seed, 8, capacity, 0.02, True)
    st, labels = batch_to_device(vb, dev)
    model = make_minkunet("Res16UNet34C", level_caps=level_caps(capacity), seed=seed,
                          device=dev)
    optimizer, scheduler = make_optimizer(
        "SGD", model.parameters(), make_schedule("PolyLR", 0.1, max_iter=60000))

    def forward_alone():
        with torch.no_grad():
            model(st, train=True)

    return (lambda: train_step(model, optimizer, scheduler, st, labels),
            f"stage-2 Res16UNet34C train step, {int(vb.num)} voxels of capacity {capacity}",
            forward_alone)


def _pointgroup(seed: int, dev):
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import (make_pg_batch,
                                                                 scene_instance_tuple)
    from seggroup_tpu_torch.cli.stage2_test_pointgroup import make_eval_model
    from seggroup_tpu_torch.ops.voxelize import voxel_gather_mean, voxelize
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    point_cap, voxel_cap = 2 ** 17, 2 ** 16
    scene = scene_instance_tuple(make_synthetic_scene(seed=seed, **BENCH_SCENE), {}, None, "")
    hb = make_pg_batch([scene], point_cap, 256)
    ic = np.floor(hb.coords / 0.02).astype(np.int32)
    ic -= ic.min(0)
    pts, batch_ids, valid = (torch.from_numpy(x).to(dev)
                             for x in (hb.coords, hb.batch_ids, hb.valid))
    vm = voxelize(torch.from_numpy(ic).to(dev), batch_ids, valid, voxel_cap)
    feats = torch.cat([torch.from_numpy(hb.feats).to(dev), pts], dim=1)
    st = SparseTensor(vm.voxel_coords, voxel_gather_mean(feats, vm), vm.voxel_valid,
                      vm.num_voxels)
    model = make_eval_model(16, voxel_cap, dev, seed=seed)

    def forward():
        with torch.no_grad():
            return model(st, vm.point2voxel, pts, batch_ids, valid, do_clustering=True)

    return (forward, f"PointGroup forward with clustering, {int(hb.valid.sum())} points, "
            f"{min(int(vm.num_voxels), voxel_cap)} voxel rows of {int(vm.num_voxels)} voxels",
            None)


# kernel-name fragments of each group of the train step's device time
# K2's two passes: the weights into K-major order, and the gather-GEMM
# (subm_gather_gemm and its warp-specialised form subm_gather_gemm_ws)
K2_KERNELS = ("subm_conv_weights_k_major", "subm_gather_gemm")
GROUPS = (("K2 subm_conv", K2_KERNELS),
          ("K3 subm_dw", ("subm_dw_compact", "subm_dw_gemm", "sum_slabs")),
          ("other GEMMs", ("gemm", "cutlass", "sm90_xmma", "cublas", "splitK")),
          ("sum reductions (BatchNorm, loss)", ("reduce_kernel",)),
          ("index backward (up-conv gathers)", ("indexing_backward",)),
          ("rulebook sorts and searches", ("sort", "radix", "search", "bucketize")))
# ... and of the PointGroup forward's
GROUPS_POINTGROUP = (("K2 subm_conv", K2_KERNELS),
                     ("K4 cc_sweep", ("cc_sweep_kernel",)),
                     ("GEMMs", ("gemm", "cutlass", "sm90_xmma", "cublas", "splitK")),
                     ("sorts and searches", ("sort", "radix", "search", "bucketize")),
                     ("reductions and scatters", ("reduce_kernel", "scatter", "index_put",
                                                  "indexFuncLargeIndex", "scan")),
                     ("elementwise", ("elementwise", "CatArrayBatchedCopy", "index_elementwise",
                                      "gather")))


def _kernels(prof):
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k.lower() in low for k in keys):
            return group
    return "rest"


def _seconds(forward) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["stage1", "stage2", "train", "pointgroup"],
                    default="stage1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    card = card_description()
    forward, what, forward_alone = {"stage1": _stage1, "stage2": _stage2, "train": _train,
                                    "pointgroup": _pointgroup}[args.path](args.seed, dev)
    group_keys = GROUPS_POINTGROUP if args.path == "pointgroup" else GROUPS
    _seconds(forward)  # warm-up
    plain_s = _seconds(forward)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = _seconds(forward)

    kernels = _kernels(prof)
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
    groups: dict[str, list] = {}
    for e in kernels:
        g = groups.setdefault(_group(e.key, group_keys), [0.0, 0])
        g[0] += e.self_device_time_total / 1e3
        g[1] += e.count
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {name}: {ms:.3f} ms in {count} launches")
    if forward_alone is not None:
        # K2 serves the forward and the data gradient under one name: a
        # profile of the forward alone splits its time
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as fprof:
            _seconds(forward_alone)
        fwd = [e for e in _kernels(fprof) if any(k in e.key for k in K2_KERNELS)]
        k2_ms = sum(e.self_device_time_total for e in fwd) / 1e3
        k2_n = sum(e.count for e in fwd)
        total_ms, total_n = groups.get("K2 subm_conv", [0.0, 0])
        print(f"  of K2: forward {k2_ms:.3f} ms in {k2_n} launches (profiled alone), data "
              f"gradient {total_ms - k2_ms:.3f} ms in {total_n - k2_n} launches")
        groups["K2 forward (profiled alone)"] = [k2_ms, k2_n]
    print(json.dumps({"card": card, "path": args.path, "wall_s": plain_s,
                      "profiled_wall_s": profiled_s, "device_s": device_s,
                      "busy_share": device_s / plain_s, "launches": launches, "top": top,
                      "groups": {k: {"ms": v[0], "launches": v[1]} for k, v in groups.items()}}))


if __name__ == "__main__":
    main()
