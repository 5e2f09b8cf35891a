#!/usr/bin/env python3
"""Drive the PyTorch port (seggroup_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; build every kernel from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at edge cases; kernel and plain times (CUDA events);
  3. the main path at full width: stage-1 ins_infer over 4 bench-size
     synthetic scenes (150,528 points, 512 segment slots, 4,096 edge slots)
     through infer.infer_scenes, labels exported to a temporary directory,
     and one sem_infer; the kernels' launch counts are read around it;
  4. the same forward on a small scene at float32 on the card (kernel path)
     and on the CPU (plain path): integer outputs equal;
  5. a `kernels` JSON line, then the device line as the last line.

Needs one card. Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

SMALL = dict(num_points=2048, num_slots=64, num_edges=256,
             num_instances=6, segs_per_instance=6)
N_SCENES = 4
FPS_K = 64


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fps_cases(torch, dev):
    """(name, points, valid) on the card: the stage-1 call's shape with the
    bench scene's segment sizes as valid prefixes, the largest cap bucket,
    a P that is not a multiple of 32, tiny rows and duplicate points."""
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene

    g = torch.Generator().manual_seed(0)
    scene = make_synthetic_scene(seed=0, **BENCH_SCENE)
    counts = np.bincount(scene.point2seg, minlength=BENCH_SCENE["num_slots"])

    def rows(b, p, lengths):
        pts = torch.randn(b, p, 3, generator=g) * 2.0
        valid = torch.arange(p)[None, :] < torch.as_tensor(lengths)[:, None]
        return pts.to(dev), valid.to(dev)

    stage1 = rows(512, 1024, np.minimum(counts, 1024))
    big = rows(512, 16384, np.full(512, 16384))
    odd = rows(64, 1000, np.arange(64) * 16 % 1001)
    tiny = rows(64, 1024, np.arange(64) % 66)  # 0..65 valid: 1 and < k
    dup_pts, dup_valid = rows(64, 1024, np.full(64, 1024))
    dup_pts = torch.round(dup_pts * 2.0) / 2.0  # coarse grid: many equal points
    sparse = torch.rand(64, 1024, generator=g).to(dev) < 0.3
    return [("stage1", *stage1), ("cap16384", *big), ("p1000", *odd),
            ("tiny_rows", *tiny), ("duplicates", dup_pts, dup_valid),
            ("scattered_valid", dup_pts, sparse)]


def check_fps(torch, dev, card):
    from seggroup_tpu_torch.ops import cuda_fps
    from seggroup_tpu_torch.ops.fps import masked_fps_plain

    max_err = 0
    for name, pts, valid in fps_cases(torch, dev):
        got = cuda_fps.masked_fps_cuda(pts, valid, FPS_K)
        want = masked_fps_plain(pts, valid, FPS_K)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        print(f"K1 masked_fps {name} {tuple(pts.shape)} k={FPS_K}: "
              f"max |kernel - plain| = {err}", flush=True)
        if err != 0:
            raise AssertionError(f"K1 disagrees with its plain version on {name}")
        max_err = max(max_err, err)
        if name == "stage1":
            timed = (pts, valid)

    pts, valid = timed
    b, p, _ = pts.shape
    ms = cuda_ms(lambda: cuda_fps.masked_fps_cuda(pts, valid, FPS_K), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: masked_fps_plain(pts, valid, FPS_K), reps=3, warmup=1)
    n_valid = int(valid.sum())
    n_start_invalid = int((~valid[:, 0]).sum())
    # the bytes the function needs, each once: xyz (f32) of the valid
    # candidates and of candidate 0 of each row (the start), the whole valid
    # mask, and the output; k distance passes over the valid points at
    # 8 flops each (3 sub, 3 mul, 2 add)
    nbytes = 12 * (n_valid + n_start_invalid) + b * p + b * FPS_K * 4
    flops = 8 * FPS_K * n_valid
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    print(f"K1 masked_fps stage-1 shape ({b},{p}) k={FPS_K}, {n_valid} valid: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}) on {card}", flush=True)
    return {"name": "masked_fps", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/fps.cu",
            "replaces": "seggroup_tpu/ops/pallas_fps.py:26",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def run_main_path(torch, dev, card):
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.infer import infer_scenes
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.ops import cuda_fps

    scenes = [make_synthetic_scene(seed=i, **BENCH_SCENE).to(dev) for i in range(N_SCENES)]
    model = SegGroupGNN(cluster_cap=1024, knn_window=8192, knn_k=20, seed=0,
                        device=dev)
    t0 = time.perf_counter()
    model(scenes[0], mode="ins_infer")  # warm-up
    torch.cuda.synchronize()
    print(f"main path warm-up forward: {time.perf_counter() - t0:.3f} s", flush=True)

    phases: dict[str, float] = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as results:
        cuda_fps.launches = 0
        t0 = time.perf_counter()
        outs = infer_scenes(model, scenes, mode="ins_infer", results_root=results,
                            phase_seconds=phases)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sem_out = infer_scenes(model, scenes[:1], mode="sem_infer")[0]
        torch.cuda.synchronize()
        launches = {"masked_fps": cuda_fps.launches}
        written = sorted(os.listdir(os.path.join(results, "scene_0000", "ins_infer")))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    forwards = N_SCENES + 1
    if launches["masked_fps"] < forwards:
        raise AssertionError(f"K1 launched {launches['masked_fps']} times in "
                             f"{forwards} forwards")
    n = BENCH_SCENE["num_points"]
    for out in outs + [sem_out]:
        if int(out.max_segment_size) > 1024 or int(out.max_cluster_size) > 8192:
            raise AssertionError("a cap bound: the exact path did not run")
        for name in ("final_root", "final_sem", "final_ins", "sem_layer2"):
            if tuple(getattr(out, name).shape) != (n,):
                raise AssertionError(f"{name} has shape {tuple(getattr(out, name).shape)}")
        if not (torch.isfinite(out.iou_sem).all() and torch.isfinite(out.acc).all()):
            raise AssertionError("non-finite metrics")
    for i, out in enumerate(outs):
        valid = scenes[i].point2seg < BENCH_SCENE["num_slots"]
        if not bool((out.final_ins[valid] > 0).all()):
            raise AssertionError(f"scene {i}: a valid point ends without an instance")
        if not bool(((out.final_sem[valid] >= 1) & (out.final_sem[valid] <= 40)).all()):
            raise AssertionError(f"scene {i}: final_sem out of 1..40")
    if len(written) != 15:
        raise AssertionError(f"exported {written}")

    per_scene = wall / N_SCENES
    forward = (wall - phases.get("export", 0.0)) / N_SCENES
    rest = forward - sum(v for k, v in phases.items() if k != "export") / N_SCENES
    split = ", ".join(f"{k} {v / N_SCENES:.3f} s" for k, v in sorted(phases.items()))
    print(f"stage-1 ins_infer at {n} points, {BENCH_SCENE['num_slots']} slots, "
          f"{BENCH_SCENE['num_edges']} edges (bf16): {per_scene:.3f} s/scene with the "
          f"label export, forward {forward:.3f} s/scene = {n / forward:.1f} points/s; "
          f"per scene: {split}, rest of the forward {rest:.3f} s; "
          f"peak {peak_gib:.2f} GiB; acc(sem,ins) scene 0 = "
          f"{float(outs[0].acc[0]):.4f}, {float(outs[0].acc[1]):.4f}; on {card}",
          flush=True)
    print(f"main path launches over {forwards} forwards: {launches}", flush=True)
    return launches


def card_vs_cpu(torch, dev):
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    scene = make_synthetic_scene(seed=3, **SMALL)
    kw = dict(cluster_cap=2048, knn_window=2048, compute_dtype=torch.float32, seed=1)
    on_card = SegGroupGNN(device=dev, **kw)
    on_cpu = SegGroupGNN(device="cpu", **kw)
    for mode in ("ins_infer", "sem_infer"):
        a = on_card(scene.to(dev), mode=mode)
        b = on_cpu(scene.to("cpu"), mode=mode)
        for name in a._fields:
            x, y = getattr(a, name).cpu(), getattr(b, name)
            if x.dtype.is_floating_point:
                # float sums run in another order on the card (atomics,
                # cuBLAS): a tolerance, not equality
                if not torch.allclose(x, y, rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"{mode} {name}: card vs CPU differ "
                                         f"by {float((x - y).abs().max())}")
            elif not torch.equal(x, y):
                raise AssertionError(f"{mode} {name}: card vs CPU differ at "
                                     f"{int((x != y).sum())} entries")
        print(f"card vs CPU, {mode} at N=2048 float32: integer fields equal, "
              f"float fields within 1e-5", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from seggroup_tpu_torch.device import card_description
    from seggroup_tpu_torch.ops import cuda_fps

    dev = torch.device("cuda", 0)
    card = card_description()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib, log = cuda_fps.build()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "ptxas info" in line:
            print("  " + line.strip(), flush=True)

    k1 = check_fps(torch, dev, card)
    launches = run_main_path(torch, dev, card)
    card_vs_cpu(torch, dev)

    k1["launches"] = launches["masked_fps"]
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
