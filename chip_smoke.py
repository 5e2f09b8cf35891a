#!/usr/bin/env python3
"""Drive the PyTorch port (seggroup_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; build every kernel from csrc/ (one
     nvcc per source, all started together);
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at edge cases; kernel, plain and library times (CUDA
     events) beside each kernel's bound; K2 timed a call back to back, as
     every kernel is, and beside it with its launches queued behind a spin
     (the card's time without the host's), at every pair of Res16UNet34C
     and of its data gradient, on a bench scene's level 0 and level 3, with
     whole row tiles lacking every offset and with a 5^3 kernel; K2's
     register and spill counts from the build, no spill allowed;
  3. the stage-1 path at full width: ins_infer over 4 bench-size synthetic
     scenes (150,528 points, 512 segment slots, 4,096 edge slots) through
     infer.infer_scenes, labels exported to a temporary directory, and one
     sem_infer; K1's launch count is read around it;
  4. the same forward on a small scene at float32 on the card (kernel path)
     and on the CPU (plain path): integer outputs equal;
  5. the stage-2 path at full width: Res16UNet34C semantic inference over 4
     bench-size scenes voxelised at 2 cm into 2^17 voxels, through
     cli.stage2_test_semantic.test_semantic_minkunet; K2's launch count is
     read around it;
  6. MinkUNet on a small input on the card (K2) and on the CPU (plain):
     rulebooks and downsample maps equal, logits within tolerance;
  7. the stage-2 training path at full width: Res16UNet34C train steps at
     2^17 voxels, batch size 8, SGD lr 0.1 PolyLR, augmented batches of 8
     bench-size scenes built by the host prefetcher, through
     cli.stage2_train_minkunet.train_step; K2's and K3's launch counts are
     read around the timed steps (47 K3 and 93 K2 launches per step);
  8. Res16UNet14A on the card (K2, K3) and on the CPU (plain): one train
     step at 2^14 and at 2,048 rows (loss, gradients and running
     statistics within tolerance) and one backward through the
     running-statistics forward at 2^14 rows (each gradient tensor held on
     its own); then 30 steps on one fixed batch on the card, whose loss
     must fall;
  9. K4, the radius-graph connected-components sweep, against its plain
     version (labels exactly equal after one sweep and at the fixpoint,
     bit-equal across two runs) on the doubled point set of a full-width
     PointGroup forward, on a bench scene clustered on its true labels, and
     on edge cases; `semantic_radius_cc` on the card against the CPU; K2
     against its plain version at every PointGroup (Cin, Cout), K = 27 and
     K = 1;
 10. the PointGroup path at full width: instance-segmentation inference
     over 4 bench-size scenes at the evaluation CLI's defaults (m=16,
     2^17 points, 2^16 voxels, radius 0.03) through
     cli.stage2_test_pointgroup.test_instance_pointgroup; K2's and K4's
     launch counts are read around it, at least one K4 launch per forward;
     then the clustering and the ScoreNet on the true labels of a scene;
 11. PointGroup at a small size on the card and on the CPU: heads within
     tolerance, clustering exactly equal at shared heads, scores within
     tolerance at a shared voxel map;
 12. a `kernels` JSON line, the card line, then the device line as the last.

Needs one card. Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import json
import os
import platform
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

SMALL = dict(num_points=2048, num_slots=64, num_edges=256,
             num_instances=6, segs_per_instance=6)
N_SCENES = 4
FPS_K = 64
# stage 2: the semantic evaluation CLI's defaults (cli/stage2_test_semantic.py)
CAPACITY = 2 ** 17
VOXEL = 0.02
SUBM_PER_FORWARD = 47  # Res16UNet34C: stem 1, encoder 30, decoder 16
# every (Cin, Cout) of Res16UNet34C's submanifold convs
K2_PAIRS = [(3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256),
            (256, 256), (384, 256), (192, 128), (128, 96), (96, 96)]
# the (Cout, Cin) K2 runs at for the data gradient (none for the stem,
# whose input needs no gradient)
K2_DGRAD_PAIRS = list(dict.fromkeys((co, ci) for ci, co in K2_PAIRS if ci != 3))
K2_TIMED = (384, 256)  # the widest pair: the one the kernels line reports
K2_RTOL = 1e-4  # of max|plain|: only the order of the float32 sums differs
# K2's device time: launches queued behind a spin of this many cycles
# (about 10 ms)
SPIN_CYCLES = 20_000_000
K3_RTOL = 1e-4  # of max|plain|: the same, over sums as long as M
# stage-2 training: the training driver's defaults (cli/stage2_train_minkunet.py)
TRAIN_BATCH, TRAIN_POOL, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_FENCED = 8, 8, 2, 10, 3
K2_PER_STEP = 2 * SUBM_PER_FORWARD - 1  # forward, and the data gradient but the stem's
# card vs CPU train step: the bounds tests/test_torch_minkunet_train.py holds
# the port's bf16 step to against JAX (bf16 gradients through batch
# statistics are chaotic: the reference's own bf16 and float32 gradients
# differ by 0.23 in relative L2 norm)
STEP_LOSS_ATOL, STAT_ATOL, STAT_RTOL = 1e-3, 1e-4, 1e-3
GRAD_REL_L2, HEAD_GRAD_RTOL = 0.3, 2e-2
# each gradient tensor of a backward through running statistics at 2^14
# rows: its max |card - CPU| / max|CPU| at most GRAD_OVER_BF16 times (what
# bf16 itself moves that tensor by on the CPU, against float32 convs, plus
# GRAD_FLOOR). The card and the CPU round the same operands to bf16 and
# differ only in the order of the float32 sums; measured at most 0.968 of
# that reading on an H100 (a fault confined to the (32, 32) convs' data
# gradient scores 6 or more, one in the stem's weight gradient about 90)
GRAD_OVER_BF16, GRAD_FLOOR = 1.5, 1e-2
OVERFIT_STEPS = 30
# MinkUNet card vs CPU: the tolerance tests/test_torch_minkunet.py holds the
# port to against JAX (bf16 products, float32 sums in another order)
LOGIT_ATOL, LOGIT_RTOL, ARGMAX_AGREE = 2e-4, 1e-3, 0.99
# PointGroup: the evaluation CLI's defaults (cli/stage2_test_pointgroup.py)
PG_M, PG_POINT_CAP, PG_VOXEL_CAP, PG_RADIUS = 16, 2 ** 17, 2 ** 16, 0.03
# submanifold convs per forward: the U-Net's stem, 4 per level in its 2 blocks
# and 5 in its 2 tail blocks (the first has the K=1 branch) below the top of
# 6 levels; the 2-level ScoreNet 2 * 4 + 5
PG_SUBM_PER_FORWARD = (1 + 7 * 4 + 6 * 5) + (2 * 4 + 5)
# every (Cin, Cout) of PointGroup's K=27 submanifold convs at m=16, and of the
# K=1 branch of the first block after each concatenation
PG_PAIRS = ([(6, 16)] + [(16 * i, 16 * i) for i in range(1, 8)]
            + [(32 * i, 16 * i) for i in range(1, 7)])
PG_K1_PAIRS = [(32 * i, 16 * i) for i in range(1, 7)]


def machine_id(torch) -> str:
    """What tells one machine from another beside a host-bound time: the
    host's name and the card's UUID."""
    uuid = getattr(torch.cuda.get_device_properties(0), "uuid", "unknown")
    return f"host {platform.node()}, card {uuid}"


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


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over `reps` calls queued behind a
    spin on the card, so that the host's time to launch them is hidden and
    the card runs them back to back (CUDA events around them)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_each(fn, reps: int, warmup: int = 2) -> list[float]:
    """Device milliseconds of each of `reps` calls (one CUDA event pair per
    call), for a minimum and a median beside the mean."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


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


def k2_sites(torch, dev, m: int, kernel: int = 3):
    """A dense voxel set: each of two batch ids holds a random half of a
    51^3 grid, in the voxeliser's sorted order, cut to m rows; its rulebook
    for a cube of `kernel` built on the card (about 13 present neighbours
    per site at kernel 3)."""
    from seggroup_tpu_torch.sparse.conv import build_subm_rulebook
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    rng = np.random.default_rng(0)
    g = 51
    parts = []
    for b in (0, 1):
        cells = np.sort(rng.permutation(g ** 3)[: g ** 3 // 2])
        xyz = np.stack(np.unravel_index(cells, (g, g, g)), 1)
        parts.append(np.concatenate([np.full((len(xyz), 1), b), xyz], 1))
    coords = torch.from_numpy(np.concatenate(parts)[:m].astype(np.int32)).to(dev)
    st = SparseTensor(coords, torch.zeros((m, 1), device=dev),
                      torch.ones(m, dtype=torch.bool, device=dev),
                      torch.tensor(m, dtype=torch.int32, device=dev))
    return build_subm_rulebook(st, kernel)


def bench_rulebooks(torch, dev):
    """The level-0 and level-3 rulebooks that Res16UNet34C builds for bench
    scene 0 voxelised at 2 cm into 2^17 rows (the capacity binds at level
    0; level 3 holds 16,384 rows, padding rows among them), built on the
    card."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_to_device
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.sparse.conv import build_subm_rulebook, downsample_coords
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    scene = scene_to_training_tuple(make_synthetic_scene(seed=0, **BENCH_SCENE), {}, None,
                                    "", False)
    st, _ = batch_to_device(make_voxel_batch([scene], CAPACITY, VOXEL), dev)
    rb0 = build_subm_rulebook(st, 3)
    caps = level_caps(CAPACITY)
    for lvl in range(3):
        coords, valid, num = downsample_coords(st, caps[lvl + 1])[:3]
        st = SparseTensor(coords, torch.zeros((caps[lvl + 1], 1), device=dev), valid, num)
    rb3 = build_subm_rulebook(st, 3)
    return [(rb0, " bench level 0"),
            (rb3, f" bench level 3 ({int(st.valid.sum())} valid rows)")]


def k2_build_lines(log: str) -> list[tuple[str, int, int]]:
    """(function, registers, spill bytes) of each K2 function in nvcc's
    -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif name and "spill stores" in line:
            words = line.split()
            spill = int(words[words.index("spill") - 2]) + int(words[-4])
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            out.append((name, int(words[words.index("Used") + 1]), spill))
            name = None
    return out


def k2_case(torch, f, w, rb, note, card, timed=True):
    """One K2 case: held against its plain version (K2_RTOL of max|plain|,
    finite, rows without neighbours exactly 0, bit-equal across two runs),
    then, when `timed`, timed a call back to back (`ms`, as every kernel)
    and behind a spin (`device_ms`) beside its plain version, the
    pre-gathered matmul and the bound. Returns the largest error and the
    times."""
    from seggroup_tpu_torch.sparse import cuda_subm_conv
    from seggroup_tpu_torch.sparse.conv import subm_conv_plain

    rows, kvol = rb.shape
    cin, cout = w.shape[1], w.shape[2]
    got = cuda_subm_conv.subm_conv_cuda(f, w, rb)
    again = cuda_subm_conv.subm_conv_cuda(f, w, rb)
    want = subm_conv_plain(f, w, rb, torch.bfloat16)
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    present = int((rb < rows).sum())
    tile_offsets = float(cuda_subm_conv.present_offsets_plain(rb).sum()) / -(-rows // 128)
    p = cuda_subm_conv.plan(cin, cout, kvol, rows)
    line = (f"K2 {cuda_subm_conv.regime(cin)} ({cin},{cout}) K={kvol}{note}: max |kernel - "
            f"plain| = {err:.3e} = {err / scale:.2e} of max|plain| ({present / rows:.2f} "
            f"present neighbours per row, {tile_offsets:.2f} present offsets per 128-row "
            f"tile; N tile {p.n} x {p.n_tiles}, {p.stages} stages"
            f"{', warp-specialised' if p.ws else ''}{', no weights pass' if p.direct else ''})")
    if err > K2_RTOL * scale or not torch.isfinite(got).all():
        raise AssertionError(line)
    if not (got[(rb == rows).all(1)] == 0).all():
        raise AssertionError(f"{line}: a row with no neighbour is not zero")
    if not torch.equal(got, again):
        raise AssertionError(f"{line}: two runs on the same inputs differ")
    del got, again
    if not timed:
        print(line + "; bit-equal across two runs", flush=True)
        return err, None
    call = lambda: cuda_subm_conv.subm_conv_cuda(f, w, rb)  # noqa: E731
    ms, dev_ms = cuda_ms(call, reps=30, warmup=3), device_ms(call, reps=30, warmup=3)
    plain_ms = cuda_ms(lambda: subm_conv_plain(f, w, rb, torch.bfloat16), reps=3, warmup=1)
    a = torch.cat([f, f.new_zeros(1, cin)])[rb.long()].reshape(rows, kvol * cin)
    b = w.reshape(kvol * cin, cout)
    library_ms = cuda_ms(lambda: torch.matmul(a, b), reps=20, warmup=2)
    del a
    # the bytes K2 must move (bf16 feats and weights, int32 rulebook, f32
    # output), and 2*Cin*Cout operations per present pair
    nbytes = rows * cin * 2 + rows * kvol * 4 + kvol * cin * cout * 2 + rows * cout * 4
    flops = 2 * present * cin * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"{line}; bit-equal across two runs; kernel {ms:.4f} ms a call back to back, "
          f"{dev_ms:.4f} ms behind a spin, plain {plain_ms:.3f} ms, library {library_ms:.4f} "
          f"ms, bound {bound:.4f} ms ({by}); {flops / dev_ms / 1e9:.1f} TFLOP/s on {card}",
          flush=True)
    return err, dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound, bound_by=by)


def check_subm_conv(torch, dev, card, bench):
    """K2 against its plain version in bf16 at every (Cin, Cout) of
    Res16UNet34C and of its data gradient, on 131,072 dense sites, plus rows
    with no neighbour, a ragged M, whole 128-row tiles without any offset,
    a 5^3 kernel (K = 125), and a bench scene's level-0 and level-3
    rulebooks; each case run twice and required bit-equal; each case but
    the first two edge cases timed beside the plain version, the
    pre-gathered matmul and the bound."""
    m = CAPACITY
    rb_full = k2_sites(torch, dev, m)
    rb_lonely = rb_full.clone()
    rb_lonely[::7] = m  # every 7th row: all 27 neighbours absent
    rb_ragged = k2_sites(torch, dev, m - 13)  # not a multiple of the row tile
    rb_holes = rb_full.clone()
    rb_holes[128 * 40:128 * 200] = m  # 160 whole row tiles without any offset
    rb_holes[128 * 300:128 * 301, :26] = m  # a tile with the last offset alone
    rb_k125 = k2_sites(torch, dev, m, kernel=5)
    pairs_present = int((rb_full < m).sum())
    print(f"K2 sites: M={m}, {pairs_present / m:.2f} present neighbours per site", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [(c, rb_full, "") for c in K2_PAIRS]
    cases += [((64, 64), rb_lonely, " rows without neighbours"),
              ((96, 96), rb_ragged, f" M={m - 13}")]
    cases += [(c, rb_full, " (data gradient)") for c in K2_DGRAD_PAIRS if c not in K2_PAIRS]
    (rb_l0, l0), (rb_l3, l3) = bench
    cases += [((3, 32), rb_l0, l0), ((32, 32), rb_l0, l0),
              ((384, 256), rb_l3, l3), ((256, 384), rb_l3, l3 + " (data gradient)"),
              ((128, 128), rb_holes, " tiles without any offset"),
              ((3, 32), rb_k125, " 5^3 kernel")]
    worst, timed = 0.0, None
    for (cin, cout), rb, note in cases:
        rows, kvol = rb.shape
        f = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(kvol, cin, cout, generator=g, device=dev)
             / (kvol * cin) ** 0.5).to(torch.bfloat16)
        edge = note in (" rows without neighbours", f" M={m - 13}")
        err, t = k2_case(torch, f, w, rb, note, card, timed=not edge)
        if (cin, cout) == K2_TIMED and not note:
            timed = t
        worst = max(worst, err)
    return {"name": "subm_conv", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/subm_conv.cu",
            "replaces": "seggroup_tpu/sparse/pallas_conv.py:268",
            "max_abs_err": worst, **timed}


def run_stage2_path(torch, dev, card):
    """Res16UNet34C semantic inference at full width over 4 bench-size
    scenes through the stage-2 evaluation's scoring loop."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps, test_semantic_minkunet
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw

    scenes = []
    for i in range(N_SCENES):
        name = f"bench{i}"
        c, col, lab = scene_to_training_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE),
                                              {}, None, name, False)
        scenes.append((name, c, col, lab))
    model = make_minkunet("Res16UNet34C", out_channels=20, level_caps=level_caps(CAPACITY),
                          seed=0, device=dev)
    t0 = time.perf_counter()
    test_semantic_minkunet(model, scenes[:1], CAPACITY, VOXEL, 20)  # warm-up
    torch.cuda.synchronize()
    print(f"stage-2 warm-up forward: {time.perf_counter() - t0:.3f} s", flush=True)

    phases: dict[str, float] = {}
    log: list = []
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_subm_conv.launches = 0
    cuda_subm_dw.launches = 0
    t0 = time.perf_counter()
    miou, _, ap_class = test_semantic_minkunet(model, scenes, CAPACITY, VOXEL, 20,
                                               phase_seconds=phases, scene_log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_subm_conv.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    if launches < SUBM_PER_FORWARD * N_SCENES:
        raise AssertionError(f"K2 launched {launches} times in {N_SCENES} forwards")
    if cuda_subm_dw.launches:
        raise AssertionError("inference launched the weight-gradient kernel")
    for (name, c, col, lab), rec in zip(scenes, log):
        over = int((make_voxel_batch([(c, col, lab)], CAPACITY, VOXEL).point2voxel[0] < 0).sum())
        if rec["dropped"] != over:
            raise AssertionError(f"{name}: {rec['dropped']} points excluded, {over} over capacity")
        if not (rec["logits_finite"] and rec["padding_zero"]):
            raise AssertionError(f"{name}: logits not finite or not zero on padding")
    if not (np.isfinite(miou) or np.isnan(miou)):
        raise AssertionError(f"mIoU {miou}")

    voxels = sum(rec["voxels"] for rec in log)
    forward = phases["forward"] / N_SCENES
    inner = {k: phases.get(k, 0.0) / N_SCENES for k in ("rulebooks", "subm_conv")}
    split = (f"voxelize {phases['voxelize'] / N_SCENES:.4f} s, rulebooks and downsampling "
             f"{inner['rulebooks']:.4f} s, subm convs {inner['subm_conv']:.4f} s, rest of the "
             f"forward {forward - sum(inner.values()):.4f} s, point mapping and scoring "
             f"{phases['score'] / N_SCENES:.4f} s")
    print(f"stage-2 Res16UNet34C semantic inference, capacity {CAPACITY}, voxel {VOXEL} m, "
          f"{N_SCENES} scenes of {BENCH_SCENE['num_points']} points: {wall / N_SCENES:.4f} "
          f"s/scene, forward {forward:.4f} s/scene, {voxels / wall:.1f} voxels/s; per scene: "
          f"{split}; {launches} K2 launches ({launches / N_SCENES:.1f} per forward); peak "
          f"{peak_gib:.2f} GiB; dropped points {[rec['dropped'] for rec in log]}; mIoU "
          f"{miou:.4f}, mAP {np.nanmean(ap_class):.4f} (random weights); on {card}", flush=True)
    return launches


def minkunet_card_vs_cpu(torch, dev):
    """Res16UNet14A on 2,048 voxel rows on the card (K2) and on the CPU
    (plain): rulebooks and downsample maps of every level equal, logits
    within the tolerance the CPU tests hold against JAX."""
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.sparse.conv import build_subm_rulebook, downsample_coords
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    m, n = 2048, 1500
    caps = [m, m // 2, m // 4, m // 8, m // 8]
    st_cpu, _ = _small_batch(torch, m, n, 5)
    st_card = st_cpu.to(dev)

    a, b = st_card, st_cpu
    for lvl in range(4):
        maps = [(build_subm_rulebook(a, 3), build_subm_rulebook(b, 3))]
        down = list(zip(downsample_coords(a, caps[lvl + 1]), downsample_coords(b, caps[lvl + 1])))
        for x, y in maps + down:
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"level {lvl}: card and CPU rulebooks or maps differ")
        (ca, cb), (va, vb), (na, nb) = down[:3]
        a = SparseTensor(ca, torch.zeros((caps[lvl + 1], 1), device=dev), va, na)
        b = SparseTensor(cb, torch.zeros((caps[lvl + 1], 1)), vb, nb)

    on_card = make_minkunet("Res16UNet14A", out_channels=20, level_caps=caps, seed=1,
                            device=dev)
    on_cpu = make_minkunet("Res16UNet14A", out_channels=20, level_caps=caps, seed=1,
                           device="cpu")
    with torch.no_grad():
        x = on_card(st_card).cpu()
        y = on_cpu(st_cpu)
    diff = float((x - y).abs().max())
    agree = float((x[:n].argmax(1) == y[:n].argmax(1)).float().mean())
    if not torch.allclose(x, y, rtol=LOGIT_RTOL, atol=LOGIT_ATOL) or agree < ARGMAX_AGREE:
        raise AssertionError(f"MinkUNet card vs CPU: max |diff| {diff}, argmax agree {agree}")
    if not (x[n:] == 0).all():
        raise AssertionError("MinkUNet card logits not zero on padding")
    print(f"card vs CPU, Res16UNet14A at M={m} ({n} voxels): rulebooks and downsample maps "
          f"of 4 levels equal; logits max |card - CPU| = {diff:.3e} (max |logit| "
          f"{float(y.abs().max()):.3f}), argmax agrees on {agree:.4f} of voxels", flush=True)


def check_subm_dw(torch, dev, card, bench):
    """K3 against its plain version in bf16 at every (Cin, Cout) of
    Res16UNet34C, on the 131,072 dense sites, plus rows with no neighbour,
    a ragged M, and a bench scene's level-0 rulebook (about 3.8 present
    neighbours per row) and level-3 rulebook (16,384 rows with padding
    rows); each case run twice and required bit-equal, its compaction pass
    required equal to compact_pairs_plain; per pair and per bench case the
    kernel's, the plain version's and the pre-gathered matmul's times beside
    the bound, and the compaction pass's and the slab sum's times alone."""
    from seggroup_tpu_torch.sparse import cuda_subm_dw
    from seggroup_tpu_torch.sparse.conv import subm_dw_plain

    m = CAPACITY
    rb_full = k2_sites(torch, dev, m)
    rb_lonely = rb_full.clone()
    rb_lonely[::7] = m
    rb_ragged = k2_sites(torch, dev, m - 13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(c, rb_full, "") for c in K2_PAIRS]
    cases += [((64, 64), rb_lonely, " rows without neighbours"),
              ((96, 96), rb_ragged, f" M={m - 13}")]
    (rb_l0, l0), (rb_l3, l3) = bench
    cases += [((3, 32), rb_l0, l0), ((32, 32), rb_l0, l0),
              ((384, 256), rb_l3, l3), ((256, 256), rb_l3, l3)]
    max_err, timed = 0.0, None
    for (cin, cout), rb, note in cases:
        rows = rb.shape[0]
        pairs_present = int((rb < rows).sum())
        f = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
        d = torch.randn(rows, cout, generator=g, device=dev).to(torch.bfloat16)
        got = cuda_subm_dw.subm_dw_cuda(f, d, rb)
        again = cuda_subm_dw.subm_dw_cuda(f, d, rb)
        want = subm_dw_plain(f, d, rb, torch.bfloat16)
        cin_p, cout_p = -(-cin // 8) * 8, -(-cout // 8) * 8
        slabs, slab_rows = cuda_subm_dw.slabs_for(rows, 27, cin_p, cout_p, sms)
        pairs, counts = cuda_subm_dw.compact_pairs_cuda(rb, slabs, slab_rows)
        want_pairs, want_counts = cuda_subm_dw.compact_pairs_plain(rb, slabs, slab_rows)
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        filled = torch.arange(slab_rows, device=dev)[None, None, :] < want_counts[:, :, None]
        compact_equal = (torch.equal(counts, want_counts)
                         and torch.equal(pairs[filled], want_pairs[filled]))
        del pairs, want_pairs, filled
        line = (f"K3 {cuda_subm_dw.regime(cin)} ({cin},{cout}){note}: max |kernel - plain| = "
                f"{err:.3e} = {err / scale:.2e} of max|plain| (sums over {rows} rows, "
                f"{pairs_present / rows:.2f} present neighbours per row; {slabs} slabs of "
                f"{slab_rows} rows, tile {cuda_subm_dw.tile(cin_p, cout_p)}; "
                f"{int((want_counts == 0).sum())} of {want_counts.numel()} (slab, offset) "
                f"segments empty)")
        if err > K3_RTOL * scale or not torch.isfinite(got).all():
            raise AssertionError(line)
        if not torch.equal(got, again):
            raise AssertionError(f"{line}: two runs on the same inputs differ")
        if not compact_equal:
            raise AssertionError(f"{line}: the compaction pass differs from compact_pairs_plain")
        max_err = max(max_err, err)
        if note and not note.startswith(" bench"):
            print(line + "; bit-equal across two runs, compaction equal to its plain version",
                  flush=True)
            continue
        ms = cuda_ms(lambda: cuda_subm_dw.subm_dw_cuda(f, d, rb), reps=30, warmup=3)
        compact_ms = cuda_ms(lambda: cuda_subm_dw.compact_pairs_cuda(rb, slabs, slab_rows),
                             reps=30, warmup=3)
        sum_ms = 0.0
        if slabs > 1:
            ws = torch.zeros((slabs, 27, cin_p, cout_p), dtype=torch.float32, device=dev)
            sum_ms = cuda_ms(lambda: cuda_subm_dw.sum_slabs_cuda(ws), reps=30, warmup=3)
            del ws
        plain_ms = cuda_ms(lambda: subm_dw_plain(f, d, rb, torch.bfloat16), reps=3, warmup=1)
        a = torch.cat([f, f.new_zeros(1, cin)])[rb.long()].reshape(rows, 27 * cin)
        library_ms = cuda_ms(lambda: torch.matmul(a.T, d), reps=20, warmup=2)
        del a
        # the bytes K3 must move (bf16 feats and dout, int32 rulebook, f32
        # dW), and 2*Cin*Cout operations per present pair
        nbytes = rows * cin * 2 + rows * cout * 2 + rows * 27 * 4 + 27 * cin * cout * 4
        flops = 2 * pairs_present * cin * cout
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{line}; bit-equal across two runs, compaction equal to its plain version; "
              f"kernel {ms:.4f} ms (compaction {compact_ms:.4f} ms, slab sum {sum_ms:.4f} ms, "
              f"product {ms - compact_ms - sum_ms:.4f} ms), plain {plain_ms:.3f} ms, library "
              f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s on {card}", flush=True)
        if (cin, cout) == K2_TIMED and not note:
            timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                         bound_by=by)
    return {"name": "subm_dw", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/subm_dw.cu",
            "replaces": "seggroup_tpu/sparse/pallas_conv.py:644",
            "max_abs_err": max_err, **timed}


def _train_setup(torch, dev, variant, caps, seed):
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    model = make_minkunet(variant, out_channels=20, level_caps=caps, seed=seed, device=dev)
    optimizer, scheduler = make_optimizer("SGD", model.parameters(),
                                          make_schedule("PolyLR", 0.1, max_iter=60000))
    return model, optimizer, scheduler


def run_train_path(torch, dev, card):
    """Res16UNet34C training at full width: augmented batches built by the
    host prefetcher (2 workers, 3 ahead) over 8 bench-size scenes, moved to
    the card in the main thread, through train_step. Returns the K2 and K3
    launch counts of the timed steps."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import (batch_to_device,
                                                              make_train_batch, train_step)
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw
    from seggroup_tpu_torch.utils.prefetch import HostPrefetcher

    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None,
                                      "", False) for i in range(TRAIN_POOL)]
    model, optimizer, scheduler = _train_setup(torch, dev, "Res16UNet34C",
                                               level_caps(CAPACITY), 0)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    prefetch = HostPrefetcher(
        lambda s: make_train_batch(scenes.__getitem__, range(TRAIN_POOL), s + 1, 1,
                                   TRAIN_BATCH, CAPACITY, VOXEL, True),
        depth=3, workers=2)
    losses, voxels, scenes_used = [], [], []
    try:
        t0 = time.perf_counter()
        for _ in range(TRAIN_WARMUP):
            st, labels = batch_to_device(next(prefetch), dev)
            losses.append(train_step(model, optimizer, scheduler, st, labels)[0])
        torch.cuda.synchronize()
        print(f"stage-2 training warm-up, {TRAIN_WARMUP} steps: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        torch.cuda.reset_peak_memory_stats(dev)
        cuda_subm_conv.launches = 0
        cuda_subm_dw.launches = 0
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            vb = next(prefetch)
            voxels.append(int(vb.num))
            scenes_used.append(int(vb.coords[: int(vb.num), 0].max()) + 1)
            st, labels = batch_to_device(vb, dev)
            losses.append(train_step(model, optimizer, scheduler, st, labels)[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"subm_conv": cuda_subm_conv.launches, "subm_dw": cuda_subm_dw.launches}
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

        # the split, each phase fenced by a synchronisation on each side
        phases: dict[str, float] = {}
        t0 = time.perf_counter()
        for _ in range(TRAIN_FENCED):
            torch.cuda.synchronize()
            tw = time.perf_counter()
            st, labels = batch_to_device(next(prefetch), dev)
            torch.cuda.synchronize()
            phases["batch wait"] = phases.get("batch wait", 0.0) + time.perf_counter() - tw
            losses.append(train_step(model, optimizer, scheduler, st, labels,
                                     phase_seconds=phases)[0])
        fenced = (time.perf_counter() - t0) / TRAIN_FENCED
    finally:
        prefetch.close()

    if launches["subm_dw"] != SUBM_PER_FORWARD * TRAIN_STEPS:
        raise AssertionError(f"K3 launched {launches['subm_dw']} times in {TRAIN_STEPS} steps")
    if launches["subm_conv"] != K2_PER_STEP * TRAIN_STEPS:
        raise AssertionError(f"K2 launched {launches['subm_conv']} times in {TRAIN_STEPS} steps")
    loss_values = [float(x) for x in losses]
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"non-finite training loss: {loss_values}")
    moved = [k for k, v in model.named_buffers() if not torch.equal(v, stats0[k])]
    if len(moved) != len(stats0):
        raise AssertionError(f"BatchNorm running statistics did not move: "
                             f"{sorted(set(stats0) - set(moved))[:5]}")
    split = ", ".join(f"{k} {v / TRAIN_FENCED:.4f} s" for k, v in phases.items())
    print(f"stage-2 Res16UNet34C training, capacity {CAPACITY}, batch size {TRAIN_BATCH} "
          f"from {TRAIN_POOL} bench-size scenes ({BENCH_SCENE['num_points']} points), SGD lr "
          f"0.1 PolyLR, augmented: {wall / TRAIN_STEPS:.4f} s/step over {TRAIN_STEPS} steps, "
          f"{sum(voxels) / wall:.1f} voxels/s ({np.mean(voxels):.1f} voxels per step from "
          f"{np.mean(scenes_used):.2f} scenes: the capacity binds); fenced split per step "
          f"({fenced:.4f} s/step): {split}; peak {peak_gib:.2f} GiB; per step "
          f"{launches['subm_conv'] / TRAIN_STEPS:.1f} K2 and "
          f"{launches['subm_dw'] / TRAIN_STEPS:.1f} K3 launches; losses "
          f"{[round(x, 4) for x in loss_values]}; on {card}", flush=True)
    return launches


def _small_batch(torch, m, n, seed):
    """A SparseTensor of n unique sites over two batch ids in a 24^3 box,
    padded to m rows, and random labels (some unlabelled), on the CPU."""
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    rng = np.random.default_rng(seed)
    seen, rows = set(), []
    while len(rows) < n:
        c = (int(rng.integers(0, 2)), *(int(v) for v in rng.integers(0, 24, 3)))
        if c not in seen:
            seen.add(c)
            rows.append(c)
    coords = np.zeros((m, 4), np.int32)
    coords[:n] = rows
    feats = np.zeros((m, 3), np.float32)
    feats[:n] = rng.normal(size=(n, 3))
    labels = rng.integers(0, 20, size=m).astype(np.int32)
    labels[rng.random(m) < 0.1] = 255
    labels[n:] = 255
    st = SparseTensor(torch.from_numpy(coords), torch.from_numpy(feats),
                      torch.arange(m) < n, torch.tensor(n, dtype=torch.int32))
    return st, torch.from_numpy(labels)


class CheckedDispatch:
    """While active, every K2 and K3 call of the sparse conv (the forward,
    the data gradient and the weight gradient, through the device dispatch
    of sparse/conv.py) is held against its plain version on the same card
    inputs: max |kernel - plain| within K2_RTOL or K3_RTOL of max|plain|.
    Records the worst ratio per (kernel, Cin, Cout, rows)."""

    def __init__(self, torch):
        self.torch = torch
        self.worst: dict = {}

    def _checked(self, name, fn, plain, rtol):
        def call(a, b, rulebook, compute_dtype):
            got = fn(a, b, rulebook, compute_dtype)
            if a.is_cuda:
                want = plain(a, b, rulebook, compute_dtype)
                ratio = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
                key = (name, a.shape[1], got.shape[-1], a.shape[0])
                self.worst[key] = max(self.worst.get(key, 0.0), ratio)
                if ratio > rtol or not self.torch.isfinite(got).all():
                    raise AssertionError(f"{name} {key[1:]} in the network: max |kernel - "
                                         f"plain| = {ratio:.2e} of max|plain|")
            return got
        return call

    def __enter__(self):
        from seggroup_tpu_torch.sparse import conv

        self.saved = conv._subm_apply, conv._subm_dw
        conv._subm_apply = self._checked("K2", conv._subm_apply, conv.subm_conv_plain, K2_RTOL)
        conv._subm_dw = self._checked("K3", conv._subm_dw, conv.subm_dw_plain, K3_RTOL)
        return self

    def __exit__(self, *exc):
        from seggroup_tpu_torch.sparse import conv

        conv._subm_apply, conv._subm_dw = self.saved

    def summary(self) -> str:
        by = {}
        for key, ratio in self.worst.items():
            by.setdefault(key[0], []).append(ratio)
        return "; ".join(f"{name} {len(r)} shapes, worst {max(r):.2e} of max|plain|"
                         for name, r in sorted(by.items()))


def _grads_on(torch, devices, st, labels, caps, train, f32=False):
    """Res16UNet14A from the same weights on each device (K2 and K3 on the
    card, the plain versions on the CPU): with `train`, one train step;
    else one backward of the loss through the running-statistics forward,
    its submanifold convs at float32 with `f32` (the CPU only). Returns
    (loss, gradients, buffers) for each device."""
    import functools

    from seggroup_tpu_torch.cli.stage2_train_minkunet import masked_nll, train_step
    from seggroup_tpu_torch.models import minkunet

    runs = []
    for d in devices:
        model, optimizer, scheduler = _train_setup(torch, d, "Res16UNet14A", caps, 1)
        st_d, labels_d = st.to(d), labels.to(d)
        if train:
            loss, _ = train_step(model, optimizer, scheduler, st_d, labels_d)
        else:
            subm_conv = minkunet.subm_conv
            if f32:
                minkunet.subm_conv = functools.partial(subm_conv, compute_dtype=torch.float32)
            try:
                loss = masked_nll(model(st_d), labels_d, st_d.valid)
                loss.backward()
            finally:
                minkunet.subm_conv = subm_conv
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        runs.append((float(loss.detach()), grads,
                     {k: b.cpu() for k, b in model.named_buffers()}))
    return runs


def _per_tensor(ga, gb, norm):
    """{name: |ga - gb| / |gb|} in the given norm ("max" or "l2")."""
    if norm == "max":
        return {k: float((ga[k] - g).abs().max() / g.abs().max()) for k, g in gb.items()}
    return {k: float((ga[k] - g).norm() / g.norm()) for k, g in gb.items()}


def _spread(errs):
    worst = max(errs, key=errs.get)
    return (f"median {float(np.median(list(errs.values()))):.2e}, worst {errs[worst]:.2e} "
            f"({worst})")


def _step_line(torch, runs):
    """(out of bounds, text): the loss, the running statistics and the
    gradients' relative L2 distance, card against CPU."""
    (la, ga, sa), (lb, gb, sb) = runs
    stat_err = max(float(((sa[k] - v).abs() - STAT_RTOL * v.abs()).max()) for k, v in sb.items())
    diff = sum(float(((ga[k] - g) ** 2).sum()) for k, g in gb.items())
    rel_l2 = (diff / sum(float((g ** 2).sum()) for g in gb.values())) ** 0.5
    bad = (abs(la - lb) > STEP_LOSS_ATOL or stat_err > STAT_ATOL or rel_l2 > GRAD_REL_L2
           or not all(torch.isfinite(g).all() for g in ga.values()))
    return bad, (f"loss {la:.6f} vs {lb:.6f}, running statistics within "
                 f"{max(stat_err, 0.0):.2e} beyond rtol {STAT_RTOL}, gradients "
                 f"{rel_l2:.4f} apart in relative L2 norm")


def train_card_vs_cpu(torch, dev):
    """Res16UNet14A on the card (K2, K3) and on the CPU (plain versions)
    from the same weights, at two sizes. A train step's loss and running
    statistics are held to the bounds the CPU tests hold the port's bf16
    step to against JAX, its gradients to GRAD_REL_L2 as a whole: bf16
    gradients through batch statistics are chaotic at both sizes (at 2^14
    rows the CPU's own step, run again on one thread, shows the spread that
    summation order alone makes).

    At M=2^14 (a 30,000-point scene voxelised at 2 cm: the capacity binds
    at level 0, 225 voxels at the coarsest level) every K2 and K3 call of
    the card's train step, and of a backward through the running-statistics
    forward, is held against its plain version on the same inputs
    (CheckedDispatch): the forward, every data gradient and every weight
    gradient (the stem's with Cin padded from 3 to 8) at the network's own
    shapes and full depth. In that backward BatchNorm is affine, and each
    parameter's gradient is held on its own: the card may differ from the
    CPU by GRAD_OVER_BF16 times what bf16 moves that tensor on the CPU.
    At M=2,048 (1,500 random sites in a 24^3 box, about 12 voxels at the
    coarsest level) the train step's classifier head is held to
    HEAD_GRAD_RTOL."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_to_device
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch

    m = 2 ** 14
    caps = [m, m // 2, m // 4, m // 8, m // 8]
    scene = scene_to_training_tuple(make_synthetic_scene(seed=5, num_points=30000), {}, None,
                                    "", False)
    st, labels = batch_to_device(make_voxel_batch([scene], m, VOXEL), "cpu")
    cpu = torch.device("cpu")
    with CheckedDispatch(torch) as checked:
        runs = _grads_on(torch, (dev, cpu), st, labels, caps, True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the same CPU step, its sums in another order
    try:
        one_thread = _grads_on(torch, (cpu,), st, labels, caps, True)[0]
    finally:
        torch.set_num_threads(threads)
    bad, text = _step_line(torch, runs)
    line = (f"card vs CPU, Res16UNet14A train step at M={m} ({int(st.num)} voxels): {text}; "
            f"per tensor in relative L2 norm, card vs CPU: "
            f"{_spread(_per_tensor(runs[0][1], runs[1][1], 'l2'))}; CPU on 1 thread vs "
            f"{threads}: {_spread(_per_tensor(one_thread[1], runs[1][1], 'l2'))}; every "
            f"kernel call of the step against its plain version: {checked.summary()}")
    if bad:
        raise AssertionError(line)
    print(line, flush=True)

    with CheckedDispatch(torch) as checked:
        (la, ga, _), (lb, gb, _) = _grads_on(torch, (dev, cpu), st, labels, caps, False)
    _, g32, _ = _grads_on(torch, (cpu,), st, labels, caps, False, f32=True)[0]
    errs = _per_tensor(ga, gb, "max")
    spread = _per_tensor(g32, gb, "max")
    over = {k: errs[k] / (spread[k] + GRAD_FLOOR) for k in errs}
    worst = max(over, key=over.get)
    narrow = ", ".join(f"{k} {errs[k]:.2e} (bf16 {spread[k]:.2e})" for k in (
        "conv0.kernel", "block1_0.conv1.kernel", "block8_0.conv2.kernel"))
    line = (f"card vs CPU, Res16UNet14A backward with running statistics at M={m}: loss "
            f"{la:.6f} vs {lb:.6f}; each gradient's max |card - CPU| / max |CPU|: "
            f"{_spread(errs)} over {len(errs)} tensors; what bf16 does on the CPU "
            f"(float32 convs vs bf16): {_spread(spread)}; largest card error over "
            f"(bf16's + {GRAD_FLOOR}): {over[worst]:.3f} ({worst}: {errs[worst]:.2e} vs "
            f"{spread[worst]:.2e}); {narrow}; every kernel call against its plain version: "
            f"{checked.summary()}")
    if (abs(la - lb) > STEP_LOSS_ATOL or not all(torch.isfinite(g).all() for g in ga.values())
            or over[worst] > GRAD_OVER_BF16):
        raise AssertionError(line)
    print(line, flush=True)

    m, n = 2048, 1500
    st, labels = _small_batch(torch, m, n, 5)
    runs = _grads_on(torch, (dev, cpu), st, labels, [m, m // 2, m // 4, m // 8, m // 8], True)
    bad, text = _step_line(torch, runs)
    (_, ga, _), (_, gb, _) = runs
    head = max(_per_tensor(ga, gb, "max")[k] for k in ("final.weight", "final.bias"))
    line = (f"card vs CPU, Res16UNet14A train step at M={m} ({n} voxels): {text}, "
            f"classifier head {head:.2e} of max")
    if bad or head > HEAD_GRAD_RTOL:
        raise AssertionError(line)
    print(line, flush=True)


def overfit_check(torch, dev, card):
    """30 SGD steps of Res16UNet14A on one fixed small batch on the card:
    the mean of the last 5 losses must be below the mean of the first 5."""
    from seggroup_tpu_torch.cli.stage2_train_minkunet import train_step

    m, n = 2048, 1500
    st, labels = _small_batch(torch, m, n, 6)
    st, labels = st.to(dev), labels.to(dev)
    model, optimizer, scheduler = _train_setup(torch, dev, "Res16UNet14A",
                                               [m, m // 2, m // 4, m // 8, m // 8], 2)
    losses = [float(train_step(model, optimizer, scheduler, st, labels)[0])
              for _ in range(OVERFIT_STEPS)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    line = (f"overfit, Res16UNet14A on one batch of {n} voxels, {OVERFIT_STEPS} steps: mean "
            f"loss of the first 5 {first:.4f}, of the last 5 {last:.4f}; on {card}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{line}; losses {losses}")
    print(line, flush=True)


def _pg_scene(i):
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import scene_instance_tuple
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene

    name = f"bench{i}"
    return (name, *scene_instance_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None,
                                        name))


def _pg_inputs(torch, dev, scene, point_cap, voxel_cap):
    """One scene as the evaluation CLI hands it to the model: the host
    batch, and (voxels, p2v, coords, batch_ids, valid) on `dev`."""
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import make_pg_batch
    from seggroup_tpu_torch.ops.voxelize import voxel_gather_mean, voxelize
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    hb = make_pg_batch([scene[1:]], point_cap, 256)
    ic = np.floor(hb.coords / VOXEL).astype(np.int32)
    ic -= ic.min(0)
    pts = torch.from_numpy(hb.coords).to(dev)
    batch_ids = torch.from_numpy(hb.batch_ids).to(dev)
    valid = torch.from_numpy(hb.valid).to(dev)
    vm = voxelize(torch.from_numpy(ic).to(dev), batch_ids, valid, voxel_cap)
    feats = torch.cat([torch.from_numpy(hb.feats).to(dev), pts], dim=1)
    st = SparseTensor(vm.voxel_coords, voxel_gather_mean(feats, vm), vm.voxel_valid,
                      vm.num_voxels)
    return hb, (st, vm.point2voxel, pts, batch_ids, valid)


def _true_label_heads(torch, dev, hb, shift: float):
    """Heads that predict the truth: one-hot scores of the true classes
    (class 0 where unlabelled) and offsets `shift` of the way to the
    instance's centroid."""
    labels = torch.from_numpy(np.where(hb.labels >= 0, hb.labels, 0)).to(dev).long()
    scores = torch.nn.functional.one_hot(labels, 20).float()
    has_inst = torch.from_numpy(hb.instance_labels >= 0).to(dev)[:, None]
    to_centre = torch.from_numpy(hb.instance_centroid - hb.coords).to(dev)
    return scores, torch.where(has_inst, shift * to_centre, 0.0)


def cc_problems(torch, dev, model):
    """(name, coords, batch, valid, classes) on the card: the doubled point
    set a full-width forward clusters (random weights), a bench scene on its
    true labels (alone, and doubled with offsets half-way to the centroids),
    no valid row, valid rows ending inside a tile, and two scenes with
    interleaved batch ids."""
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import make_pg_batch
    from seggroup_tpu_torch.models.pointgroup import PointGroup

    scene = _pg_scene(0)
    hb, (st, p2v, pts, batch_ids, valid) = _pg_inputs(torch, dev, scene, PG_POINT_CAP,
                                                      PG_VOXEL_CAP)
    with torch.no_grad():
        _, sem, off = model.backbone(st, p2v, valid)
    out = [("full-width forward, random weights",
            *PointGroup.clustering_problem(sem, off, pts, batch_ids, valid))]
    sem_t, off_t = _true_label_heads(torch, dev, hb, 0.5)
    p2, b2, v2, s2 = PointGroup.clustering_problem(sem_t, off_t, pts, batch_ids, valid)
    n = PG_POINT_CAP
    out.append(("bench scene, true labels", p2[:n], batch_ids, v2[:n], s2[:n]))
    out.append(("bench scene, true labels, doubled with half-way offsets", p2, b2, v2, s2))
    out.append(("no valid row", p2[:n], batch_ids, torch.zeros_like(v2[:n]), s2[:n]))
    cut = torch.arange(n, device=dev) < 100_037  # 390 tiles and 197 rows
    out.append(("valid rows end inside a tile", p2[:n], batch_ids, v2[:n] & cut, s2[:n]))
    hb2 = make_pg_batch([_pg_scene(2)[1:], _pg_scene(3)[1:]], PG_POINT_CAP, 256,
                        max_points_per_scene=PG_POINT_CAP // 2)
    sem_2, off_2 = _true_label_heads(torch, dev, hb2, 0.5)
    out.append(("two scenes, interleaved batch ids", *PointGroup.clustering_problem(
        sem_2, off_2, torch.from_numpy(hb2.coords).to(dev),
        torch.from_numpy(hb2.batch_ids).to(dev), torch.from_numpy(hb2.valid).to(dev))))
    return out


def cc_pair_tests(torch, prep, tile: int) -> tuple[int, int]:
    """Pair tests of one sweep: (those of the tiles' whole ranges, tile *
    (hi - lo) summed over tiles and groups, which is what a design that
    walks each range for every query of the tile performs; those the
    function needs). The function needs a distance only where the key test
    can pass: for a valid query row with key k and group g, the rows of its
    tile's range [lo, hi) whose key lies in k + off[g] - 1 .. k + off[g] + 1,
    a run of the sorted keys found by two binary searches. Invalid rows keep
    their label and need none."""
    from seggroup_tpu_torch.ops import radius_cc

    span = (prep.hi - prep.lo).clamp(min=0)
    key = prep.key.long()
    target = key[:, None] + prep.offs.long()[None, :]
    first = torch.searchsorted(key, target - 1)
    last = torch.searchsorted(key, target + 1, right=True)
    lo = prep.lo.long().repeat_interleave(tile, dim=0)
    hi = prep.hi.long().repeat_interleave(tile, dim=0)
    run = (torch.minimum(last, hi) - torch.maximum(first, lo)).clamp(min=0)
    return tile * int(span.sum()), int(run[key < radius_cc.PAD_KEY].sum())


def check_cc_sweep(torch, dev, card, model):
    """K4 against its plain version: labels exactly equal after one sweep
    and at the fixpoint, the kernel bit-equal across two runs, on every
    problem of cc_problems; the kernel's and the plain version's time per
    sweep beside the bound on the full-width forward's problem; then
    semantic_radius_cc on the card against the CPU at 2 x 2^13 rows, through
    the sweep and through the fallback."""
    from seggroup_tpu_torch.ops import cuda_cc, radius_cc

    radius = torch.tensor(PG_RADIUS, dtype=torch.float32, device=dev)
    r2 = radius * radius
    row = None
    for name, pts, batch, valid, sem in cc_problems(torch, dev, model):
        n = pts.shape[0]
        prep = radius_cc._prep(pts, radius, batch, valid, sem, radius_cc.TILE,
                               radius_cc.WINDOW)
        if not bool(prep.use_window):
            raise AssertionError(f"K4 {name}: a range overflows the window, the sweep does "
                                 f"not apply")
        s_valid = valid[prep.order.long()]
        lab0 = torch.where(s_valid, torch.arange(n, dtype=torch.int32, device=dev), n)
        got = radius_cc.sweep(lab0, prep, r2)
        again = radius_cc.sweep(lab0, prep, r2)
        want = radius_cc.sweep_plain(lab0, prep, r2)
        before = cuda_cc.launches
        fix = radius_cc._cc_loop(prep, r2, valid)
        sweeps = cuda_cc.launches - before
        fix_again = radius_cc._cc_loop(prep, r2, valid)
        fix_plain = radius_cc._cc_loop(prep, r2, valid, sweep_fn=radius_cc.sweep_plain)
        torch.cuda.synchronize()
        span = (prep.hi - prep.lo).clamp(min=0)
        real = (prep.key.reshape(-1, radius_cc.TILE) < radius_cc.PAD_KEY).any(1)
        err = int((got.long() - want.long()).abs().max())
        err_fix = int((fix.long() - fix_plain.long()).abs().max())
        comps = int(torch.unique(fix[fix < n]).numel())
        sizes = torch.bincount(fix[fix < n].long(), minlength=1)
        line = (f"K4 cc_sweep {name}: N={n}, {int(valid.sum())} valid rows; one sweep max "
                f"|kernel - plain| = {err} ({int((got < lab0).sum())} labels fell), at the "
                f"fixpoint after {sweeps} sweeps {err_fix}; {comps} components, "
                f"{int((sizes >= 50).sum())} of at least 50 points; mean true range "
                f"{float(span[real].float().mean()) if bool(real.any()) else 0.0:.1f} rows, "
                f"longest {int(span.max())} of {radius_cc.WINDOW}")
        if err or err_fix:
            raise AssertionError(line)
        if not (torch.equal(got, again) and torch.equal(fix, fix_again)):
            raise AssertionError(f"{line}: two runs on the same inputs differ")
        if not bool((fix[~valid] == n).all()):
            raise AssertionError(f"{line}: an invalid row has a label")
        print(line + "; bit-equal across two runs", flush=True)
        doubled = name == "bench scene, true labels, doubled with half-way offsets"
        if row is None or doubled:
            each = cuda_ms_each(lambda: radius_cc.sweep(lab0, prep, r2), reps=30, warmup=3)
            ms = float(np.mean(each))
            plain_ms = cuda_ms(lambda: radius_cc.sweep_plain(lab0, prep, r2), reps=2, warmup=1)
            # the operations the function needs: a distance (8 f32 operations:
            # 3 sub, 3 mul, 2 add) for each pair that can pass the key test,
            # not for each pair of a tile's whole ranges; its bytes: each row
            # read once (xyz, class, key, label: 24 B), one label written, the
            # two range tables read
            walked, needed = cc_pair_tests(torch, prep, radius_cc.TILE)
            flops = 8 * needed
            nbytes = n * 28 + 2 * prep.lo.numel() * 4
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            print(f"K4 cc_sweep {name}: kernel {ms:.4f} ms per sweep (mean of {len(each)} "
                  f"launches, min {min(each):.4f}, median {float(np.median(each)):.4f}), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}: bytes {t_bytes:.5f} ms for "
                  f"{nbytes / 1e6:.2f} MB, operations {t_ops:.5f} ms for {needed / 1e6:.3f} M "
                  f"pair tests within the 3-cell key runs, "
                  f"{needed / max(int(valid.sum()), 1):.1f} per valid row; the tiles' whole "
                  f"ranges hold {walked / 1e6:.3f} M pairs, which this kernel walks), kernel "
                  f"{ms / bound:.1f} times its bound; on {card}", flush=True)
            stats = {"rows": n, "valid_rows": int(valid.sum()), "sweeps_to_fixpoint": sweeps,
                     "ms": ms, "ms_min": min(each), "ms_median": float(np.median(each)),
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "pair_tests_needed": needed, "pair_tests_of_whole_ranges": walked}
            if row is None:
                row = {"name": "cc_sweep", "route": "cuda",
                       "source": "seggroup_tpu_torch/csrc/cc_sweep.cu",
                       "replaces": "seggroup_tpu/ops/pallas_cc.py:131", "max_abs_err": 0,
                       "ms": ms, "ms_min": stats["ms_min"], "ms_median": stats["ms_median"],
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "library_ms": None, "by_problem": {}}
            row["by_problem"][name] = stats

    # the public function, card against CPU, at a size the CPU's plain sweep
    # takes: a 30,000-point scene's true labels cropped to 2^13 rows, doubled
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import (make_pg_batch,
                                                                 scene_instance_tuple)
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.models.pointgroup import PointGroup

    small = scene_instance_tuple(make_synthetic_scene(seed=5, num_points=30000), {}, None, "")
    hb = make_pg_batch([small], 2 ** 13, 256)
    cpu = torch.device("cpu")
    sem_c, off_c = _true_label_heads(torch, cpu, hb, 0.5)
    prob = PointGroup.clustering_problem(sem_c, off_c, torch.from_numpy(hb.coords),
                                         torch.from_numpy(hb.batch_ids),
                                         torch.from_numpy(hb.valid))
    for r, kw, note in ((0.06, {}, "the sweep"), (0.06, dict(window=32), "the fallback")):
        on_cpu, uw_cpu = radius_cc.semantic_radius_cc(
            prob[0], r, *prob[1:], fused_halves=True, return_use_window=True, **kw)
        before = cuda_cc.launches
        on_card, uw = radius_cc.semantic_radius_cc(
            prob[0].to(dev), r, *(t.to(dev) for t in prob[1:]), fused_halves=True,
            return_use_window=True, **kw)
        used = cuda_cc.launches - before
        n = on_cpu.shape[0]
        line = (f"semantic_radius_cc card vs CPU through {note}, N={n}, radius {r}: "
                f"{int((on_card.cpu() != on_cpu).sum())} labels differ, "
                f"{int(torch.unique(on_cpu[on_cpu < n]).numel())} components, use_window "
                f"{bool(uw)} / {bool(uw_cpu)}, {used} K4 launches")
        if (not torch.equal(on_card.cpu(), on_cpu) or bool(uw) != bool(uw_cpu)
                or bool(uw) != (note == "the sweep") or (used > 0) != bool(uw)):
            raise AssertionError(line)
        print(line, flush=True)
    return row


def check_subm_conv_pointgroup(torch, dev, card):
    """K2 against its plain version in bf16 at every (Cin, Cout) of
    PointGroup at m=16, on 65,536 dense sites (the U-Net's level-0
    capacity): K = 27 over the site rulebook, and K = 1 over each row's own
    index (the block after a concatenation); each case run twice and
    required bit-equal; kernel, plain and pre-gathered matmul times beside
    the bound."""
    m = PG_VOXEL_CAP
    rb27 = k2_sites(torch, dev, m)
    rb1 = torch.arange(m, dtype=torch.int32, device=dev)[:, None].contiguous()
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for (cin, cout), rb in [(c, rb27) for c in PG_PAIRS] + [(c, rb1) for c in PG_K1_PAIRS]:
        kvol = rb.shape[1]
        f = torch.randn(m, cin, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(kvol, cin, cout, generator=g, device=dev)
             / (kvol * cin) ** 0.5).to(torch.bfloat16)
        err, _ = k2_case(torch, f, w, rb, f" PointGroup, M={m}", card)
        worst = max(worst, err)
    return worst


def run_pointgroup_path(torch, dev, card, model):
    """PointGroup instance-segmentation inference at full width over 4
    bench-size scenes through the evaluation CLI's loop, on random
    weights as the CLI runs without a checkpoint; then the clustering
    and the ScoreNet on a scene's true labels. Returns the K2 and K4 launch
    counts of the timed scenes."""
    from seggroup_tpu_torch.cli.stage2_test_pointgroup import test_instance_pointgroup
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE
    from seggroup_tpu_torch.ops import cuda_cc
    from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw

    scenes = [_pg_scene(i) for i in range(N_SCENES)]
    t0 = time.perf_counter()
    test_instance_pointgroup(model, scenes[:1], PG_POINT_CAP, PG_VOXEL_CAP)  # warm-up
    torch.cuda.synchronize()
    print(f"PointGroup warm-up scene: {time.perf_counter() - t0:.3f} s", flush=True)

    sweeps = []  # K4 launches of each forward's clustering
    cluster = model.cluster

    def counted(*args, **kwargs):
        before = cuda_cc.launches
        out = cluster(*args, **kwargs)
        sweeps.append(cuda_cc.launches - before)
        return out

    model.cluster = counted
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_subm_conv.launches = cuda_subm_dw.launches = cuda_cc.launches = 0
        t0 = time.perf_counter()
        aps, avg = test_instance_pointgroup(model, scenes, PG_POINT_CAP, PG_VOXEL_CAP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"subm_conv": cuda_subm_conv.launches, "cc_sweep": cuda_cc.launches}
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        per_forward = list(sweeps)
        # the split, each phase fenced by a synchronisation on each side
        phases: dict[str, float] = {}
        log: list = []
        t0 = time.perf_counter()
        test_instance_pointgroup(model, scenes, PG_POINT_CAP, PG_VOXEL_CAP,
                                 phase_seconds=phases, scene_log=log)
        fenced = (time.perf_counter() - t0) / N_SCENES
    finally:
        del model.cluster

    if min(per_forward) < 1:
        raise AssertionError(f"K4 launches per forward {per_forward}: a forward took the "
                             f"fallback, not the sweep")
    if launches["subm_conv"] != PG_SUBM_PER_FORWARD * N_SCENES or cuda_subm_dw.launches:
        raise AssertionError(f"K2 launched {launches['subm_conv']} times in {N_SCENES} "
                             f"forwards, K3 {cuda_subm_dw.launches}")
    if aps.shape != (18, 10) or not all(rec["finite"] for rec in log):
        raise AssertionError(f"AP array {aps.shape}, scenes {log}")
    for rec in log:
        if not (0 < rec["points"] <= PG_POINT_CAP and rec["voxels"] > 0):
            raise AssertionError(f"scene {rec}")
    top = ("host batch", "voxelize", "unet", "clustering", "scorenet", "proposals to AP")
    split = ", ".join(f"{k} {phases.get(k, 0.0) / N_SCENES:.4f} s" for k in top)
    inner = ", ".join(f"{k} {phases.get(k, 0.0) / N_SCENES:.4f} s"
                      for k in ("rulebooks", "subm_conv"))
    print(f"PointGroup instance inference, m={PG_M}, point cap {PG_POINT_CAP}, voxel cap "
          f"{PG_VOXEL_CAP}, radius {PG_RADIUS}, {N_SCENES} scenes of "
          f"{BENCH_SCENE['num_points']} points cropped to {[rec['points'] for rec in log]}: "
          f"{wall / N_SCENES:.4f} s/scene, {sum(rec['points'] for rec in log) / wall:.1f} "
          f"points/s; fenced split per scene "
          f"({fenced:.4f} s/scene): {split}; inside the U-Net and the ScoreNet: {inner}; "
          f"per forward {launches['subm_conv'] / N_SCENES:.1f} K2 launches and K4 launches "
          f"(sweeps) {per_forward}; voxels {[rec['voxels'] for rec in log]} (those past the "
          f"{PG_VOXEL_CAP} rows are dropped); proposals found "
          f"{[rec['proposals'] for rec in log]}, kept {[rec['kept'] for rec in log]}; peak "
          f"{peak_gib:.2f} GiB; AP {avg['all_ap']:.3f} (random weights); on {card}, "
          f"{machine_id(torch)}", flush=True)

    # the same model on heads that predict the truth: real components for the
    # clustering and real proposals for the ScoreNet
    hb, (st, p2v, pts, batch_ids, valid) = _pg_inputs(torch, dev, scenes[0], PG_POINT_CAP,
                                                      PG_VOXEL_CAP)
    sem_t, off_t = _true_label_heads(torch, dev, hb, 0.5)
    with torch.no_grad():
        point_feats, _, _ = model.backbone(st, p2v, valid)
        torch.cuda.synchronize()
        before, t0 = cuda_cc.launches, time.perf_counter()
        props = model.cluster(sem_t, off_t, pts, batch_ids, valid)
        torch.cuda.synchronize()
        t_cluster = time.perf_counter() - t0
        used = cuda_cc.launches - before
        t0 = time.perf_counter()
        scores = model.score(point_feats, props.proposal_of_point, props.score_vox)
        torch.cuda.synchronize()
        t_score = time.perf_counter() - t0
    n_prop = int(props.num_proposals)
    in_prop = int((props.proposal_of_point < 2 * model.max_proposals_per_source).sum())
    instances = int(np.unique(hb.instance_labels[hb.instance_labels >= 0]).size)
    line = (f"PointGroup on true labels (offsets half-way to the centroids), scene 0: "
            f"{instances} instances, {n_prop} proposals of at least "
            f"{model.cluster_npoint_thre} points holding {in_prop} (source, point) pairs, "
            f"{int(props.score_vox.num_voxels)} score voxels of {model.score_cap}; "
            f"clustering {t_cluster:.4f} s with {used} K4 launches, ScoreNet {t_score:.4f} s; "
            f"on {card}, {machine_id(torch)}")
    if used < 1 or n_prop < 1 or not torch.isfinite(scores).all():
        raise AssertionError(line)
    print(line, flush=True)
    return launches


def pointgroup_card_vs_cpu(torch, dev):
    """PointGroup (m=8, 4,096 points of a small scene in 2,048 voxel rows,
    radius 0.25) on the card and on the CPU from the same weights, stage by
    stage: the heads within the MinkUNet tolerance; clustering, proposals
    and score voxelisation exactly equal at shared heads (the CPU's); the
    scores within tolerance at the shared voxel map."""
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import scene_instance_tuple
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.models.pointgroup import PointGroup

    kw = dict(classes=8, m=8, max_proposals_per_source=32, score_cap=2048,
              cluster_npoint_thre=20, cluster_radius=0.25, seed=4)
    scene = ("small", *scene_instance_tuple(make_synthetic_scene(seed=7), {}, None, ""))
    cpu = torch.device("cpu")
    runs = []
    for d in (dev, cpu):
        model = PointGroup(device=d, **kw)
        with torch.no_grad():  # spread the statistics so that no layer is the identity
            for name, buf in model.named_buffers():
                buf.copy_(torch.linspace(0.5, 1.5, buf.numel()) if name.endswith("var")
                          else torch.linspace(-0.2, 0.2, buf.numel()))
        _, args = _pg_inputs(torch, d, scene, 4096, 2048)
        with torch.no_grad():
            feats, sem, off = model.backbone(args[0], args[1], args[4])
        runs.append((model, args, feats, sem, off))
    (m_a, args_a, feats_a, sem_a, off_a), (m_b, args_b, feats_b, sem_b, off_b) = runs
    for name, x, y in (("semantic scores", sem_a, sem_b), ("offsets", off_a, off_b)):
        if not torch.allclose(x.cpu(), y, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"PointGroup card vs CPU {name}: max |diff| "
                                 f"{float((x.cpu() - y).abs().max())}")
    with torch.no_grad():
        p_a = m_a.cluster(sem_b.to(dev), off_b.to(dev), *args_a[2:])
        p_b = m_b.cluster(sem_b, off_b, *args_b[2:])
    flat_a = [p_a.proposal_of_point, p_a.proposal_valid, p_a.num_proposals, p_a.voxel_coords,
              *p_a.score_vox]
    flat_b = [p_b.proposal_of_point, p_b.proposal_valid, p_b.num_proposals, p_b.voxel_coords,
              *p_b.score_vox]
    for i, (x, y) in enumerate(zip(flat_a, flat_b)):
        if not torch.equal(x.cpu(), y):
            raise AssertionError(f"PointGroup card vs CPU clustering: field {i} differs at "
                                 f"{int((x.cpu() != y).sum())} entries")
    with torch.no_grad():
        s_a = m_a.score(feats_a, p_a.proposal_of_point, p_a.score_vox).cpu()
        s_b = m_b.score(feats_b, p_b.proposal_of_point, p_b.score_vox)
    if not torch.allclose(s_a, s_b, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
        raise AssertionError(f"PointGroup card vs CPU scores: max |diff| "
                             f"{float((s_a - s_b).abs().max())}")
    if int(p_b.num_proposals) < 1:
        raise AssertionError("PointGroup card vs CPU: the small scene gave no proposal")
    print(f"card vs CPU, PointGroup m=8 at N=4096: heads max |card - CPU| = "
          f"{float((sem_a.cpu() - sem_b).abs().max()):.3e} (scores), "
          f"{float((off_a.cpu() - off_b).abs().max()):.3e} (offsets); at shared heads "
          f"{int(p_b.num_proposals)} proposals, proposal maps, cells and all "
          f"{int(p_b.score_vox.num_voxels)} score voxels equal; proposal scores max |card - "
          f"CPU| = {float((s_a - s_b).abs().max()):.3e}", flush=True)


def build_all() -> None:
    """Build every kernel, one nvcc per source, all started together."""
    from seggroup_tpu_torch.ops import cuda_cc, cuda_fps
    from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw

    def timed(build):
        t0 = time.perf_counter()
        lib, log = build()
        return lib, log, time.perf_counter() - t0

    mods = (cuda_fps, cuda_subm_conv, cuda_subm_dw, cuda_cc)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        jobs = [pool.submit(timed, mod.build) for mod in mods]
        for mod, job in zip(mods, jobs):
            lib, log, seconds = job.result()
            print(f"built {os.path.relpath(lib, ROOT)} in {seconds:.2f} s", flush=True)
            for line in log.splitlines():
                if ("ptxas info" in line and "Compile time" not in line) or "spill" in line:
                    print("  " + line.strip(), flush=True)
            if mod is cuda_subm_conv and log:
                funcs = k2_build_lines(log)
                print("K2 functions (registers, spill bytes): " + "; ".join(
                    f"{name} {regs}, {spill}" for name, regs, spill in funcs), flush=True)
                if not funcs or any(spill for _, _, spill in funcs):
                    raise AssertionError("a K2 function spills registers")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from seggroup_tpu_torch.device import card_description, resolve_device

    dev = resolve_device(torch.device("cuda", 0))  # TF32 off, as the entry points set it
    card = card_description()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {machine_id(torch)}", flush=True)

    build_all()

    k1 = check_fps(torch, dev, card)
    bench = bench_rulebooks(torch, dev)
    k2 = check_subm_conv(torch, dev, card, bench)
    k3 = check_subm_dw(torch, dev, card, bench)
    launches = run_main_path(torch, dev, card)
    card_vs_cpu(torch, dev)
    inference_k2 = run_stage2_path(torch, dev, card)
    minkunet_card_vs_cpu(torch, dev)
    train = run_train_path(torch, dev, card)
    train_card_vs_cpu(torch, dev)
    overfit_check(torch, dev, card)

    from seggroup_tpu_torch.cli.stage2_test_pointgroup import make_eval_model

    pg_model = make_eval_model(PG_M, PG_VOXEL_CAP, dev)
    k4 = check_cc_sweep(torch, dev, card, pg_model)
    check_subm_conv_pointgroup(torch, dev, card)
    pointgroup = run_pointgroup_path(torch, dev, card, pg_model)
    pointgroup_card_vs_cpu(torch, dev)

    k1["launches"] = launches["masked_fps"]
    # the training path runs both K2 and K3; K2's counts on the inference
    # paths stand beside it
    k2["launches"] = train["subm_conv"]
    k2["launches_by_path"] = {"stage2_semantic_inference": inference_k2,
                              "stage2_training": train["subm_conv"],
                              "pointgroup_inference": pointgroup["subm_conv"]}
    k3["launches"] = train["subm_dw"]
    k4["launches"] = pointgroup["cc_sweep"]
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
