#!/usr/bin/env python3
"""Drive the PyTorch port (seggroup_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; build every kernel from csrc/ (one
     nvcc per source, all started together);
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at edge cases; kernel, plain and library times (CUDA
     events) beside each kernel's bound;
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
  7. a `kernels` JSON line, the card line, then the device line as the last.

Needs one card. Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import json
import os
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
K2_TIMED = (384, 256)  # the widest pair: the one the kernels line reports
K2_RTOL = 1e-4  # of max|plain|: only the order of the float32 sums differs
# MinkUNet card vs CPU: the tolerance tests/test_torch_minkunet.py holds the
# port to against JAX (bf16 products, float32 sums in another order)
LOGIT_ATOL, LOGIT_RTOL, ARGMAX_AGREE = 2e-4, 1e-3, 0.99


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


def k2_sites(torch, dev, m: int):
    """A dense voxel set: each of two batch ids holds a random half of a
    51^3 grid, in the voxeliser's sorted order, cut to m rows; its rulebook
    built on the card (about 13 present neighbours per site)."""
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
    return build_subm_rulebook(st, 3)


def check_subm_conv(torch, dev, card):
    """K2 against its plain version in bf16 at every (Cin, Cout) of
    Res16UNet34C, on 131,072 dense sites, plus rows with no neighbour and a
    ragged M; per pair the kernel's, the plain version's and the
    pre-gathered matmul's times beside the bound."""
    from seggroup_tpu_torch.sparse import cuda_subm_conv
    from seggroup_tpu_torch.sparse.conv import subm_conv_plain

    m = CAPACITY
    rb_full = k2_sites(torch, dev, m)
    rb_lonely = rb_full.clone()
    rb_lonely[::7] = m  # every 7th row: all 27 neighbours absent
    rb_ragged = k2_sites(torch, dev, m - 13)  # not a multiple of the 64-row tile
    pairs_present = int((rb_full < m).sum())
    print(f"K2 sites: M={m}, {pairs_present / m:.2f} present neighbours per site", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [(c, rb_full, "") for c in K2_PAIRS]
    cases += [((64, 64), rb_lonely, " rows without neighbours"),
              ((96, 96), rb_ragged, f" M={m - 13}")]
    max_err, timed = 0.0, None
    for (cin, cout), rb, note in cases:
        rows = rb.shape[0]
        f = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(27, cin, cout, generator=g, device=dev)
             / (27 * cin) ** 0.5).to(torch.bfloat16)
        got = cuda_subm_conv.subm_conv_cuda(f, w, rb)
        want = subm_conv_plain(f, w, rb, torch.bfloat16)
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        line = (f"K2 {cuda_subm_conv.regime(cin)} ({cin},{cout}){note}: "
                f"max |kernel - plain| = {err:.3e} = {err / scale:.2e} of max|plain|")
        if err > K2_RTOL * scale or not torch.isfinite(got).all():
            raise AssertionError(line)
        if not (got[(rb == rows).all(1)] == 0).all():
            raise AssertionError(f"{line}: a row with no neighbour is not zero")
        max_err = max(max_err, err)
        if note:
            print(line, flush=True)
            continue
        ms = cuda_ms(lambda: cuda_subm_conv.subm_conv_cuda(f, w, rb), reps=50, warmup=3)
        plain_ms = cuda_ms(lambda: subm_conv_plain(f, w, rb, torch.bfloat16), reps=3, warmup=1)
        a = torch.cat([f, f.new_zeros(1, cin)])[rb.long()].reshape(rows, 27 * cin)
        b = w.reshape(27 * cin, cout)
        library_ms = cuda_ms(lambda: torch.matmul(a, b), reps=20, warmup=2)
        del a
        # the bytes K2 must move (bf16 feats and weights, int32 rulebook,
        # f32 output), and 2*Cin*Cout operations per present pair
        nbytes = rows * cin * 2 + rows * 27 * 4 + 27 * cin * cout * 2 + rows * cout * 4
        flops = 2 * pairs_present * cin * cout
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{line}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s on {card}",
              flush=True)
        if (cin, cout) == K2_TIMED:
            timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                         bound_by=by)
    return {"name": "subm_conv", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/subm_conv.cu",
            "replaces": "seggroup_tpu/sparse/pallas_conv.py:268",
            "max_abs_err": max_err, **timed}


def run_stage2_path(torch, dev, card):
    """Res16UNet34C semantic inference at full width over 4 bench-size
    scenes through the stage-2 evaluation's scoring loop."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps, test_semantic_minkunet
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.sparse import cuda_subm_conv

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
    t0 = time.perf_counter()
    miou, _, ap_class = test_semantic_minkunet(model, scenes, CAPACITY, VOXEL, 20,
                                               phase_seconds=phases, scene_log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_subm_conv.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    if launches < SUBM_PER_FORWARD * N_SCENES:
        raise AssertionError(f"K2 launched {launches} times in {N_SCENES} forwards")
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
    rng = np.random.default_rng(5)
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
    st_cpu = SparseTensor(torch.from_numpy(coords), torch.from_numpy(feats),
                          torch.arange(m) < n, torch.tensor(n, dtype=torch.int32))
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


def build_all() -> None:
    """Build every kernel, one nvcc per source, all started together."""
    from seggroup_tpu_torch.ops import cuda_fps
    from seggroup_tpu_torch.sparse import cuda_subm_conv

    def timed(build):
        t0 = time.perf_counter()
        lib, log = build()
        return lib, log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        jobs = [pool.submit(timed, mod.build) for mod in (cuda_fps, cuda_subm_conv)]
        for job in jobs:
            lib, log, seconds = job.result()
            print(f"built {os.path.relpath(lib, ROOT)} in {seconds:.2f} s", flush=True)
            for line in log.splitlines():
                if "ptxas info" in line and "Compile time" not in line:
                    print("  " + line.strip(), flush=True)


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
          f"{torch.cuda.get_device_name(0)}", flush=True)

    build_all()

    k1 = check_fps(torch, dev, card)
    k2 = check_subm_conv(torch, dev, card)
    launches = run_main_path(torch, dev, card)
    card_vs_cpu(torch, dev)
    k2["launches"] = run_stage2_path(torch, dev, card)
    minkunet_card_vs_cpu(torch, dev)

    k1["launches"] = launches["masked_fps"]
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
