#!/usr/bin/env python3
"""Drive the PyTorch port (seggroup_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; build every kernel from csrc/ (one
     nvcc per source, all started together);
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at edge cases; kernel, plain and library times (CUDA
     events) beside each kernel's bound; K1, K2 and K4 timed a call back to
     back, as every kernel is, and beside it with their launches queued
     behind a spin (the card's time without the host's); K1's time per
     dependent step of its k-step chain beside its bound; K2 at every pair
     of Res16UNet34C and of its data gradient, on a bench scene's level 0
     and level 3, with whole row tiles lacking every offset and with a 5^3
     kernel; K2 and K3 at the ST nets' widths (32 to 256) on the level-1
     rulebooks of a 5-column batch of bench frames at K = 29 (the hybrid
     region) and K = 81 (the 4-D hypercube), and at Cout = 512 (K2 at
     (512, 512) on level 3 and at (512, 256) and its data gradient on level
     2, K3 at (512, 512)); K1's, K2's and K4's register and spill counts
     from the build, no spill allowed;
  3. the stage-1 path at full width: ins_infer over 4 bench-size synthetic
     scenes (150,528 points, 512 segment slots, 4,096 edge slots) through
     infer.infer_scenes, labels exported to a temporary directory, and one
     sem_infer; K1's launch count is read around it;
  4. the same forward on a small scene at float32 on the card (kernel path)
     and on the CPU (plain path): integer outputs equal;
 4a. the stage-1 fast configuration (bench.py's `stage1_fast`: the
     parallel-rounds grouping; `fast_knn`, exact off the TPU) over the same bench
     scenes, timed in turns beside the default configuration, with the
     same output checks, K1's launches (at least one a forward) and the
     parallel rounds per grouping pass; then its integer outputs card vs
     CPU at float32 on a bench-shaped scene cut to 2^15 points;
  5. the stage-1 training path at full width: train steps of the bf16
     model over the 4 bench-size scenes through cli.stage1_train.train_step
     (Adam lr 0.001, the driver's defaults), 2 warm-up steps, 8 timed and
     4 fenced into forward, backward and optimizer with the grouping,
     cluster kNN and cluster-cloud shares; K1's launch count is read around
     the timed steps (at least one per step); the loss and every gradient
     finite, every parameter's gradient nonzero, the parameters and the
     running statistics moved;
  6. one stage-1 train step at float32 on a small scene with one injected
     dropout mask on the card and on the CPU: integer outputs equal, the
     loss, each gradient and the running statistics within tolerance; then
     30 train steps on one small scene on the card, whose loss must fall;
  7. the stage-2 path at full width: Res16UNet34C semantic inference over 4
     bench-size scenes voxelised at 2 cm into 2^17 voxels, through
     cli.stage2_test_semantic.test_semantic_minkunet; K2's launch count is
     read around it;
 7a. the repaired evaluation driver end to end:
     cli.stage2_test_semantic.main with --synthetic 2 (Res16UNet34C at its
     defaults), its log written, K2's launches read around it;
  8. MinkUNet on a small input on the card (K2) and on the CPU (plain):
     rulebooks and downsample maps equal, logits within tolerance;
  9. the stage-2 training path at full width: Res16UNet34C train steps at
     2^17 voxels, batch size 8, SGD lr 0.1 PolyLR, augmented batches of 8
     bench-size scenes built by the host prefetcher, through
     cli.stage2_train_minkunet.train_step; K2's and K3's launch counts are
     read around the timed steps (47 K3 and 93 K2 launches per step);
 10. Res16UNet14A on the card (K2, K3) and on the CPU (plain): one train
     step at 2^14 and at 2,048 rows (loss, gradients and running
     statistics within tolerance) and one backward through the
     running-statistics forward at 2^14 rows (each gradient tensor held on
     its own); then 30 steps on one fixed batch on the card, whose loss
     must fall;
 11. K4, the radius-graph connected-components sweep, against its plain
     version (labels exactly equal after one sweep and at the fixpoint,
     bit-equal across two runs) on the doubled point set of a full-width
     PointGroup forward, on a bench scene clustered on its true labels, and
     on edge cases, with the pairs of its key runs beside those the function
     needs and its wrapper's host time a call;
     `semantic_radius_cc` on the card against the CPU; K2
     against its plain version at every PointGroup (Cin, Cout), K = 27 and
     K = 1;
 12. the PointGroup path at full width: instance-segmentation inference
     over 4 bench-size scenes at the evaluation CLI's defaults (m=16,
     2^17 points, 2^16 voxels, radius 0.03) through
     cli.stage2_test_pointgroup.test_instance_pointgroup; K2's and K4's
     launch counts are read around it, at least one K4 launch per forward;
     then the clustering and the ScoreNet on the true labels of a scene;
 13. PointGroup at a small size on the card and on the CPU: heads within
     tolerance, clustering exactly equal at shared heads, scores within
     tolerance at a shared voxel map; before the PointGroup path (in phase
     11), K3 against its plain version at every PointGroup (Cin, Cout), K =
     27 and K = 1, bit-equal across two runs, beside the pre-gathered
     matmul and the bound;
 14. the PointGroup training path at full width (this slice's main path):
     train steps at the training driver's defaults (m=16, 2^17 points,
     2^16 voxels, batch size 4, Adam lr 1e-3) over the 4 bench-size scenes
     through cli.stage2_train_pointgroup.train_step, batches built ahead
     by the host prefetcher as the driver builds them: the prepare phase
     (no clustering), then the clustering and the ScoreNet, each 2
     warm-up, 4 timed and 2 fenced steps (host batch, voxelise, unet,
     clustering, scorenet, loss, backward, optimizer); every kernel's
     launch counts are read around the timed steps of each; then one step
     with every K2 and K3 call held against its plain version;
 15. one PointGroup train step (m=8, with the clustering) at float32 convs
     on a 2,048-point batch on the card and on the CPU: integer outputs
     equal, the loss, each gradient and the running statistics within
     tolerance; then 30 Adam steps on that batch on the card, whose loss
     must fall;
 15a. KPConv semantic inference at the evaluation driver's defaults
     (KPFCNN with SCANNET_ARCHITECTURE, first_features_dim 64, dl0 0.04,
     point_cap 2^15, in_radius 2.0, 3 votes) over 1 bench scene through
     cli.stage2_test_semantic.test_semantic_kpconv, at seeded weights with
     nonzero deformable offset kernels: 100% coverage and finite logits,
     spheres per scene, the fenced split (pyramid, encoder, decoder, host
     vote), per-level neighbour-overflow rates, peak memory, no kernel
     launched (K1-K4 counted around it); then one sphere's pyramid (integer arrays and points equal) and logits (within
     1e-4 of their magnitude) on the card and on the CPU;
 15b. KPConv training (no kernel): cli.stage2_train_kpconv.main at its
     defaults (KPFCNN, first_features_dim 64, point cap 2^15, 4 spheres a
     step, neighbour caps calibrated from 4 probe batches, SGD momentum
     0.98) on 2 bench scenes (1 held out), --steps 10 --save_freq 10: the
     calibrated caps, probe overflow rates, s/step and the validation
     lines; one fenced step of the driver's (host batch, pyramid, forward,
     loss, backward, gradient transform, SGD) with points/s and peak
     memory; bench.py's KPConv step (2^17 points, 10 spheres, caps n >>
     i), 2 warm-ups and 4 timed steps, peak memory; one float32 train step
     of two-level deformable v1 and modulated v2 nets card vs CPU (loss
     within 1e-5 relative, each gradient within 1e-4 of its max, running
     statistics within 1e-5); 30 SGD steps of the driver's model on one
     batch, whose loss must fall to half; then the KPCNN classification
     driver at its defaults and introspect_kpconv --mode erf on the
     trainer's checkpoint; K1-K4 launch counts around each driver;
 15c. the rest of the MinkUNet family: cli.demo_semantic.main on a bench
     scene written as a PLY, at its defaults (Res16UNet34C, 2 cm, 2^17
     voxels), with --variant MinkUNetHyper, --variant ResUNet18INBN and
     --conv1_kernel_size 5 (seconds a run, the fenced phases, every
     kernel's launches, one output vertex per kept point); train steps at full width through
     cli.stage2_train_minkunet.train_step of STResTesseract16UNet18A (K =
     81) and STRes16UNet18A (K = 29) on 4 bench frames of 2^15 voxels
     (2^17 5-column voxels) and of MinkUNetHyper14INBN on 2^17 voxels of
     bench scenes, each 2 warm-ups, 4 timed steps (every kernel's launches
     a step, s/step, voxels/s, peak memory) and one step with every K2 and
     K3 call held against its plain version; BilateralCRF-Res16UNet34C's
     forward at 2^17 voxels, 10 iterations (seconds, peak memory, every
     kernel's launches); then STResTesseract16UNet18A, MinkUNetHyper14INBN
     and BilateralCRF-Res16UNet14A card vs CPU at 2,048 rows (logits within
     the MinkUNet tolerance, MinkUNetHyper14INBN's within a fixed 3e-2, the
     CRF's integer rows equal);
 15d. the pyramid plans: the native host library built from
     csrc/seggroup_native.cpp and loaded (the run fails otherwise), its
     subm_rulebook3, downsample_plan and subm_windows exactly equal to their
     numpy fallbacks on a 2^17-voxel batch of the MinkUNet train phase;
     that batch's 5-level plan built on the card bit-equal to the host's
     (rulebooks, down maps, windows, use_window), each timed with and
     without windows; Res16UNet34C train steps in three plan forms
     (--plan_mode device: the float16 wire and the card's plan; --plan_mode
     host; no plan on the float16 batch; the trainer's plans hold no
     windows),
     each from the seeded init over the same 5 batches, 2 warm-up and 3
     timed steps, K2 and K3 launches a step, the first losses within the
     card-vs-CPU step tolerance; PointGroup at the training driver's
     defaults: one clustering step with --plan_mode host and one with
     --plan_mode device on the same host batch (its device plan bit-equal
     to the host plan; K2, K3, K4 counted), then the split program
     (propose, then score_plan) beside the fused step with PyTorch's
     deterministic algorithms on: outputs, loss, gradients and running
     statistics bit-equal, the ScoreNet's device plan equal to its
     searched rulebooks; then a
     synthetic raw ScanNet scene of 50,000 vertices prepared by
     cli.prepare_scannet at its defaults and cli.stage1_infer --ins_infer
     over it on the card (label files at the vertex count, K1 counted);
 15e. data parallelism (parallel/dp.py, parallel/point_sharding.py): an
     NCCL group of world size 1 in this process and one MinkUNet DP step
     through it (Res16UNet34C, --plan_mode device, 2^17 voxels, batch 8);
     then one spawn of 2 gloo ranks sharing cuda:0 (NCCL refuses two ranks
     on one card), each running the stage-1 DP train step at the bench
     width (bf16, Adam), the same MinkUNet DP step, a PointGroup DP step
     with the clustering on label heads in each --plan_mode (rank 0 draws
     both ranks' batches and hands them out) and the stage-1 point-sharded
     forward at the bench width, whose final_sem, final_ins and final_root
     must equal the unsharded forward's; after each, every rank's
     parameters and running statistics bit-equal; with deterministic
     algorithms on, a Res16UNet14A DP step against the mean of the two
     ranks' own gradients fed through a copy of the optimizer; s/step,
     peak memory and K1-K4 launches per rank of each path (two ranks on
     one card contend: not a scaling figure). With 2 or more cards, the
     same over NCCL across min(count, 4) cards;
 16. each phase's wall seconds, a `kernels` JSON line (each kernel's
     `launches_by_path` with every rank's launches on each DP path), the
     card line, then the device line as the last.

Needs one card. Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import json
import os
import platform
import sys
import tempfile
import time
import warnings
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
# the ST nets' block widths (STRes16UNet18A's encoder) for K2 and K3 at K = 29
# and K = 81, over bench scene 0 in ST_FRAMES frames of ST_FRAME_CAP voxels
ST_PAIRS = [(32, 32), (64, 64), (128, 128), (256, 256)]
ST_FRAMES, ST_FRAME_CAP = 4, 2 ** 15
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
# stage-1 training: the training driver's defaults (cli/stage1_train.py)
S1_LR, S1_WARMUP, S1_STEPS, S1_FENCED = 0.001, 2, 8, 4
# stage-1 card vs CPU train step at float32: the bounds
# tests/test_torch_stage1_train.py holds the port to against JAX
S1_LOSS_RTOL, S1_GRAD_RTOL, S1_STAT_TOL = 1e-5, 1e-4, 1e-5
# MinkUNet card vs CPU: the tolerance tests/test_torch_minkunet.py holds the
# port to against JAX (bf16 products, float32 sums in another order)
LOGIT_ATOL, LOGIT_RTOL, ARGMAX_AGREE = 2e-4, 1e-3, 0.99
# MinkUNetHyper14INBN's logits card vs CPU, absolute: its instance norms
# over a few dozen voxels a scene at the coarse levels of the 1,500-voxel
# batch amplify the bf16 rounding that the card's and the CPU's float32 sums
# in another order can flip. Measured on an H100 1.52e-2 and 1.60e-2 (max
# |logit| 5.84), where bf16 itself moves the CPU's logits by 4.79e-2
# against float32 convs.
INBN_LOGIT_ATOL = 3e-2
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
# PointGroup training: the training driver's defaults (cli/stage2_train_pointgroup.py)
PGT_BATCH, PGT_LR, PGT_INSTANCE_CAP = 4, 1e-3, 256
PGT_WARMUP, PGT_STEPS, PGT_FENCED = 2, 4, 2
# submanifold convs of the U-Net alone (the prepare phase); with the
# clustering the ScoreNet's join them (PG_SUBM_PER_FORWARD)
PG_SUBM_UNET = 1 + 7 * 4 + 6 * 5
# PointGroup card vs CPU train step at float32 convs: the bounds
# tests/test_torch_pointgroup_train.py holds the port to against JAX; the
# gradient of the bias that the training BatchNorm after it removes is
# rounding noise on both sides, held in absolute terms
PGT_LOSS_RTOL, PGT_GRAD_RTOL, PGT_STAT_TOL, PGT_NOISE_GRAD = 1e-5, 1e-4, 1e-5, 1e-6
PGT_ZERO_GRAD = "offset_dense.bias"
PG_SMALL = dict(classes=8, m=8, max_proposals_per_source=32, score_cap=2048,
                cluster_npoint_thre=20, cluster_radius=0.25)
# stage 1 in bench.py's `stage1_fast` configuration (cli/stage1_infer.py
# --parallel_grouping --fast_knn); card vs CPU on a bench-shaped scene cut to
# 2^15 points (the CPU's cluster kNN at the full 150,528 takes minutes)
FAST = dict(sequential=False, fast_knn=True)
FAST_CHECK_POINTS = 2 ** 15
# KPConv semantic inference at the evaluation driver's defaults
# (cli/stage2_test_semantic.py --model kpconv), on one bench scene so that the
# script with the KPConv training phases keeps near its time
KP_POINT_CAP, KP_FDIM, KP_DL0, KP_RADIUS, KP_VOTES, KP_SCENES = 2 ** 15, 64, 0.04, 2.0, 3, 1
# the deformable offset kernels' scale: at 0 (their init) a deformable layer
# is the rigid one
KP_OFFSET_STD = 0.05
# KPConv card vs CPU on one sphere: float32 sums in another order (cuBLAS);
# logits within this share of their largest magnitude
KP_LOGIT_RTOL = 1e-4


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
        print(f"K1 masked_fps {name} {tuple(pts.shape)} k={FPS_K}, "
              f"{cuda_fps.variant(pts.shape[1])} design: max |kernel - plain| = {err}",
              flush=True)
        if err != 0:
            raise AssertionError(f"K1 disagrees with its plain version on {name}")
        max_err = max(max_err, err)
        if name == "stage1":
            timed = (pts, valid)

    pts, valid = timed
    b, p, _ = pts.shape
    ms = cuda_ms(lambda: cuda_fps.masked_fps_cuda(pts, valid, FPS_K), reps=50, warmup=5)
    dev_ms = device_ms(lambda: cuda_fps.masked_fps_cuda(pts, valid, FPS_K), reps=50, warmup=5)
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
    # the picks form a chain of k dependent argmaxes: no design takes fewer
    # than k steps, so the time of one step is what stands beside the bound
    print(f"K1 masked_fps stage-1 shape ({b},{p}) k={FPS_K}, {n_valid} valid, "
          f"{cuda_fps.variant(p)} design: kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms "
          f"device (launches queued behind a spin) = {dev_ms / FPS_K * 1e3:.3f} us per "
          f"dependent step of the {FPS_K}-step chain; plain {plain_ms:.3f} ms, bound "
          f"{max(t_bytes, t_ops):.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
          f"no design takes fewer than the {FPS_K} dependent steps) on {card}", flush=True)
    return {"name": "masked_fps", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/fps.cu",
            "replaces": "seggroup_tpu/ops/pallas_fps.py:26",
            "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "ms_per_step": dev_ms / FPS_K, "plain_ms": plain_ms,
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


def run_stage1_fast_path(torch, dev, card):
    """Stage-1 inference at bench.py's `stage1_fast` configuration
    (parallel-rounds grouping; `fast_knn`, exact off the TPU), over the bench scenes
    with the caps of run_main_path, timed beside the default configuration
    in this call; then card vs CPU at float32 on a cut bench scene. Returns
    K1's launches in the fast forwards."""
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.ops import cuda_fps
    from seggroup_tpu_torch.ops import grouping as gr

    scenes = [make_synthetic_scene(seed=i, **BENCH_SCENE).to(dev) for i in range(N_SCENES)]
    kw = dict(cluster_cap=1024, knn_window=8192, knn_k=20, seed=0, device=dev)
    models = {"default": SegGroupGNN(**kw), "fast": SegGroupGNN(**kw, **FAST)}
    for model in models.values():
        model(scenes[0], mode="ins_infer")  # warm-up
    torch.cuda.synchronize()
    secs, outs = {}, {}
    for name in ("default", "fast", "default", "fast"):  # in turns
        if name == "fast":
            cuda_fps.launches = 0
            gr.parallel_rounds = gr.parallel_cc_iterations = 0
        t0 = time.perf_counter()
        outs[name] = [models[name](sc, mode="ins_infer") for sc in scenes]
        torch.cuda.synchronize()
        secs.setdefault(name, []).append((time.perf_counter() - t0) / N_SCENES)
        if name == "fast":
            launches, rounds, cc_its = (cuda_fps.launches, gr.parallel_rounds,
                                        gr.parallel_cc_iterations)
    if launches < N_SCENES:
        raise AssertionError(f"K1 launched {launches} times in {N_SCENES} fast forwards")
    n = BENCH_SCENE["num_points"]
    for i, out in enumerate(outs["fast"]):
        if int(out.max_segment_size) > 1024 or int(out.max_cluster_size) > 8192:
            raise AssertionError("a cap bound: the exact path did not run")
        for name in ("final_root", "final_sem", "final_ins", "sem_layer2"):
            if tuple(getattr(out, name).shape) != (n,):
                raise AssertionError(f"{name} has shape {tuple(getattr(out, name).shape)}")
        valid = scenes[i].point2seg < BENCH_SCENE["num_slots"]
        if not bool((out.final_ins[valid] > 0).all()):
            raise AssertionError(f"scene {i}: a valid point ends without an instance")
        if not bool(((out.final_sem[valid] >= 1) & (out.final_sem[valid] <= 40)).all()):
            raise AssertionError(f"scene {i}: final_sem out of 1..40")
        if not (torch.isfinite(out.iou_sem).all() and torch.isfinite(out.acc).all()):
            raise AssertionError("non-finite metrics")
    clusters = {name: [int(torch.unique(o.final_root).numel()) for o in outs[name]]
                for name in outs}
    # one fenced forward of each on scene 0: where the time goes
    splits = {}
    for name, model in models.items():
        phases: dict[str, float] = {}
        t0 = time.perf_counter()
        model(scenes[0], mode="ins_infer", phase_seconds=phases)
        torch.cuda.synchronize()
        rest = time.perf_counter() - t0 - sum(phases.values())
        splits[name] = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(phases.items())
                                 ) + f", rest {rest:.4f} s"
    # each ins_infer forward groups 3 times, each grouping in 2 passes
    passes = 2 * 3 * N_SCENES
    print(f"stage-1 ins_infer fast configuration (parallel-rounds grouping, fast_knn "
          f"as the exact kNN) at {n} points (bf16): {secs['fast']} s/scene, default configuration "
          f"{secs['default']} s/scene (each over {N_SCENES} scenes, in turns); "
          f"{launches} K1 launches in {N_SCENES} forwards; {rounds / passes:.2f} parallel "
          f"rounds and {cc_its / passes:.2f} CC iterations per grouping pass; final clusters "
          f"per scene {clusters['fast']} (default {clusters['default']}); fenced forward of "
          f"scene 0: fast {splits['fast']}; default {splits['default']}; on {card}",
          flush=True)

    cut = dict(BENCH_SCENE, num_points=FAST_CHECK_POINTS)
    scene = make_synthetic_scene(seed=5, **cut)
    kw = dict(cluster_cap=1024, knn_window=8192, compute_dtype=torch.float32, seed=1, **FAST)
    t0 = time.perf_counter()
    a = SegGroupGNN(device=dev, **kw)(scene.to(dev), mode="ins_infer")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b = SegGroupGNN(device="cpu", **kw)(scene.to("cpu"), mode="ins_infer")
    t2 = time.perf_counter()
    for name in a._fields:
        x, y = getattr(a, name).cpu(), getattr(b, name)
        if not x.dtype.is_floating_point and not torch.equal(x, y):
            raise AssertionError(f"fast configuration {name}: card vs CPU differ at "
                                 f"{int((x != y).sum())} entries")
    print(f"card vs CPU, fast configuration ins_infer at N={FAST_CHECK_POINTS} float32: "
          f"integer fields equal; card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s with the "
          f"models' builds", flush=True)
    return launches


def run_stage1_train_path(torch, dev, card):
    """Stage-1 training at full width: the bf16 model at the driver's
    defaults over the 4 bench-size scenes, one scene a step through
    cli.stage1_train.train_step. Returns K1's launches in the timed steps."""
    from seggroup_tpu_torch.cli.stage1_train import train_step
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.ops import cuda_fps
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    scenes = [make_synthetic_scene(seed=i, **BENCH_SCENE).to(dev) for i in range(N_SCENES)]
    model = SegGroupGNN(cluster_cap=1024, knn_window=8192, knn_k=20, seed=0, device=dev)
    optimizer, _ = make_optimizer("Adam", model.parameters(), make_schedule("constant", S1_LR))
    gen = torch.Generator(device=dev).manual_seed(3)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    losses, sizes = [], []

    def step(i, phases=None):
        loss, metrics = train_step(model, optimizer, scenes[i % N_SCENES], generator=gen,
                                   phase_seconds=phases)
        losses.append(loss)
        sizes.append((metrics["max_segment_size"], metrics["max_cluster_size"]))

    t0 = time.perf_counter()
    for i in range(S1_WARMUP):
        step(i)
    torch.cuda.synchronize()
    print(f"stage-1 training warm-up, {S1_WARMUP} steps: {time.perf_counter() - t0:.3f} s",
          flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_fps.launches = 0
    t0 = time.perf_counter()
    for i in range(S1_STEPS):
        step(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_fps.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    phases: dict[str, float] = {}
    t0 = time.perf_counter()
    for i in range(S1_FENCED):
        step(i, phases)
    fenced = (time.perf_counter() - t0) / S1_FENCED

    if launches < S1_STEPS:
        raise AssertionError(f"K1 launched {launches} times in {S1_STEPS} train steps")
    loss_values = [float(x) for x in losses]
    if not np.isfinite(loss_values).all():
        raise AssertionError(f"non-finite stage-1 training loss: {loss_values}")
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"gradient of {name} missing or not finite")
        if float(p.grad.abs().max()) == 0.0:
            raise AssertionError(f"gradient of {name} is zero")
    unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[k])]
    if unmoved:
        raise AssertionError(f"parameters or running statistics did not move: {unmoved}")
    # the training driver runs at fixed budgets, as the JAX one does: a
    # merged cluster over knn_window gets the window-truncated kNN there
    mseg = max(int(a) for a, _ in sizes)
    mclu = max(int(b) for _, b in sizes)
    over = sum(int(b) > model.knn_window for _, b in sizes)
    n = BENCH_SCENE["num_points"]
    per = {k: v / S1_FENCED for k, v in phases.items()}
    split = ", ".join(f"{k} {per[k]:.4f} s" for k in ("forward", "backward", "optimizer"))
    shares = ", ".join(f"{k} {per.get(k, 0.0):.4f} s"
                       for k in ("grouping", "cluster_knn", "cluster_pointclouds"))
    print(f"stage-1 training at {n} points, {BENCH_SCENE['num_slots']} slots, "
          f"{BENCH_SCENE['num_edges']} edges (bf16), Adam lr {S1_LR}, one of {N_SCENES} "
          f"bench-size scenes a step: {wall / S1_STEPS:.4f} s/step over {S1_STEPS} steps "
          f"= {n * S1_STEPS / wall:.1f} points/s; fenced split per step ({fenced:.4f} "
          f"s/step): {split}; within the forward: {shares}; peak {peak_gib:.2f} GiB; "
          f"largest segment {mseg} (cluster_cap {model.cluster_cap}), largest cluster "
          f"{mclu} (knn_window {model.knn_window}; over it in {over} of {len(sizes)} "
          f"steps); K1 launches {launches} in "
          f"{S1_STEPS} steps; losses {[round(x, 4) for x in loss_values]}; on {card}",
          flush=True)
    return launches


def stage1_train_card_vs_cpu(torch, dev, card):
    """One train forward and backward at float32 on a small scene with one
    injected dropout mask on the card and on the CPU, then 30 train steps
    of the bf16 model on one small scene on the card: the mean of the last
    5 losses must be below the mean of the first 5."""
    from seggroup_tpu_torch.cli.stage1_train import train_step
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    scene = make_synthetic_scene(seed=3, **SMALL)
    kw = dict(cluster_cap=2048, knn_window=2048, compute_dtype=torch.float32, seed=1)
    keep = torch.rand((128, 128), generator=torch.Generator().manual_seed(11)) < 0.5
    runs = []
    for d in (dev, torch.device("cpu")):
        model = SegGroupGNN(device=d, **kw)
        out = model(scene.to(d), mode="train", dropout_keep=keep.to(d))
        loss = out.loss_sum / torch.clamp(out.loss_count, min=1.0)
        loss.backward()
        runs.append((model, out, loss.detach()))
    (m_a, a, loss_a), (m_b, b, loss_b) = runs
    for name in a._fields:
        x, y = getattr(a, name).detach().cpu(), getattr(b, name).detach()
        if x.dtype.is_floating_point:
            if not torch.allclose(x, y, rtol=S1_LOSS_RTOL, atol=1e-5):
                raise AssertionError(f"train {name}: card vs CPU differ by "
                                     f"{float((x - y).abs().max())}")
        elif not torch.equal(x, y):
            raise AssertionError(f"train {name}: card vs CPU differ at "
                                 f"{int((x != y).sum())} entries")
    loss_err = abs(float(loss_a) - float(loss_b)) / abs(float(loss_b))
    if loss_err > S1_LOSS_RTOL:
        raise AssertionError(f"train loss: card {float(loss_a)} vs CPU {float(loss_b)}")
    grad_err = 0.0
    cpu_params = dict(m_b.named_parameters())
    for name, p in m_a.named_parameters():
        want = cpu_params[name].grad
        err = float((p.grad.cpu() - want).abs().max()) / float(want.abs().max())
        if not err <= S1_GRAD_RTOL:
            raise AssertionError(f"gradient of {name}: card vs CPU differ by {err:.3e} of "
                                 f"its max")
        grad_err = max(grad_err, err)
    cpu_buffers = dict(m_b.named_buffers())
    stat_err = 0.0
    for name, v in m_a.named_buffers():
        err = float((v.cpu() - cpu_buffers[name]).abs().max())
        if not torch.allclose(v.cpu(), cpu_buffers[name], rtol=S1_STAT_TOL, atol=S1_STAT_TOL):
            raise AssertionError(f"running statistic {name}: card vs CPU differ by {err}")
        stat_err = max(stat_err, err)
    print(f"card vs CPU, stage-1 train step at N={SMALL['num_points']} float32 with one "
          f"injected dropout mask: integer fields equal, loss {float(loss_a):.6f} (relative "
          f"error {loss_err:.2e}), gradients within {grad_err:.2e} of their max, running "
          f"statistics within {stat_err:.2e}", flush=True)

    model = SegGroupGNN(cluster_cap=2048, knn_window=2048, seed=2, device=dev)
    optimizer, _ = make_optimizer("Adam", model.parameters(), make_schedule("constant", S1_LR))
    gen = torch.Generator(device=dev).manual_seed(4)
    small = scene.to(dev)
    losses = [float(train_step(model, optimizer, small, generator=gen)[0])
              for _ in range(OVERFIT_STEPS)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    line = (f"stage-1 overfit, bf16 on one scene of {SMALL['num_points']} points, "
            f"{OVERFIT_STEPS} Adam steps: mean loss of the first 5 {first:.4f}, of the last "
            f"5 {last:.4f}; on {card}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{line}; losses {losses}")
    print(line, flush=True)


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


def bench_frames(torch, dev, frames=ST_FRAMES, cap=ST_FRAME_CAP):
    """A 5-column (batch, x, y, z, t) batch: bench scene 0 in `frames`
    frames, frame t shifted by t cm along x, each voxelised at 2 cm and cut
    to `cap` voxels, t the frame index; (SparseTensor, labels) on `dev`."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    c, col, lab = scene_to_training_tuple(make_synthetic_scene(seed=0, **BENCH_SCENE), {},
                                          None, "", False)
    parts = []
    for t in range(frames):
        vb = make_voxel_batch([(c + np.array([0.01 * t, 0.0, 0.0]), col, lab)], cap, VOXEL)
        n = int(vb.num)
        coords = np.concatenate([vb.coords[:n], np.full((n, 1), t, np.int32)], 1)
        parts.append((coords, vb.feats[:n], vb.labels[:n]))
    m = frames * cap
    coords = np.zeros((m, 5), np.int32)
    feats = np.zeros((m, 3), np.float32)
    labels = np.full(m, 255, np.int32)
    n = sum(len(p[0]) for p in parts)
    coords[:n] = np.concatenate([p[0] for p in parts])
    feats[:n] = np.concatenate([p[1] for p in parts])
    labels[:n] = np.concatenate([p[2] for p in parts])
    st = SparseTensor(torch.from_numpy(coords), torch.from_numpy(feats),
                      torch.arange(m) < n, torch.tensor(n, dtype=torch.int32))
    return st.to(dev), torch.from_numpy(labels).to(dev)


def bench_rulebooks(torch, dev):
    """The rulebooks that Res16UNet34C builds for bench scene 0 voxelised at
    2 cm into 2^17 rows at levels 0 (the capacity binds), 2 and 3 (16,384
    rows, padding rows among them), and the level-1 rulebooks of the ST
    nets' hybrid (K = 29) and hypercube (K = 81) regions over `bench_frames`
    (65,536 rows), all built on the card."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_to_device
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.sparse.conv import build_subm_rulebook, downsample_coords
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    def down(st, cap):
        coords, valid, num = downsample_coords(st, cap)[:3]
        return SparseTensor(coords, torch.zeros((cap, 1), device=dev), valid, num)

    scene = scene_to_training_tuple(make_synthetic_scene(seed=0, **BENCH_SCENE), {}, None,
                                    "", False)
    st, _ = batch_to_device(make_voxel_batch([scene], CAPACITY, VOXEL), dev)
    out = {"l0": (build_subm_rulebook(st, 3), " bench level 0")}
    caps = level_caps(CAPACITY)
    for lvl in range(3):
        st = down(st, caps[lvl + 1])
        if lvl:
            out[f"l{lvl + 1}"] = (build_subm_rulebook(st, 3), f" bench level {lvl + 1} "
                                  f"({int(st.valid.sum())} valid rows)")
    st1 = down(bench_frames(torch, dev)[0], ST_FRAMES * ST_FRAME_CAP // 2)
    for conv_type, kvol in (("spatial_hypercube_temporal_hypercross", 29), ("hypercube", 81)):
        out[f"st{kvol}"] = (build_subm_rulebook(st1, 3, conv_type=conv_type),
                            f" bench frames level 1 ({int(st1.valid.sum())} valid rows, "
                            f"{conv_type})")
    return out


def kernel_build_lines(log: str) -> list[tuple[str, int, int]]:
    """(function, registers, spill bytes) of each function in nvcc's
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
    (rb_l0, l0), (rb_l2, l2), (rb_l3, l3) = bench["l0"], bench["l2"], bench["l3"]
    cases += [((3, 32), rb_l0, l0), ((32, 32), rb_l0, l0),
              ((384, 256), rb_l3, l3), ((256, 384), rb_l3, l3 + " (data gradient)"),
              ((128, 128), rb_holes, " tiles without any offset"),
              ((3, 32), rb_k125, " 5^3 kernel")]
    # this slice's shapes: ResUNet's and MinkUNetHyper's Cout = 512, the ST
    # nets' K = 29 and K = 81
    new = [((512, 512), rb_l3, l3), ((512, 256), rb_l2, l2),
           ((256, 512), rb_l2, l2 + " (data gradient)")]
    new += [(c, bench[key][0], bench[key][1]) for key in ("st29", "st81") for c in ST_PAIRS]
    worst, timed, shapes = 0.0, None, {}
    for i, ((cin, cout), rb, note) in enumerate(cases + new):
        rows, kvol = rb.shape
        f = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(kvol, cin, cout, generator=g, device=dev)
             / (kvol * cin) ** 0.5).to(torch.bfloat16)
        edge = note in (" rows without neighbours", f" M={m - 13}")
        err, t = k2_case(torch, f, w, rb, note, card, timed=not edge)
        if (cin, cout) == K2_TIMED and not note:
            timed = t
        if i >= len(cases):
            shapes[f"({cin},{cout}) K={kvol} M={rows}"] = t
        worst = max(worst, err)
    return {"name": "subm_conv", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/subm_conv.cu",
            "replaces": "seggroup_tpu/sparse/pallas_conv.py:268",
            "max_abs_err": worst, **timed, "new_shapes": shapes}


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


def run_semantic_driver(torch, dev, card):
    """The repaired evaluation driver end to end on the card:
    cli.stage2_test_semantic.main with `--synthetic 2`, MinkUNet at its
    defaults, in a scratch working directory (its log and checkpoint
    lookup). Returns K2's launches."""
    from seggroup_tpu_torch.cli import stage2_test_semantic
    from seggroup_tpu_torch.sparse import cuda_subm_conv

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            cuda_subm_conv.launches = 0
            t0 = time.perf_counter()
            miou, _, ap = stage2_test_semantic.main(["--synthetic", "2"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cuda_subm_conv.launches
            log = open(os.path.join("checkpoints", "exp", "minkunet_test.log")).read()
        finally:
            os.chdir(cwd)
    if launches < 2 * SUBM_PER_FORWARD:
        raise AssertionError(f"K2 launched {launches} times in the driver's 2 forwards")
    if "WARNING: random weights" not in log or "mIoU:" not in log:
        raise AssertionError("the driver's log lacks its lines")
    print(f"stage2_test_semantic.main --synthetic 2 (Res16UNet34C, capacity {CAPACITY}): "
          f"{wall:.3f} s with the model's build, {launches} K2 launches, mIoU {miou:.4f}, "
          f"mAP {np.nanmean(ap):.4f} (random weights); on {card}", flush=True)
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
    (rb_l0, l0), (rb_l3, l3) = bench["l0"], bench["l3"]
    cases += [((3, 32), rb_l0, l0), ((32, 32), rb_l0, l0),
              ((384, 256), rb_l3, l3), ((256, 256), rb_l3, l3)]
    n_old = len(cases)
    # this slice's shapes: the ST nets' K = 29 and K = 81, and Cout = 512
    cases += [(c, bench[key][0], bench[key][1]) for key in ("st29", "st81") for c in ST_PAIRS]
    cases += [((512, 512), rb_l3, l3)]
    max_err, timed, shapes = 0.0, None, {}
    for i, ((cin, cout), rb, note) in enumerate(cases):
        rows, kvol = rb.shape
        pairs_present = int((rb < rows).sum())
        f = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
        d = torch.randn(rows, cout, generator=g, device=dev).to(torch.bfloat16)
        got = cuda_subm_dw.subm_dw_cuda(f, d, rb)
        again = cuda_subm_dw.subm_dw_cuda(f, d, rb)
        want = subm_dw_plain(f, d, rb, torch.bfloat16)
        cin_p, cout_p = -(-cin // 8) * 8, -(-cout // 8) * 8
        slabs, slab_rows = cuda_subm_dw.slabs_for(rows, kvol, cin_p, cout_p, sms)
        pairs, counts = cuda_subm_dw.compact_pairs_cuda(rb, slabs, slab_rows)
        want_pairs, want_counts = cuda_subm_dw.compact_pairs_plain(rb, slabs, slab_rows)
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        filled = torch.arange(slab_rows, device=dev)[None, None, :] < want_counts[:, :, None]
        compact_equal = (torch.equal(counts, want_counts)
                         and torch.equal(pairs[filled], want_pairs[filled]))
        del pairs, want_pairs, filled
        line = (f"K3 {cuda_subm_dw.regime(cin)} ({cin},{cout}) K={kvol}{note}: max |kernel - "
                f"plain| = "
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
            ws = torch.zeros((slabs, kvol, cin_p, cout_p), dtype=torch.float32, device=dev)
            sum_ms = cuda_ms(lambda: cuda_subm_dw.sum_slabs_cuda(ws), reps=30, warmup=3)
            del ws
        plain_ms = cuda_ms(lambda: subm_dw_plain(f, d, rb, torch.bfloat16), reps=3, warmup=1)
        a = torch.cat([f, f.new_zeros(1, cin)])[rb.long()].reshape(rows, kvol * cin)
        library_ms = cuda_ms(lambda: torch.matmul(a.T, d), reps=20, warmup=2)
        del a
        # the bytes K3 must move (bf16 feats and dout, int32 rulebook, f32
        # dW), and 2*Cin*Cout operations per present pair
        nbytes = rows * cin * 2 + rows * cout * 2 + rows * kvol * 4 + kvol * cin * cout * 4
        flops = 2 * pairs_present * cin * cout
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{line}; bit-equal across two runs, compaction equal to its plain version; "
              f"kernel {ms:.4f} ms (compaction {compact_ms:.4f} ms, slab sum {sum_ms:.4f} ms, "
              f"product {ms - compact_ms - sum_ms:.4f} ms), plain {plain_ms:.3f} ms, library "
              f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s on {card}", flush=True)
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=by)
        if (cin, cout) == K2_TIMED and not note:
            timed = t
        if i >= n_old:
            shapes[f"({cin},{cout}) K={kvol} M={rows}"] = t
    return {"name": "subm_dw", "route": "cuda",
            "source": "seggroup_tpu_torch/csrc/subm_dw.cu",
            "replaces": "seggroup_tpu/sparse/pallas_conv.py:644",
            "max_abs_err": max_err, **timed, "new_shapes": shapes}


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
    Records the worst ratio per (kernel, Cin, Cout, rows, kernel volume),
    the calls per kernel, and in `empty` the keys whose every plain result
    was all zero (there the ratio says nothing)."""

    def __init__(self, torch):
        self.torch = torch
        self.worst: dict = {}
        self.calls: dict = {}
        self.empty: set = set()
        self.nonzero: set = set()

    def _checked(self, name, fn, plain, rtol):
        def call(a, b, rulebook, compute_dtype):
            got = fn(a, b, rulebook, compute_dtype)
            if a.is_cuda:
                want = plain(a, b, rulebook, compute_dtype)
                ratio = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
                key = (name, a.shape[1], got.shape[-1], a.shape[0], rulebook.shape[1])
                self.calls[name] = self.calls.get(name, 0) + 1
                self.worst[key] = max(self.worst.get(key, 0.0), ratio)
                if bool((want != 0).any()):
                    self.nonzero.add(key)
                    self.empty.discard(key)
                elif key not in self.nonzero:
                    self.empty.add(key)
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
        return "; ".join(f"{name} {self.calls[name]} calls over {len(r)} shapes, worst "
                         f"{max(r):.2e} of max|plain|" for name, r in sorted(by.items()))


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


def cc_pair_tests(torch, prep, tile: int) -> tuple[int, int, int]:
    """Pair tests of one sweep, counted from the prepared keys (not from
    the kernel): (those of the tiles' whole ranges, tile * (hi - lo) summed
    over tiles and groups, which a design walking each range for every
    query of the tile would test; those of every row's key runs, radius_cc.key_runs, which
    K4 walks by construction, invalid rows included; those the function
    needs, the key runs of the valid rows: a distance is needed only where
    the key test can pass)."""
    from seggroup_tpu_torch.ops import radius_cc

    span = (prep.hi - prep.lo).clamp(min=0)
    start, end, _, _ = radius_cc.key_runs(prep)
    run = (end - start).clamp(min=0)
    return (tile * int(span.sum()), int(run.sum()),
            int(run[prep.key < radius_cc.PAD_KEY].sum()))


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of `fn`, its launches queued behind a
    spin on the card so that none waits for the card."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


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
            dev_ms = device_ms(lambda: radius_cc.sweep(lab0, prep, r2), reps=30, warmup=3)
            wrapper_us = host_us(lambda: radius_cc.sweep(lab0, prep, r2))
            plain_ms = cuda_ms(lambda: radius_cc.sweep_plain(lab0, prep, r2), reps=2, warmup=1)
            # the operations the function needs: a distance (8 f32 operations:
            # 3 sub, 3 mul, 2 add) for each pair that can pass the key test,
            # not for each pair of a tile's whole ranges; its bytes: each row
            # read once (xyz, class, key, label: 24 B), one label written, the
            # two range tables read
            whole, in_runs, needed = cc_pair_tests(torch, prep, radius_cc.TILE)
            flops = 8 * needed
            nbytes = n * 28 + 2 * prep.lo.numel() * 4
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            print(f"K4 cc_sweep {name}: kernel {ms:.4f} ms per sweep back to back (mean of "
                  f"{len(each)} launches, min {min(each):.4f}, median "
                  f"{float(np.median(each)):.4f}), {dev_ms:.4f} ms device (launches queued "
                  f"behind a spin), the wrapper's host time {wrapper_us:.2f} us a call; plain "
                  f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}: bytes {t_bytes:.5f} ms for "
                  f"{nbytes / 1e6:.2f} MB, operations {t_ops:.5f} ms for {needed / 1e6:.3f} M "
                  f"pair tests within the 3-cell key runs, "
                  f"{needed / max(int(valid.sum()), 1):.1f} per valid row); every row's key "
                  f"runs, which the kernel walks by construction, hold {in_runs / 1e6:.3f} M "
                  f"pairs (a count from the keys, not a measurement; the tiles' whole "
                  f"ranges {whole / 1e6:.3f} M); kernel "
                  f"{dev_ms / bound:.1f} times its bound on device time; on {card}", flush=True)
            stats = {"rows": n, "valid_rows": int(valid.sum()), "sweeps_to_fixpoint": sweeps,
                     "ms": ms, "ms_min": min(each), "ms_median": float(np.median(each)),
                     "device_ms": dev_ms, "host_us": wrapper_us,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "pair_tests_needed": needed, "pair_tests_of_whole_ranges": whole}
            if row is None:
                row = {"name": "cc_sweep", "route": "cuda",
                       "source": "seggroup_tpu_torch/csrc/cc_sweep.cu",
                       "replaces": "seggroup_tpu/ops/pallas_cc.py:131", "max_abs_err": 0,
                       "ms": ms, "ms_min": stats["ms_min"], "ms_median": stats["ms_median"],
                       "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by,
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


def _pg_train_setup(torch, dev, seed=0):
    """The training driver's model (make_eval_model's PointGroup at m=16,
    7 levels of 2^16 >> i rows, a ScoreNet over 2^13) and its Adam."""
    from seggroup_tpu_torch.cli.stage2_test_pointgroup import make_eval_model
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import make_adam, step_schedule

    model = make_eval_model(PG_M, PG_VOXEL_CAP, dev, seed=seed)
    optimizer, scheduler = make_adam(model, step_schedule(PGT_LR, 0.5, 120000))
    return model, optimizer, scheduler


def _pg_wire_batch(scenes, step, phase=None):
    """The training driver's wire batch of `step` over `scenes`
    (make_train_batch at the driver's defaults, its generator seeded by
    (seed, step) at seed 1); `phase` times its halves, "host batch" and
    "voxelise"."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import make_train_batch

    return make_train_batch(scenes.__getitem__, range(len(scenes)),
                            np.random.default_rng((1, step)), PGT_BATCH, PG_POINT_CAP,
                            PG_VOXEL_CAP, PGT_INSTANCE_CAP, VOXEL, True, phase)


def _cluster_on_labels(torch, model, batch):
    """Has `model` cluster on heads made from the batch's own labels and
    instance centroids (one-hot scores of the true classes, offsets half-way
    to the instance's centroid, as cc_problems' true-label problem: at the
    whole offset an instance's points fall into one cell, past what the
    windowed sweep holds, and the exact fallback would take the clustering
    from K4), as a trained model's heads would give them; the model's own
    heads still feed the loss. A point past the voxel cap has no voxel and
    zero features, from which no heads can tell its class: it is given
    class 0, which does not cluster. At random weights the heads give few
    proposals, or none, of such points, and the ScoreNet then has no
    work."""
    voxels, p2v, coords, _, valid, labels, inst, centroid, _ = batch
    classes = model.linear.out_features
    known = valid & (p2v < voxels.capacity)
    sem = torch.nn.functional.one_hot(torch.where(known, labels, 0).clamp(0, classes - 1).long(),
                                      classes).float()
    on_inst = (known & (inst >= 0))[:, None]
    off = torch.where(on_inst, 0.5 * (centroid - coords), 0.0)
    cluster = type(model).cluster.__get__(model)
    model.cluster = lambda _sem, _off, *rest: cluster(sem, off, *rest)


def run_pointgroup_train_path(torch, dev, card):
    """PointGroup training at the training driver's defaults (m=16, 2^17
    points, 2^16 voxels, batch size 4, Adam lr 1e-3) over the 4 bench-size
    scenes, batches built ahead by the host prefetcher as the driver builds
    them, through cli.stage2_train_pointgroup.train_step: the prepare phase
    (no clustering, no score loss), then the clustering and the ScoreNet,
    each 2 warm-up steps, 4 timed unfenced and 2 fenced. The clustering
    steps cluster on heads made from each batch's labels
    (_cluster_on_labels), so that the ScoreNet works as it would after
    the prepare phase, and each must give a proposal. Checks the launch
    counts of K2 (forward and data gradient), K3 (weight gradient) and K4
    (at least one sweep a clustering step), finite losses and gradients,
    and that every parameter and running statistic moved. Returns the
    launch counts of each mode's timed steps."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import train_step
    from seggroup_tpu_torch.data.pg_wire import unpack_pg_batch
    from seggroup_tpu_torch.device import PhaseClock
    from seggroup_tpu_torch.utils.prefetch import HostPrefetcher

    scenes = [_pg_scene(i)[1:] for i in range(N_SCENES)]
    model, optimizer, scheduler = _pg_train_setup(torch, dev)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    jitter_gen = torch.Generator().manual_seed(2)
    prefetch = HostPrefetcher(lambda s: _pg_wire_batch(scenes, s + 1), depth=3, workers=1)
    losses, out = [], {}

    def step(clustering, batch, phases=None):
        jitter = torch.rand(3, generator=jitter_gen).to(dev)
        if clustering:
            _cluster_on_labels(torch, model, batch)
        loss, _, props = train_step(model, optimizer, scheduler, batch, clustering, jitter,
                                    phase_seconds=phases)
        losses.append(loss)
        return props

    try:
        for clustering in (False, True):
            mode = "clustering and ScoreNet" if clustering else "prepare phase"
            t0 = time.perf_counter()
            for _ in range(PGT_WARMUP):
                step(clustering, unpack_pg_batch(next(prefetch), PG_VOXEL_CAP, dev))
            torch.cuda.synchronize()
            print(f"PointGroup training warm-up ({mode}), {PGT_WARMUP} steps: "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)

            torch.cuda.reset_peak_memory_stats(dev)
            mods = _kernel_counts()
            for mod in mods.values():
                mod.launches = 0
            points, dropped, props = [], [], []
            t0 = time.perf_counter()
            for _ in range(PGT_STEPS):
                w = next(prefetch)
                points.append(int(w["nvalid"]))
                dropped.append(int((w["p2v"][:points[-1]] >= PG_VOXEL_CAP).sum()))
                props.append(step(clustering, unpack_pg_batch(w, PG_VOXEL_CAP, dev)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: mod.launches for name, mod in mods.items()}
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            props = [int(x) for x in props]

            # the split, each phase fenced by a synchronisation on each side
            phases: dict[str, float] = {}
            clock = PhaseClock(dev, phases)
            fenced_props = []
            t0 = time.perf_counter()
            for i in range(PGT_FENCED):
                w = _pg_wire_batch(scenes, 1000 + i, clock)
                with clock("voxelise"):  # the transfer and the voxel features on the card
                    batch = unpack_pg_batch(w, PG_VOXEL_CAP, dev)
                fenced_props.append(int(step(clustering, batch, phases)))
            fenced = (time.perf_counter() - t0) / PGT_FENCED

            n_subm = PG_SUBM_PER_FORWARD if clustering else PG_SUBM_UNET
            if (launches["subm_conv"] != (2 * n_subm - 1) * PGT_STEPS
                    or launches["subm_dw"] != n_subm * PGT_STEPS):
                raise AssertionError(f"PointGroup training ({mode}): K2 launched "
                                     f"{launches['subm_conv']} times, K3 "
                                     f"{launches['subm_dw']} in {PGT_STEPS} steps")
            if (launches["cc_sweep"] >= PGT_STEPS) != clustering or launches["masked_fps"]:
                raise AssertionError(f"PointGroup training ({mode}): K4 launched "
                                     f"{launches['cc_sweep']} times in {PGT_STEPS} steps, K1 "
                                     f"{launches['masked_fps']}")
            if clustering and min(props + fenced_props) < 1:
                raise AssertionError(f"PointGroup training ({mode}): a step gave no proposal: "
                                     f"timed {props}, fenced {fenced_props}")
            top = ("host batch", "voxelise", "unet", "clustering", "scorenet", "loss",
                   "backward", "optimizer")
            split = ", ".join(f"{k} {phases.get(k, 0.0) / PGT_FENCED:.4f} s" for k in top)
            inner = ", ".join(f"{k} {phases.get(k, 0.0) / PGT_FENCED:.4f} s"
                              for k in ("rulebooks", "subm_conv"))
            print(f"PointGroup training ({mode}), m={PG_M}, point cap {PG_POINT_CAP}, voxel "
                  f"cap {PG_VOXEL_CAP}, batch size {PGT_BATCH} from {N_SCENES} bench-size "
                  f"scenes (valid points {points}, of them without a voxel past the cap "
                  f"{dropped}), Adam lr {PGT_LR}: "
                  f"{wall / PGT_STEPS:.4f} s/step over {PGT_STEPS} steps, "
                  f"{sum(points) / wall:.1f} points/s; fenced split per step "
                  f"({fenced:.4f} s/step): {split}; inside the forward: {inner}; peak "
                  f"{peak_gib:.2f} GiB; per step {launches['subm_conv'] / PGT_STEPS:.1f} K2, "
                  f"{launches['subm_dw'] / PGT_STEPS:.1f} K3 and "
                  f"{launches['cc_sweep'] / PGT_STEPS:.2f} K4 launches; proposals per step "
                  f"{props}, fenced {fenced_props}"
                  f"{' (clustered on heads from the labels)' if clustering else ''}; on {card}, "
                  f"{machine_id(torch)}", flush=True)
            out[clustering] = dict(launches, s_per_step=wall / PGT_STEPS,
                                   points_per_s=sum(points) / wall, peak_gib=peak_gib,
                                   proposals=props)
    finally:
        prefetch.close()

    loss_values = [float(x) for x in losses]
    if not np.isfinite(loss_values).all():
        raise AssertionError(f"non-finite PointGroup training loss: {loss_values}")
    for name, p in model.named_parameters():
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"gradient of {name} not finite")
    unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[k])]
    if unmoved:
        raise AssertionError(f"parameters or running statistics did not move: {unmoved}")
    print(f"PointGroup training losses {[round(x, 4) for x in loss_values]}; every parameter "
          f"and running statistic moved, the ScoreNet's among them", flush=True)
    return out


def pointgroup_train_checked_step(torch, dev):
    """One PointGroup train step with the clustering, every K2 and K3 call
    of it (forward, data gradient, weight gradient; the K = 1 branches
    among them) held against its plain version on the same card inputs
    (CheckedDispatch): at the driver's defaults on a bench batch, clustered
    on heads from its labels (_cluster_on_labels) so that the ScoreNet's
    U-Net runs on nonzero features, and with the small model (m=8) on a 2,048-point
    batch on its own heads. Each must give a proposal, every gradient must
    be nonzero but that of the bias before the heads' training BatchNorm,
    and every shape of K2 and K3 must have met a nonzero plain result."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import make_adam, step_schedule, train_step
    from seggroup_tpu_torch.data.pg_wire import unpack_pg_batch
    from seggroup_tpu_torch.models.pointgroup import PointGroup

    scenes = [_pg_scene(i)[1:] for i in range(N_SCENES)]
    w = _pg_wire_batch(scenes, 2000)
    full = (*_pg_train_setup(torch, dev, seed=1), unpack_pg_batch(w, PG_VOXEL_CAP, dev),
            int(w["nvalid"]))
    _cluster_on_labels(torch, full[0], full[3])
    small = PointGroup(device=dev, seed=5, **PG_SMALL)
    small = (small, *make_adam(small, step_schedule(PGT_LR, 0.5, 120000)),
             _pg_small_train_batch(torch, dev), 2048)
    jitter = torch.tensor([0.25, 0.5, 0.75], device=dev)
    for name, (model, optimizer, scheduler, batch, n) in (("the driver's defaults", full),
                                                          ("m=8", small)):
        with CheckedDispatch(torch) as checked:
            loss, _, props = train_step(model, optimizer, scheduler, batch, True, jitter)
        k1 = sum(1 for key in checked.worst if key[0] == "K3" and key[4] == 1)
        zero = [k for k, p in model.named_parameters()
                if float(p.grad.abs().max()) == 0 and k != PGT_ZERO_GRAD]
        n_subm = sum(1 for k in dict(model.named_parameters()) if k.endswith(".kernel"))
        line = (f"PointGroup train step at {name} ({n} points, {int(props)} proposals), every "
                f"kernel call against its plain version: {checked.summary()}; K3 at kernel "
                f"volume 1 over {k1} shapes; shapes whose every plain result was zero "
                f"{len(checked.empty)}; loss {float(loss):.6f}; zero gradients {len(zero)}")
        if (checked.calls.get("K2") != 2 * n_subm - 1 or checked.calls.get("K3") != n_subm
                or k1 < 1 or not np.isfinite(float(loss)) or zero or int(props) < 1
                or checked.empty):
            raise AssertionError(f"{line}: {zero} {sorted(checked.empty)}")
        print(line, flush=True)


def check_subm_dw_pointgroup(torch, dev, card):
    """K3 against its plain version in bf16 at every (Cin, Cout) of
    PointGroup at m=16 on 65,536 dense sites: K = 27 over the site
    rulebook, K = 1 over each row's own index; each case run twice and
    required bit-equal; kernel, plain and pre-gathered matmul times beside
    the bound (at K = 1 the matmul is feats^T @ dout over the present
    rows). Returns (largest error, times per case)."""
    from seggroup_tpu_torch.sparse import cuda_subm_dw
    from seggroup_tpu_torch.sparse.conv import subm_dw_plain

    m = PG_VOXEL_CAP
    rb27 = k2_sites(torch, dev, m)
    rb1 = torch.arange(m, dtype=torch.int32, device=dev)[:, None].contiguous()
    g = torch.Generator(device=dev).manual_seed(3)
    worst, cases = 0.0, {}
    for (cin, cout), rb in [(c, rb27) for c in PG_PAIRS] + [(c, rb1) for c in PG_K1_PAIRS]:
        kvol = rb.shape[1]
        f = torch.randn(m, cin, generator=g, device=dev).to(torch.bfloat16)
        d = torch.randn(m, cout, generator=g, device=dev).to(torch.bfloat16)
        got = cuda_subm_dw.subm_dw_cuda(f, d, rb)
        again = cuda_subm_dw.subm_dw_cuda(f, d, rb)
        want = subm_dw_plain(f, d, rb, torch.bfloat16)
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        present = int((rb < m).sum())
        line = (f"K3 {cuda_subm_dw.regime(cin)} ({cin},{cout}) K={kvol} PointGroup, M={m}: "
                f"max |kernel - plain| = {err:.3e} = {err / scale:.2e} of max|plain| "
                f"({present / m:.2f} present neighbours per row)")
        if err > K3_RTOL * scale or not torch.isfinite(got).all():
            raise AssertionError(line)
        if not torch.equal(got, again):
            raise AssertionError(f"{line}: two runs on the same inputs differ")
        worst = max(worst, err)
        ms = cuda_ms(lambda: cuda_subm_dw.subm_dw_cuda(f, d, rb), reps=20, warmup=2)
        plain_ms = cuda_ms(lambda: subm_dw_plain(f, d, rb, torch.bfloat16), reps=2, warmup=1)
        a = torch.cat([f, f.new_zeros(1, cin)])[rb.long()].reshape(m, kvol * cin)
        library_ms = cuda_ms(lambda: torch.matmul(a.T, d), reps=20, warmup=2)
        del a
        nbytes = m * cin * 2 + m * cout * 2 + m * kvol * 4 + kvol * cin * cout * 4
        flops = 2 * present * cin * cout
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        print(f"{line}; bit-equal across two runs; kernel {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, library {library_ms:.4f} ms, bound {bound:.4f} ms ({by}); kernel "
              f"{ms / library_ms:.2f} times the library on {card}", flush=True)
        cases[f"({cin},{cout}) K={kvol}"] = dict(ms=ms, plain_ms=plain_ms,
                                                 library_ms=library_ms, bound_ms=bound,
                                                 bound_by=by)
    return worst, cases


class PlainConvs:
    """While active, the submanifold convs run their plain versions at
    float32 on every device (the kernels take bf16 operands only), so
    that the card and the CPU differ only in the order of their sums."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import functools

        from seggroup_tpu_torch.models import minkunet
        from seggroup_tpu_torch.sparse import conv

        self.saved = conv._subm_apply, conv._subm_dw, minkunet.subm_conv
        conv._subm_apply, conv._subm_dw = conv.subm_conv_plain, conv.subm_dw_plain
        minkunet.subm_conv = functools.partial(minkunet.subm_conv,
                                               compute_dtype=self.torch.float32)
        return self

    def __exit__(self, *exc):
        from seggroup_tpu_torch.models import minkunet
        from seggroup_tpu_torch.sparse import conv

        conv._subm_apply, conv._subm_dw, minkunet.subm_conv = self.saved


def _pg_small_train_batch(torch, dev, seed=7):
    """A small scene (4,096 points) in a 2,048-point batch, voxelised by the
    training driver's host voxelisation into 2,048 rows, on `dev`."""
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import (host_voxelize_plan,
                                                                 make_pg_batch,
                                                                 scene_instance_tuple)
    from seggroup_tpu_torch.data.pg_wire import pack_pg_batch, unpack_pg_batch
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene

    scene = scene_instance_tuple(make_synthetic_scene(seed=seed), {}, None, "")
    hb = make_pg_batch([scene], 2048, 64)
    vcoords, num, p2v = host_voxelize_plan(hb, VOXEL, 2048)
    return unpack_pg_batch(pack_pg_batch(hb, vcoords, num, p2v), 2048, dev)


def pointgroup_train_card_vs_cpu(torch, dev, card):
    """One PointGroup train forward and backward (m=8, the clustering and
    the ScoreNet, a fixed jitter) at float32 convs on a 2,048-point batch,
    on the card and on the CPU from the same weights: integer outputs
    equal, the loss, each gradient and the running statistics within the
    bounds the CPU tests hold the port to against JAX. Then 30 Adam steps
    of the bf16 model (K2, K3, K4) on that batch on the card: the mean of
    the last 5 losses must be below the mean of the first 5."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import make_adam, step_schedule, train_step
    from seggroup_tpu_torch.models.pointgroup import PointGroup, pointgroup_loss

    jitter = torch.tensor([0.25, 0.5, 0.75])
    cpu = torch.device("cpu")

    def run(d, heads=None):
        """The float32 step on `d`; with `heads` (the CPU's scores and
        offsets), clustered on those."""
        model = PointGroup(device=d, seed=4, **PG_SMALL)
        with torch.no_grad():  # spread the statistics so that no layer is the identity
            for name, buf in model.named_buffers():
                buf.copy_(torch.linspace(0.5, 1.5, buf.numel()) if name.endswith("var")
                          else torch.linspace(-0.2, 0.2, buf.numel()))
        if heads is not None:
            cluster = model.cluster
            model.cluster = lambda sem, off, *rest, **kw: cluster(
                *(h.to(d) for h in heads), *rest, **kw)
        st, p2v, coords, batch_ids, valid, labels, inst, centroid, pointnum = (
            _pg_small_train_batch(torch, d))
        with PlainConvs(torch):
            out = model(st, p2v, coords, batch_ids, valid, do_clustering=True, train=True,
                        jitter=jitter.to(d))
            loss, _ = pointgroup_loss(out, labels, inst, centroid, pointnum, coords, valid,
                                      pointnum.shape[0], True)
            loss.backward()
        return model, out, float(loss), valid.cpu()

    m_b, b, loss_b, valid = run(cpu)
    m_a, a, loss_a, _ = run(dev)
    heads = float((a.semantic_scores.detach().cpu() - b.semantic_scores.detach()).abs().max())
    top2 = b.semantic_scores.detach().topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    flipped = valid & (a.semantic_scores.detach().cpu().argmax(1)
                       != b.semantic_scores.detach().argmax(1))
    pinned = ""
    if bool(flipped.any()):
        # a class argmax at a near-tie may fall the other way under another
        # summation order; the step is then held at shared proposals
        if float(gap[flipped].max()) > 2 * heads:
            raise AssertionError(f"PointGroup train: card vs CPU argmax differs where the "
                                 f"two best classes are {float(gap[flipped].max()):.2e} apart, "
                                 f"the heads within {heads:.2e}")
        pinned = (f"; {int(flipped.sum())} argmaxes fell the other way at near-ties (the "
                  f"widest gap {float(gap[flipped].max()):.2e}), so held at shared proposals")
        m_a, a, loss_a, _ = run(dev, (b.semantic_scores.detach(), b.pt_offsets.detach()))
    for name in ("proposal_of_point", "proposal_valid", "num_proposals"):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        if not torch.equal(x, y):
            raise AssertionError(f"PointGroup train {name}: card vs CPU differ at "
                                 f"{int((x != y).sum())} entries")
    # a point whose features are all zero scores every class at its bias,
    # exactly the same on both sides: the least gap that is not such a tie
    gap = float(gap[valid & (gap > 0)].min())
    loss_err = abs(loss_a - loss_b) / abs(loss_b)
    if loss_err > PGT_LOSS_RTOL:
        raise AssertionError(f"PointGroup train loss: card {loss_a} vs CPU {loss_b}")
    grad_err = 0.0
    cpu_params = dict(m_b.named_parameters())
    for name, p in m_a.named_parameters():
        got, want = p.grad.cpu(), cpu_params[name].grad
        if name == PGT_ZERO_GRAD:
            if max(float(got.abs().max()), float(want.abs().max())) > PGT_NOISE_GRAD:
                raise AssertionError(f"gradient of {name} is not rounding noise")
            continue
        if float(want.abs().max()) == 0:
            raise AssertionError(f"gradient of {name} is zero")
        err = float((got - want).abs().max()) / float(want.abs().max())
        if not err <= PGT_GRAD_RTOL:
            raise AssertionError(f"gradient of {name}: card vs CPU differ by {err:.3e} of "
                                 f"its max")
        grad_err = max(grad_err, err)
    cpu_buffers = dict(m_b.named_buffers())
    stat_err = 0.0
    for name, v in m_a.named_buffers():
        if not torch.allclose(v.cpu(), cpu_buffers[name], rtol=PGT_STAT_TOL, atol=PGT_STAT_TOL):
            raise AssertionError(f"running statistic {name}: card vs CPU differ by "
                                 f"{float((v.cpu() - cpu_buffers[name]).abs().max())}")
        stat_err = max(stat_err, float((v.cpu() - cpu_buffers[name]).abs().max()))
    print(f"card vs CPU, PointGroup train step m=8 at N=2048 float32 convs with the "
          f"clustering: proposals equal ({int(b.num_proposals)}{pinned}), semantic scores "
          f"within {heads:.2e} (least nonzero gap of a valid point's two best classes "
          f"{gap:.2e}), loss "
          f"{loss_b:.6f} (relative error {loss_err:.2e}), gradients within {grad_err:.2e} of "
          f"their max, running statistics within {stat_err:.2e}", flush=True)
    if int(b.num_proposals) < 1:
        raise AssertionError("PointGroup card vs CPU train step: no proposal")

    model = PointGroup(device=dev, seed=5, **PG_SMALL)
    optimizer, scheduler = make_adam(model, step_schedule(PGT_LR, 0.5, 120000))
    batch = _pg_small_train_batch(torch, dev)
    gen = torch.Generator().manual_seed(6)
    losses = [float(train_step(model, optimizer, scheduler, batch, True,
                               torch.rand(3, generator=gen).to(dev))[0])
              for _ in range(OVERFIT_STEPS)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    line = (f"PointGroup overfit, bf16 m=8 with the clustering on one batch of 2048 points, "
            f"{OVERFIT_STEPS} Adam steps: mean loss of the first 5 {first:.4f}, of the last 5 "
            f"{last:.4f}; on {card}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{line}; losses {losses}")
    print(line, flush=True)


def _kpconv_model(torch, dev, seed=0):
    """KPFCNN at the driver's defaults, seeded, with nonzero offset kernels."""
    from seggroup_tpu_torch.models.kpconv import KPFCNN, KPConvLayer

    model = KPFCNN(num_classes=20, first_features_dim=KP_FDIM, dl0=KP_DL0, seed=seed,
                   device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, KPConvLayer) and mod.deformable:
                mod.offset_kernel.copy_(torch.randn(mod.offset_kernel.shape, generator=g)
                                        * KP_OFFSET_STD)
    return model


def run_kpconv_path(torch, dev, card):
    """KPConv semantic inference at the evaluation driver's defaults over
    KP_SCENES bench scenes with 3 votes, through cli.stage2_test_semantic's
    test_semantic_kpconv, at seeded weights with nonzero offset kernels;
    then the pyramid and the logits of one sphere on the card and on the
    CPU."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import (KPCONV_LAYERS, kpconv_level_caps,
                                                             test_semantic_kpconv)
    from seggroup_tpu_torch.data.potentials import PotentialSampler
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.models.kpconv import build_pyramid, kernel_point_positions

    t0 = time.perf_counter()
    kernel_point_positions(15)
    print(f"KPConv kernel points (numpy, once a process): {time.perf_counter() - t0:.3f} s",
          flush=True)
    model = _kpconv_model(torch, dev)
    scenes = []
    for i in range(KP_SCENES):
        name = f"bench{i}"
        scenes.append((name, *scene_to_training_tuple(
            make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None, name, False)))
    # the first sphere of scene 0, as the driver draws it: the warm-up, and
    # the card vs CPU comparison below
    _, c, col, _ = scenes[0]
    center = PotentialSampler([c], in_radius=KP_RADIUS, seed=0).next_center()[1]
    sel = np.where(((c - center) ** 2).sum(1) < KP_RADIUS ** 2)[0][:KP_POINT_CAP]
    pts = np.zeros((KP_POINT_CAP, 3), np.float32)
    feats = np.ones((KP_POINT_CAP, 4), np.float32)
    pts[: len(sel)] = c[sel]
    feats[: len(sel), 1:] = col[sel] / 255.0
    valid = np.arange(KP_POINT_CAP) < len(sel)

    def sphere(d, m):
        pyr = build_pyramid(torch.from_numpy(pts).to(d),
                            torch.zeros(KP_POINT_CAP, dtype=torch.int32, device=d),
                            torch.from_numpy(valid).to(d), KPCONV_LAYERS, KP_DL0,
                            level_caps=kpconv_level_caps(KP_POINT_CAP))
        with torch.no_grad():
            logits, reg = m(pyr, torch.from_numpy(feats).to(d))
        return [[t.cpu() for t in lvl] for lvl in pyr], logits.cpu(), float(reg)

    on_card = sphere(dev, model)  # warm-up
    torch.cuda.synchronize()
    phases: dict[str, float] = {}
    log: list = []
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    (miou, _, ap), launches = _count_launches(
        torch, lambda: test_semantic_kpconv(model, scenes, KP_POINT_CAP, KP_RADIUS, KP_VOTES,
                                            20, phase_seconds=phases, scene_log=log))
    wall = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError(f"KPConv inference launched a kernel: {launches}")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for rec in log:
        if rec["coverage"] != 1.0 or not rec["logits_finite"]:
            raise AssertionError(f"{rec['name']}: coverage {rec['coverage']}, finite "
                                 f"{rec['logits_finite']}")
    spheres = [rec["spheres"] for rec in log]
    over = np.mean([rec["overflow"] for rec in log], axis=0)
    split = ", ".join(f"{k} {v / KP_SCENES:.4f} s" for k, v in sorted(phases.items()))
    print(f"KPConv semantic inference (KPFCNN, first_features_dim {KP_FDIM}, dl0 {KP_DL0}, "
          f"point_cap {KP_POINT_CAP}, in_radius {KP_RADIUS}, {KP_VOTES} votes) over "
          f"{KP_SCENES} scenes of {BENCH_SCENE['num_points']} points: {wall / KP_SCENES:.4f} "
          f"s/scene, spheres per scene {spheres} ({wall / sum(spheres):.4f} s/sphere); per "
          f"scene, fenced: {split}; neighbour-overflow rate per level {over.round(4).tolist()}; "
          f"peak {peak_gib:.2f} GiB; mIoU {miou:.4f}, mAP {np.nanmean(ap):.4f} (random "
          f"weights); on {card}", flush=True)

    # card vs CPU on that sphere
    (pa, la, ra), (pb, lb, rb) = on_card, sphere(torch.device("cpu"),
                                                 _kpconv_model(torch, "cpu"))
    for i, (x, y) in enumerate(zip(pa, pb)):
        for name, s, t in zip(("points", "batch", "valid", "neighbors", "pools", "upsamples"),
                              x, y):
            if not torch.equal(s, t):
                raise AssertionError(f"KPConv pyramid level {i} {name}: card vs CPU differ")
    err = float((la - lb).abs().max())
    scale = float(lb.abs().max())
    if not err <= KP_LOGIT_RTOL * scale or abs(ra - rb) > KP_LOGIT_RTOL * abs(rb):
        raise AssertionError(f"KPConv logits card vs CPU differ by {err} of {scale}, "
                             f"regulariser {ra} vs {rb}")
    print(f"KPConv card vs CPU on one sphere ({len(sel)} points): the pyramid's arrays "
          f"equal at all {KPCONV_LAYERS} levels, logits within {err:.3g} of max "
          f"{scale:.4g} (bound {KP_LOGIT_RTOL} of it), regulariser {ra:.6g} vs {rb:.6g}",
          flush=True)
    return {"spheres": spheres, "seconds_per_scene": wall / KP_SCENES, "launches": launches}


# ---------------------------------------------------------------------------
# KPConv training, KPCNN classification and introspection
# ---------------------------------------------------------------------------

# the training driver at its defaults on 2 bench scenes (val_frac holds out 1)
KPT_STEPS, KPT_SCENES, KPT_POINT_CAP = 10, 2, 2 ** 15
# bench.py's KPConv train step (stage2_kpconv_s_per_iter): 2^17 points in 10
# spheres of 2 m surfaces, level caps n >> i, neighbour cap 32, regulariser
# weight 1e-3; 2 warm-ups and 4 timed steps
KPB_POINTS, KPB_SPHERES, KPB_REG, KPB_WARMUP, KPB_STEPS = 2 ** 17, 10, 1e-3, 2, 4
# card vs CPU: two levels of deformable v1 (or modulated v2) blocks on 4 batch
# elements of 1,024 points at dl0 0.05 (a net whose float32 gradients are not
# chaotic; tests/test_torch_kpconv_train.py): loss within 1e-5 relative, each
# gradient within 1e-4 of its max, running statistics within 1e-5
KPC_POINTS, KPC_BATCHES, KPC_DL0, KPC_FDIM = 4096, 4, 0.05, 16
KPC_SHALLOW = {"v1": ("simple", "resnetb_deformable", "resnetb_deformable_strided",
                      "resnetb_deformable", "nearest_upsample", "unary"),
               "v2": ("simple", "resnetb_deformable_v2", "resnetb_deformable_v2_strided",
                      "resnetb_deformable_v2", "nearest_upsample", "unary")}
# the weights' seeds: at some seeds (3 and 5 for v2) float32 itself is
# chaotic here, the CPU's gradients moving by 6e-4 to 2e-2 of their max when
# the features move by 1e-7; the phase measures that move (the CPU's own
# spread) and requires it under KPC_SPREAD
KPC_SEEDS, KPC_SPREAD = {"v1": 3, "v2": 7}, 1e-5
KPC_LOSS_RTOL, KPC_GRAD_RTOL, KPC_STATS_ATOL = 1e-5, 1e-4, 1e-5
# overfit: the driver's model on one batch of 2^13 points, 30 SGD steps; the
# mean of the last 5 losses must be at most this share of the first 5's
KPO_POINTS, KPO_FALL = 2 ** 13, 0.5


def _kernel_counts():
    from seggroup_tpu_torch.ops import cuda_cc, cuda_fps
    from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw

    return {"masked_fps": cuda_fps, "subm_conv": cuda_subm_conv, "subm_dw": cuda_subm_dw,
            "cc_sweep": cuda_cc}


def _count_launches(torch, fn, *args):
    """fn(*args) with every kernel's count set to 0 just before; returns
    (its result, {kernel: launches})."""
    mods = _kernel_counts()
    for mod in mods.values():
        mod.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {name: mod.launches for name, mod in mods.items()}


def _bench_scene_source():
    """SceneSource's synthetic scenes at bench size, for the drivers'
    `--synthetic N`: restores the 4,096-point ones on exit."""
    from contextlib import contextmanager
    from functools import partial

    from seggroup_tpu_torch.cli import stage1_common
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene

    @contextmanager
    def patched():
        stage1_common.make_synthetic_scene = partial(make_synthetic_scene, **BENCH_SCENE)
        try:
            yield
        finally:
            stage1_common.make_synthetic_scene = make_synthetic_scene
    return patched()


def _room_sphere_points(rng, n, radius):
    """bench.py's `room_sphere_points`: a floor disc (45%), two wall strips
    (30%) and furniture blobs (25%) inside an in_radius sphere."""
    nf = int(n * 0.45)
    nw = int(n * 0.30)
    nb = n - nf - nw
    floor = np.stack([rng.uniform(-radius, radius, nf), rng.uniform(-radius, radius, nf),
                      rng.normal(0, 0.01, nf) - radius * 0.6], 1)
    walls = []
    for k in range(2):
        m = nw // 2 if k == 0 else nw - nw // 2
        w = np.stack([rng.normal(0, 0.01, m) + (radius * 0.7 if k else -radius * 0.5),
                      rng.uniform(-radius, radius, m), rng.uniform(-radius * 0.6, radius, m)], 1)
        walls.append(w if k else w[:, [1, 0, 2]])
    centers = rng.uniform(-radius * 0.6, radius * 0.6, (6, 3))
    which = rng.integers(0, 6, nb)
    blobs = centers[which] + rng.normal(0, 0.12, (nb, 3))
    p = np.concatenate([floor] + walls + [blobs]).astype(np.float32)
    r = np.linalg.norm(p, axis=1)
    p[r > radius] *= (radius / r[r > radius])[:, None] * 0.999
    return p


def _bench_kpconv_batch():
    """bench.py's stage2_kpconv_s_per_iter inputs: (points, batch ids,
    valid, feats, labels)."""
    rng = np.random.default_rng(0)
    n = KPB_POINTS
    per = n // KPB_SPHERES
    pts = np.zeros((n, 3), np.float32)
    bids = np.zeros(n, np.int32)
    for b in range(KPB_SPHERES):
        center = rng.uniform(0, 8, 3).astype(np.float32)
        sl = slice(b * per, (b + 1) * per)
        pts[sl] = center + _room_sphere_points(rng, per, 2.0)
        bids[sl] = b
    valid = np.ones(n, bool)
    feats = np.concatenate([np.ones((n, 1), np.float32), rng.random((n, 3)).astype(np.float32)],
                           1)
    labels = rng.integers(0, 20, n).astype(np.int32)
    return pts, bids, valid, feats, labels


def _peak_gib(torch, dev):
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def run_kpconv_train_path(torch, dev, card, work):
    """KPConv training: (a) cli.stage2_train_kpconv.main at its defaults on 2
    bench scenes, --steps 10 --save_freq 10, in `work` (its checkpoint is
    what the introspection phase restores); (b) one fenced step of the
    driver's: host batch, pyramid, forward, loss, backward, gradient
    transform, SGD; (c) bench.py's KPConv step, 2 warm-ups and 4 timed.
    Returns the kernels' launches in (a) and the figures."""
    import ast
    import re

    from seggroup_tpu_torch.cli import stage2_train_kpconv as TR
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import kpconv_level_caps
    from seggroup_tpu_torch.data.potentials import PotentialSampler
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.device import PhaseClock
    from seggroup_tpu_torch.models.kpconv import KPFCNN

    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        with _bench_scene_source():
            # one rank in this process, whatever the cards (the bench scenes
            # are swapped in here, and the kernels counted here)
            _, launches = _count_launches(torch, TR.main, ["--synthetic", str(KPT_SCENES),
                                                          "--steps", str(KPT_STEPS),
                                                          "--save_freq", str(KPT_STEPS),
                                                          "--num_devices", "1"])
        wall = time.perf_counter() - t0
        log = open(os.path.join("checkpoints", "exp", "kpconv.log")).read()
    finally:
        os.chdir(cwd)
    caps_line = next(ln for ln in log.splitlines() if ln.startswith("calibrated neighbor caps"))
    step_line = next(ln for ln in log.splitlines() if ln.startswith(f"step {KPT_STEPS}/"))
    val_lines = [ln for ln in log.splitlines() if "val acc" in ln or "overflow %" in ln]
    s_it = float(re.search(r"\(([\d.]+)s/it\)", step_line).group(1))
    loss = float(re.search(r"loss ([\d.]+)", step_line).group(1))
    if not (np.isfinite(loss) and len(val_lines) == 2 and "kpconv" in os.listdir(
            os.path.join(work, "checkpoints", "exp"))):
        raise AssertionError(f"the KPConv trainer's log: {log}")
    print(f"stage2_train_kpconv.main at its defaults on {KPT_SCENES} bench scenes of "
          f"{BENCH_SCENE['num_points']} points (1 held out), --steps {KPT_STEPS}: {wall:.2f} s "
          f"with the build and calibration; {caps_line}; {step_line}; "
          + "; ".join(ln.strip() for ln in val_lines)
          + f"; kernel launches {launches}; on {card}", flush=True)
    nbr_caps = ast.literal_eval(caps_line.split(": ", 1)[1].split(" (")[0])

    # (b) the driver's step, fenced
    name = "bench0"
    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=0, **BENCH_SCENE), {}, None,
                                      name, False)]
    n_cap = KPT_POINT_CAP
    caps = kpconv_level_caps(n_cap)
    sampler = PotentialSampler([c for c, _, _ in scenes], in_radius=2.0, seed=1)
    rng = np.random.default_rng(1)
    model = KPFCNN(first_features_dim=64, dl0=0.04, seed=1, device=dev)
    optimizer, scheduler = TR.make_sgd(model, 1e-2)
    split: dict[str, float] = {}
    points = 0
    for step in range(2):  # a warm-up, then the fenced step
        phases = split if step else {}
        phase = PhaseClock(dev, phases)
        with phase("host batch"):
            pts, feats, labs, bids, valid = TR.sample_batch(scenes, sampler, rng, 4, 2.0, n_cap)
        with phase("pyramid"):
            pyr = TR.to_device_pyramid(pts, bids, valid, dev, 0.04, caps, nbr_caps)
        if step:
            torch.cuda.reset_peak_memory_stats(dev)
        TR.train_step(model, optimizer, scheduler, pyr, torch.from_numpy(feats).to(dev),
                      torch.from_numpy(labs).to(dev), phase_seconds=phases)
        points = int(valid.sum())
    peak = _peak_gib(torch, dev)
    total = sum(split.values())
    print(f"KPConv driver step, fenced ({points} points in 4 spheres, point cap {n_cap}, "
          f"neighbour caps {nbr_caps}): " + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
          + f"; total {total:.4f} s = {points / total:.1f} points/s; peak {peak:.2f} GiB; "
          f"on {card}", flush=True)

    # (c) bench.py's configuration
    pts, bids, valid, feats, labels = _bench_kpconv_batch()
    bcaps = [KPB_POINTS >> i for i in range(1, 5)]
    model = KPFCNN(first_features_dim=64, dl0=0.04, seed=0, device=dev)
    optimizer, scheduler = TR.make_sgd(model, 1e-2)
    f_d, l_d = torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev)

    def bench_step(phases=None):
        with PhaseClock(dev, phases)("pyramid"):
            pyr = TR.to_device_pyramid(pts, bids, valid, dev, 0.04, bcaps, [32] * 5)
        return TR.train_step(model, optimizer, scheduler, pyr, f_d, l_d,
                             offset_loss_weight=KPB_REG, phase_seconds=phases)[0]

    for _ in range(KPB_WARMUP):
        bench_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = [bench_step() for _ in range(KPB_STEPS)]
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / KPB_STEPS
    peak_b = _peak_gib(torch, dev)
    bsplit: dict[str, float] = {}
    bench_step(bsplit)
    if not all(np.isfinite(float(x)) for x in losses):
        raise AssertionError(f"bench.py KPConv step losses {losses}")
    print(f"KPConv train step at bench.py's configuration ({KPB_POINTS} points, "
          f"{KPB_SPHERES} spheres, caps n >> i, neighbour cap 32): {per_step:.4f} s/step "
          f"= {KPB_POINTS / per_step:.1f} points/s over {KPB_STEPS} steps after {KPB_WARMUP} "
          f"warm-ups; peak {peak_b:.2f} GiB; one fenced: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in bsplit.items()) + f"; on {card}", flush=True)
    return {"launches": launches, "driver_s_per_step": s_it, "split": split,
            "bench_s_per_step": per_step}


def _kpc_inputs():
    rng = np.random.default_rng(15)
    n = KPC_POINTS
    pts = rng.random((n, 3)).astype(np.float32)
    bids = (np.arange(n) * KPC_BATCHES // n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[-n // 10:] = False
    pts[~valid] = 0.0
    feats = np.ones((n, 4), np.float32)
    feats[:, 1:] = rng.random((n, 3))
    labels = rng.integers(0, 20, n).astype(np.int32)
    labels[rng.random(n) < 0.1] = 255
    labels[~valid] = 255
    return pts, bids, valid, feats, labels


def kpconv_train_card_vs_cpu(torch, dev, card):
    """One float32 train step (cli.stage2_train_kpconv.train_step) of a
    two-level KPFCNN with deformable v1, then modulated v2, blocks at
    nonzero offset weights (KP_OFFSET_STD) on the card and on the CPU from
    the same weights; then 30 steps of the driver's model on one batch on
    the card, whose loss must fall."""
    from seggroup_tpu_torch.cli import stage2_train_kpconv as TR
    from seggroup_tpu_torch.models.kpconv import KPFCNN, build_pyramid

    pts, bids, valid, feats, labels = _kpc_inputs()
    caps = [KPC_POINTS >> i for i in range(1, 5)]
    moved = feats * (1 + 1e-7 * np.random.default_rng(3).standard_normal(feats.shape)
                     ).astype(np.float32)
    lines = []
    for arch, architecture in KPC_SHALLOW.items():
        ref = KPFCNN(architecture=architecture, first_features_dim=KPC_FDIM, dl0=KPC_DL0,
                     modulated=arch == "v2", seed=KPC_SEEDS[arch], device="cpu")
        g = torch.Generator().manual_seed(KPC_SEEDS[arch] + 1)
        with torch.no_grad():
            for name, p in ref.named_parameters():
                if "offset" in name:
                    p.copy_(torch.randn(p.shape, generator=g) * KP_OFFSET_STD)
        state = {k: v.clone() for k, v in ref.state_dict().items()}
        runs = []
        for d, f in ((dev, feats), (torch.device("cpu"), feats), (torch.device("cpu"), moved)):
            model = KPFCNN(architecture=architecture, first_features_dim=KPC_FDIM, dl0=KPC_DL0,
                           modulated=arch == "v2", device=d)
            model.load_state_dict(state)
            optimizer, scheduler = TR.make_sgd(model, 1e-2)
            pyr = build_pyramid(*(torch.from_numpy(x).to(d) for x in (pts, bids, valid)), 5,
                                KPC_DL0, level_caps=caps)
            loss, _ = TR.train_step(model, optimizer, scheduler, pyr,
                                    torch.from_numpy(f).to(d), torch.from_numpy(labels).to(d))
            runs.append((float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()},
                         {n: b.cpu() for n, b in model.named_buffers()}))
        (la, ga, ba), (lb, gb, bb), (_, gm, _) = runs

        def spread(x, y):
            return max(float((x[n] - y[n]).abs().max() / y[n].abs().max()) for n in y)
        grad_err, own = spread(ga, gb), spread(gm, gb)
        stats_err = max(float((ba[n] - bb[n]).abs().max()) for n in bb)
        line = (f"{arch} (seed {KPC_SEEDS[arch]}): loss {la:.6f} vs {lb:.6f}, gradients within "
                f"{grad_err:.3g} of their max (the CPU's own move at features moved by 1e-7: "
                f"{own:.3g}), running statistics within {stats_err:.3g}")
        if not (abs(la - lb) <= KPC_LOSS_RTOL * abs(lb) and grad_err <= KPC_GRAD_RTOL
                and stats_err <= KPC_STATS_ATOL and own <= KPC_SPREAD):
            raise AssertionError(f"KPConv train step card vs CPU, {line}")
        lines.append(line)
    print(f"KPConv train step card vs CPU ({KPC_POINTS} points in {KPC_BATCHES} batch elements, "
          f"two levels, offsets at {KP_OFFSET_STD}): " + "; ".join(lines), flush=True)

    # overfit one batch of the driver's sampling at the driver's model
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import kpconv_level_caps
    from seggroup_tpu_torch.data.potentials import PotentialSampler
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene

    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=1, **BENCH_SCENE), {}, None,
                                      "bench1", False)]
    sampler = PotentialSampler([c for c, _, _ in scenes], in_radius=2.0, seed=5)
    b_pts, b_feats, b_labs, b_bids, b_valid = TR.sample_batch(
        scenes, sampler, np.random.default_rng(5), 4, 2.0, KPO_POINTS)
    model = KPFCNN(first_features_dim=64, dl0=0.04, seed=6, device=dev)
    optimizer, scheduler = TR.make_sgd(model, 1e-2)
    pyr = TR.to_device_pyramid(b_pts, b_bids, b_valid, dev, 0.04, kpconv_level_caps(KPO_POINTS),
                               [32] * 5)
    f_d, l_d = torch.from_numpy(b_feats).to(dev), torch.from_numpy(b_labs).to(dev)
    losses = [float(TR.train_step(model, optimizer, scheduler, pyr, f_d, l_d)[0])
              for _ in range(OVERFIT_STEPS)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    line = (f"KPConv overfit, the driver's KPFCNN on one batch of {int(b_valid.sum())} points, "
            f"{OVERFIT_STEPS} SGD steps: mean loss of the first 5 {first:.4f}, of the last 5 "
            f"{last:.4f} (at most {KPO_FALL} of it required); on {card}")
    if not (np.isfinite(losses).all() and last <= KPO_FALL * first):
        raise AssertionError(f"{line}; losses {losses}")
    print(line, flush=True)


def run_kpcnn_and_introspection(torch, dev, card, work):
    """cli.stage2_test_classification.main at its defaults (random weights:
    no KPCNN trainer exists), then cli.introspect_kpconv.main --mode erf at
    its defaults on the KPConv trainer's checkpoint in `work`. Returns the
    kernels' launches of each."""
    from seggroup_tpu_torch.cli import introspect_kpconv, stage2_test_classification

    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        acc, cls_launches = _count_launches(torch, stage2_test_classification.main, [])
        cls_wall = time.perf_counter() - t0
        cls_log = open(os.path.join("checkpoints", "exp", "kpcnn_test.log")).read()
        t0 = time.perf_counter()
        _, erf_launches = _count_launches(torch, introspect_kpconv.main,
                                          ["--mode", "erf", "--synthetic", "1"])
        erf_wall = time.perf_counter() - t0
        erf_log = open(os.path.join("checkpoints", "exp", "introspect.log")).read()
        ply = [f for f in os.listdir("introspect") if f.endswith("_erf.ply")]
    finally:
        os.chdir(cwd)
    if "FINAL accuracy" not in cls_log or not 0 <= acc <= 100:
        raise AssertionError(f"the classification driver's log: {cls_log}")
    if "loaded checkpoint" not in erf_log or len(ply) != 1:
        raise AssertionError(f"the introspection driver's log: {erf_log}")
    print(f"stage2_test_classification.main at its defaults (16 shapes, 3 votes, 8 clouds of "
          f"512 points a batch, first_features_dim 32, random weights): {cls_wall:.2f} s, "
          f"accuracy {acc:.2f}%, kernel launches {cls_launches}; introspect_kpconv.main --mode "
          f"erf on the trainer's checkpoint: {erf_wall:.2f} s, "
          f"{erf_log.strip().splitlines()[-1]}, kernel launches {erf_launches}; on {card}",
          flush=True)
    return cls_launches, erf_launches


# ---------------------------------------------------------------------------
# The rest of the MinkUNet family: the demo, ST and MinkUNetHyper training,
# the mean-field CRF
# ---------------------------------------------------------------------------

# the demo at its defaults and in the three other configurations, with the
# submanifold convs each forward runs: Res16UNet34C's 47, and 1 + 6 groups
# of 2 blocks of 2 for the ResUNet trunk
DEMO_RUNS = [("Res16UNet34C", [], 47),
             ("MinkUNetHyper", ["--variant", "MinkUNetHyper"], 25),
             ("ResUNet18INBN", ["--variant", "ResUNet18INBN"], 25),
             ("Res16UNet34C, 5^3 stem", ["--conv1_kernel_size", "5"], 47)]
# full-width train steps through cli.stage2_train_minkunet.train_step: the
# two ST nets on bench_frames (2^17 5-column voxels), MinkUNetHyper14INBN on
# two bench scenes (2^17 voxels); with each forward's submanifold convs
# (K3 launches a step; K2 launches a step are twice that less the stem's
# data gradient)
NEW_TRAIN = [("STResTesseract16UNet18A", 33), ("STRes16UNet18A", 33),
             ("MinkUNetHyper14INBN", 13)]
NEW_WARMUP, NEW_STEPS = 2, 4
CRF_VARIANT = "BilateralCRF-Res16UNet34C"


def run_demo_path(torch, dev, card):
    """cli.demo_semantic.main on bench scene 1 written as a PLY, in the four
    DEMO_RUNS configurations at the demo's defaults otherwise (2 cm, 2^17
    voxels, seeded weights); each run's seconds, its fenced phases, every
    kernel's launches (K2's only expected) and peak memory; the output PLY
    must hold one vertex per kept input point. Returns each kernel's
    launches over the four runs."""
    from seggroup_tpu_torch.cli import demo_semantic
    from seggroup_tpu_torch.cli.stage2_common import VALID_CLASS_IDS
    from seggroup_tpu_torch.data.ply import read_ply, write_ply
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch

    scene = make_synthetic_scene(seed=1, **BENCH_SCENE)
    pts = scene.points[:, :3].astype(np.float32)
    rgb = np.clip((scene.points[:, 3:6] + 1.0) * 127.5, 0, 255).astype(np.uint8)
    kept = int((make_voxel_batch([(pts.astype(np.float64), rgb.astype(np.float32),
                                   np.zeros(len(pts), np.int32))], CAPACITY, VOXEL)
                .point2voxel[0] >= 0).sum())
    total = dict.fromkeys(_kernel_counts(), 0)
    with tempfile.TemporaryDirectory() as work:
        path, out = os.path.join(work, "scene.ply"), os.path.join(work, "pred.ply")
        write_ply(path, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                         "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
        for label, argv, want_k2 in DEMO_RUNS:
            phases: dict[str, float] = {}
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            (_, lab), counts = _count_launches(
                torch, lambda: demo_semantic.main(["--ply", path, "--out", out, *argv],
                                                  phase_seconds=phases))
            wall = time.perf_counter() - t0
            peak = _peak_gib(torch, dev)
            written = len(read_ply(out)["vertex"])
            line = (f"demo_semantic {label} on a bench scene ({len(pts)} points, {kept} kept "
                    f"at capacity {CAPACITY}): {wall:.3f} s a run, fenced "
                    + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items())
                    + f"; kernel launches {counts}; peak {peak:.2f} GiB; {written} vertices "
                    f"written; on {card}")
            if written != kept or len(lab) != kept:
                raise AssertionError(f"{line}: not one vertex per kept point")
            if counts != {**dict.fromkeys(counts, 0), "subm_conv": want_k2}:
                raise AssertionError(f"{line}: {want_k2} K2 launches and no other expected")
            if not np.isin(lab, VALID_CLASS_IDS).all():
                raise AssertionError(f"{line}: labels outside the 20 NYU40 ids")
            print(line, flush=True)
            total = {name: total[name] + c for name, c in counts.items()}
    return total


def _bench_pair_batch(torch, dev):
    """Bench scenes 0 and 1 voxelised at 2 cm into 2^17 rows (the capacity
    binds in the first), with their labels, on `dev`."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_to_device
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch

    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None,
                                      "", False) for i in range(2)]
    return batch_to_device(make_voxel_batch(scenes, CAPACITY, VOXEL), dev)


def run_new_train_path(torch, dev, card):
    """The NEW_TRAIN nets at full width through train_step (SGD lr 0.1,
    PolyLR, bf16 convs): NEW_WARMUP warm-ups, NEW_STEPS timed steps (every
    kernel's launches read around them, K2's and K3's only expected), then
    one step with every K2 and K3 call held against its plain version
    (CheckedDispatch). Returns each net's launches over its timed steps."""
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import train_step
    from seggroup_tpu_torch.models import get_model
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    frames = bench_frames(torch, dev)
    pair = _bench_pair_batch(torch, dev)
    out = {}
    for name, convs in NEW_TRAIN:
        st, labels = frames if name.startswith("ST") else pair
        model = get_model(name, out_channels=20, level_caps=level_caps(CAPACITY), seed=0,
                          device=dev)
        optimizer, scheduler = make_optimizer("SGD", model.parameters(),
                                              make_schedule("PolyLR", 0.1, max_iter=60000))
        losses = []
        t0 = time.perf_counter()
        for _ in range(NEW_WARMUP):
            losses.append(train_step(model, optimizer, scheduler, st, labels)[0])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)

        def timed_steps():
            for _ in range(NEW_STEPS):
                losses.append(train_step(model, optimizer, scheduler, st, labels)[0])

        t0 = time.perf_counter()
        _, launches = _count_launches(torch, timed_steps)
        wall = time.perf_counter() - t0
        peak = _peak_gib(torch, dev)
        t0 = time.perf_counter()
        with CheckedDispatch(torch) as checked:
            losses.append(train_step(model, optimizer, scheduler, st, labels)[0])
        torch.cuda.synchronize()
        checked_s = time.perf_counter() - t0
        loss_values = [float(x) for x in losses]
        kvols = sorted({key[4] for key in checked.worst})
        line = (f"{name} train step at full width, {int(st.num)} voxels of {st.capacity} "
                f"({st.coords.shape[1]}-column coords), SGD lr 0.1 PolyLR: "
                f"{wall / NEW_STEPS:.4f} s/step over {NEW_STEPS} steps "
                f"({NEW_WARMUP} warm-ups {warm:.3f} s), {NEW_STEPS * int(st.num) / wall:.1f} "
                f"voxels/s; per step {launches['subm_conv'] / NEW_STEPS:.1f} K2 and "
                f"{launches['subm_dw'] / NEW_STEPS:.1f} K3 launches at K in {kvols} (counts "
                f"over the steps {launches}); peak "
                f"{peak:.2f} GiB; checked step ({checked_s:.3f} s): {checked.summary()}, "
                f"{len(checked.empty)} shapes with all-zero plain results; losses "
                f"{[round(x, 4) for x in loss_values]}; on {card}")
        if launches != {**dict.fromkeys(launches, 0), "subm_dw": convs * NEW_STEPS,
                        "subm_conv": (2 * convs - 1) * NEW_STEPS}:
            raise AssertionError(f"{line}: {convs} K3 and {2 * convs - 1} K2 launches a step "
                                 "and no other expected")
        if checked.calls != {"K2": 2 * convs - 1, "K3": convs}:
            raise AssertionError(f"{line}: the checked step made {checked.calls} calls")
        if not all(np.isfinite(loss_values)):
            raise AssertionError(f"{line}: a loss is not finite")
        print(line, flush=True)
        out[name] = launches
        del model, optimizer, scheduler
    return out


def run_crf_path(torch, dev, card):
    """get_model(CRF_VARIANT) forward at 2^17 voxels of bench scene 0, the
    voxels' colours into the 6-D bilateral grid, 10 mean-field iterations:
    seconds (and the backbone's alone), peak memory, every kernel's
    launches (K2 only: the backbone's 47). Returns the launches."""
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.models import get_model

    st, _ = _bench_pair_batch(torch, dev)
    colors = (st.feats + 1.0) * 127.5
    model = get_model(CRF_VARIANT, out_channels=20, level_caps=level_caps(CAPACITY), seed=0,
                      device=dev)
    with torch.no_grad():
        model(st, colors)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(st, colors, apply_filter=False)
        torch.cuda.synchronize()
        backbone_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out, launches = _count_launches(torch, model, st, colors)
        wall = time.perf_counter() - t0
        cell_id = model.crf.cells(st, colors)[0]
    peak = _peak_gib(torch, dev)
    cells = int(torch.unique(cell_id[st.valid]).numel())
    line = (f"{CRF_VARIANT} forward at {int(st.num)} voxels (capacity {CAPACITY}), "
            f"{model.crf.iterations} mean-field iterations over {cells} bilateral cells, 13 "
            f"offsets: {wall:.4f} s (the backbone alone {backbone_s:.4f} s), peak "
            f"{peak:.2f} GiB, kernel launches {launches}; on {card}")
    if launches != {**dict.fromkeys(launches, 0), "subm_conv": SUBM_PER_FORWARD}:
        raise AssertionError(f"{line}: {SUBM_PER_FORWARD} K2 launches and no other expected")
    if not (torch.isfinite(out).all() and (out[~st.valid] == 0).all()):
        raise AssertionError(f"{line}: logits not finite or not zero on padding")
    print(line, flush=True)
    return launches


def new_models_card_vs_cpu(torch, dev):
    """STResTesseract16UNet18A on a 2,048-row 5-column batch (bench_frames
    at 2 frames of 1,024), MinkUNetHyper14INBN and BilateralCRF-
    Res16UNet14A on a 2,048-row batch of 1,500 voxels, the same weights on
    the card (K2) and on the CPU (plain): logits within the MinkUNet
    tolerance, MinkUNetHyper14INBN's within INBN_LOGIT_ATOL, argmaxes
    agreeing on ARGMAX_AGREE of the voxels, the CRF's integer rows equal.
    The line also prints how far bf16 itself moves the CPU's logits (the
    same net with float32 convs)."""
    import functools

    from seggroup_tpu_torch.models import get_model, minkunet

    m = 2048
    caps = [m, m // 2, m // 4, m // 8, m // 8]
    frames, _ = bench_frames(torch, "cpu", frames=2, cap=m // 2)
    small, _ = _small_batch(torch, m, 1500, 5)
    colors = torch.from_numpy(np.random.default_rng(6).uniform(0, 255, (m, 3)).astype(
        np.float32))
    for name, st in (("STResTesseract16UNet18A", frames), ("MinkUNetHyper14INBN", small),
                     ("BilateralCRF-Res16UNet14A", small)):
        args = (colors,) if "CRF" in name else ()
        outs, models = [], []
        for d in (dev, "cpu"):
            model = get_model(name, out_channels=20, level_caps=caps, seed=1, device=d)
            with torch.no_grad():
                outs.append(model(st.to(d), *(a.to(d) for a in args)).cpu())
            models.append(model)
        subm_conv = minkunet.subm_conv
        minkunet.subm_conv = functools.partial(subm_conv, compute_dtype=torch.float32)
        try:
            with torch.no_grad():
                y32 = models[1](st, *args)
        finally:
            minkunet.subm_conv = subm_conv
        x, y = outs
        n = int(st.num)
        ok = st.valid
        diff, spread = float((x - y).abs().max()), float((y - y32).abs().max())
        agree = float((x[ok].argmax(1) == y[ok].argmax(1)).float().mean())
        agree32 = float((y[ok].argmax(1) == y32[ok].argmax(1)).float().mean())
        line = (f"card vs CPU, {name} at M={m} ({n} voxels, {st.coords.shape[1]}-column "
                f"coords): logits max |card - CPU| = {diff:.3e} (max |logit| "
                f"{float(y.abs().max()):.3f}; bf16 moves the CPU's by {spread:.3e} against "
                f"float32 convs), argmax agrees on {agree:.4f} of voxels ({agree32:.4f} "
                "bf16 against float32 on the CPU)")
        within = (diff <= INBN_LOGIT_ATOL if name == "MinkUNetHyper14INBN"
                  else torch.allclose(x, y, rtol=LOGIT_RTOL, atol=LOGIT_ATOL))
        if not (within and agree >= ARGMAX_AGREE):
            raise AssertionError(line)
        if not (x[~ok] == 0).all():
            raise AssertionError(f"{line}: card logits not zero on padding")
        if "CRF" in name:
            rows = [mdl.crf.cells(st.to(d), colors.to(d)) for mdl, d in zip(models,
                                                                              (dev, "cpu"))]
            if not all(torch.equal(a.cpu(), b) for a, b in zip(*rows)):
                raise AssertionError(f"{line}: the CRF's cell rows differ")
            line += "; the CRF's cell_id, tgt_rows and tgt_ok equal"
        print(line, flush=True)


# pyramid plans and the raw-scene path. MinkUNet in three plan forms
# (the trainer's --plan_mode device and host, and no plan on the float16
# batch), each from the same seeded weights over the same batches
PLAN_FORMS = ("device", "host", "none")
PLAN_WARMUP, PLAN_STEPS = 2, 3
# a synthetic raw ScanNet scene: a 250 x 200 vertex room surface, 10 x 10
# vertex segments, 12 instances; prepared at prepare_scannet's defaults
RAW_GRID, RAW_SEG, RAW_POINTS = (250, 200), 10, 150528  # prepare_scannet's default points
RAW_CATEGORIES = [("floor", 2), ("chair", 5), ("table", 7), ("sofa", 6), ("bed", 4),
                  ("cabinet", 3), ("desk", 14), ("bookshelf", 10)]


def plan_batches(torch):
    """The MinkUNet train phase's batches (run_train_path: 8 augmented
    bench-size scenes at 2^17 voxels, seed 1), steps 1 to 5, as VoxelBatches."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_train_minkunet import make_train_batch
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene

    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None,
                                      "", False) for i in range(TRAIN_POOL)]
    return [make_train_batch(scenes.__getitem__, range(TRAIN_POOL), s + 1, 1, TRAIN_BATCH,
                             CAPACITY, VOXEL, True) for s in range(PLAN_WARMUP + PLAN_STEPS)]


def check_native(torch, vb, card):
    """The native host library built from csrc/seggroup_native.cpp and
    loaded (the run fails otherwise), and its plan builders held exactly
    against their numpy fallbacks on a full-width batch: subm_rulebook3 at
    2^17 rows, downsample_plan to 2^16, subm_windows of that rulebook."""
    from seggroup_tpu_torch import native

    t0 = time.perf_counter()
    loaded = native.available()
    build_s = time.perf_counter() - t0
    print(f"native host library: {'loaded' if loaded else 'NOT loaded'} in {build_s:.2f} s"
          f"{'' if loaded else ': ' + str(native.load_error())}", flush=True)
    if not loaded:
        raise AssertionError(f"the native host library did not load: {native.load_error()}")
    coords, n = vb.coords, int(vb.num)

    def run():
        times, outs = {}, {}
        for name, fn in (("subm_rulebook3", lambda: native.subm_rulebook3(coords, n, CAPACITY)),
                         ("downsample_plan",
                          lambda: native.downsample_plan(coords, n, CAPACITY // 2))):
            t0 = time.perf_counter()
            outs[name] = fn()
            times[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs["subm_windows"] = native.subm_windows(outs["subm_rulebook3"], 256, 512)
        times["subm_windows"] = time.perf_counter() - t0
        return outs, times

    lib, lib_s = run()
    with native.numpy_fallbacks():
        plain, plain_s = run()
    for name in lib:
        a, b = lib[name], plain[name]
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"native {name} differs from its numpy fallback")
    if lib["subm_windows"][2] != 0:
        raise AssertionError(f"a sorted batch overflowed its windows: {lib['subm_windows'][2]}")
    print("native vs numpy fallback on a 2^17-voxel batch (" + str(n) + " valid), exactly "
          "equal: " + "; ".join(f"{k} {lib_s[k] * 1e3:.2f} ms vs {plain_s[k] * 1e3:.2f} ms"
                                for k in lib) + f" (host clock, on the card's host; {card})",
          flush=True)


def _assert_plans_equal(torch, a, b, what):
    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for lvl, (x, y) in enumerate(zip(a["rulebooks"], b["rulebooks"], strict=True)):
        if not np.array_equal(arr(x), arr(y)):
            raise AssertionError(f"{what}: rulebook {lvl} differs")
    for lvl, (x, y) in enumerate(zip(a["down"], b["down"], strict=True)):
        for k in ("coords", "num", "out_row", "delta"):
            if not np.array_equal(arr(x[k]), arr(y[k])):
                raise AssertionError(f"{what}: down map {lvl} {k} differs")
    for lvl, (x, y) in enumerate(zip(a.get("windows", []), b.get("windows", []), strict=True)):
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: windows {lvl} present on one side only")
        if x is not None and not all(np.array_equal(arr(x[k]), arr(y[k]))
                                     for k in ("rb_win", "win_base", "use_window")):
            raise AssertionError(f"{what}: windows {lvl} differ")


def run_plan_paths(torch, dev, card, vbs):
    """Res16UNet34C train steps at the training driver's defaults in the
    three plan forms (cli/stage2_train_minkunet.py --plan_mode device: the
    float16 wire and the plan built on the card; --plan_mode host: the
    float32 batch and the host plan; no plan on the float16 batch; the
    plans without windows, as the trainer builds them), each
    from the seeded init over the same batches, 2 warm-up and 3 timed
    steps with the batch's packing or host plan, its transfer and any
    plan built on the card inside the step. Checks the device plan
    bit-equal to the host plan (rulebooks, down maps, windows, use_window),
    both built with and without windows and timed, each form's K2 and K3 launches a step, and the first step's losses
    within the card-vs-CPU step tolerance of one another. Returns each
    form's launch counts."""
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_on_device, train_step
    from seggroup_tpu_torch.sparse.device_plan import (build_unet_plan_device,
                                                       pack_voxel_batch, unpack_voxel_batch)
    from seggroup_tpu_torch.sparse.plan import build_unet_plan

    caps = level_caps(CAPACITY)
    vb = vbs[0]
    st, _ = unpack_voxel_batch(*pack_voxel_batch(vb), device=dev)
    build_unet_plan_device(st.coords, st.num, caps)  # warm
    secs = {(side, win): [] for side in ("card", "host") for win in (True, False)}
    for _ in range(3):
        for win in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dplan = build_unet_plan_device(st.coords, st.num, caps, with_windows=win)
            torch.cuda.synchronize()
            secs["card", win].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            hplan = build_unet_plan(vb.coords, int(vb.num), caps, with_windows=win)
            secs["host", win].append(time.perf_counter() - t0)
            if win:
                _assert_plans_equal(torch, dplan, hplan, "MinkUNet device plan vs host plan")
                use = [None if w is None else bool(w["use_window"]) for w in hplan["windows"]]

    def ms(side, win):
        return (f"{min(secs[side, win]) * 1e3:.2f} ms (of "
                f"{[round(x * 1e3, 2) for x in secs[side, win]]})")

    print(f"MinkUNet plan at capacity {CAPACITY} ({int(vb.num)} voxels), levels {caps}: "
          f"device plan bit-equal to the host plan (windows on levels "
          f"{[i for i, u in enumerate(use) if u is not None]}, use_window {use}); built on "
          f"the card {ms('card', True)}, without windows as the trainer builds it "
          f"{ms('card', False)}; on the host (native) {ms('host', True)}, without windows "
          f"{ms('host', False)}; on {card}", flush=True)

    mods = _kernel_counts()
    out, first = {}, {}
    for form in PLAN_FORMS:
        model, optimizer, scheduler = _train_setup(torch, dev, "Res16UNet34C", caps, 0)
        losses = []
        for i, batch in enumerate(vbs):
            if i == PLAN_WARMUP:
                torch.cuda.synchronize()
                for mod in mods.values():
                    mod.launches = 0
                t0 = time.perf_counter()
            if form == "device":
                st, labels, plan = batch_on_device(pack_voxel_batch(batch), None, dev, caps)
            elif form == "host":
                st, labels, plan = batch_on_device(
                    batch, build_unet_plan(batch.coords, int(batch.num), caps,
                                           with_windows=False), dev, caps)
            else:
                st, labels = unpack_voxel_batch(*pack_voxel_batch(batch), device=dev)
                plan = None
            losses.append(train_step(model, optimizer, scheduler, st, labels, plan=plan)[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in mods.items()}
        loss_values = [float(x) for x in losses]
        if not np.isfinite(loss_values).all():
            raise AssertionError(f"MinkUNet ({form} plan): non-finite loss {loss_values}")
        if (launches["subm_conv"] != K2_PER_STEP * PLAN_STEPS
                or launches["subm_dw"] != SUBM_PER_FORWARD * PLAN_STEPS
                or launches["masked_fps"] or launches["cc_sweep"]):
            raise AssertionError(f"MinkUNet ({form} plan): launches {launches} in "
                                 f"{PLAN_STEPS} steps")
        first[form] = loss_values[0]
        out[form] = dict(launches, s_per_step=wall / PLAN_STEPS)
        print(f"MinkUNet training, --plan_mode {form if form != 'none' else '(no plan, float16 batch)'}: "
              f"{wall / PLAN_STEPS:.4f} s/step over {PLAN_STEPS} steps (packing or host plan, "
              f"transfer, device plan and step); per step "
              f"{launches['subm_conv'] / PLAN_STEPS:.1f} K2, {launches['subm_dw'] / PLAN_STEPS:.1f}"
              f" K3 launches; losses {[round(x, 5) for x in loss_values]}; on {card}", flush=True)
        del model, optimizer, scheduler
    for form in ("host", "none"):
        if abs(first[form] - first["device"]) > STEP_LOSS_ATOL:
            raise AssertionError(f"MinkUNet first-step loss, {form} {first[form]} vs device "
                                 f"{first['device']}")
    print(f"MinkUNet first-step losses: device {first['device']:.6f}, host "
          f"{first['host']:.6f}, none {first['none']:.6f} (within {STEP_LOSS_ATOL})", flush=True)
    return out


def run_pointgroup_plan_paths(torch, dev, card):
    """PointGroup at the training driver's defaults on one host batch of the
    4 bench scenes: one clustering step with --plan_mode host (the float32
    batch, the 7-level host plan) and one with --plan_mode device (the same
    batch's wire and the plan built on the card; that plan bit-equal to the
    host plan), from the same seeded init, clustering on heads from the
    labels (_cluster_on_labels), K2, K3 and K4 launches counted; then the
    split program (propose, then score_plan) beside the fused step over the
    host plan at the same weights, both with PyTorch's deterministic
    algorithms on (the card's scatter-adds otherwise sum in a varying
    order), through K2 and K3: proposals, heads, scores, the loss, every
    gradient and the running statistics bit-equal; the ScoreNet's device
    plan equal to the rulebooks the plan-less ScoreNet builds."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import (batch_on_device,
                                                                make_train_batch, train_step)
    from seggroup_tpu_torch.data.pg_wire import pack_pg_batch
    from seggroup_tpu_torch.models.pointgroup import pointgroup_loss, propose
    from seggroup_tpu_torch.sparse.conv import build_subm_rulebook, downsample_coords
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    scenes = [_pg_scene(i)[1:] for i in range(N_SCENES)]
    raw = make_train_batch(scenes.__getitem__, range(N_SCENES), np.random.default_rng((1, 7)),
                           PGT_BATCH, PG_POINT_CAP, PG_VOXEL_CAP, PGT_INSTANCE_CAP, VOXEL, True,
                           plan_mode="host")
    hb, (vcoords, num, p2v, hplan) = raw
    wire = pack_pg_batch(hb, vcoords, num, p2v)
    jitter = torch.rand(3, generator=torch.Generator().manual_seed(3)).to(dev)
    mods = _kernel_counts()
    out = {}
    model, optimizer, scheduler = _pg_train_setup(torch, dev)  # a warm-up step, not counted
    batch, plan = batch_on_device(wire, PG_VOXEL_CAP, dev)
    _cluster_on_labels(torch, model, batch)
    train_step(model, optimizer, scheduler, batch, True, jitter, plan=plan)
    del model, optimizer, scheduler
    for mode, r in (("host", raw), ("device", wire)):
        model, optimizer, scheduler = _pg_train_setup(torch, dev)
        torch.cuda.synchronize()
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        batch, plan = batch_on_device(r, PG_VOXEL_CAP, dev)
        _cluster_on_labels(torch, model, batch)
        loss, _, props = train_step(model, optimizer, scheduler, batch, True, jitter, plan=plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in mods.items()}
        if mode == "device":
            _assert_plans_equal(torch, plan, hplan, "PointGroup device plan vs host plan")
        if (launches["subm_conv"] != 2 * PG_SUBM_PER_FORWARD - 1
                or launches["subm_dw"] != PG_SUBM_PER_FORWARD or launches["cc_sweep"] < 1
                or int(props) < 1 or not np.isfinite(loss.item())):
            raise AssertionError(f"PointGroup --plan_mode {mode}: launches {launches}, "
                                 f"proposals {int(props)}, loss {float(loss)}")
        out[mode] = dict(launches, seconds=wall)
        print(f"PointGroup train step with the clustering, --plan_mode {mode}: {wall:.4f} s "
              f"(transfer{', device plan' if mode == 'device' else ''} and step), loss "
              f"{float(loss):.5f}, {int(props)} proposals, K2 {launches['subm_conv']}, K3 "
              f"{launches['subm_dw']}, K4 {launches['cc_sweep']} launches; on {card}",
              flush=True)
        del model, optimizer, scheduler

    batch, plan = batch_on_device(raw, PG_VOXEL_CAP, dev)
    labels, inst, centroid, pointnum = batch[5:]

    def fwd_bwd(form):
        """(seconds, outputs, loss, gradients, running statistics, the
        split's ScoreNet context) of one forward and backward."""
        model, _, _ = _pg_train_setup(torch, dev)
        _cluster_on_labels(torch, model, batch)
        ctx = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if form == "split":
            _, score_plan = propose(model, *batch[:5], train=True, jitter=jitter, plan=plan)
            ctx = score_plan[3]
            o = model(*batch[:5], do_clustering=True, train=True, plan=plan,
                      score_plan=score_plan)
        else:
            o = model(*batch[:5], do_clustering=True, train=True, jitter=jitter, plan=plan)
        loss, _ = pointgroup_loss(o, labels, inst, centroid, pointnum, batch[2], batch[4],
                                  num_instances_cap=PGT_INSTANCE_CAP, with_score=True)
        loss.backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, o, loss.detach(),
                {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                {k: b.clone() for k, b in model.named_buffers()}, ctx)

    # the card's scatter-adds sum in an order that changes from run to run
    # (at float32 the heads of two runs differ by about 6e-5); PyTorch's
    # deterministic algorithms fix that order, so that the two programs can
    # be held bit for bit, through K2 and K3 at bf16 as the trainer runs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fused, split = fwd_bwd("fused"), fwd_bwd("split")
        finally:
            torch.use_deterministic_algorithms(False)
    for name in ("proposal_of_point", "proposal_valid", "num_proposals", "semantic_scores",
                 "pt_offsets", "scores"):
        if not torch.equal(getattr(fused[1], name), getattr(split[1], name)):
            raise AssertionError(f"split program: {name} differs from the fused step's")
    for i, what in ((2, "loss"), (3, "gradients"), (4, "running statistics")):
        a, b = (fused[i], split[i]) if i != 2 else ({"": fused[2]}, {"": split[2]})
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        if bad:
            raise AssertionError(f"split program: {what} differ from the fused step's: {bad[:4]}")
    # the ScoreNet's plan, built on the card from the proposals' voxelisation,
    # equals the rulebooks and down map the plan-less ScoreNet builds
    vox, score_plan = split[5]["vox"], split[5]["unet_plan"]
    cap = PG_VOXEL_CAP // 8
    st = SparseTensor(vox.voxel_coords, torch.zeros((cap, 1), device=dev), vox.voxel_valid,
                      vox.num_voxels)
    coords_1, valid_1, num_1, out_row, _ = downsample_coords(st, cap // 2)
    searched = [build_subm_rulebook(st, 3, xy_bits=(5, 5)),
                build_subm_rulebook(SparseTensor(coords_1, st.feats[: cap // 2], valid_1, num_1),
                                    3, xy_bits=(5, 5))]
    if not (all(torch.equal(x, y) for x, y in zip(score_plan["rulebooks"], searched))
            and torch.equal(score_plan["down"][0]["out_row"], out_row)):
        raise AssertionError("the ScoreNet's device plan differs from its searched rulebooks")
    print(f"PointGroup split program (propose, then score_plan) vs the fused step over the "
          f"host plan, the same weights, PyTorch's deterministic algorithms on, bf16 through "
          f"K2 and K3: {int(split[1].num_proposals)} proposals, the heads, the scores, the "
          f"loss ({float(split[2]):.6f}), every gradient and the running statistics "
          f"bit-equal; the ScoreNet's device plan ({int(vox.num_voxels)} voxels) equal to its "
          f"searched rulebooks and down map; forward and backward {split[0]:.4f} s split vs "
          f"{fused[0]:.4f} s fused; on {card}", flush=True)
    out["split_s"], out["fused_s"] = split[0], fused[0]
    return out


def write_raw_scene(scans_dir, scene, seed=0):
    """A synthetic raw ScanNet scene in ScanNet's files: <scene>_vh_clean_2.ply
    (a RAW_GRID vertex surface, 2 cm apart, with bumps and colours),
    <scene>_vh_clean_2.0.010000.segs.json (RAW_SEG x RAW_SEG vertex
    segments, scattered ids), <scene>.aggregation.json (the floor and 11
    objects of a few segments each). Returns the vertex count."""
    from seggroup_tpu_torch.data.ply import write_ply

    rng = np.random.default_rng(seed)
    gw, gh = RAW_GRID
    xs, ys = np.meshgrid(np.arange(gw), np.arange(gh), indexing="xy")
    sx, sy = xs // RAW_SEG, ys // RAW_SEG
    nsx, nsy = -(-gw // RAW_SEG), -(-gh // RAW_SEG)
    seg_of = (sx + nsx * sy).ravel()
    z = rng.uniform(0.0, 0.4, nsx * nsy)[seg_of] * (rng.random(nsx * nsy) < 0.3)[seg_of]
    verts = np.stack([xs.ravel() * 0.02, ys.ravel() * 0.02, z + rng.normal(0, 0.002, z.shape)],
                     1).astype(np.float32)
    cols = rng.integers(0, 255, (nsx * nsy, 3))[seg_of] + rng.integers(-8, 8, (len(seg_of), 3))
    cols = np.clip(cols, 0, 255).astype(np.uint8)
    a = (ys[:-1, :-1] * gw + xs[:-1, :-1]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + gw], 1),
                            np.stack([a + 1, a + gw + 1, a + gw], 1)]).astype(np.int32)
    seg_ids = rng.permutation(10 ** 5)[: nsx * nsy]
    groups, taken = [], set()
    order = rng.permutation(nsx * nsy)
    floor = [int(s) for s in order[: nsx * nsy // 3]]
    groups.append({"objectId": 0, "label": "floor", "segments": [int(seg_ids[s]) for s in floor]})
    taken.update(floor)
    for obj in range(1, 12):
        start = int(rng.choice([s for s in range(nsx * nsy) if s not in taken]))
        segs = [s for s in (start, start + 1, start + nsx, start + nsx + 1)
                if s < nsx * nsy and s not in taken]
        taken.update(segs)
        groups.append({"objectId": obj, "label": RAW_CATEGORIES[1 + obj % 7][0],
                       "segments": [int(seg_ids[s]) for s in segs]})
    d = os.path.join(scans_dir, scene)
    os.makedirs(d, exist_ok=True)
    write_ply(os.path.join(d, f"{scene}_vh_clean_2.ply"),
              {"x": verts[:, 0], "y": verts[:, 1], "z": verts[:, 2], "red": cols[:, 0],
               "green": cols[:, 1], "blue": cols[:, 2]}, faces)
    with open(os.path.join(d, f"{scene}_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"segIndices": seg_ids[seg_of].tolist()}, f)
    with open(os.path.join(d, f"{scene}.aggregation.json"), "w") as f:
        json.dump({"segGroups": groups}, f)
    return len(verts)


def run_raw_scene_path(torch, dev, card, work):
    """A synthetic raw scene of 50,000 vertices written under `work`,
    prepared by cli.prepare_scannet at its defaults (150,528 points,
    maxseg labels), then cli.stage1_infer --ins_infer on the card over the
    prepared npz: its pseudo-label files written at the mesh's vertex
    count, K1 launched at least once. Returns K1-K4's launches in the
    inference."""
    from seggroup_tpu_torch.cli import prepare_scannet, stage1_infer
    from seggroup_tpu_torch.data.scannet import load_scene_npz

    scans = os.path.join(work, "scans")
    n_verts = write_raw_scene(scans, "scene0000_00")
    with open(os.path.join(work, "labels.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\tnyu40id\n")
        for i, (cat, nyu) in enumerate(RAW_CATEGORIES):
            f.write(f"{i}\t{cat}\t{cat}\t{nyu}\n")
    prepared = os.path.join(work, "prepared")
    t0 = time.perf_counter()
    results = prepare_scannet.main(["--scans_dir", scans, "--tsv",
                                    os.path.join(work, "labels.tsv"), "--out", prepared,
                                    "--label_style", "maxseg", "--workers", "1",
                                    "--num_points", str(RAW_POINTS)])
    prep_s = time.perf_counter() - t0
    if [r[2] for r in results] != [None]:
        raise AssertionError(f"prepare_scannet failed: {results}")
    scene, extras = load_scene_npz(os.path.join(prepared, "maxseg", "scene0000_00.npz"))
    n_weak = int((scene.weak_ins >= 0).sum())
    if scene.points.shape != (RAW_POINTS, 6) or len(extras["unmap"]) != n_verts or n_weak < 5:
        raise AssertionError(f"prepared scene: points {scene.points.shape}, unmap "
                             f"{len(extras['unmap'])}, {n_weak} weak segments")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        _, launches = _count_launches(torch, stage1_infer.main, [
            "--data_root", prepared, "--label_style", "maxseg", "--ins_infer",
            "--exp_name", "raw", "--num_devices", "1"])
        infer_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    out_dir = os.path.join(work, "results", "raw", "scene0000_00", "ins_infer")
    sem = np.loadtxt(os.path.join(out_dir, "final.sem.txt"), dtype=np.int64)
    if len(sem) != n_verts or launches["masked_fps"] < 1:
        raise AssertionError(f"stage 1 on the raw scene: {len(sem)} labels for {n_verts} "
                             f"vertices, launches {launches}")
    print(f"raw ScanNet scene ({n_verts} vertices, {int(scene.edge_valid.sum())} segment "
          f"edges, {n_weak} weak segments) -> prepare_scannet at its defaults in "
          f"{prep_s:.3f} s (host) -> stage1_infer --ins_infer on the card in {infer_s:.3f} s: "
          f"{len(os.listdir(out_dir))} label files of {n_verts} vertices, K1 "
          f"{launches['masked_fps']} launches (K2 {launches['subm_conv']}, K3 "
          f"{launches['subm_dw']}, K4 {launches['cc_sweep']}); on {card}", flush=True)
    return dict(launches, prep_s=prep_s, infer_s=infer_s)


# ---------------------------------------------------------------------------
# phase 15e: data parallelism (parallel/dp.py, parallel/point_sharding.py)
# ---------------------------------------------------------------------------

# each DP path's steps a rank: the first warms up, the rest are timed and
# counted
DP_STEPS = 2
DP_TIMEOUT_S = 300
# the 2-rank step against the mean of the two ranks' own gradients fed
# through the same optimizer, with deterministic algorithms on, at the
# bounds the card-vs-CPU train steps hold (S1_GRAD_RTOL, S1_STAT_TOL):
# each parameter's change within 1e-4 of its largest, the running
# statistics within 1e-5; Res16UNet14A at 2^14 rows
DP_MEAN_ROWS, DP_MEAN_SITES = 2 ** 14, 12000


def _dp_same_on_ranks(torch, mesh, model, what):
    """Raises unless every rank holds rank 0's parameters and running
    statistics bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1) for t in model.state_dict().values()
                      if t.is_floating_point()])
    ref = flat.clone()
    dist.broadcast(ref, 0, group=mesh.group)
    same = torch.tensor([int(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    if not int(same):
        raise AssertionError(f"{what}: the ranks' parameters or statistics differ")


def _dp_timed(torch, mesh, step, batches):
    """step(batch) over `batches`: the first warms up, the rest are timed
    with every kernel's launches counted. Returns (s/step, launches, peak
    GiB of this rank, the steps' returns)."""
    outs = [step(batches[0])]
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    mods = _kernel_counts()
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    for b in batches[1:]:
        outs.append(step(b))
    torch.cuda.synchronize(mesh.device)
    wall = (time.perf_counter() - t0) / (len(batches) - 1)
    return (wall, {name: mod.launches for name, mod in mods.items()},
            torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30, outs)


def _dp_minkunet(torch, mesh):
    """The MinkUNet trainer's default DP step (build_minkunet_dp_step_packed:
    Res16UNet34C, the float16 wire, the plan built on the rank, 2^17
    voxels, batch 8 of the bench scenes, SGD 0.1 PolyLR); rank d's batch of
    step s is the driver's make_batch(s * ranks + d + 1)."""
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import make_batch
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.parallel.dp import build_minkunet_dp_step_packed

    caps = level_caps(CAPACITY)
    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=i, **BENCH_SCENE), {}, None,
                                      "", False) for i in range(TRAIN_POOL)]
    wires = [make_batch(scenes.__getitem__, range(TRAIN_POOL), s * mesh.size + mesh.rank + 1,
                        1, TRAIN_BATCH, CAPACITY, VOXEL, True, "device", caps)[0]
             for s in range(DP_STEPS)]
    model, optimizer, scheduler = _train_setup(torch, mesh.device, "Res16UNet34C", caps, 0)
    mesh.replicate(model, optimizer)
    step = build_minkunet_dp_step_packed(model, optimizer, scheduler, mesh, caps)
    wall, launches, peak, outs = _dp_timed(torch, mesh, step, wires)
    _dp_same_on_ranks(torch, mesh, model, "MinkUNet DP step")
    loss = [float(x) / mesh.size for x, _ in outs]
    if not np.isfinite(loss).all() or int(outs[-1][1].sum()) == 0:
        raise AssertionError(f"MinkUNet DP step: loss {loss}, confusion empty")
    del model, optimizer
    torch.cuda.empty_cache()
    return dict(launches, s_per_step=wall, peak_gib=peak, loss=loss)


def _dp_stage1(torch, mesh):
    """The stage-1 DP train step at the bench width (150,528 points, bf16,
    Adam lr 0.001), rank d on bench scene d, its dropout from its own
    generator."""
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.parallel.dp import build_stage1_train_step, rank_seed
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    scene = make_synthetic_scene(seed=mesh.rank, **BENCH_SCENE).to(mesh.device)
    model = SegGroupGNN(cluster_cap=1024, knn_window=8192, seed=0, device=mesh.device)
    optimizer, _ = make_optimizer("Adam", model.parameters(), make_schedule("constant", S1_LR))
    mesh.replicate(model, optimizer)
    gen = torch.Generator(device=mesh.device).manual_seed(rank_seed(3, mesh.rank))
    step = build_stage1_train_step(model, optimizer, mesh)
    wall, launches, peak, outs = _dp_timed(
        torch, mesh, lambda sc: step(sc, generator=gen), [scene] * DP_STEPS)
    _dp_same_on_ranks(torch, mesh, model, "stage-1 DP step")
    loss = [float(x) / mesh.size for x, _ in outs]
    if not np.isfinite(loss).all() or launches["masked_fps"] < DP_STEPS - 1:
        raise AssertionError(f"stage-1 DP step: loss {loss}, K1 {launches['masked_fps']}")
    del model, optimizer
    torch.cuda.empty_cache()
    return dict(launches, s_per_step=wall, peak_gib=peak, loss=loss)


def _dp_pointgroup(torch, mesh):
    """PointGroup DP steps with the clustering at the training driver's
    defaults, in each --plan_mode: rank 0 draws both ranks' batches (the
    wire, or the host batch with its host plan) and hands rank d its own
    over the host group, as the trainer does; each rank unpacks on its card
    (building the plan there in device mode) and clusters on heads made
    from its batch's labels (_cluster_on_labels)."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import batch_on_device, make_train_batch
    from seggroup_tpu_torch.parallel.dp import build_pointgroup_dp_step, rank_seed

    scenes = [_pg_scene(i)[1:] for i in range(N_SCENES)] if mesh.is_main else None
    out = {}
    for plan_mode in ("device", "host"):
        def draw(s):
            return make_train_batch(scenes.__getitem__, range(N_SCENES),
                                    np.random.default_rng((1, s)), PGT_BATCH, PG_POINT_CAP,
                                    PG_VOXEL_CAP, PGT_INSTANCE_CAP, VOXEL, True,
                                    plan_mode=plan_mode)
        raws = [mesh.scatter([draw(s * mesh.size + d) for d in range(mesh.size)]
                             if mesh.is_main else None) for s in range(DP_STEPS)]
        model, optimizer, scheduler = _pg_train_setup(torch, mesh.device)
        mesh.replicate(model, optimizer)
        inner = build_pointgroup_dp_step(model, optimizer, scheduler, mesh, do_clustering=True)
        gen = torch.Generator().manual_seed(rank_seed(2, mesh.rank))

        def step(raw):
            batch, plan = batch_on_device(raw, PG_VOXEL_CAP, mesh.device)
            _cluster_on_labels(torch, model, batch)
            return inner(batch, plan, torch.rand(3, generator=gen).to(mesh.device))

        wall, launches, peak, outs = _dp_timed(torch, mesh, step, raws)
        _dp_same_on_ranks(torch, mesh, model, f"PointGroup DP step ({plan_mode} plan)")
        loss = [float(x) / mesh.size for x in outs]
        if not np.isfinite(loss).all() or launches["cc_sweep"] < DP_STEPS - 1:
            raise AssertionError(f"PointGroup DP step ({plan_mode}): loss {loss}, K4 "
                                 f"{launches['cc_sweep']}")
        out[plan_mode] = dict(launches, s_per_step=wall, peak_gib=peak, loss=loss)
        del model, optimizer
        torch.cuda.empty_cache()
    return out


def _dp_point_sharded(torch, mesh):
    """The stage-1 forward with its point axis sharded over the ranks
    (point_sharding.make_point_sharded_model) at the bench width, beside
    the unsharded forward on the same card, deterministic algorithms on:
    final_sem, final_ins and final_root exactly equal."""
    from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.parallel.point_sharding import (build_stage1_point_sharded_forward,
                                                            make_point_sharded_model)

    scene = make_synthetic_scene(seed=0, **BENCH_SCENE).to(mesh.device)
    sharded = make_point_sharded_model(mesh, cluster_cap=1024, knn_window=8192, seed=0)
    fwd = build_stage1_point_sharded_forward(sharded, mesh)
    wall, launches, peak, outs = _dp_timed(torch, mesh, fwd, [scene] * DP_STEPS)
    plain = SegGroupGNN(cluster_cap=1024, knn_window=8192, seed=0, device=mesh.device)
    want = plain(scene, mode="ins_infer")
    for k in ("final_sem", "final_ins", "final_root"):
        if not torch.equal(getattr(outs[-1], k), getattr(want, k)):
            raise AssertionError(f"point-sharded forward: {k} differs from the unsharded one")
    del sharded, plain
    torch.cuda.empty_cache()
    return dict(launches, s_per_step=wall, peak_gib=peak)


def _dp_mean_check(torch, mesh):
    """With deterministic algorithms on: one MinkUNet DP step (Res16UNet14A,
    2^14 rows, SGD with momentum, from a step already taken) against each
    rank's own gradient and moved statistics, gathered, averaged on every
    rank in rank order and fed through a copy of the same optimizer.
    Returns the worst change error over the parameters' largest change and
    the worst statistics error."""
    import copy

    import torch.distributed as dist

    from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
    from seggroup_tpu_torch.cli.stage2_train_minkunet import masked_nll
    from seggroup_tpu_torch.parallel.dp import build_minkunet_dp_step

    caps = level_caps(DP_MEAN_ROWS)
    batches = [tuple(x.to(mesh.device) for x in _small_batch(
        torch, DP_MEAN_ROWS, DP_MEAN_SITES, 40 + 2 * s + mesh.rank)) for s in range(2)]
    model, optimizer, scheduler = _train_setup(torch, mesh.device, "Res16UNet14A", caps, 0)
    mesh.replicate(model, optimizer)
    step = build_minkunet_dp_step(model, optimizer, scheduler, mesh)
    step(*batches[0], None)  # the momentum buffers filled

    ref_model = copy.deepcopy(model)
    ref_opt = type(optimizer)(ref_model.parameters(), **optimizer.defaults)
    # a copy: load_state_dict keeps the very tensors, which the step moves
    ref_opt.load_state_dict(copy.deepcopy(optimizer.state_dict()))
    for group in ref_opt.param_groups:
        group["lr"] = optimizer.param_groups[0]["lr"]
    st, labels = batches[1]
    ref_model.zero_grad(set_to_none=True)
    masked_nll(ref_model(st, train=True), labels, st.valid).backward()
    local = torch.cat([p.grad.reshape(-1) for p in ref_model.parameters()]
                      + [b.reshape(-1) for b in ref_model.buffers()])
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    mean = parts[0]
    for part in parts[1:]:
        mean = mean + part
    mean = mean / mesh.size
    i = 0
    with torch.no_grad():
        for p in ref_model.parameters():
            p.grad = mean[i:i + p.numel()].view_as(p).clone()
            i += p.numel()
        for b in ref_model.buffers():
            b.copy_(mean[i:i + b.numel()].view_as(b))
            i += b.numel()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref_opt.step()
    step(st, labels, None)
    got, want = model.state_dict(), ref_model.state_dict()
    grad_err = stat_err = 0.0
    for k, v in want.items():
        if k.endswith((".mean", ".var")):
            stat_err = max(stat_err, float((got[k] - v).abs().max()))
            continue
        change = (v - before[k]).abs().max()
        grad_err = max(grad_err, float((got[k] - v).abs().max() / torch.clamp(change, 1e-12)))
    if grad_err > S1_GRAD_RTOL or stat_err > S1_STAT_TOL:
        raise AssertionError(f"DP step against the mean of the ranks' own gradients: "
                             f"{grad_err:.3e} of the largest change, statistics {stat_err:.3e}")
    return dict(grad_err=grad_err, stat_err=stat_err)


def _dp_rank(mesh):
    """Every DP path on one rank (parallel/dp.launch calls it in each rank's
    process); returns what rank 0 prints."""
    import torch

    from seggroup_tpu_torch.device import resolve_device

    sys.path.insert(0, ROOT)
    resolve_device(mesh.device)
    out = {"stage1": _dp_stage1(torch, mesh), "minkunet": _dp_minkunet(torch, mesh)}
    pg = _dp_pointgroup(torch, mesh)
    out.update({f"pointgroup_plan_{k}": v for k, v in pg.items()})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["point_sharded"] = _dp_point_sharded(torch, mesh)
        out["mean_check"] = _dp_mean_check(torch, mesh)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _dp_world1(torch):
    """An NCCL group of world size 1 on the card, in this process: one
    MinkUNet DP step through it (and one to warm up)."""
    from datetime import timedelta

    import torch.distributed as dist

    from seggroup_tpu_torch.parallel.dp import make_mesh

    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1,
                                rank=0, timeout=timedelta(seconds=DP_TIMEOUT_S))
        try:
            return _dp_minkunet(torch, make_mesh("cuda"))
        finally:
            dist.destroy_process_group()


def _dp_line(name, transport, ranks):
    per = "; ".join(
        f"rank {r}: {o['s_per_step']:.4f} s/step, peak {o['peak_gib']:.2f} GiB, K1 "
        f"{o['masked_fps']}, K2 {o['subm_conv']}, K3 {o['subm_dw']}, K4 {o['cc_sweep']}"
        for r, o in enumerate(ranks))
    return f"DP {name} over {transport}: {per}"


def run_dp_paths(torch, dev, card):
    """Phase 15e: the data-parallel steps on the card. Returns {path:
    [launches of each rank]} for the kernels line."""
    from datetime import timedelta

    from seggroup_tpu_torch.parallel.dp import launch

    world1 = _dp_world1(torch)
    print(_dp_line("MinkUNet step (Res16UNet34C, device plan, 2^17 voxels, batch 8)",
                   "NCCL, world 1", [world1]) + f"; on {card}", flush=True)
    runs = {"nccl1": [world1]}
    transports = [("gloo2", "2 gloo ranks sharing cuda:0", 2, "gloo")]
    if torch.cuda.device_count() >= 2:
        n = min(torch.cuda.device_count(), 4)
        transports.append((f"nccl{n}", f"NCCL across {n} cards", n, "nccl"))
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic mode
    try:
        for key, transport, n, backend in transports:
            t0 = time.perf_counter()
            ranks = launch(_dp_rank, n, "cuda:0" if backend == "gloo" else "cuda",
                           backend=backend,
                           timeout=timedelta(seconds=DP_TIMEOUT_S), all_ranks=True)
            note = (" (two ranks on one card contend for it: not a scaling figure)"
                    if key == "gloo2" else "")
            for path in ("stage1", "minkunet", "pointgroup_plan_device",
                         "pointgroup_plan_host", "point_sharded"):
                print(_dp_line(path, transport, [r[path] for r in ranks]) + note, flush=True)
            mean = ranks[0]["mean_check"]
            print(f"DP over {transport}: ranks bit-equal after every step; point-sharded "
                  f"labels equal the unsharded forward's; the Res16UNet14A step against "
                  f"the mean of the ranks' own gradients (deterministic algorithms): "
                  f"{mean['grad_err']:.3e} of the largest change (bound {S1_GRAD_RTOL}), "
                  f"statistics {mean['stat_err']:.3e} (bound {S1_STAT_TOL}); "
                  f"{time.perf_counter() - t0:.1f} s with the spawn; on {card}", flush=True)
            for path in ranks[0]:
                if path != "mean_check":
                    runs[f"{key}_{path}"] = [r[path] for r in ranks]
    finally:
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    runs["nccl1_minkunet"] = runs.pop("nccl1")
    return runs


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
            kernel = {cuda_fps: "K1", cuda_subm_conv: "K2", cuda_cc: "K4"}.get(mod)
            if kernel and log:
                funcs = kernel_build_lines(log)
                print(f"{kernel} functions (registers, spill bytes): " + "; ".join(
                    f"{name} {regs}, {spill}" for name, regs, spill in funcs), flush=True)
                if not funcs or any(spill for _, _, spill in funcs):
                    raise AssertionError(f"a {kernel} function spills registers")


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

    seconds: dict[str, float] = {}

    def phase(name, fn, *args):
        """fn(*args), its wall seconds kept under `name` for the summary."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    phase("build", build_all)
    k1 = phase("K1 check", check_fps, torch, dev, card)
    bench = phase("K2/K3 rulebooks", bench_rulebooks, torch, dev)
    k2 = phase("K2 check", check_subm_conv, torch, dev, card, bench)
    k3 = phase("K3 check", check_subm_dw, torch, dev, card, bench)
    launches = phase("stage-1 inference", run_main_path, torch, dev, card)
    phase("stage-1 card vs CPU", card_vs_cpu, torch, dev)
    fast_fps = phase("stage-1 fast", run_stage1_fast_path, torch, dev, card)
    train_fps = phase("stage-1 training", run_stage1_train_path, torch, dev, card)
    phase("stage-1 training card vs CPU", stage1_train_card_vs_cpu, torch, dev, card)
    inference_k2 = phase("MinkUNet inference", run_stage2_path, torch, dev, card)
    driver_k2 = phase("semantic driver", run_semantic_driver, torch, dev, card)
    phase("MinkUNet card vs CPU", minkunet_card_vs_cpu, torch, dev)
    train = phase("MinkUNet training", run_train_path, torch, dev, card)
    phase("MinkUNet training card vs CPU", train_card_vs_cpu, torch, dev)
    phase("MinkUNet overfit", overfit_check, torch, dev, card)

    from seggroup_tpu_torch.cli.stage2_test_pointgroup import make_eval_model

    pg_model = make_eval_model(PG_M, PG_VOXEL_CAP, dev)
    k4 = phase("K4 check", check_cc_sweep, torch, dev, card, pg_model)
    phase("K2 PointGroup pairs", check_subm_conv_pointgroup, torch, dev, card)
    k3_pg_err, k3_pg = phase("K3 PointGroup pairs", check_subm_dw_pointgroup, torch, dev, card)
    pointgroup = phase("PointGroup inference", run_pointgroup_path, torch, dev, card, pg_model)
    phase("PointGroup card vs CPU", pointgroup_card_vs_cpu, torch, dev)
    del pg_model
    pg_train = phase("PointGroup training", run_pointgroup_train_path, torch, dev, card)
    phase("PointGroup checked step", pointgroup_train_checked_step, torch, dev)
    phase("PointGroup training card vs CPU", pointgroup_train_card_vs_cpu, torch, dev, card)
    kp_infer = phase("KPConv inference", run_kpconv_path, torch, dev, card)
    with tempfile.TemporaryDirectory() as kp_work:
        kp_train = phase("KPConv training", run_kpconv_train_path, torch, dev, card, kp_work)
        phase("KPConv training card vs CPU", kpconv_train_card_vs_cpu, torch, dev, card)
        kpcnn_launches, erf_launches = phase("KPCNN and introspection",
                                             run_kpcnn_and_introspection, torch, dev, card,
                                             kp_work)
    demo = phase("demo_semantic", run_demo_path, torch, dev, card)
    new_train = phase("ST and MinkUNetHyper training", run_new_train_path, torch, dev, card)
    crf = phase("CRF forward", run_crf_path, torch, dev, card)
    phase("ST, MinkUNetHyper and CRF card vs CPU", new_models_card_vs_cpu, torch, dev)
    vbs = phase("plan batches", plan_batches, torch)
    phase("native library", check_native, torch, vbs[0], card)
    plans = phase("MinkUNet plans", run_plan_paths, torch, dev, card, vbs)
    del vbs
    pg_plans = phase("PointGroup plans and split", run_pointgroup_plan_paths, torch, dev, card)
    with tempfile.TemporaryDirectory() as raw_work:
        raw_scene = phase("raw scene to stage 1", run_raw_scene_path, torch, dev, card, raw_work)
    dp_runs = phase("data parallelism", run_dp_paths, torch, dev, card)
    print("wall seconds by phase: " + "; ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.2f}", flush=True)

    # each kernel's count is this slice's main path's: K2 and K3 the
    # MinkUNet trainer's default --plan_mode device steps, K4 PointGroup's
    # --plan_mode device step, K1 stage 1 on the prepared raw scene; each
    # kernel's counts on every path stand beside it.
    counted_paths = {"kpconv_inference": kp_infer["launches"],
                     "kpconv_training": kp_train["launches"],
                     "kpcnn_classification": kpcnn_launches,
                     "introspect_kpconv": erf_launches, "demo_semantic": demo,
                     "crf_forward": crf,
                     **{f"training_{n}": c for n, c in new_train.items()},
                     **{f"minkunet_training_plan_{f}": plans[f] for f in PLAN_FORMS},
                     "pointgroup_training_plan_host": pg_plans["host"],
                     "pointgroup_training_plan_device": pg_plans["device"],
                     "raw_scene_stage1_inference": raw_scene}
    prepare, clustering = pg_train[False], pg_train[True]
    k1["launches"] = raw_scene["masked_fps"]
    k1["launches_by_path"] = {"stage1_inference": launches["masked_fps"],
                              "stage1_inference_fast": fast_fps,
                              "stage1_training": train_fps,
                              "pointgroup_training_prepare": prepare["masked_fps"],
                              "pointgroup_training_clustering": clustering["masked_fps"]}
    k2["launches"] = plans["device"]["subm_conv"]
    k2["launches_by_path"] = {"stage2_semantic_inference": inference_k2,
                              "stage2_test_semantic_driver": driver_k2,
                              "stage2_training": train["subm_conv"],
                              "pointgroup_inference": pointgroup["subm_conv"],
                              "pointgroup_training_prepare": prepare["subm_conv"],
                              "pointgroup_training_clustering": clustering["subm_conv"]}
    k3["launches"] = plans["device"]["subm_dw"]
    k3["launches_by_path"] = {"stage2_training": train["subm_dw"],
                              "pointgroup_training_prepare": prepare["subm_dw"],
                              "pointgroup_training_clustering": clustering["subm_dw"]}
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_pg_err)
    k3["pointgroup_pairs"] = k3_pg
    k4["launches"] = pg_plans["device"]["cc_sweep"]
    k4["launches_by_path"] = {"pointgroup_inference": pointgroup["cc_sweep"],
                              "pointgroup_training_prepare": prepare["cc_sweep"],
                              "pointgroup_training_clustering": clustering["cc_sweep"]}
    for k, name in ((k1, "masked_fps"), (k2, "subm_conv"), (k3, "subm_dw"), (k4, "cc_sweep")):
        k["launches_by_path"].update({path: c[name] for path, c in counted_paths.items()})
        # the DP paths: a list of each rank's launches in its timed steps
        k["launches_by_path"].update({f"dp_{path}": [r[name] for r in ranks]
                                      for path, ranks in dp_runs.items()})
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
