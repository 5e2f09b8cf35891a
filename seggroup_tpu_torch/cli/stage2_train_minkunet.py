"""Stage-2 semantic segmentation training: MinkowskiNet Res16UNet on pseudo
labels (cli/stage2_train_minkunet.py of the JAX package; reference
minkowski/main.py + lib/train.py:29-176): an iteration-based loop, SGD with
PolyLR by default, the masked mean NLL with an ignore label, periodic
validation that keeps the best checkpoint, and a STOP file.

Host threads (utils/prefetch.py) build the augmented voxel batches in numpy
ahead of the card (`make_batch`). `--plan_mode device`, the default as in
the JAX driver, packs each batch into the compact wire (float16 features,
int16 coordinates, uint8 labels: sparse/device_plan.pack_voxel_batch,
which raises on coordinates at or beyond +-32,000 and on labels outside
uint8), so that training and validation see the float16-rounded features
the JAX driver sees, and the card builds the pyramid plan
(`build_unet_plan_device`); `--plan_mode host` keeps the float32 batch
and builds the plan on the host (sparse/plan.build_unet_plan, the native
library). Neither plan holds window layouts, which the JAX driver's
Pallas kernels read and the port's K2 and K3 do not (sparse/conv.py).
The main thread moves each batch to the card (`batch_on_device`)
and runs `train_step`: the forward over the plan with BatchNorm batch
statistics, the backward through the submanifold convs' kernels (K2 for
the data gradient, K3 for the weight gradient), and the optimizer step.
The confusion matrix accumulates on the card and is read every 10
iterations.

    python -m seggroup_tpu_torch.cli.stage2_train_minkunet --synthetic 16 --max_iter 100
    python -m seggroup_tpu_torch.cli.stage2_train_minkunet --synthetic 2 --max_iter 2 \\
        --model Res16UNet14A --capacity 4096 --batch_size 2 --device cpu [--plan_mode host]

Runs on the card unless `--device cpu`. `--num_devices N` (default every
visible card; 1 on the CPU) starts N ranks (parallel/dp.py), each with its
own prefetcher: at step s (counted from 0) rank d trains on the JAX
driver's batch `make_batch(s * N + d + 1)`, a pure function of its seed, so
nothing is sent between ranks; each rank unpacks its batch on its card
as the single process does (`batch_on_device`: in `--plan_mode device` it
builds the plan there, in host mode it moves its host plan there) and runs
`build_minkunet_dp_step`. The ranks average their gradients and running
statistics; the loss and the confusion matrix are summed over them (the
loss logged divided by N). Rank 0 alone logs, validates and saves, the
others wait; `--resume` restores on every rank. With N = 1 the driver runs
in its own process.

    python -m seggroup_tpu_torch.cli.stage2_train_minkunet --synthetic 2 --max_iter 2 \\
        --model Res16UNet14A --capacity 4096 --batch_size 2 --device cpu --num_devices 2"""

from __future__ import annotations

import argparse
import os
import time
from datetime import timedelta
from collections.abc import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from seggroup_tpu_torch.cli.stage1_common import (SceneSource, add_common_args, dump_config,
                                                  should_stop)
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
from seggroup_tpu_torch.data.voxel_dataset import IGNORE_LABEL, VoxelBatch, make_voxel_batch
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.eval.semantic import confusion_matrix, miou_from_confusion
from seggroup_tpu_torch.models.minkunet import MinkUNet, make_minkunet
from seggroup_tpu_torch.parallel.dp import (Mesh, build_minkunet_dp_step, launch,
                                            resolve_num_devices)
from seggroup_tpu_torch.solvers import ScheduledLR, make_optimizer, make_schedule
from seggroup_tpu_torch.sparse.device_plan import (build_unet_plan_device, pack_voxel_batch,
                                                   unpack_voxel_batch)
from seggroup_tpu_torch.sparse.plan import build_unet_plan, plan_to_device
from seggroup_tpu_torch.sparse.tensor import SparseTensor
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager, lenient_restore
from seggroup_tpu_torch.utils.logging import IOStream
from seggroup_tpu_torch.utils.prefetch import HostPrefetcher
from seggroup_tpu_torch.utils.tb import ScalarWriter


def masked_nll(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the valid, labelled rows (the JAX
    driver's loss, cli/stage2_train_minkunet.py:213-218)."""
    ok = valid & (labels != IGNORE_LABEL)
    lp = F.log_softmax(logits, dim=-1)
    target = torch.clamp(labels, 0, logits.shape[1] - 1).long()
    nll = -lp.gather(1, target[:, None])[:, 0]
    return torch.where(ok, nll, 0.0).sum() / torch.clamp(ok.sum(), min=1)


def train_step(model: MinkUNet, optimizer: torch.optim.Optimizer, scheduler: ScheduledLR,
               st: SparseTensor, labels: torch.Tensor,
               phase_seconds: dict | None = None,
               plan: dict | None = None,
               sync: Callable[[torch.nn.Module], None] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One training step on the model's device: the forward with BatchNorm
    batch statistics (which updates the running statistics) over the
    batch's pyramid `plan` (built inside the forward without one), the
    loss, the backward, the optimizer step and the learning-rate schedule.
    Returns (loss, confusion matrix of the step's argmax over valid rows),
    both on the device, so nothing waits for it. With `phase_seconds`, the
    device is synchronised around "forward", "backward" and "optimizer",
    and their wall seconds are added to the dict. `sync(model)`, where
    given, runs between the backward and the optimizer (parallel/dp.py
    `Mesh.sync`), timed as "all-reduce"."""
    phase = PhaseClock(st.coords.device, phase_seconds)
    with phase("forward"):
        # the nets without plans (ResUNet, MinkUNetHyper) take none
        logits = model(st, train=True) if plan is None else model(st, train=True, plan=plan)
        loss = masked_nll(logits, labels, st.valid)
    with phase("backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if sync is not None:
        with phase("all-reduce"):
            sync(model)
    with phase("optimizer"):
        optimizer.step()
        scheduler.step()
    hist = confusion_matrix(logits.detach().argmax(-1),
                            torch.where(st.valid, labels, IGNORE_LABEL), logits.shape[1])
    return loss.detach(), hist


def make_train_batch(scene_tuple: Callable[[int], tuple], pool: Sequence[int], step: int,
                     seed: int, batch_size: int, capacity: int, voxel_size: float,
                     augment: bool) -> VoxelBatch:
    """The voxel batch of `step`: batch_size scenes drawn from `pool` and
    augmented with the generator seeded by (seed, step), so any thread can
    build any step's batch. `scene_tuple(i)` gives scene i's training tuple."""
    rng = np.random.default_rng((seed, step))
    idx = rng.integers(0, len(pool), size=batch_size)
    tuples = [scene_tuple(int(pool[int(i)])) for i in idx]
    return make_voxel_batch(tuples, capacity, voxel_size, rng=rng, augment=augment)


def batch_to_device(vb: VoxelBatch, dev: torch.device) -> tuple[SparseTensor, torch.Tensor]:
    st = SparseTensor(torch.from_numpy(vb.coords), torch.from_numpy(vb.feats),
                      torch.from_numpy(vb.valid), torch.tensor(int(vb.num), dtype=torch.int32))
    return st.to(dev), torch.from_numpy(vb.labels).to(dev)


def make_batch(scene_tuple: Callable[[int], tuple], pool: Sequence[int], step: int, seed: int,
               batch_size: int, capacity: int, voxel_size: float, augment: bool,
               plan_mode: str = "device", caps: Sequence[int] | None = None) -> tuple:
    """The batch of `step` as the JAX driver's `make_batch` ships it: with
    plan_mode "device" (wire, None), the wire pack_voxel_batch's (coords
    int16, feats float16, labels uint8, num); with "host" (VoxelBatch, host
    plan over `caps`)."""
    vb = make_train_batch(scene_tuple, pool, step, seed, batch_size, capacity, voxel_size,
                          augment)
    if plan_mode == "device":
        return pack_voxel_batch(vb), None
    return vb, build_unet_plan(vb.coords, int(vb.num), list(caps), with_windows=False)


def batch_on_device(batch, plan, dev: torch.device, caps: Sequence[int]
                    ) -> tuple[SparseTensor, torch.Tensor, dict]:
    """(st, labels, plan) on `dev` of what `make_batch` returned: the wire
    unpacked (float16 features made float32) and its plan built on `dev`
    (`build_unet_plan_device`), or the float32 batch and its host plan
    moved to `dev`."""
    if plan is None:
        st, labels = unpack_voxel_batch(*batch, device=dev)
        return st, labels, build_unet_plan_device(st.coords, st.num, tuple(caps),
                                                  with_windows=False)
    st, labels = batch_to_device(batch, dev)
    return st, labels, plan_to_device(plan, dev)


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-2 MinkUNet semantic training")
    add_common_args(p)
    p.add_argument("--model", type=str, default="Res16UNet34C")
    p.add_argument("--pseudo_root", type=str, default=None,
                   help="results/<exp> dir with stage-1 pseudo labels; "
                        "default trains on GT (fully-supervised upper bound)")
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--capacity", type=int, default=2 ** 17)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--optimizer", type=str, default="SGD")
    p.add_argument("--scheduler", type=str, default="PolyLR")
    p.add_argument("--max_iter", type=int, default=60000)
    p.add_argument("--val_freq", type=int, default=1000)
    p.add_argument("--val_frac", type=float, default=0.1,
                   help="fraction of scenes held out for validation")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--prefetch_workers", type=int, default=2)
    p.add_argument("--prefetch_depth", type=int, default=3)
    p.add_argument("--plan_mode", choices=["device", "host"], default="device",
                   help="device: ship compact float16 batches and build the pyramid plan "
                        "on the card (sparse/device_plan.py); host: ship float32 batches "
                        "and the plans the host builds (sparse/plan.py)")
    p.add_argument("--resume", action="store_true",
                   help="restore the model, optimizer and schedule from the latest "
                        "checkpoint and continue the iteration counter")
    p.add_argument("--weights", type=str, default=None,
                   help="initialize the model from this checkpoint dir, keeping "
                        "fresh values where names or shapes differ")
    args = p.parse_args(argv)

    n_dev = resolve_num_devices(args.num_devices, args.device)
    if n_dev == 1:
        resolve_device(args.device)
    dump_config(args, "stage2_minkunet")
    if n_dev > 1:
        return launch(_train, n_dev, args.device, args,
                      timeout=timedelta(seconds=args.dist_timeout))
    return _train(None, args)


def _train(mesh: Mesh | None, args):
    """The training loop of one rank (`mesh`), or of the only process;
    returns (last iteration, best validation mIoU) (rank 0's)."""
    dev = resolve_device(args.device if mesh is None else mesh.device)
    n_dev, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    exp_dir = os.path.join("checkpoints", args.exp_name)
    io = IOStream(os.path.join(exp_dir, "minkunet.log"), enabled=rank == 0)
    tb = ScalarWriter(os.path.join(exp_dir, "tb"), enabled=args.tensorboard and rank == 0)
    source = SceneSource(args)
    n_val = int(len(source) * args.val_frac)
    if args.val_frac > 0 and n_val == 0 and len(source) > 1:
        n_val = 1
    val_idx = list(range(len(source) - n_val, len(source)))
    train_idx = list(range(len(source) - n_val)) or val_idx
    io.cprint(f"scenes: {len(train_idx)} train / {len(val_idx)} val  model: {args.model}")

    def scene_tuple(i: int):
        scene, extras = source.get(i)
        return scene_to_training_tuple(scene, extras, args.pseudo_root, source.names[i],
                                       args.pseudo_root is not None)

    caps = level_caps(args.capacity)

    def draw(step, pool, augment):
        return make_batch(scene_tuple, pool, step, args.seed, args.batch_size, args.capacity,
                          args.voxel_size, augment, args.plan_mode, caps)

    model = make_minkunet(args.model, out_channels=args.num_classes, level_caps=caps,
                          seed=args.seed, device=dev)
    n_params = sum(x.numel() for x in model.parameters())
    io.cprint(f"Network parameters: {n_params / 1e6:.2f}M")
    schedule = make_schedule(args.scheduler, args.lr, max_iter=args.max_iter)
    optimizer, scheduler = make_optimizer(args.optimizer, model.parameters(), schedule)
    ckpt = CheckpointManager(os.path.join(exp_dir, "minkunet"), pow2_retention=True)
    best_ckpt = CheckpointManager(os.path.join(exp_dir, "minkunet_best"))
    if args.weights:
        state, n_loaded, n_tot = lenient_restore(args.weights, model.state_dict(),
                                                 log=io.cprint)
        model.load_state_dict(state)
        io.cprint(f"lenient init: {n_loaded}/{n_tot} tensors from {args.weights}")
    start_it = 0
    if args.resume:
        restored = ckpt.restore(map_location=dev)
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            scheduler.load_state_dict(restored["scheduler"])
            start_it = ckpt.latest_step()
            io.cprint(f"resumed from iter {start_it} "
                      f"(lr continues at {schedule(start_it):.4g})")

    def save_state(it):
        if rank == 0:
            ckpt.save(it, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                           "scheduler": scheduler.state_dict()})

    if mesh is None:
        def step(batch):
            st, labels, plan = batch_on_device(*batch, dev, caps)
            return train_step(model, optimizer, scheduler, st, labels, plan=plan)
    else:
        mesh.replicate(model, optimizer)
        io.cprint(f"data parallel over {n_dev} devices ({args.batch_size} scenes/device)")
        dp = build_minkunet_dp_step(model, optimizer, scheduler, mesh)

        def step(batch):
            return dp(*batch_on_device(*batch, dev, caps))

    def validate():
        hist = torch.zeros((args.num_classes, args.num_classes), dtype=torch.int64,
                           device=dev)
        with torch.no_grad():
            for j, vi in enumerate(val_idx):
                st, labels, plan = batch_on_device(*draw(10_000_000 + j, [vi], False), dev,
                                                   caps)
                logits = model(st, train=False, plan=plan)
                hist += confusion_matrix(logits.argmax(-1),
                                         torch.where(st.valid, labels, IGNORE_LABEL),
                                         args.num_classes)
        return miou_from_confusion(hist.cpu().numpy())[0]

    # rank d's batch of step s (from 0) is the JAX driver's shard d
    prefetch = HostPrefetcher(lambda s: draw(s * n_dev + rank + 1, train_idx, True),
                              depth=args.prefetch_depth, workers=args.prefetch_workers,
                              start=start_it)
    hist_acc = np.zeros((args.num_classes, args.num_classes))
    hist_dev = None  # device-side accumulator between logging reads
    best_val = -1.0
    t_window = time.time()
    it_window = start_it
    it = start_it
    try:
        for it in range(start_it + 1, args.max_iter + 1):
            loss, hist = step(next(prefetch))
            loss = loss / n_dev
            hist_dev = hist if hist_dev is None else hist_dev + hist
            if it % 10 == 0 or it == args.max_iter:
                hist_acc = hist_acc + hist_dev.cpu().numpy()
                hist_dev = None
                miou, _ = miou_from_confusion(hist_acc)
                io.cprint("iter %d/%d  loss %.4f  running mIoU %.2f%%  lr %.4g  (%.2fs/it)"
                          % (it, args.max_iter, float(loss), 100 * miou, schedule(it),
                             (time.time() - t_window) / max(1, it - it_window)))
                tb.add_scalar("train/loss", float(loss), it)
                tb.add_scalar("train/miou", 100 * miou, it)
                tb.add_scalar("train/lr", float(schedule(it)), it)
                t_window = time.time()
                it_window = it
            stop = rank == 0 and should_stop(args.exp_name)
            if mesh is not None:
                stop = mesh.any(stop)
            if stop:
                io.cprint("STOP file found — saving and exiting")
                save_state(it)
                break
            if it % args.val_freq == 0 or it == args.max_iter:
                save_state(it)
                if rank == 0:
                    val_miou = validate()
                    marker = ""
                    if val_miou > best_val:
                        best_val = val_miou
                        best_ckpt.save(it, {"model": model.state_dict()})
                        marker = "  (new best)"
                    io.cprint(f"==> saved iter {it}  val mIoU {100 * val_miou:.2f}%{marker}")
                    tb.add_scalar("val/miou", 100 * val_miou, it)
                if mesh is not None:
                    mesh.barrier()
                t_window = time.time()
                it_window = it
    finally:
        prefetch.close()
        tb.close()
        io.close()
    return it, best_val


if __name__ == "__main__":
    main()
