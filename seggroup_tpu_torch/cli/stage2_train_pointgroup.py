"""Stage-2 instance segmentation training: PointGroup on pseudo labels
(cli/stage2_train_pointgroup.py of the JAX package; reference
pointgroup/train.py with config/pointgroup_run2_scannet.yaml): Adam at lr
1e-3 under the step schedule lr = base * multiplier^(step // step_size),
never below 1e-6; the heads alone for `--prepare_steps` steps, then the
dual clustering, the ScoreNet and its loss; validation on held-out scenes
with the best checkpoint kept; a STOP file.

A host thread (utils/prefetch.py) builds each step's batch ahead of the
card: the scenes drawn and augmented, in step order, from one generator
seeded by `seed`, as the JAX driver's single prefetch worker draws them
(validation draws from its own, seeded by seed + 100); cropped and padded
to the point cap, voxelised
(`host_voxelize_plan`) and, at the default `--plan_mode device`, packed
into the compact wire format, whose colours are float16 as the JAX
trainer's default ships them; the card unpacks it and builds the U-Net's
7-level pyramid plan (`build_unet_plan_device`, no windows). With
`--plan_mode host` the batch stays float32 and the host builds the plan
as well (`host_voxelize_plan(level_caps=...)`); the card makes the voxel
features from it (`host_batch_on_device`). The main thread runs
`train_step` over the plan: the forward with BatchNorm batch statistics, the loss, the
backward through the submanifold convs' kernels (K2 for the data gradient,
K3 for the weight gradient), and the optimizer step; the clustering runs
kernel K4. The proposals' jitter comes from a generator seeded by seed + 1,
three uniforms a step. A checkpoint holds the batch generator's state just
after its step's draw (the prefetcher has drawn further by then), so a
resumed run draws what an unbroken one would; the JAX driver restarts its
generator on resume instead.

    python -m seggroup_tpu_torch.cli.stage2_train_pointgroup --synthetic 8 --steps 50
    python -m seggroup_tpu_torch.cli.stage2_train_pointgroup --data_root ... --pseudo_root results/exp
    python -m seggroup_tpu_torch.cli.stage2_train_pointgroup --synthetic 2 --device cpu \\
        --steps 4 --prepare_steps 2 --save_freq 2 --point_cap 4096 --voxel_cap 4096 --m 8

Runs on the card unless `--device cpu`. Writes checkpoints/<exp>/pointgroup,
which cli/stage2_test_pointgroup.py restores. `--num_devices N` (default
every visible card; 1 on the CPU) starts N ranks (parallel/dp.py): rank 0's
prefetcher draws each step's N batches from the one generator, in rank
order, as the JAX driver's `[sample_batch() for _ in range(n_dev)]` does,
and hands rank d its own (the wire, or the host batch and plan, over the
host group); each rank unpacks it on its card and draws its jitter from a
generator of its own, seeded by (seed + 1, rank). The ranks average their
gradients and running statistics (`build_pointgroup_dp_step`)
and sum the loss, logged divided by N. Rank 0 alone logs, validates and
saves, its checkpoint holds the generator's state after the step's N
draws; `--resume` restores on every rank. With N = 1 the driver runs in
its own process.

    python -m seggroup_tpu_torch.cli.stage2_train_pointgroup --synthetic 3 --device cpu \\
        --steps 4 --prepare_steps 2 --point_cap 4096 --voxel_cap 4096 --m 8 --num_devices 2"""

from __future__ import annotations

import argparse
import os
import time
from datetime import timedelta
from collections.abc import Callable, Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage1_common import (SceneSource, add_common_args, dump_config,
                                                  should_stop)
from seggroup_tpu_torch.cli.stage2_pointgroup_common import (host_voxelize_plan, make_pg_batch,
                                                             scene_instance_tuple)
from seggroup_tpu_torch.cli.stage2_test_pointgroup import make_eval_model
from seggroup_tpu_torch.data.pg_wire import (host_batch_on_device, pack_pg_batch,
                                             unpack_pg_batch)
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.pointgroup import PointGroup, pointgroup_loss
from seggroup_tpu_torch.parallel.dp import (Mesh, build_pointgroup_dp_step, launch, rank_seed,
                                            resolve_num_devices)
from seggroup_tpu_torch.solvers import ScheduledLR, make_optimizer
from seggroup_tpu_torch.sparse.device_plan import build_unet_plan_device
from seggroup_tpu_torch.sparse.plan import plan_to_device
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager, lenient_restore
from seggroup_tpu_torch.utils.logging import IOStream
from seggroup_tpu_torch.utils.prefetch import HostPrefetcher
from seggroup_tpu_torch.utils.tb import ScalarWriter

MIN_LR = 1e-6


def step_schedule(lr: float, multiplier: float, step_size: int) -> Callable[[int], float]:
    """The reference's step decay (util/utils.py:25-29) with the JAX
    driver's floor: lr * multiplier^(step // step_size), at least 1e-6."""
    return lambda s: max(lr * multiplier ** (s // step_size), MIN_LR)


def make_adam(model: PointGroup, schedule: Callable[[int], float]
              ) -> tuple[torch.optim.Optimizer, ScheduledLR]:
    """The JAX driver's optax.adam(schedule): no weight decay."""
    return make_optimizer("Adam", model.parameters(), schedule, weight_decay=0.0)


def train_step(model: PointGroup, optimizer: torch.optim.Optimizer, scheduler: ScheduledLR,
               batch: tuple, do_clustering: bool, jitter: torch.Tensor | None,
               phase_seconds: dict | None = None,
               plan: dict | None = None,
               sync: Callable[[torch.nn.Module], None] | None = None
               ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """One training step on the model's device, the single-device form of
    parallel/dp.py `build_pointgroup_dp_step` (its pmean and psum are the
    identity on one device): the `train` forward (BatchNorm batch
    statistics, which move the running ones; with `do_clustering` the
    dual clustering with the proposals shifted by `jitter` and the
    ScoreNet), pointgroup_loss (the score loss with `do_clustering`), the
    backward and one optimizer step. `batch` is unpack_pg_batch's tuple;
    the instance cap is the length of its per-instance point counts.
    Parameters that the step does not reach (the ScoreNet's before the
    clustering starts) get a zero gradient, as jax.grad gives them, so
    that Adam counts the step for them as optax does. Returns (loss, the
    loss's parts, proposals), all on the device. `plan`: the U-Net's
    pyramid plan (the forward builds its rulebooks without one). With
    `phase_seconds`, the device is synchronised around "forward" (and
    inside it "unet", "clustering", "scorenet"), "loss", "backward" and
    "optimizer", and their wall seconds are added to the dict. `sync(model)`,
    where given, runs between the backward and the optimizer
    (parallel/dp.py `Mesh.sync`), timed as "all-reduce"."""
    st, p2v, coords, batch_ids, valid, labels, inst, centroid, pointnum = batch
    phase = PhaseClock(coords.device, phase_seconds)
    with phase("forward"):
        out = model(st, p2v, coords, batch_ids, valid, do_clustering=do_clustering, train=True,
                    jitter=jitter, plan=plan, phase_seconds=phase_seconds)
    with phase("loss"):
        loss, aux = pointgroup_loss(out, labels, inst, centroid, pointnum, coords, valid,
                                    num_instances_cap=pointnum.shape[0],
                                    with_score=do_clustering)
    with phase("backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if sync is not None:
        with phase("all-reduce"):
            sync(model)
    with phase("optimizer"):
        optimizer.step()
        scheduler.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, out.num_proposals


def unet_level_caps(voxel_cap: int) -> tuple[int, ...]:
    """The 7-level U-Net's capacities (the JAX driver's level_caps)."""
    return tuple(voxel_cap >> i for i in range(7))


def make_train_batch(scene_tuple: Callable[[int], tuple], pool: Sequence[int],
                     rng: np.random.Generator, batch_size: int, point_cap: int, voxel_cap: int,
                     instance_cap: int, voxel_size: float, augment: bool,
                     phase: PhaseClock | None = None, plan_mode: str = "device"):
    """The batch of `batch_size` scenes drawn from `pool` with `rng` (which
    also draws the augmentation and the crops): with plan_mode "device" the
    wire (a dict), with "host" (PGHostBatch, host_voxelize_plan's voxel
    coords, num, point2voxel and 7-level plan). `scene_tuple(i)` gives
    scene i's (coords, colours, sem, ins). With `phase`, its two halves are
    timed apart: "host batch" (the draw, the crops, the augmentation, the
    instance bookkeeping) and "voxelise" (the host voxelisation and the
    wire or the plan)."""
    phase = phase or PhaseClock(torch.device("cpu"), None)
    with phase("host batch"):
        idx = rng.integers(0, len(pool), size=batch_size)
        hb = make_pg_batch([scene_tuple(int(pool[int(i)])) for i in idx], point_cap,
                           instance_cap, rng=rng, augment=augment)
    with phase("voxelise"):
        if plan_mode == "device":
            vcoords, num, p2v = host_voxelize_plan(hb, voxel_size, voxel_cap)
            return pack_pg_batch(hb, vcoords, num, p2v)
        return hb, host_voxelize_plan(hb, voxel_size, voxel_cap, unet_level_caps(voxel_cap))


def batch_on_device(raw, voxel_cap: int, dev: torch.device) -> tuple[tuple, dict]:
    """(unpack_pg_batch's tuple, the U-Net's plan) on `dev` from what
    make_train_batch returned: the wire unpacked and its plan built on
    `dev`, or the host batch with its host plan moved there."""
    if isinstance(raw, dict):
        batch = unpack_pg_batch(raw, voxel_cap, dev)
        st = batch[0]
        return batch, build_unet_plan_device(st.coords, st.num, unet_level_caps(voxel_cap),
                                             window_levels=0)
    hb, (vcoords, num, p2v, plan) = raw
    return (host_batch_on_device(hb, vcoords, num, p2v, voxel_cap, dev),
            plan_to_device(plan, dev))


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-2 PointGroup training")
    add_common_args(p)
    p.add_argument("--pseudo_root", type=str, default=None)
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--point_cap", type=int, default=2 ** 17)
    p.add_argument("--voxel_cap", type=int, default=2 ** 16)
    p.add_argument("--instance_cap", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_step_size", type=int, default=120000,
                   help="steps per decay step (reference step_epoch=384 of "
                        "384 epochs, i.e. one decay interval over the run)")
    p.add_argument("--lr_multiplier", type=float, default=0.5)
    p.add_argument("--steps", type=int, default=120000)
    p.add_argument("--val_frac", type=float, default=0.1)
    p.add_argument("--prepare_steps", type=int, default=40000,
                   help="steps before clustering+ScoreNet kick in "
                        "(reference prepare_epochs=128 of 384)")
    p.add_argument("--save_freq", type=int, default=2000)
    p.add_argument("--m", type=int, default=16)
    p.add_argument("--prefetch_depth", type=int, default=3)
    p.add_argument("--plan_mode", choices=["device", "host"], default="device",
                   help="device: ship compact batches and build the 7-level pyramid plan "
                        "on the card; host: ship float32 batches and the plans the host "
                        "builds")
    p.add_argument("--resume", action="store_true",
                   help="restore the model, optimizer and schedule from the latest "
                        "checkpoint and continue the step counter, the LR schedule and "
                        "the jitter stream")
    p.add_argument("--pretrain", type=str, default=None,
                   help="checkpoint dir to initialize matching tensors from; names or "
                        "shapes that differ keep their init")
    args = p.parse_args(argv)

    n_dev = resolve_num_devices(args.num_devices, args.device)
    if n_dev == 1:
        resolve_device(args.device)
    dump_config(args, "stage2_pointgroup")
    if n_dev > 1:
        return launch(_train, n_dev, args.device, args,
                      timeout=timedelta(seconds=args.dist_timeout))
    return _train(None, args)


def _train(mesh: Mesh | None, args):
    """The training loop of one rank (`mesh`), or of the only process;
    returns (last step, best validation loss) (rank 0's)."""
    dev = resolve_device(args.device if mesh is None else mesh.device)
    n_dev, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    exp_dir = os.path.join("checkpoints", args.exp_name)
    io = IOStream(os.path.join(exp_dir, "pointgroup.log"), enabled=rank == 0)
    tb = ScalarWriter(os.path.join(exp_dir, "tb"), enabled=args.tensorboard and rank == 0)
    source = SceneSource(args)
    n_val = int(len(source) * args.val_frac)
    if args.val_frac > 0 and n_val == 0 and len(source) > 1:
        n_val = 1
    val_idx = list(range(len(source) - n_val, len(source)))
    train_idx = list(range(len(source) - n_val)) or val_idx
    io.cprint(f"scenes: {len(train_idx)} train / {len(val_idx)} val")

    def scene_tuple(i: int):
        scene, extras = source.get(i)
        return scene_instance_tuple(scene, extras, args.pseudo_root, source.names[i])

    def make_batch(rng, pool, augment):
        return make_train_batch(scene_tuple, pool, rng, args.batch_size, args.point_cap,
                                args.voxel_cap, args.instance_cap, args.voxel_size, augment,
                                plan_mode=args.plan_mode)

    model = make_eval_model(args.m, args.voxel_cap, dev, seed=args.seed)
    io.cprint("Network parameters: %.2fM" % (sum(x.numel() for x in model.parameters()) / 1e6))
    schedule = step_schedule(args.lr, args.lr_multiplier, args.lr_step_size)
    optimizer, scheduler = make_adam(model, schedule)
    ckpt = CheckpointManager(os.path.join(exp_dir, "pointgroup"), pow2_retention=True)
    best_ckpt = CheckpointManager(os.path.join(exp_dir, "pointgroup_best"))
    if args.pretrain:
        state, n_loaded, n_tot = lenient_restore(args.pretrain, model.state_dict(),
                                                 log=io.cprint)
        model.load_state_dict(state)
        io.cprint(f"pretrain init: {n_loaded}/{n_tot} tensors from {args.pretrain}")
    # one generator draws every training batch, in step order, on the single
    # prefetch worker (JAX: cli/stage2_train_pointgroup.py `sample_batch`)
    batch_rng = np.random.default_rng(args.seed)
    start_it = 0
    if args.resume:
        restored = ckpt.restore(map_location=dev)
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            scheduler.load_state_dict(restored["scheduler"])
            if "batch_rng" not in restored:
                raise ValueError(
                    "this checkpoint predates the single training batch generator "
                    "and holds no generator state, so a resumed run cannot continue "
                    "its batch stream bit for bit; start a fresh run")
            batch_rng.bit_generator.state = restored["batch_rng"]
            start_it = ckpt.latest_step()
            io.cprint(f"resumed from step {start_it} (lr continues at {schedule(start_it):.4g})")

    def draw_batch(_):
        # the step's batch (data-parallel: its n_dev batches, in rank order);
        # the prefetcher runs ahead, so the generator's live state is a later
        # step's: each step carries the state its draws left
        batches = [make_batch(batch_rng, train_idx, True) for _ in range(n_dev)]
        return batches[0] if mesh is None else batches, batch_rng.bit_generator.state

    def save_state(it):  # after step `it`, whose draws left `rng_state`
        if rank == 0:
            ckpt.save(it, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                           "scheduler": scheduler.state_dict(), "batch_rng": rng_state})

    val_rng = np.random.default_rng(args.seed + 100)

    def validate():
        losses = []
        with torch.no_grad():
            for _ in range(max(1, len(val_idx) // args.batch_size)):
                batch, plan = batch_on_device(make_batch(val_rng, val_idx, False),
                                              args.voxel_cap, dev)
                st, p2v, coords, batch_ids, valid, labels, inst, centroid, pointnum = batch
                out = model(st, p2v, coords, batch_ids, valid, do_clustering=False, train=False,
                            plan=plan)
                loss, _ = pointgroup_loss(out, labels, inst, centroid, pointnum, coords, valid,
                                          num_instances_cap=args.instance_cap,
                                          with_score=False)
                losses.append(float(loss))
        return float(np.mean(losses))

    # one jitter draw a step, clustering or not: replayed on resume
    jitter_gen = torch.Generator().manual_seed(
        args.seed + 1 if mesh is None else rank_seed(args.seed + 1, rank))
    for _ in range(start_it):
        torch.rand(3, generator=jitter_gen)
    if mesh is None:
        def step(raw, clustering, jitter):
            batch, plan = batch_on_device(raw, args.voxel_cap, dev)
            return train_step(model, optimizer, scheduler, batch, clustering, jitter,
                              plan=plan)[:2]
    else:
        mesh.replicate(model, optimizer)
        io.cprint(f"data parallel over {n_dev} devices")
        dp = {c: build_pointgroup_dp_step(model, optimizer, scheduler, mesh, c)
              for c in (False, True)}

        def step(raw, clustering, jitter):
            return dp[clustering](*batch_on_device(raw, args.voxel_cap, dev), jitter), {}
    # rank 0 draws every rank's batches and hands them out
    prefetch = (HostPrefetcher(draw_batch, depth=args.prefetch_depth, workers=1,
                               start=start_it) if rank == 0 else None)
    best_val = float("inf")
    t0 = time.time()
    it = start_it
    try:
        for it in range(start_it + 1, args.steps + 1):
            jitter = torch.rand(3, generator=jitter_gen).to(dev)
            clustering = it > args.prepare_steps
            raw, rng_state = next(prefetch) if rank == 0 else (None, None)
            if mesh is not None:
                raw = mesh.scatter(raw)
            loss, aux = step(raw, clustering, jitter)
            loss = loss / n_dev
            if it % 10 == 0 or it == args.steps:
                parts = "  ".join(f"{k} {float(v):.4f}" for k, v in aux.items())
                io.cprint("step %d/%d  loss %.4f  %s  (%.2fs/it)"
                          % (it, args.steps, float(loss), parts,
                             (time.time() - t0) / max(1, it - start_it)))
                tb.add_scalar("train/loss", float(loss), it)
                for k, v in aux.items():
                    tb.add_scalar(f"train/{k}", float(v), it)
            stop = rank == 0 and should_stop(args.exp_name)
            if mesh is not None:
                stop = mesh.any(stop)
            if stop:
                io.cprint("STOP file found — saving and exiting")
                save_state(it)
                break
            if it % args.save_freq == 0 or it == args.steps:
                save_state(it)
                if rank == 0:
                    vl = validate()
                    marker = ""
                    if vl < best_val:
                        best_val = vl
                        best_ckpt.save(it, {"model": model.state_dict()})
                        marker = "  (new best)"
                    io.cprint(f"==> saved step {it}  val loss {vl:.4f}{marker}")
                    tb.add_scalar("val/loss", float(vl), it)
                if mesh is not None:
                    mesh.barrier()
    finally:
        if prefetch is not None:
            prefetch.close()
        tb.close()
        io.close()
    return it, best_val


if __name__ == "__main__":
    main()
