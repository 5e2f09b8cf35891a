"""Stage-1 training driver (cli/stage1_train.py of the JAX package;
reference seggroup/train.py): trains the SegGroup GNN one scene a rank a
step, Adam (or SGD at 100 times the learning rate with `--use_sgd`), a
checkpoint of the model, the optimizer and the epoch after every epoch.

    python -m seggroup_tpu_torch.cli.stage1_train --label_style manual --epochs 6 --use_sgd
    python -m seggroup_tpu_torch.cli.stage1_train --synthetic 4 --epochs 1
    python -m seggroup_tpu_torch.cli.stage1_train --synthetic 2 --epochs 1 --device cpu \\
        --cluster_cap 256

Runs on the card unless `--device cpu`. `--num_devices N` (default every
visible card; 1 on the CPU) starts N ranks (parallel/dp.py): each step,
rank d trains on scene d of the JAX driver's batch (`batch_indices`: the
epoch's order in steps of N, the tail wrapped to its start), with its own
dropout generator, and the ranks average their gradients and running
statistics (`build_stage1_train_step`); the loss, IoU sums and accuracies
are summed over the ranks and the loss and accuracies divided by N, as
the JAX driver logs them. Rank 0 alone logs and saves; `--resume`
restores on every rank. With N = 1 the driver runs in its own process.

    python -m seggroup_tpu_torch.cli.stage1_train --synthetic 4 --epochs 1 --device cpu \\
        --cluster_cap 256 --num_devices 2"""

from __future__ import annotations

import argparse
import os
import time
from collections.abc import Callable, Sequence
from datetime import timedelta

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage1_common import (SceneSource, add_common_args,
                                                  batch_indices, dump_config, should_stop)
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.seggroup import SegGroupGNN
from seggroup_tpu_torch.parallel.dp import (Mesh, build_stage1_train_step, launch, rank_seed,
                                            resolve_num_devices)
from seggroup_tpu_torch.solvers import make_optimizer, make_schedule
from seggroup_tpu_torch.types import Scene
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager
from seggroup_tpu_torch.utils.logging import IOStream
from seggroup_tpu_torch.utils.tb import ScalarWriter


def train_step(model: SegGroupGNN, optimizer: torch.optim.Optimizer, scene: Scene,
               generator: torch.Generator | None = None,
               dropout_keep: torch.Tensor | None = None,
               phase_seconds: dict | None = None,
               sync: Callable[[torch.nn.Module], None] | None = None
               ) -> tuple[torch.Tensor, dict]:
    """One training step on one scene, the single-device counterpart of
    parallel/dp.py:77-124 `build_stage1_train_step` (its pmean and psum are
    the identity on one device): the `train` forward (BatchNorm batch
    statistics, which move the running ones; dropout from `generator` or
    `dropout_keep`), loss = loss_sum / max(loss_count, 1), the backward and
    one optimizer step. Returns (loss, metrics): the scene's `iou_sem`,
    `iou_ins` and `acc`, and the sizes that decide whether a budget bound
    (`max_segment_size`, `max_cluster_size`), all on the device. With
    `phase_seconds`, the device is synchronised around "forward",
    "backward" and "optimizer", and the forward adds its own phases and
    counters (SegGroupGNN.forward); every phase's entries go under
    "count.<phase>", and the process's recorder stays bound to the dict
    (utils/profiling.py). `sync(model)`, where given, runs between the
    backward and the optimizer (parallel/dp.py `Mesh.sync`: the ranks'
    mean of the gradients and the running statistics), timed as
    "all-reduce", inside which Mesh.sync adds "all-reduce.wait" (the wait
    for the slowest rank) and "all-reduce.transfer"."""
    phase = PhaseClock(model.device, phase_seconds)
    with phase("forward"):
        out = model(scene, mode="train", phase_seconds=phase_seconds,
                    dropout_keep=dropout_keep, generator=generator)
        loss = out.loss_sum / torch.clamp(out.loss_count, min=1.0)
    with phase("backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if sync is not None:
        with phase("all-reduce"):
            sync(model)
    with phase("optimizer"):
        optimizer.step()
    metrics = {name: getattr(out, name) for name in
               ("iou_sem", "iou_ins", "acc", "max_segment_size", "max_cluster_size")}
    return loss.detach(), metrics


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-1 SegGroup GNN training")
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--use_sgd", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--cluster_cap", type=int, default=1024)
    p.add_argument("--knn_window", type=int, default=8192,
                   help="cluster-kNN Morton-window budget; set both caps to "
                        "num_points for the exact (reference-semantics) path "
                        "on scenes with over-budget clusters")
    args = p.parse_args(argv)

    n_dev = resolve_num_devices(args.num_devices, args.device)
    if n_dev == 1:
        resolve_device(args.device)
    dump_config(args, "stage1_train")
    if n_dev > 1:
        return launch(_train, n_dev, args.device, args,
                      timeout=timedelta(seconds=args.dist_timeout))
    return _train(None, args)


def _train(mesh: Mesh | None, args):
    """The training loop of one rank (`mesh`), or of the only process."""
    dev = resolve_device(args.device if mesh is None else mesh.device)
    n_dev, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    exp_dir = os.path.join("checkpoints", args.exp_name)
    io = IOStream(os.path.join(exp_dir, "run.log"), enabled=rank == 0)
    tb = ScalarWriter(os.path.join(exp_dir, "tb"), enabled=args.tensorboard and rank == 0)
    io.cprint(f"mesh: {n_dev} devices ({dev.type})")

    source = SceneSource(args)
    io.cprint(f"scenes: {len(source)}")

    model = SegGroupGNN(cluster_cap=args.cluster_cap, knn_window=args.knn_window,
                        sequential=not args.parallel_grouping, fast_knn=args.fast_knn,
                        seed=args.seed, device=dev)
    n_params = sum(x.numel() for x in model.parameters())
    io.cprint(f"Network parameters: {n_params}")

    # the JAX driver's optimizers (parallel/dp.py:60-74): SGD at 100 x lr
    # with momentum, or Adam at lr; weight decay 1e-4 on the gradient
    if args.use_sgd:
        optimizer, _ = make_optimizer("SGD", model.parameters(),
                                      make_schedule("constant", args.lr * 100),
                                      momentum=args.momentum)
    else:
        optimizer, _ = make_optimizer("Adam", model.parameters(),
                                      make_schedule("constant", args.lr))

    ckpt = CheckpointManager(os.path.join(exp_dir, "models"), max_to_keep=args.epochs + 1)
    start_epoch = 0
    if args.resume:
        restored = ckpt.restore(map_location=dev)
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            start_epoch = int(restored["epoch"])
            io.cprint(f"resumed from epoch {start_epoch}")
    if mesh is None:
        dropout_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)

        def step(scene, generator):
            return train_step(model, optimizer, scene, generator=generator)
    else:
        mesh.replicate(model, optimizer)
        dropout_gen = torch.Generator(device=dev).manual_seed(rank_seed(args.seed + 2, rank))
        step = build_stage1_train_step(model, optimizer, mesh)

    try:
        for epoch in range(start_epoch, args.epochs):
            order = np.random.default_rng(args.seed + epoch).permutation(len(source))
            train_loss, nstep = 0.0, 0
            i_sem = np.zeros(40); u_sem = np.zeros(40)
            i_ins = np.zeros(40); u_ins = np.zeros(40)
            acc_all = np.zeros(4)
            t0 = time.time()
            for idx, _ in batch_indices(order, n_dev):
                scene, _ = source.get(idx[rank])
                loss, metrics = step(scene.to(dev), generator=dropout_gen)
                nstep += 1
                train_loss += float(loss) / n_dev
                iou_sem = metrics["iou_sem"].cpu().numpy()
                iou_ins = metrics["iou_ins"].cpu().numpy()
                i_sem += iou_sem[0]; u_sem += iou_sem[1]
                i_ins += iou_ins[0]; u_ins += iou_ins[1]
                acc_all += metrics["acc"].cpu().numpy() / n_dev
                with np.errstate(invalid="ignore", divide="ignore"):
                    miou_s = np.nanmean(np.where(u_sem > 0, i_sem / u_sem, np.nan))
                    miou_i = np.nanmean(np.where(u_ins > 0, i_ins / u_ins, np.nan))
                io.cprint(
                    "Epoch[%d/%d](%04d/%04d)  Loss: %.6f  Ins mIoU: %.2f%%  "
                    "Sem mIoU: %.2f%%  Ins Acc: %.2f%%  Sem Acc: %.2f%%  (%.2fs/step)"
                    % (epoch + 1, args.epochs, nstep * n_dev, len(source),
                       train_loss / nstep, 100 * miou_i, 100 * miou_s,
                       100 * acc_all[1] / nstep, 100 * acc_all[0] / nstep,
                       (time.time() - t0) / nstep))
            tb.add_scalar("train/loss", train_loss / max(nstep, 1), epoch + 1)
            tb.add_scalar("train/sem_miou", 100 * miou_s, epoch + 1)
            tb.add_scalar("train/ins_miou", 100 * miou_i, epoch + 1)
            if rank == 0:
                ckpt.save(epoch + 1, {"model": model.state_dict(),
                                      "optimizer": optimizer.state_dict(),
                                      "epoch": epoch + 1})
            io.cprint(f"==> saved checkpoint epoch {epoch + 1}")
            stop = rank == 0 and should_stop(args.exp_name)
            if mesh is not None:
                stop = mesh.any(stop)  # rank 0 has saved by then
            if stop:
                io.cprint("STOP file found — exiting after checkpoint save")
                break
    finally:
        tb.close()
        io.close()


if __name__ == "__main__":
    main()
