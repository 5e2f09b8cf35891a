"""Stage-2 semantic segmentation training: the KPConv FCNN on pseudo labels
(cli/stage2_train_kpconv.py of the JAX package; reference
kpconv/training_Scannet2.py + utils/trainer.py): in-radius spheres at the
potential sampler's minimum, per-level neighbour caps calibrated from probe
batches, SGD with momentum 0.98 under an exponential decay, the deformable
offsets' regulariser in the loss, a 0.1 learning-rate scale on the offset
weights and a per-tensor gradient clip (trainer.py:119-152), and
vote-smoothed validation on held-out scenes (tester EMA, utils/tester.py:742)
with the best checkpoint kept; a STOP file.

The batches are the JAX driver's: one generator seeded by `--seed` serves
every sphere's random crop; the calibration batches come from a sampler
seeded by seed + 1, then the training sampler (seed) gives one batch that
the JAX driver initialises the model on and never trains on (the port
draws it too and discards it), then the single prefetch worker
(utils/prefetch.py) draws the steps in order. A checkpoint holds the
sampler's and the generator's state just after its step's draw, so a
resumed run draws what an unbroken one would; the JAX driver restarts both
on resume instead. The main thread moves each batch to the device, builds
the pyramid there and runs `train_step`.

    python -m seggroup_tpu_torch.cli.stage2_train_kpconv --synthetic 8 --steps 30
    python -m seggroup_tpu_torch.cli.stage2_train_kpconv --synthetic 3 --device cpu \\
        --steps 2 --save_freq 2 --point_cap 512 --first_features_dim 16 --dl0 0.2 \\
        --in_radius 5.0 --batch_size 1 --calib_batches 1

Runs on the card unless `--device cpu`. Writes checkpoints/<exp>/kpconv
(`{"model": state_dict, ...}`, power-of-two retention) and kpconv_best,
which cli/stage2_test_semantic.py --model kpconv and cli/introspect_kpconv.py
restore. `--num_devices N` (default every visible card; 1 on the CPU)
starts N ranks (parallel/dp.py): every rank loads the scenes and runs the
same calibration, and rank 0's prefetcher draws each step's N batches
from the one sampler and generator, in rank order, as the JAX driver's
`[sample_batch(sampler) for _ in range(n_dev)]` does, and hands rank d its
own over the host group. Each rank builds its pyramid on its card, clips
and scales its own gradients, and the ranks average them and their
running statistics (`build_kpconv_dp_step`: transform, then mean); the
loss is summed (logged divided by N), the accuracy averaged. Rank 0 alone
logs, validates and saves, its checkpoint holds the sampler's and
generator's states after the step's N draws; `--resume` restores on every
rank. With N = 1 the driver runs in its own process."""

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
from seggroup_tpu_torch.cli.stage2_test_semantic import KPCONV_LAYERS, kpconv_level_caps
from seggroup_tpu_torch.data.potentials import PotentialSampler
from seggroup_tpu_torch.data.voxel_dataset import IGNORE_LABEL
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.kpconv import (KPFCNN, PyramidLevel, build_pyramid,
                                              calibrate_batch_limit, calibrate_neighbor_caps,
                                              sample_sphere_sizes)
from seggroup_tpu_torch.parallel.dp import Mesh, build_kpconv_dp_step, launch, resolve_num_devices
from seggroup_tpu_torch.solvers import ScheduledLR, make_optimizer, make_schedule
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager, lenient_restore
from seggroup_tpu_torch.utils.logging import IOStream
from seggroup_tpu_torch.utils.prefetch import HostPrefetcher
from seggroup_tpu_torch.utils.tb import ScalarWriter

# the reference's exponential decay: a tenth every 150,000 steps
EXP_GAMMA = 0.1 ** (1 / 150000)
SGD_MOMENTUM = 0.98
OFFSET_PARAMS = ("offset_kernel", "offset_mlp")


def sample_batch(scenes: Sequence[tuple], sampler: PotentialSampler, rng: np.random.Generator,
                 batch_size: int, in_radius: float, n_cap: int):
    """One batch of in-radius spheres at the sampler's minimum-potential
    centres (the JAX driver's `sample_batch`): up to `batch_size` spheres,
    each cut to the room left under `n_cap` by a permutation from `rng`,
    stopping once the cap is full. Returns (points (n_cap, 3), feats
    (n_cap, 4): 1 and rgb / 255, labels (n_cap,) with 255 on padding,
    batch ids, valid)."""
    coords_l, feats_l, labels_l, batch_l = [], [], [], []
    total = 0
    for b in range(batch_size):
        si, center = sampler.next_center()
        c, col, lab = scenes[si]
        sel = np.where(((c - center) ** 2).sum(1) < in_radius ** 2)[0]
        if len(sel) > (n_cap - total):
            sel = sel[rng.permutation(len(sel))[: n_cap - total]]
        coords_l.append(c[sel])
        feats_l.append(col[sel])
        labels_l.append(lab[sel])
        batch_l.append(np.full(len(sel), b, np.int32))
        total += len(sel)
        if total >= n_cap:
            break
    pts = np.zeros((n_cap, 3), np.float32)
    cols = np.zeros((n_cap, 3), np.float32)
    labs = np.full(n_cap, IGNORE_LABEL, np.int32)
    bids = np.zeros(n_cap, np.int32)
    n = min(total, n_cap)
    pts[:n] = np.concatenate(coords_l)[:n]
    cols[:n] = np.concatenate(feats_l)[:n]
    labs[:n] = np.concatenate(labels_l)[:n]
    bids[:n] = np.concatenate(batch_l)[:n]
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    # in_features_dim 4: a constant 1 and rgb (reference training_Scannet.py:122)
    feats = np.concatenate([np.ones((n_cap, 1), np.float32), cols / 255.0], 1)
    return pts, feats, labs, bids, valid


def kpconv_loss(logits: torch.Tensor, regs: torch.Tensor, labels: torch.Tensor,
                offset_loss_weight: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy over the labelled rows, labels clipped to the
    classes, plus `offset_loss_weight` times the regularisers; the accuracy
    over the labelled rows), as the JAX driver's step computes them."""
    ok = labels != IGNORE_LABEL
    lp = F.log_softmax(logits, dim=-1)
    target = torch.clamp(labels, 0, logits.shape[1] - 1).long()
    nll = -lp.gather(1, target[:, None])[:, 0]
    n_ok = torch.clamp(ok.sum(), min=1)
    ce = torch.where(ok, nll, 0.0).sum() / n_ok
    acc = ((torch.argmax(logits, -1) == labels) & ok).sum() / n_ok
    return ce + offset_loss_weight * regs, acc


def transform_grads(model: torch.nn.Module, offset_lr_scale: float, clip: float) -> None:
    """The JAX driver's `per_var_grads`, in place: the gradients of the
    offset weights (`offset_kernel`, `offset_mlp`) scaled by
    `offset_lr_scale`, then each tensor's clipped to norm `clip` (scaled by
    min(1, clip / sqrt(sum g^2 + 1e-12)))."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = p.grad
            if any(k in name for k in OFFSET_PARAMS):
                g.mul_(offset_lr_scale)
            norm = torch.sqrt(torch.sum(torch.square(g)) + 1e-12)
            g.mul_(torch.clamp(clip / norm, max=1.0))


def make_sgd(model: torch.nn.Module, lr: float) -> tuple[torch.optim.Optimizer, ScheduledLR]:
    """optax.sgd(ExpLR(lr, 0.1^(1/150000) a step), momentum=0.98): optax's
    trace g + 0.98 t is torch's momentum buffer; no weight decay."""
    schedule = make_schedule("ExpLR", lr, exp_gamma=EXP_GAMMA, exp_step_size=1)
    return make_optimizer("SGD", model.parameters(), schedule, momentum=SGD_MOMENTUM,
                          weight_decay=0.0)


def train_step(model: KPFCNN, optimizer: torch.optim.Optimizer, scheduler: ScheduledLR,
               pyramid: list[PyramidLevel], feats: torch.Tensor, labels: torch.Tensor,
               offset_loss_weight: float = 0.1, grad_clip_norm: float = 100.0,
               offset_lr_scale: float = 0.1, phase_seconds: dict | None = None,
               sync: Callable[[torch.nn.Module], None] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the JAX driver's `step` on the model's device: the train
    forward (TFBatchNorm batch statistics, which move the running ones),
    `kpconv_loss`, the backward, `transform_grads` and one SGD step.
    Returns (loss, accuracy) on the device. With `phase_seconds`, the device
    is synchronised around "forward", "loss", "backward", "grad transform"
    and "optimizer", and their wall seconds are added to the dict.
    `sync(model)`, where given, runs after the gradient transform and
    before the optimizer (parallel/dp.py `Mesh.sync`: the transform acts
    on each rank's own gradients before their mean, as the JAX DP step's
    grad_transform does), timed as "all-reduce"."""
    phase = PhaseClock(feats.device, phase_seconds)
    with phase("forward"):
        logits, regs = model(pyramid, feats, train=True)
    with phase("loss"):
        loss, acc = kpconv_loss(logits, regs, labels, offset_loss_weight)
    with phase("backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in model.parameters():  # jax.grad's zeros, which optax's trace counts
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    with phase("grad transform"):
        transform_grads(model, offset_lr_scale, grad_clip_norm)
    if sync is not None:
        with phase("all-reduce"):
            sync(model)
    with phase("optimizer"):
        optimizer.step()
        scheduler.step()
    return loss.detach(), acc


def to_device_pyramid(pts, bids, valid, dev, dl0: float, caps: Sequence[int],
                      nbr_caps: Sequence[int], return_overflow: bool = False):
    """The driver's pyramid (5 levels at `caps` rows below level 0,
    `nbr_caps` neighbours a level) of a host batch, on `dev`."""
    return build_pyramid(torch.from_numpy(pts).to(dev), torch.from_numpy(bids).to(dev),
                         torch.from_numpy(valid).to(dev), KPCONV_LAYERS, dl0,
                         level_caps=caps, neighbor_cap=list(nbr_caps),
                         return_overflow=return_overflow)


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-2 KPConv semantic training")
    add_common_args(p)
    p.add_argument("--pseudo_root", type=str, default=None)
    p.add_argument("--dl0", type=float, default=0.04)
    p.add_argument("--in_radius", type=float, default=2.0)
    p.add_argument("--point_cap", type=int, default=2 ** 15)
    p.add_argument("--batch_size", type=int, default=4,
                   help="spheres per step (reference batch_num=10)")
    p.add_argument("--first_features_dim", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--steps", type=int, default=300000,
                   help="reference: 500 epochs x 600 steps")
    p.add_argument("--offset_loss_weight", type=float, default=0.1)
    p.add_argument("--save_freq", type=int, default=2000)
    p.add_argument("--val_frac", type=float, default=0.1,
                   help="fraction of scenes held out for validation "
                        "(reference validates per epoch, trainer.py:331+)")
    p.add_argument("--val_spheres", type=int, default=8,
                   help="vote spheres per validation pass")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--calib_batches", type=int, default=4,
                   help="batches probed for neighbor-cap calibration")
    p.add_argument("--auto_point_cap", action="store_true",
                   help="calibrate point_cap from sampled in_radius-sphere "
                        "sizes so ~batch_size spheres fit (reference "
                        "calibrate_batches, common.py:487-549); overrides "
                        "--point_cap")
    p.add_argument("--keep_ratio", type=float, default=0.8,
                   help="calibration quantile (reference common.py:561)")
    p.add_argument("--grad_clip_norm", type=float, default=100.0,
                   help="per-variable gradient clip (reference trainer.py:125)")
    p.add_argument("--offset_lr_scale", type=float, default=0.1,
                   help="LR scale on deformable offset convs "
                        "(reference trainer.py:119-152)")
    p.add_argument("--prefetch_depth", type=int, default=3)
    p.add_argument("--resume", action="store_true",
                   help="restore the model, optimizer, schedule, sampler and batch "
                        "generator from the latest checkpoint and continue the step "
                        "counter and LR schedule")
    p.add_argument("--weights", type=str, default=None,
                   help="initialize params from this checkpoint dir with "
                        "shape-mismatch tolerance (lenient loading)")
    args = p.parse_args(argv)

    n_dev = resolve_num_devices(args.num_devices, args.device)
    if n_dev == 1:
        resolve_device(args.device)
    dump_config(args, "stage2_kpconv")
    if n_dev > 1:
        return launch(_train, n_dev, args.device, args,
                      timeout=timedelta(seconds=args.dist_timeout))
    return _train(None, args)


def _train(mesh: Mesh | None, args):
    """The training loop of one rank (`mesh`), or of the only process;
    returns (last step, best validation accuracy) (rank 0's)."""
    dev = resolve_device(args.device if mesh is None else mesh.device)
    n_dev, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    exp_dir = os.path.join("checkpoints", args.exp_name)
    io = IOStream(os.path.join(exp_dir, "kpconv.log"), enabled=rank == 0)
    tb = ScalarWriter(os.path.join(exp_dir, "tb"), enabled=args.tensorboard and rank == 0)
    source = SceneSource(args)
    io.cprint(f"scenes: {len(source)}")
    rng = np.random.default_rng(args.seed)
    n_cap = args.point_cap
    caps = kpconv_level_caps(n_cap)

    # every scene held in memory (the reference's too, Scannet.py:304-423)
    scenes = []
    for si in range(len(source)):
        scene, extras = source.get(si)
        scenes.append(scene_to_training_tuple(scene, extras, args.pseudo_root, source.names[si],
                                              args.pseudo_root is not None))
    n_val = int(len(scenes) * args.val_frac)
    if args.val_frac > 0 and n_val == 0 and len(scenes) > 1:
        n_val = 1
    val_scenes = scenes[len(scenes) - n_val:]
    scenes = scenes[: len(scenes) - n_val] or val_scenes
    io.cprint(f"scenes: {len(scenes)} train / {len(val_scenes)} val")

    if args.auto_point_cap:
        sizes = sample_sphere_sizes([c for c, _, _ in scenes], args.in_radius,
                                    rng=np.random.default_rng(args.seed + 2))
        lim, n_cap = calibrate_batch_limit(sizes, args.batch_size,
                                           rng=np.random.default_rng(args.seed + 3))
        caps = kpconv_level_caps(n_cap)
        io.cprint(f"calibrated batch limit: {lim:.0f} points "
                  f"-> point_cap {n_cap} (sphere sizes "
                  f"p50={int(np.median(sizes))} max={int(sizes[-1])})")

    def new_sampler(seed):
        return PotentialSampler([c for c, _, _ in scenes], in_radius=args.in_radius, seed=seed)

    def draw(sampler):
        return sample_batch(scenes, sampler, rng, args.batch_size, args.in_radius, n_cap)

    model = KPFCNN(num_classes=args.num_classes, first_features_dim=args.first_features_dim,
                   dl0=args.dl0, seed=args.seed, device=dev)
    calib_sampler = new_sampler(args.seed + 1)
    calib = [draw(calib_sampler) for _ in range(args.calib_batches)]
    nbr_caps, over_rate = calibrate_neighbor_caps(
        [(b[0], b[3], b[4]) for b in calib], num_layers=KPCONV_LAYERS, dl0=args.dl0,
        keep_ratio=args.keep_ratio, level_caps=caps, device=dev)
    io.cprint(f"calibrated neighbor caps: {nbr_caps} "
              f"(probe overflow rate/level: " + " ".join(f"{r:.3f}" for r in over_rate) + ")")
    sampler = new_sampler(args.seed)
    draw(sampler)  # the batch the JAX driver initialises its model on
    io.cprint("Network parameters: %.2fM" % (sum(x.numel() for x in model.parameters()) / 1e6))

    optimizer, scheduler = make_sgd(model, args.lr)
    ckpt = CheckpointManager(os.path.join(exp_dir, "kpconv"), pow2_retention=True)
    best_ckpt = CheckpointManager(os.path.join(exp_dir, "kpconv_best"))
    if args.weights:
        state, n_loaded, n_tot = lenient_restore(args.weights, model.state_dict(), log=io.cprint)
        model.load_state_dict(state)
        io.cprint(f"lenient init: {n_loaded}/{n_tot} tensors from {args.weights}")
    start_it = 0
    if args.resume:
        restored = ckpt.restore(map_location=dev)
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            scheduler.load_state_dict(restored["scheduler"])
            sampler.set_state(restored["sampler"])
            rng.bit_generator.state = restored["batch_rng"]
            start_it = ckpt.latest_step()
            io.cprint(f"resumed from step {start_it} "
                      f"(lr continues at {scheduler.schedule(start_it):.4g})")

    def draw_step(_):
        # the step's batch (data-parallel: its n_dev batches, in rank order);
        # the prefetcher runs ahead, so the live states are a later step's:
        # each step carries the states its draws left
        batches = [draw(sampler) for _ in range(n_dev)]
        state = sampler.state()
        state["potentials"] = [torch.from_numpy(x) for x in state["potentials"]]
        return batches[0] if mesh is None else batches, state, rng.bit_generator.state

    def validate():
        """Vote-smoothed held-out accuracy (the JAX driver's `validate`): a
        fresh sampler and generator of seed 7 each call, EMA-accumulated
        softmax, point accuracy on the voted points; logs the pyramid's
        mean overflow rates."""
        if not val_scenes:
            return float("nan")
        vs = PotentialSampler([c for c, _, _ in val_scenes], in_radius=args.in_radius, seed=7)
        probs = [np.zeros((len(c), args.num_classes), np.float32) for c, _, _ in val_scenes]
        voted = [np.zeros(len(c), bool) for c, _, _ in val_scenes]
        vrng = np.random.default_rng(7)
        over_acc = np.zeros(KPCONV_LAYERS)
        n_over = 0
        for _ in range(args.val_spheres):
            si, center = vs.next_center()
            c, col, _ = val_scenes[si]
            sel = np.where(((c - center) ** 2).sum(1) < args.in_radius ** 2)[0]
            if len(sel) > n_cap:
                sel = sel[vrng.permutation(len(sel))[:n_cap]]
            if not len(sel):
                continue
            pts = np.zeros((n_cap, 3), np.float32)
            feats = np.ones((n_cap, 4), np.float32)
            pts[: len(sel)] = c[sel]
            feats[: len(sel), 1:] = col[sel] / 255.0
            vmask = np.zeros(n_cap, bool)
            vmask[: len(sel)] = True
            with torch.no_grad():
                pyr, over = to_device_pyramid(pts, np.zeros(n_cap, np.int32), vmask, dev,
                                              args.dl0, caps, nbr_caps, return_overflow=True)
                logits, _ = model(pyr, torch.from_numpy(feats).to(dev))
            logits = logits[: len(sel)].cpu().numpy()
            over_acc += torch.stack(over).cpu().numpy()
            n_over += 1
            sm = np.exp(logits - logits.max(1, keepdims=True))
            sm /= sm.sum(1, keepdims=True)
            probs[si][sel] = 0.95 * probs[si][sel] + 0.05 * sm
            voted[si][sel] = True
        if n_over:
            io.cprint("    ball-query overflow %/level: "
                      + " ".join(f"{100*r/n_over:.2f}" for r in over_acc))
        hits = tot = 0
        for (c, col, lab), pr, vt in zip(val_scenes, probs, voted):
            ok = vt & (lab != IGNORE_LABEL)
            hits += int((pr.argmax(1)[ok] == lab[ok]).sum())
            tot += int(ok.sum())
        return hits / max(tot, 1)

    if mesh is None:
        def step(pts, feats, labs, bids, valid):
            pyr = to_device_pyramid(pts, bids, valid, dev, args.dl0, caps, nbr_caps)
            return train_step(model, optimizer, scheduler, pyr,
                              torch.from_numpy(feats).to(dev), torch.from_numpy(labs).to(dev),
                              args.offset_loss_weight, args.grad_clip_norm,
                              args.offset_lr_scale)
    else:
        mesh.replicate(model, optimizer)
        io.cprint(f"data parallel over {n_dev} devices")
        step = build_kpconv_dp_step(model, optimizer, scheduler, mesh, args.dl0, caps, nbr_caps,
                                    args.offset_loss_weight, args.grad_clip_norm,
                                    args.offset_lr_scale)
    # rank 0 draws every rank's batches and hands them out
    prefetch = (HostPrefetcher(draw_step, depth=args.prefetch_depth, workers=1, start=start_it)
                if rank == 0 else None)

    def save_state(it, states):  # after step `it`, whose draws left `states`
        if rank == 0:
            ckpt.save(it, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                           "scheduler": scheduler.state_dict(), "sampler": states[0],
                           "batch_rng": states[1]})

    best_val = -1.0
    t0 = time.time()
    it = start_it
    try:
        for it in range(start_it + 1, args.steps + 1):
            batch, *states = next(prefetch) if rank == 0 else (None, None, None)
            loss, acc = step(*(batch if mesh is None else mesh.scatter(batch)))
            loss = loss / n_dev
            if it % 10 == 0 or it == args.steps:
                io.cprint("step %d/%d  loss %.4f  acc %.2f%%  (%.2fs/it)"
                          % (it, args.steps, float(loss), 100 * float(acc),
                             (time.time() - t0) / max(1, it - start_it)))
                tb.add_scalar("train/loss", float(loss), it)
                tb.add_scalar("train/acc", 100 * float(acc), it)
            stop = rank == 0 and should_stop(args.exp_name)
            if mesh is not None:
                stop = mesh.any(stop)
            if stop:
                io.cprint("STOP file found — saving and exiting")
                save_state(it, states)
                break
            if it % args.save_freq == 0 or it == args.steps:
                save_state(it, states)
                if rank == 0:
                    val_acc = validate()
                    marker = ""
                    if val_acc > best_val:
                        best_val = val_acc
                        best_ckpt.save(it, {"model": model.state_dict()})
                        marker = "  (new best)"
                    io.cprint(f"==> saved step {it}  val acc {100*val_acc:.2f}%{marker}")
                    tb.add_scalar("val/acc", 100 * val_acc, it)
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
