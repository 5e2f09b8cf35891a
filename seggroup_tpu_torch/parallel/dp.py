"""Data parallelism over torch.distributed (seggroup_tpu/parallel/dp.py).

The JAX package runs one controller over a device mesh and a `shard_map`
per step. The port runs one process a rank: `launch` starts them (one a
card, NCCL between cards; gloo on the CPU), each holds its own shard of the
batch and the whole model, and after the backward the ranks take the mean
of their gradients and of their BatchNorm running statistics, which is
what the `pmean`s of the JAX steps do:

| JAX (parallel/dp.py)                | here                                  |
| ----------------------------------- | ------------------------------------- |
| `initialize_multihost`              | `initialize_multihost` (tcp rendezvous) |
| `make_mesh`                         | `make_mesh`: this rank's `Mesh`       |
| `replicate`                         | `Mesh.replicate`: rank 0's state broadcast once |
| `shard_batch`                       | nothing: each rank holds its own shard |
| `make_optimizer`                    | `solvers.make_optimizer`              |
| `build_*_step`                      | `build_*_step` below                  |

A step is the single-device trainer's `train_step` with a `sync` between
the backward and the optimizer (`Mesh.sync`): one coalesced all-reduce of
every gradient, a parameter the backward did not reach joining it as
zeros, as jax.grad gives them; their mean; then the mean of the floating
buffers (the running statistics, the port's only buffers). The running
statistics are each rank's own batch statistics moved locally first, as
the JAX steps take the `pmean` of `batch_stats` after the local update.
NCCL's and gloo's all-reduce hand every rank the same bits, so every rank
steps its optimizer on the same gradients and the parameters stay equal
bit for bit. The metrics are summed (`psum`) or averaged as the JAX steps
combine them. Not `DistributedDataParallel`: it broadcasts rank 0's
running statistics instead of averaging them, and it needs
`find_unused_parameters` for the ScoreNet that PointGroup's prepare phase
leaves without gradients."""

from __future__ import annotations

import os
import shutil
import tempfile
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from seggroup_tpu_torch.utils import profiling

# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=1800)


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """One process group over several hosts (the JAX package's
    jax.distributed.initialize): every process calls it with the same
    `coordinator` ("host:port") and `num_processes` and its own
    `process_id`. A no-op without a coordinator."""
    if coordinator is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=timeout)


def resolve_num_devices(num_devices: int | None, device: str | torch.device) -> int:
    """The number of ranks a driver starts: `num_devices`, or with None
    every visible card (1 on the CPU). More ranks than visible cards raise
    (the JAX package's make_mesh takes the first `num_devices` devices it
    has without a word)."""
    on_cards = torch.device(device).type == "cuda"
    if num_devices is None:
        return max(1, torch.cuda.device_count()) if on_cards else 1
    if num_devices < 1:
        raise ValueError(f"--num_devices {num_devices}: at least one rank")
    if on_cards and num_devices > torch.cuda.device_count():
        raise ValueError(f"--num_devices {num_devices} but {torch.cuda.device_count()} "
                         f"cards are visible")
    return num_devices


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed of its own for each rank, from (seed, rank): the
    port's counterpart of `jax.random.fold_in(key, axis_index)`."""
    return int(np.random.SeedSequence((seed, rank)).generate_state(1)[0])


@dataclass
class Mesh:
    """One rank's view of the data-parallel group: its rank, the world
    size, its device, the group its tensors travel in, and a gloo group
    for host objects (the batches rank 0 hands out, flags)."""

    rank: int
    size: int
    device: torch.device
    group: dist.ProcessGroup | None = None
    host_group: dist.ProcessGroup | None = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # --- collectives -------------------------------------------------------

    def _all_reduce_flat(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The element-wise sums over ranks of `tensors` (one dtype and
        device), in one all-reduce of their concatenation."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out

    def all_reduce(self, tensors: Sequence[torch.Tensor], mean: bool = False
                   ) -> list[torch.Tensor]:
        """The sums (or means) over the ranks of `tensors`, in the order
        given, one all-reduce for each dtype."""
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        out: list[torch.Tensor | None] = [None] * len(tensors)
        for idx in by_dtype.values():
            for i, r in zip(idx, self._all_reduce_flat([tensors[i] for i in idx])):
                out[i] = r / self.size if mean else r
        return out

    def psum(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """`jax.lax.psum` of a dict of tensors."""
        keys = list(tree)
        return dict(zip(keys, self.all_reduce([tree[k] for k in keys], mean=False)))

    def pmean(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """`jax.lax.pmean` of a dict of tensors."""
        keys = list(tree)
        return dict(zip(keys, self.all_reduce([tree[k] for k in keys], mean=True)))

    def sync(self, model: nn.Module) -> None:
        """After the backward: every parameter's gradient (zeros where
        there is none) and every floating buffer replaced by its mean over
        the ranks, in one all-reduce (float32 throughout).

        While the recorder is bound (utils/profiling.py; the trainers bind
        it to their `phase_seconds`), the ranks first meet at a barrier of
        the host group, timed as "all-reduce.wait": after the trainer's
        fence of its "all-reduce" phase, the wait for the slowest rank's
        backward. The all-reduce is then timed as "all-reduce.transfer",
        fenced. Every rank of the mesh has to be bound alike, or the
        barrier waits for a rank that never comes."""
        params = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        bufs = [b for b in model.buffers() if b.is_floating_point()]
        if profiling.bound():
            with profiling.span("all-reduce.wait"):
                self.barrier()
        with profiling.span("all-reduce.transfer", fence=self.device):
            means = self.all_reduce(grads + bufs, mean=True)
        for p, g in zip(params, means):
            p.grad = g
        with torch.no_grad():
            for b, m in zip(bufs, means[len(params):]):
                b.copy_(m)

    def any(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank (over the host group, so the
        device is not synchronised)."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, group=self.host_group)
        return bool(t.item())

    def scatter(self, objs: Sequence | None):
        """Rank 0's `objs[d]` on rank d (picklable host objects, e.g. the
        numpy batch rank 0 drew for rank d); the other ranks pass None."""
        out = [None]
        dist.scatter_object_list(out, list(objs) if self.is_main else None, src=0,
                                 group=self.host_group)
        return out[0]

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def replicate(self, model: nn.Module, optimizer: torch.optim.Optimizer | None = None
                  ) -> None:
        """Rank 0's parameters, buffers and optimizer state on every rank
        (the JAX package's `replicate`), once, at the start."""
        tensors = list(model.parameters()) + list(model.buffers())
        if optimizer is not None:
            for state in optimizer.state.values():
                tensors += [v for v in state.values() if torch.is_tensor(v)]
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0,
                               group=self.group if t.device == self.device else self.host_group)


def make_mesh(device: str | torch.device = "cuda") -> Mesh:
    """This rank's Mesh in the initialised default process group: with
    "cuda" rank r uses cuda:(r mod the cards visible), with "cuda:i" every
    rank uses card i (gloo ranks may share a card; NCCL refuses that); on
    the CPU the CPU."""
    rank, size = dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    if device.type == "cuda":
        dev = (device if device.index is not None
               else torch.device("cuda", rank % torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return Mesh(rank, size, dev, None, host)


def _rank_main(rank: int, fn: Callable, size: int, device: str, backend: str,
               timeout: timedelta, threads: int | None, args: tuple, out_dir: str) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(out_dir, 'store')}",
                            world_size=size, rank=rank, timeout=timeout)
    try:
        out = fn(make_mesh(device), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, num_devices: int, device: str | torch.device, *args,
           backend: str | None = None, timeout: timedelta = DEFAULT_TIMEOUT,
           threads: int | None = None, all_ranks: bool = False):
    """Run fn(mesh, *args) in `num_devices` new processes, one a rank, on
    `device` as make_mesh takes it, and return rank 0's result (every
    rank's, in rank order, with `all_ranks`). The ranks meet at a file in a
    fresh temporary directory; `backend` defaults to NCCL on the card and
    gloo on the CPU; `threads` sets each rank's torch.set_num_threads
    (default on the CPU: its threads shared out). A rank that raises stops
    the others and the error is raised here. `fn`, `args` and the results
    must pickle."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if threads is None and dev.type == "cpu":
        threads = max(1, torch.get_num_threads() // num_devices)
    work = tempfile.mkdtemp(prefix="seggroup_dist_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, num_devices, str(dev), backend, timeout, threads, args, work),
            nprocs=num_devices, join=True, start_method="spawn")
        outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(num_devices if all_ranks else 1)]
        return outs if all_ranks else outs[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# the steps, one for each builder of the JAX package's parallel/dp.py
# ---------------------------------------------------------------------------


def build_stage1_train_step(model, optimizer: torch.optim.Optimizer, mesh: Mesh) -> Callable:
    """dp.py:77-125: step(scene, generator=None, dropout_keep=None) on this
    rank's scene (its dropout from its own generator, as JAX folds the
    rank into the key) -> (loss, metrics), the loss and metrics `iou_sem`,
    `iou_ins`, `acc` summed over the ranks (the drivers divide the loss
    and the accuracies by the world size)."""
    from seggroup_tpu_torch.cli.stage1_train import train_step

    def step(scene, generator=None, dropout_keep=None, phase_seconds=None):
        loss, metrics = train_step(model, optimizer, scene, generator=generator,
                                   dropout_keep=dropout_keep, phase_seconds=phase_seconds,
                                   sync=mesh.sync)
        summed = mesh.psum({"loss": loss, "iou_sem": metrics["iou_sem"],
                            "iou_ins": metrics["iou_ins"], "acc": metrics["acc"]})
        return summed.pop("loss"), {**metrics, **summed}

    return step


def build_minkunet_dp_step(model, optimizer, scheduler, mesh: Mesh) -> Callable:
    """dp.py:128-187: step(st, labels, plan) on this rank's voxel batch and
    its host plan (on the device; None builds the rulebooks in the
    forward): the local step with the gradients' and statistics' mean ->
    (loss, confusion matrix), both summed over the ranks."""
    from seggroup_tpu_torch.cli.stage2_train_minkunet import train_step

    def step(st, labels, plan, phase_seconds=None):
        loss, hist = train_step(model, optimizer, scheduler, st, labels,
                                phase_seconds=phase_seconds, plan=plan, sync=mesh.sync)
        out = mesh.psum({"loss": loss, "hist": hist})
        return out["loss"], out["hist"]

    return step


def build_minkunet_dp_step_packed(model, optimizer, scheduler, mesh: Mesh,
                                  level_caps: Sequence[int]) -> Callable:
    """dp.py:335-369: step(wire) on this rank's compact wire (coords int16,
    feats float16, labels uint8, num: sparse/device_plan.pack_voxel_batch),
    unpacked on the rank's device, which builds its own pyramid plan (no
    collective) -> (summed loss, summed confusion)."""
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_on_device

    update = build_minkunet_dp_step(model, optimizer, scheduler, mesh)

    def step(wire, phase_seconds=None):
        st, labels, plan = batch_on_device(wire, None, mesh.device, level_caps)
        return update(st, labels, plan, phase_seconds)

    return step


def build_pointgroup_dp_step(model, optimizer, scheduler, mesh: Mesh,
                             do_clustering: bool = False) -> Callable:
    """dp.py:275-332: step(batch, plan, jitter) on this rank's
    unpack_pg_batch tuple, its plan (None builds the rulebooks in the
    forward) and its own jitter -> the loss summed over the ranks. The
    instance cap is the length of the batch's per-instance point counts."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import train_step

    def step(batch, plan, jitter, phase_seconds=None):
        loss, _aux, _ = train_step(model, optimizer, scheduler, batch, do_clustering, jitter,
                                   phase_seconds=phase_seconds, plan=plan, sync=mesh.sync)
        return mesh.psum({"loss": loss})["loss"]

    return step


def build_pointgroup_dp_step_packed(model, optimizer, scheduler, mesh: Mesh, voxel_cap: int,
                                    do_clustering: bool = False) -> Callable:
    """dp.py:372-429: step(raw, jitter) on what the trainer's
    make_train_batch drew for this rank (the compact wire dict, or the
    host batch with its host plan), unpacked on the rank's device, which
    builds the U-Net's 7-level plan itself -> the summed loss."""
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import batch_on_device

    inner = build_pointgroup_dp_step(model, optimizer, scheduler, mesh, do_clustering)

    def step(raw, jitter, phase_seconds=None):
        batch, plan = batch_on_device(raw, voxel_cap, mesh.device)
        return inner(batch, plan, jitter, phase_seconds)

    return step


def build_kpconv_dp_step(model, optimizer, scheduler, mesh: Mesh, dl0: float,
                         level_caps: Sequence[int], neighbor_caps: int | Sequence[int] = 32,
                         offset_loss_weight: float = 0.1, grad_clip_norm: float | None = None,
                         offset_lr_scale: float = 0.1) -> Callable:
    """dp.py:213-272: step(pts, feats, labels, bids, valid) on this rank's
    sphere batch (numpy), whose pyramid the rank builds on its device
    (`neighbor_caps` one cap for every level or one a level) -> (summed
    loss, mean accuracy). With `grad_clip_norm`, the trainer's
    per-variable gradient transform (the offset-LR scale, then the clip)
    acts on the LOCAL gradients before their mean, as the JAX step's
    `grad_transform`; without, as by default in JAX, there is no
    transform at all (no offset scale either)."""
    from seggroup_tpu_torch.cli.stage2_train_kpconv import to_device_pyramid, train_step

    def step(pts, feats, labels, bids, valid, phase_seconds=None):
        pyr = to_device_pyramid(pts, bids, valid, mesh.device, dl0, level_caps, neighbor_caps)
        loss, acc = train_step(model, optimizer, scheduler, pyr,
                               torch.from_numpy(feats).to(mesh.device),
                               torch.from_numpy(labels).to(mesh.device),
                               offset_loss_weight, grad_clip_norm, offset_lr_scale,
                               phase_seconds=phase_seconds, sync=mesh.sync)
        return mesh.psum({"loss": loss})["loss"], mesh.pmean({"acc": acc})["acc"]

    return step


def build_stage1_infer_step(model, mesh: Mesh, mode: str) -> Callable:
    """dp.py:190-210: step(scene) -> this rank's Stage1Output of its own
    scene, with no gradient (the JAX step stacks the ranks' outputs; each
    rank here exports its own)."""

    def step(scene):
        if scene.points.device != mesh.device:
            scene = scene.to(mesh.device)
        return model(scene, mode=mode)

    return step
