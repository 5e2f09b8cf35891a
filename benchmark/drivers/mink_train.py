"""Driver of Res16UNet34C training: the MinkUNet trainer's own step
(seggroup_tpu_torch.cli.stage2_train_minkunet.train_step) fed by its own
pipeline (make_batch on the HostPrefetcher's threads, batch_on_device with
the device plan), over a pool of seeded bench scenes turned into training
tuples by scene_to_training_tuple.

Set-up builds one model and optimizer from the seeded weights and drives
them through the first `warmup_steps` steps of the feed, which also warms
every kernel; it keeps each step's loss, the gradient the optimizer got at
step 1 (worked out from its momentum after one step) and the parameters'
change after the last. It then runs on, uncompared, until a step has to
wait for its batch: the prefetcher's queue, filled while the first steps
warmed up, is then empty, as it is all through a window on a host that
makes batches slower than the card trains on them. The window runs the
following steps in a closed loop. A traced window profiles its first `trace_units` steps and clocks the
trainer's phases over the rest. The check frees the program, works the
first steps' batches out again from the scenes (benchmark/reference/
voxel_batch.py) and runs the plain reference's steps on the card
(benchmark/reference/res16unet.py): the numbers compared are those of `gaps`."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import harness, scenes
from benchmark.reference import res16unet as ref
from benchmark.reference import voxel_batch as vb
from benchmark.roofline import counts

K2_KERNELS = ("subm_conv_weights_k_major", "subm_gather_gemm")
K3_KERNELS = ("subm_dw_compact", "subm_dw_gemm", "sum_slabs")


class State:
    pass


def _caps(capacity: int) -> list[int]:
    return [capacity, capacity // 2, capacity // 4, capacity // 8, capacity // 8]


def setup(spec: harness.RunSpec) -> State:
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_train_minkunet import (batch_on_device, make_batch,
                                                              train_step)
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule
    from seggroup_tpu_torch.types import Scene
    from seggroup_tpu_torch.utils.prefetch import HostPrefetcher

    st = State()
    st.spec = spec
    st.dev = dev = torch.device(spec.device)
    tr, m = spec.config["train"], spec.config["model"]
    st.scene_seed, st.weight_seed, st.data_seed = harness.sub_seeds(spec.seed, 3)
    st.pool = scenes.scene_pool(st.scene_seed, spec.traffic["scene_pool"], spec.config["scene"])
    tuples = [scene_to_training_tuple(Scene(*(sc[f] for f in scenes.FIELDS)), {}, None, "",
                                      False) for sc in st.pool]
    st.caps = caps = _caps(tr["capacity"])
    st.spec_params = harness.param_spec(ref.Res16UNet34C(m["in_channels"], m["num_classes"]))
    weights = harness.make_weights(st.spec_params, st.weight_seed, dev)
    harness.float32_products(m["float32_products"])
    model = make_minkunet(m["variant"], out_channels=m["num_classes"], level_caps=caps,
                          device=dev)
    _require_widths(m, model)
    harness.load_params(model, weights)
    optimizer, scheduler = make_optimizer(
        tr["optimizer"], model.parameters(),
        make_schedule(tr["scheduler"], tr["lr"], max_iter=tr["max_iter"]),
        momentum=tr["momentum"], weight_decay=tr["weight_decay"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pool = list(range(len(tuples)))

    def draw(step):
        return make_batch(tuples.__getitem__, pool, step, st.data_seed, tr["batch_size"],
                          tr["capacity"], tr["voxel_size"], tr["augment"], tr["plan_mode"],
                          caps)

    # step s (from 1) of the feed is the trainer's batch of step s
    st.prefetch = HostPrefetcher(lambda s: draw(s + 1), depth=tr["prefetch_depth"],
                                 workers=tr["prefetch_workers"])

    def step(batch, phases=None):
        s, labels, plan = batch_on_device(*batch, dev, caps)
        return train_step(model, optimizer, scheduler, s, labels, phase_seconds=phases,
                          plan=plan)

    st.model, st.optimizer, st.step = model, optimizer, step
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    wd = optimizer.param_groups[0]["weight_decay"]
    st.losses, st.grad_norms, st.hists = [], {}, []
    for s in range(spec.traffic["warmup_steps"]):
        loss, hist = step(next(st.prefetch))
        st.losses.append(float(loss))
        st.hists.append(hist.cpu())
        if s == 0:
            for n in names:
                # no momentum where the optimizer never stepped: no gradient
                buf = optimizer.state[params[n]].get("momentum_buffer")
                st.grad_norms[n] = (0.0 if buf is None else
                                    float(torch.linalg.vector_norm(buf - wd * weights[n])))
    st.change_norms = {n: float(torch.linalg.vector_norm(params[n].detach() - weights[n]))
                       for n in names}
    del weights
    for _ in range(2 * (tr["prefetch_depth"] + tr["prefetch_workers"])):
        t = time.perf_counter()
        batch = next(st.prefetch)
        waited = time.perf_counter() - t
        step(batch)
        if waited > 0.01:
            break
    _sync(dev)
    return st


def _require_widths(m: dict, model) -> None:
    """The built network has the configuration's widths and depths."""
    k0 = model.conv0.kernel.shape  # (K, in_channels, init_dim)
    harness.require(tuple(m["planes"]), tuple(model.planes), "planes")
    harness.require(tuple(m["layers"]), tuple(model.layers), "layers")
    harness.require((m["in_channels"], m["init_dim"]), (k0[1], k0[2]),
                    "(in_channels, init_dim)")
    harness.require(m["num_classes"], model.final.out_features, "num_classes")
    # the port's submanifold convs have no other operand type
    harness.require(m["subm_compute_dtype"], "bfloat16", "subm_compute_dtype")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(st: State, seconds: float, trace: bool) -> harness.Outcome:
    ctx: dict = {}
    voxels = steps = 0
    wait = 0.0
    coords = []

    def one(phases=None, keep=False):
        nonlocal voxels, steps, wait
        t = time.perf_counter()
        with torch.profiler.record_function("bench.batch_wait"):
            batch = next(st.prefetch)
        wait += time.perf_counter() - t
        with torch.profiler.record_function("bench.train_step"):
            st.step(batch, phases)
        wire = batch[0]
        voxels += int(wire[3])
        steps += 1
        if keep:
            coords.append(np.asarray(wire[0][:int(wire[3])], np.int32))

    start = time.perf_counter()
    deadline = start + seconds
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if st.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(st.spec.traffic["trace_units"]):
                one(keep=True)
            _sync(st.dev)
            prof_s = time.perf_counter() - t0
        ctx["trace"] = harness.summarize_trace(prof, prof_s)
        ctx["trace_units"] = steps
        ctx["trace_coords"] = coords
        phases: dict = {}
        n0, wait = steps, 0.0
        while time.perf_counter() < deadline or steps == n0:
            one(phases)
        _sync(st.dev)
        ctx["phases"] = phases
        ctx["phase_units"] = steps - n0
        ctx["batch_wait_s"] = wait
    else:
        while time.perf_counter() < deadline:
            one()
    _sync(st.dev)
    elapsed = time.perf_counter() - start
    out = harness.Outcome({"mink_train_voxels_per_s": voxels / elapsed}, ctx, steps)
    if trace:
        out.breakdown = harness.breakdown(ctx["trace"])
    return out


def memory_peak(st: State) -> int:
    return torch.cuda.max_memory_allocated(st.dev) if st.dev.type == "cuda" else 0


def release(st: State) -> None:
    st.prefetch.close()
    st.model = st.optimizer = st.step = st.prefetch = None
    gc.collect()
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(st: State, lower: bool = False):
    """The reference's first steps from the same weights and scenes."""
    tr = st.spec.config["train"]
    tuples = [vb.training_tuple(sc["points"], sc["real_sem"]) for sc in st.pool]
    batches = []
    for s in range(1, st.spec.traffic["warmup_steps"] + 1):
        c, f, lab, num = vb.wire_round(*vb.train_batch(
            tuples, (st.data_seed, s), tr["batch_size"], tr["capacity"], tr["voxel_size"]))
        batches.append(tuple(torch.from_numpy(x[:num]).to(st.dev) for x in (c, f, lab)))
    weights = harness.make_weights(st.spec_params, st.weight_seed, st.dev)
    losses, grads, after, hists = ref.train(weights, batches, st.caps[1:], lower=lower,
                                            momentum=tr["momentum"],
                                            weight_decay=tr["weight_decay"])
    grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    change = {n: float(torch.linalg.vector_norm(after[n] - weights[n])) for n in after}
    return losses, grad_norms, change, [h.cpu() for h in hists]


def gaps(losses, grad_norms, change, ref_losses, ref_grads, ref_change) -> dict:
    """The program's first steps against the reference's: `loss_gap`, the
    largest relative gap of a step's loss; `grad_gap` and `change_gap`, the
    median over the leaves of the relative gap between the two norms of a
    leaf's first gradient and of its change, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's; and
    beside them, under `_worst`, the worst leaf's gaps (over the larger of
    its and the median leaf's norm), which a fault in one layer moves."""
    med_g = float(np.median(list(ref_grads.values())))
    med_c = float(np.median(list(ref_change.values())))
    moved = [n for n, g in ref_grads.items() if g >= 1e-3 * med_g]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": float(np.median([abs(grad_norms[n] - ref_grads[n]) / ref_grads[n]
                                     for n in moved])),
        "change_gap": float(np.median([abs(change[n] - ref_change[n]) / ref_change[n]
                                       for n in moved])),
        "grad_gap_worst": max(abs(grad_norms[n] - g) / max(g, med_g)
                              for n, g in ref_grads.items()),
        "change_gap_worst": max(abs(change[n] - ref_change[n]) / max(ref_change[n], med_c)
                                for n in moved),
    }


def readings(st: State, lower: bool = False) -> dict[str, float]:
    """The gaps of the program's first steps to the reference's or, with
    `lower`, of the reference at the control's precision in its place."""
    want = reference_steps(st)
    got = reference_steps(st, lower=True) if lower else (st.losses, st.grad_norms,
                                                          st.change_norms, st.hists)
    out = gaps(*got[:3], *want[:3])
    # the share of labelled voxels whose argmax class differs, at least (a
    # bound from the steps' confusion matrices)
    out["argmax_gap"] = max(float((a - b).abs().sum()) / (2.0 * float(b.sum()))
                            for a, b in zip(got[3], want[3]))
    return out


def check(st: State, outcome: harness.Outcome) -> dict:
    release(st)
    values = readings(st)
    if outcome.context.get("trace") is not None:
        _trace_counts(st, outcome.context)
    limits = st.spec.config["limits"]["mink_train"]
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}


def _trace_counts(st: State, ctx: dict) -> None:
    """Operations and K2's and K3's least seconds of the profiled steps,
    counted from their batches' voxel coordinates."""
    total = {"flops": 0.0, "k2_bound_s": 0.0, "k3_bound_s": 0.0}
    for c in ctx.pop("trace_coords"):
        rows, pairs = counts.level_sizes(torch.from_numpy(c).to(st.dev), st.caps[1:])
        for k, v in counts.res16unet34c_step(rows, pairs).items():
            total[k] += v
    ctx.update(total)
    tr = ctx["trace"]
    ctx["k2_s"] = harness.kernel_seconds(tr, K2_KERNELS)
    ctx["k3_s"] = harness.kernel_seconds(tr, K3_KERNELS)
