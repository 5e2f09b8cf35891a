"""Driver of PointGroup training at the published batch: the PointGroup
trainer's own step (seggroup_tpu_torch.cli.stage2_train_pointgroup.
train_step) fed by its own pipeline (make_train_batch on a HostPrefetcher of
one thread, batch_on_device with the device plan), four whole bench scenes a
step, the dual clustering and the ScoreNet on every timed step.

Set-up builds the model and Adam from the seeded weights and brings them to
the clustering phase with `prepare_steps_setup` of the trainer's
prepare-phase steps (no clustering) over the feed's first `prepare_batches`
batches, cycled. It then runs `warmup_steps` steps with the clustering, the
compared steps: it keeps the program's state before them (parameters,
BatchNorm statistics, Adam's moments), each step's batch, jitter, loss,
loss parts and heads (a forward hook), the first step's gradients (a hook
before Adam's step) and the parameters after the last; the recorder is
bound over these steps alone, for the clustering's counters. It then runs on, uncompared,
until a step has to wait for its batch. The window runs the following
steps in a closed loop. A traced window profiles its first `trace_units`
steps and clocks the trainer's phases over the rest, two steps at least.

The check frees the program and holds the compared steps to the plain
reference (benchmark/reference/pointgroup.py) on the card: its own
clustering of the program's heads against the program's proposals
(`proposal_mismatch`), then its train steps from the program's state at
the program's proposals and jitter (`point_loss_gap_first`, the first
step's point losses; `change_gap`, of mink_train.gaps; the other gaps for
the record), the points and voxels the batches left out (`points_dropped`, counted against
the scenes' sizes for every batch the run stepped; `voxels_dropped`,
against the reference's voxelisation for the compared steps and, for the
window's, any batch that filled the cap), the proposals' voxels past the
ScoreNet's cap (`score_voxels_dropped`) and the clustering loops that ran
out of sweeps (`cc_unconverged`, the program's counter)."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark import harness, scenes
from benchmark.drivers.mink_train import gaps
from benchmark.reference import pointgroup as ref
from benchmark.roofline import pointgroup as rl

K4_KERNELS = ("cc_sweep_kernel",)


class State:
    pass


def ref_config(cfg: dict) -> dict:
    """The reference's sizes from the configuration."""
    m, tr = cfg["model"], cfg["train"]
    return {"m": m["m"], "classes": m["classes"], "in_channels": m["in_channels"],
            "block_reps": m["block_reps"], "levels": m["levels"],
            "voxel_size": tr["voxel_size"],
            "caps": tuple(tr["voxel_cap"] >> i for i in range(m["levels"])),
            "score_cap": tr["score_cap"], "score_fullscale": float(m["score_fullscale"]),
            "score_scale": float(m["score_scale"])}


def plant(fault: str | None, set_attr=setattr, keep: int = 2) -> None:
    """A fault in the program's step, for the control script's readings
    (benchmark/control.py --fault, through the traffic's "fault"):
    `half_batch`, the loss over the batch's first `keep` scenes alone."""
    if fault is None:
        return
    if fault != "half_batch":
        raise SystemExit(f"unknown fault {fault!r}")
    from seggroup_tpu_torch.cli import stage2_train_pointgroup as trainer

    if getattr(trainer.train_step, "planted", False):
        return  # planted by an earlier seed's set-up
    step, loss = trainer.train_step, trainer.pointgroup_loss
    batch_ids = []

    def half_step(model, optimizer, scheduler, batch, *a, **k):
        batch_ids[:] = [batch[3]]
        return step(model, optimizer, scheduler, batch, *a, **k)

    def half_loss(out, labels, inst, centroid, pointnum, coords, valid, *a, **k):
        return loss(out, labels, inst, centroid, pointnum, coords,
                    valid & (batch_ids[0] < keep), *a, **k)

    half_step.planted = True
    set_attr(trainer, "train_step", half_step)
    set_attr(trainer, "pointgroup_loss", half_loss)


def setup(spec: harness.RunSpec) -> State:
    plant(spec.traffic.get("fault"))
    from seggroup_tpu_torch.cli.stage2_pointgroup_common import scene_instance_tuple
    from seggroup_tpu_torch.cli.stage2_test_pointgroup import make_eval_model
    from seggroup_tpu_torch.cli.stage2_train_pointgroup import (batch_on_device, make_adam,
                                                                make_train_batch, step_schedule,
                                                                train_step)
    from seggroup_tpu_torch.types import Scene
    from seggroup_tpu_torch.utils import profiling
    from seggroup_tpu_torch.utils.prefetch import HostPrefetcher

    st = State()
    st.spec = spec
    st.dev = dev = torch.device(spec.device)
    cfg, traffic = spec.config, spec.traffic
    m, tr = cfg["model"], cfg["train"]
    st.cfg = ref_config(cfg)
    scene_seed, weight_seed, data_seed = harness.sub_seeds(spec.seed, 3)
    pool = scenes.scene_pool(scene_seed, traffic["scene_pool"], cfg["scene"])
    st.scene_points = {len(sc["points"]) for sc in pool}
    tuples = [scene_instance_tuple(Scene(*(sc[f] for f in scenes.FIELDS)), {}, None, "")
              for sc in pool]
    del pool
    harness.float32_products(m["float32_products"])
    model = make_eval_model(m["m"], tr["voxel_cap"], dev, score_cap=tr["score_cap"])
    _require(m, tr, model)
    harness.load_params(model, harness.make_weights(
        harness.param_spec(ref.PointGroup(m["m"], m["classes"], m["in_channels"],
                                          m["block_reps"], m["levels"])), weight_seed, dev))
    optimizer, scheduler = make_adam(model, step_schedule(tr["lr"], tr["lr_multiplier"],
                                                          tr["lr_step_size"]))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # one generator draws every batch in step order on the prefetcher's one
    # thread, as the trainer's does; the jitter, three uniforms a step
    rng = np.random.default_rng(data_seed)
    st.prefetch = HostPrefetcher(
        lambda _: make_train_batch(tuples.__getitem__, range(len(tuples)), rng,
                                   tr["batch_size"], tr["point_cap"], tr["voxel_cap"],
                                   tr["instance_cap"], tr["voxel_size"], tr["augment"],
                                   plan_mode=tr["plan_mode"],
                                   max_points_per_scene=tr["max_npoint"]),
        depth=tr["prefetch_depth"], workers=tr["prefetch_workers"])
    jitter_gen = torch.Generator().manual_seed(data_seed + 1)
    st.batches = []  # (points, voxels) of every batch a step took

    def step(raw, clustering, phases=None):
        jitter = torch.rand(3, generator=jitter_gen).to(dev)
        st.batches.append((int(raw["nvalid"]), int(raw["num"])))
        batch, plan = batch_on_device(raw, tr["voxel_cap"], dev)
        out = train_step(model, optimizer, scheduler, batch, clustering, jitter,
                         phase_seconds=phases, plan=plan)
        return out, jitter

    st.model, st.optimizer, st.step = model, optimizer, step
    built = time.time() - spec.t0_wall if spec.t0_wall else float("nan")
    marks = [("built", time.perf_counter())]
    prepare: list = []
    k = traffic["prepare_batches"]
    for s in range(traffic["prepare_steps_setup"]):
        while len(prepare) <= s % k:
            prepare.append(next(st.prefetch))
        step(prepare[s % k], False)
    del prepare
    _sync(dev)
    marks.append(("prepared", time.perf_counter()))
    _compared_steps(st, traffic["warmup_steps"], profiling)
    marks.append(("compared", time.perf_counter()))
    for _ in range(2 * (tr["prefetch_depth"] + tr["prefetch_workers"])):
        t = time.perf_counter()
        raw = next(st.prefetch)
        waited = time.perf_counter() - t
        step(raw, True)
        if waited > 0.01:
            break
    _sync(dev)
    marks.append(("ran on", time.perf_counter()))
    print(f"set-up: built {built:.1f} s from the start, then "
          + ", ".join(f"{a} {t - marks[0][1]:.1f} s" for a, t in marks[1:]), file=sys.stderr)
    return st


def _compared_steps(st: State, n: int, profiling) -> None:
    """The first `n` steps with the clustering, kept for the check."""
    model, optimizer = st.model, st.optimizer
    params = dict(model.named_parameters())
    st.start = {"params": {k: p.detach().clone() for k, p in params.items()},
                "buffers": {k: b.clone() for k, b in model.named_buffers()},
                "adam": adam_state(model, optimizer)}
    outs, grads, lrs = [], {}, []

    def keep_out(mod, args, out):
        outs.append({"sem": out.semantic_scores.detach(), "off": out.pt_offsets.detach(),
                     "prop": out.proposal_of_point.clone(),
                     "pvalid": out.proposal_valid.clone()})

    def keep_grads(opt, args, kwargs):
        lrs.append(opt.param_groups[0]["lr"])
        if not grads:
            grads.update({k: float(torch.linalg.vector_norm(p.grad)) for k, p in params.items()})

    hooks = [model.register_forward_hook(keep_out), optimizer.register_step_pre_hook(keep_grads)]
    st.compared, st.losses, st.parts = [], [], []
    sink: dict = {}
    profiling.bind(sink)
    try:
        for _ in range(n):
            raw = next(st.prefetch)
            (loss, parts, _), jitter = st.step(raw, True)
            st.losses.append(float(loss))
            st.parts.append({k: float(v) for k, v in parts.items()})
            st.compared.append({"wire": raw, "jitter": jitter.cpu()})
    finally:
        profiling.stop()
        for h in hooks:
            h.remove()
    for c, o, lr in zip(st.compared, outs, lrs):
        c.update(o)
        c["lr"] = lr
    st.grad_norms = grads
    st.change_norms = {k: float(torch.linalg.vector_norm(p.detach() - st.start["params"][k]))
                       for k, p in params.items()}
    st.counters = {k: v for k, v in sink.items() if k.startswith("count.")}


def adam_state(model, optimizer) -> dict:
    """Each parameter's Adam state by name: step, moments (zero before the
    first step)."""
    out = {}
    for k, p in model.named_parameters():
        s = optimizer.state.get(p, {})
        out[k] = {"step": int(s.get("step", 0)),
                  "exp_avg": s.get("exp_avg", torch.zeros_like(p)).detach().clone(),
                  "exp_avg_sq": s.get("exp_avg_sq", torch.zeros_like(p)).detach().clone()}
    return out


def _require(m: dict, tr: dict, model) -> None:
    """The built network has the configuration's widths, depths and
    clustering."""
    planes, u = [], model.unet
    while u is not None:
        planes.append(u.block0.conv1.kernel.shape[1])
        u = getattr(u, "u", None)
    harness.require([m["m"] * (i + 1) for i in range(m["levels"])], planes, "planes")
    harness.require(m["block_reps"], model.unet.block_reps, "block_reps")
    harness.require((m["in_channels"], m["m"]), tuple(model.input_conv.kernel.shape[1:]),
                    "(in_channels, m)")
    harness.require(m["classes"], model.linear.out_features, "classes")
    for key, attr in (("cluster_radius", "cluster_radius"),
                      ("cluster_npoint_thre", "cluster_npoint_thre"),
                      ("score_scale", "score_scale"), ("score_fullscale", "score_fullscale"),
                      ("max_proposals_per_source", "max_proposals_per_source")):
        harness.require(m[key], getattr(model, attr), key)
    harness.require(tr["score_cap"], model.score_cap, "score_cap")
    harness.require(list(m["loss_weight"]), [1.0, 1.0, 1.0, 1.0], "loss_weight")
    harness.require((m["fg_thresh"], m["bg_thresh"]), (0.75, 0.25), "(fg_thresh, bg_thresh)")
    # the port's submanifold convs have no other operand type
    harness.require(m["subm_compute_dtype"], "bfloat16", "subm_compute_dtype")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_launches(prof, fragments) -> int:
    """Launches on the device, in a torch.profiler run, of the kernels whose
    names hold a fragment."""
    low = [f.lower() for f in fragments]
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and any(f in e.name.lower() for f in low))


def window(st: State, seconds: float, trace: bool) -> harness.Outcome:
    ctx: dict = {}
    voxels = steps = 0
    wait = 0.0
    coords = []

    def one(phases=None, keep=False):
        nonlocal voxels, steps, wait
        t = time.perf_counter()
        with torch.profiler.record_function("bench.batch_wait"):
            raw = next(st.prefetch)
        wait += time.perf_counter() - t
        with torch.profiler.record_function("bench.train_step"):
            st.step(raw, True, phases)
        voxels += int(raw["num"])
        steps += 1
        if keep:
            n = int(raw["nvalid"])
            coords.append((np.asarray(raw["vcoords"][:int(raw["num"])], np.int32), n))

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
        ctx["trace_sweeps"] = kernel_launches(prof, K4_KERNELS)
        ctx["trace_units"] = steps
        ctx["trace_batches"] = coords
        phases: dict = {}
        n0, wait = steps, 0.0
        # two clocked steps at least: a batch the prefetch thread began before
        # the recorder was bound is not timed, and one step may wait on such a
        # batch alone
        while time.perf_counter() < deadline or steps < n0 + 2:
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


def _steps(st: State) -> list[dict]:
    """The compared steps as the reference takes them, on the card."""
    out = []
    for c in st.compared:
        n = int(c["wire"]["nvalid"])
        out.append({"wire": c["wire"], "proposal_of_point": c["prop"][:, :n].long(),
                    "proposal_valid": c["pvalid"], "jitter": c["jitter"].to(st.dev),
                    "lr": c["lr"]})
    return out


def proposal_mismatch(c: dict) -> float:
    """The share of the step's (source, point) entries whose proposal the
    reference's clustering of the program's heads puts elsewhere (1 where
    the proposals' validity differs or a point past the batch has one)."""
    n = int(c["wire"]["nvalid"])
    w = c["wire"]
    coords = torch.as_tensor(w["coords"][:n]).to(c["sem"].device)
    bids = torch.as_tensor(w["batch_ids"][:n]).to(coords.device).long()
    valid = torch.ones(n, dtype=torch.bool, device=coords.device)
    want, want_valid = ref.cluster(c["sem"][:n], c["off"][:n], coords, bids, valid)
    got = c["prop"]
    p_total = want_valid.shape[0]
    if not torch.equal(want_valid, c["pvalid"]) or bool((got[:, n:] != p_total).any()):
        return 1.0
    return float((got[:, :n].long() != want).float().mean())


def _gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def worst_leaves(grads, change, want_grads, want_change) -> list[str]:
    """The leaves of the worst gradient and change gaps (for the record)."""
    med_g = float(np.median(list(want_grads.values())))
    med_c = float(np.median(list(want_change.values())))
    return [max(want_grads, key=lambda n: abs(grads[n] - want_grads[n])
                / max(want_grads[n], med_g)),
            max(want_change, key=lambda n: abs(change[n] - want_change[n])
                / max(want_change[n], med_c))]


def readings(st: State, lower: bool = False) -> dict[str, float]:
    """The compared steps' readings against the reference or, with `lower`,
    the reference at the control's precision in the program's place."""
    steps = _steps(st)
    if getattr(st, "want", None) is None:
        st.want = ref.train(st.start, steps, st.cfg)
    want = st.want
    want_grads = {k: float(torch.linalg.vector_norm(g)) for k, g in want["grads"].items()}
    want_change = {k: float(torch.linalg.vector_norm(p - st.start["params"][k]))
                   for k, p in want["params"].items()}
    if lower:
        got = ref.train(st.start, steps, st.cfg, lower=True)
        grads = {k: float(torch.linalg.vector_norm(g)) for k, g in got["grads"].items()}
        change = {k: float(torch.linalg.vector_norm(p - st.start["params"][k]))
                  for k, p in got["params"].items()}
        losses, parts = got["losses"], got["parts"]
    else:
        grads, change, losses, parts = st.grad_norms, st.change_norms, st.losses, st.parts
    out = gaps(losses, grads, change, want["losses"], want_grads, want_change)
    # the first step's point losses (semantic, offset distance, offset
    # direction), a forward from the same state: the largest relative gap.
    # The score loss is left out: a BCE over 0-7 proposals, which bfloat16
    # moves as much as the control does; the total therefore too
    point = ("semantic_loss", "offset_norm_loss", "offset_dir_loss")
    out["point_loss_gap_first"] = max(_gap(parts[0][k], want["parts"][0][k]) for k in point)
    # for the record
    out["loss_gaps"] = [_gap(a, b) for a, b in zip(losses, want["losses"])]
    out["part_gaps_first"] = {k: _gap(v, want["parts"][0][k]) for k, v in parts[0].items()}
    out["worst_leaves"] = worst_leaves(grads, change, want_grads, want_change)
    out["proposal_mismatch"] = max(proposal_mismatch(c) for c in st.compared)
    per_scene = st.spec.config["train"]["batch_size"] * max(st.scene_points)
    out["points_dropped"] = float(max(per_scene - p for p, _ in st.batches))
    cap = st.spec.config["train"]["voxel_cap"]
    full = sum(1 for _, v in st.batches if v >= cap)  # a full batch cannot be told whole
    out["voxels_dropped"] = float(max(
        max(t - int(c["wire"]["num"]) for t, c in zip(want["voxels"], st.compared)), full))
    out["score_voxels_dropped"] = float(max(max(t - st.cfg["score_cap"], 0)
                                            for t in want["score_voxels"]))
    out["cc_unconverged"] = float(st.counters.get("count.cc.unconverged", 0))
    # for the record
    out["proposals"] = [int(c["pvalid"].sum()) for c in st.compared]
    out["cc_fallback"] = st.counters.get("count.cc.fallback", 0)
    out["cc_sweeps"] = st.counters.get("count.cc.sweeps", 0)
    return out


def check(st: State, outcome: harness.Outcome) -> dict:
    release(st)
    values = readings(st)
    if outcome.context.get("trace") is not None:
        _trace_counts(st, outcome.context)
    limits = st.spec.config["limits"]["pg_train"]
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}


def _trace_counts(st: State, ctx: dict) -> None:
    """Operations of the profiled steps, counted from their batches' voxel
    coordinates, and K4's least seconds over its sweeps in them: the
    launches of its kernel in the trace, each over the doubled valid points
    (every profiled step holds the same 4 whole scenes; a drop fails the
    check)."""
    m = st.spec.config["model"]
    flops, points = 0.0, []
    for c, n in ctx.pop("trace_batches"):
        rows, pairs = rl.level_sizes(torch.from_numpy(c).to(st.dev), st.cfg["caps"])
        flops += rl.pointgroup_step_flops(rows, pairs, n, m=m["m"], levels=m["levels"],
                                          reps=m["block_reps"], in_channels=m["in_channels"],
                                          classes=m["classes"])
        points.append(n)
    ctx["flops"] = flops
    ctx["k4_bound_s"] = ctx["trace_sweeps"] * rl.k4_sweep_least_s(2 * min(points))
    ctx["k4_s"] = harness.kernel_seconds(ctx["trace"], K4_KERNELS)
