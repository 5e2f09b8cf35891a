"""Driver of data-parallel stage-1 training: seggroup_tpu_torch.parallel.dp.
launch over the configuration's world size of ranks (NCCL, one card each),
each running build_stage1_train_step, the stage-1 trainer's step with the
ranks' mean of the gradients between the backward and Adam.

The configuration's scene and weight seeds fix a pool of bench scenes and
the weights, the same in every run; the run's seed orders the pool, and at
step s (from 1) rank r trains on the scene at (s * world + r) mod the pool's
size of that order (each rank makes only its own), and it draws the
classifier's dropout mask of (s, r), which is handed to the step. Set-up
(the spawn, the model on each card, `mesh.replicate`, and the first
`warmup_steps` steps) keeps every step's loss summed over the ranks (as the
step returns it), rank 0's mean gradient at step 1 (worked out from Adam's
first moment) and the parameters' change after the last warm-up step. The
window runs further steps until rank 0's clock passes the deadline (the
ranks agree on it through `Mesh.any`). A traced window profiles rank 0's
first `trace_units` steps and clocks every rank's phases over the rest.
After the window each rank keeps its parameters' float64 sums and the
modules that must not load that its process holds.

The check runs the plain reference (benchmark/reference/stage1.py) on the
first card: each step each rank's scene with its dropout mask, the mean of
their gradients and torch's Adam. `loss_gap`, `grad_gap` and `change_gap`
are read as in the MinkUNet driver (`gaps`); `rank_spread` is the largest
relative gap of a rank's parameter sums to rank 0's after the window."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, scenes
from benchmark.drivers.mink_train import gaps
from benchmark.drivers.s1_infer import port_model, ref_model
from benchmark.reference import stage1 as ref
from benchmark.roofline import counts


class State:
    pass


def _scene_index(step: int, rank: int, world: int, order) -> int:
    return int(order[(step * world + rank) % len(order)])


def _dropout_keep(seed: int, step: int, rank: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(
        int(np.random.SeedSequence((seed, step, rank)).generate_state(1)[0]))
    return (torch.rand((n, 128), generator=gen) < 0.5).to(device)


def setup(spec: harness.RunSpec) -> State:
    st = State()
    st.spec = spec
    st.dev = torch.device(spec.device if spec.device == "cpu" else "cuda:0")
    order_seed, st.dropout_seed = harness.sub_seeds(spec.seed, 2)
    st.scene_seed, st.weight_seed = spec.config["scene_seed"], spec.config["weight_seed"]
    st.order = np.random.default_rng(order_seed).permutation(spec.traffic["scene_pool"])
    st.world = spec.config["world_size"]
    return st


def plant(fault: str | None) -> None:
    """A fault in the program's exchange, for the control script's readings
    and the tests: "no_exchange" leaves the gradients out of the ranks'
    all-reduce, "half_batch" takes the mean over the first half of the
    ranks' gradients only; "foreign_module" loads a stand-in named as the
    JAX package in the rank."""
    if fault is None:
        return
    if fault == "foreign_module":
        import sys
        import types

        sys.modules.setdefault("seggroup_tpu", types.ModuleType("seggroup_tpu"))
        return
    from seggroup_tpu_torch.parallel.dp import Mesh

    def faulty_sync(self, model):
        params = list(model.parameters())
        bufs = [b for b in model.buffers() if b.is_floating_point()]
        keep = self.rank < self.size // 2
        grads = [p.grad if p.grad is not None and keep else torch.zeros_like(p)
                 for p in params]
        means = self.all_reduce((grads if fault == "half_batch" else []) + bufs, mean=True)
        if fault == "half_batch":
            for p, g in zip(params, means):
                p.grad = g * 2
            means = means[len(params):]
        with torch.no_grad():
            for b, m in zip(bufs, means):
                b.copy_(m)

    if fault not in ("no_exchange", "half_batch"):
        raise ValueError(fault)
    Mesh.sync = faulty_sync


def _rank(mesh, spec: harness.RunSpec, seconds: float, trace: bool, seeds) -> dict:
    """One rank's set-up, warm-up and window."""
    from seggroup_tpu_torch.parallel.dp import build_stage1_train_step
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule
    from seggroup_tpu_torch.types import Scene

    plant(spec.traffic.get("fault"))
    scene_seed, weight_seed, dropout_seed, order = seeds
    cfg, tr = spec.config, spec.config["train"]
    dev, world, rank = mesh.device, mesh.size, mesh.rank
    pool = spec.traffic["scene_pool"]
    pool_seeds = np.random.SeedSequence(scene_seed).generate_state(pool)
    mine = {int(i): Scene(*(sc[f] for f in scenes.FIELDS)).to(dev) for i, sc in
            ((i, scenes.make_scene(int(pool_seeds[i]), **cfg["scene"]))
             for i in order[rank % pool::world])}
    model = port_model(cfg, dev, weight_seed)
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer, _ = make_optimizer(tr["optimizer"], model.parameters(),
                                  make_schedule("constant", tr["lr"]),
                                  weight_decay=tr["weight_decay"])
    mesh.replicate(model, optimizer)
    step_fn = build_stage1_train_step(model, optimizer, mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def step(s, phases=None):
        keep = _dropout_keep(dropout_seed, s, rank, tr["max_instances"], dev)
        loss, _ = step_fn(mine[_scene_index(s, rank, world, order)], dropout_keep=keep,
                          phase_seconds=phases)
        return loss

    params = dict(model.named_parameters())
    beta1 = optimizer.param_groups[0]["betas"][0]
    out = {"losses": [], "grad_norms": {}, "rank": rank}
    for s in range(1, spec.traffic["warmup_steps"] + 1):
        out["losses"].append(float(step(s)))
        if s == 1:
            for n, p in params.items():
                avg = optimizer.state[p].get("exp_avg")
                out["grad_norms"][n] = (0.0 if avg is None else float(torch.linalg.vector_norm(
                    avg / (1 - beta1) - tr["weight_decay"] * weights[n])))
    out["change_norms"] = {n: float(torch.linalg.vector_norm(p.detach() - weights[n]))
                           for n, p in params.items()}
    del weights
    _sync(dev)
    mesh.barrier()
    out["window_start_wall"] = time.time()
    start = time.perf_counter()
    deadline = start + seconds
    s = spec.traffic["warmup_steps"]
    steps = 0

    def stop():
        return mesh.any(rank == 0 and time.perf_counter() >= deadline)

    if trace:
        phases: dict = {}
        units = spec.traffic["trace_units"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                s += 1
                with torch.profiler.record_function("bench.train_step"):
                    step(s)
                steps += 1
            _sync(dev)
            prof_s = time.perf_counter() - t0
        out["trace"] = harness.summarize_trace(prof, prof_s)
        n0 = steps
        while not stop() or steps == n0:
            s += 1
            step(s, phases)
            steps += 1
        out["phases"], out["phase_units"] = phases, steps - n0
    else:
        while not stop():
            s += 1
            step(s)
            steps += 1
    _sync(dev)
    out["elapsed"] = time.perf_counter() - start
    out["steps"] = steps
    out["points"] = steps * world * int(cfg["scene"]["num_points"])
    out["peak"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["digest"] = {n: float(p.detach().double().sum()) for n, p in params.items()}
    out["foreign"] = harness.forbidden_modules()
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(st: State, seconds: float, trace: bool) -> harness.Outcome:
    from seggroup_tpu_torch.parallel.dp import launch

    seeds = (st.scene_seed, st.weight_seed, st.dropout_seed, st.order)
    device = "cpu" if st.dev.type == "cpu" else "cuda"
    st.ranks = launch(_rank, st.world, device, st.spec, seconds, trace, seeds, all_ranks=True)
    r0 = st.ranks[0]
    e2e = {"s1_train_points_per_s": r0["points"] / r0["elapsed"],
           "setup_s": r0["window_start_wall"] - st.spec.t0_wall}
    ctx: dict = {}
    out = harness.Outcome(e2e, ctx, r0["steps"] * st.world,
                          foreign=sorted({m for r in st.ranks for m in r["foreign"]}))
    if trace:
        ctx.update(trace=r0["trace"], phases=r0["phases"], phase_units=r0["phase_units"])
        shape = st.spec.config["scene"]
        n_seg = shape["num_instances"] * shape["segs_per_instance"]
        seg_points = shape["num_points"] // n_seg
        m = st.spec.config["model"]
        # the segments stand in for the clusters: a lower bound of the kNN's
        # work, as clusters only grow
        fwd = counts.stage1_forward_flops(shape["num_points"], n_seg,
                                          [[seg_points] * n_seg] * 2, m["knn_k"],
                                          m["knn_window"], m["mlp1_points"])
        ctx["flops"] = 3 * fwd * st.spec.traffic["trace_units"]
        out.breakdown = harness.breakdown(r0["trace"])
        # the device's busy seconds and window, averaged over the cards
        ctx["device_trace"] = {k: sum(r["trace"][k] for r in st.ranks) / st.world
                               for k in ("busy_s", "window_s")}
    return out


def memory_peak(st: State) -> int:
    return max(r["peak"] for r in st.ranks)


def release(st: State) -> None:
    """The ranks have exited: the program's state is gone."""


def reference_steps(st: State, lower: bool = False):
    cfg, tr = st.spec.config, st.spec.config["train"]
    pool = st.spec.traffic["scene_pool"]
    pool_seeds = np.random.SeedSequence(st.scene_seed).generate_state(pool)
    model = ref_model(cfg).to(st.dev)
    weights = harness.make_weights(harness.param_spec(model), st.weight_seed, st.dev)
    harness.load_params(model, weights)
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=tr["lr"], betas=(0.9, 0.999),
                           weight_decay=tr["weight_decay"])
    losses, first = [], None
    made: dict = {}
    for s in range(1, st.spec.traffic["warmup_steps"] + 1):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total = 0.0
        for r in range(st.world):
            i = _scene_index(s, r, st.world, st.order)
            if i not in made:
                made[i] = scenes.to_tensors(
                    scenes.make_scene(int(pool_seeds[i]), **cfg["scene"]), st.dev)
            model.zero_grad(set_to_none=True)
            loss = model(made[i], train=True, lower=lower,
                         dropout_keep=_dropout_keep(st.dropout_seed, s, r,
                                                    tr["max_instances"], st.dev)).loss
            with ref.tf32(lower):
                loss.backward()
            total += float(loss.detach())
            for n, p in params.items():
                if p.grad is not None:
                    grads[n] += p.grad
        for n, p in params.items():
            p.grad = grads[n] / st.world
        if first is None:
            first = {n: float(torch.linalg.vector_norm(p.grad)) for n, p in params.items()}
        with ref.tf32(lower):
            opt.step()
        losses.append(total)
    change = {n: float(torch.linalg.vector_norm(p.detach() - weights[n]))
              for n, p in params.items()}
    return losses, first, change


def readings(st: State, lower: bool = False) -> dict[str, float]:
    want = reference_steps(st)
    if lower:
        out = gaps(*reference_steps(st, lower=True), *want)
        out["rank_spread"] = 0.0
        return out
    r0 = st.ranks[0]
    out = gaps(r0["losses"], r0["grad_norms"], r0["change_norms"], *want)
    out["rank_spread"] = max(abs(r["digest"][n] - d) / max(abs(d), 1e-30)
                             for r in st.ranks[1:] for n, d in r0["digest"].items())
    return out


def check(st: State, outcome: harness.Outcome) -> dict:
    values = readings(st)
    limits = st.spec.config["limits"]["s1_train_dp"]
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}
