"""Driver of stage-1 pseudo-label inference: seggroup_tpu_torch.infer.
infer_scenes over one scene at a time, each scene's label files exported
under a scratch directory of the run's TMPDIR, as stage1_infer writes them.

Set-up makes the traffic's pool of bench scenes from the run's seed and the
weights from the configuration's seed (the same in every run, as one trained
checkpoint labels every scene), builds the port's SegGroupGNN with the
configuration's options and runs one scene through the timed call. The
window runs through the pool in a closed loop, in an order drawn from the
seed; the pool is larger than a window's count of scenes, so that none
repeats (should one, it is compared again). A traced window profiles its
first `trace_units` scenes and clocks the port's phases ("grouping",
"cluster_knn", "export") over the rest. The check reads back every export
the window wrote and compares every label file with the plain reference
(benchmark/reference/stage1.py), run on the card once over each of those
scenes with the same weights: `label_mismatch` is the largest share of
points whose label differs, over the files and the exports."""

from __future__ import annotations

import gc
import os
import shutil
import time

import numpy as np
import torch

from benchmark import harness, scenes
from benchmark.reference import stage1 as ref
from benchmark.roofline import counts

FILES = ("final.sem", "final.ins", "final.seg") + tuple(
    f"layer_{i}.{k}" for i in range(1, 5) for k in ("seg", "sem", "ins"))


class State:
    pass


def _options(cfg: dict) -> dict:
    """The model options that the program and the reference share."""
    m = cfg["model"]
    return dict(knn_k=m["knn_k"], knn_window=m["knn_window"], cluster_cap=m["cluster_cap"],
                mlp1_points=m["mlp1_points"], th_structural=m["th_structural"],
                th_semantic=m["th_semantic"], gcn_alpha=m["gcn_alpha"],
                max_instances=cfg["train"]["max_instances"])


def ref_model(cfg: dict) -> ref.SegGroupGNN:
    return ref.SegGroupGNN(**_options(cfg))


def port_model(cfg: dict, dev: torch.device, weight_seed: int):
    """The port's SegGroupGNN as the configuration states it, with the
    benchmark's weights."""
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    m = cfg["model"]
    harness.float32_products(m["float32_products"])
    model = SegGroupGNN(**_options(cfg), sequential=m["grouping"] == "sequential",
                        compute_dtype=getattr(torch, m["compute_dtype"]), device=dev)
    spec = harness.param_spec(ref_model(cfg))
    harness.load_params(model, harness.make_weights(spec, weight_seed, dev))
    return model


def setup(spec: harness.RunSpec) -> State:
    from seggroup_tpu_torch.infer import infer_scenes
    from seggroup_tpu_torch.types import Scene

    st = State()
    st.spec = spec
    st.dev = torch.device(spec.device)
    scene_seed, order_seed = harness.sub_seeds(spec.seed, 2)
    st.weight_seed = spec.config["weight_seed"]
    st.pool = scenes.scene_pool(scene_seed, spec.traffic["scene_pool"], spec.config["scene"])
    st.order = np.random.default_rng(order_seed).permutation(len(st.pool))
    st.model = model = port_model(spec.config, st.dev, st.weight_seed)
    st.scenes = [Scene(*(sc[f] for f in scenes.FIELDS)).to(st.dev) for sc in st.pool]
    st.infer = infer_scenes
    st.mode = spec.traffic["mode"]
    st.ref_model = None
    st.want = {}  # the reference's labels of each scene it ran
    st.ref_roots = {}  # and its clusters
    st.work = harness.scratch_dir()
    st.results = os.path.join(st.work, "results")
    if st.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(st.dev)
    # the timed call once, into a directory of its own
    infer_scenes(model, st.scenes[:1], st.mode, os.path.join(st.work, "warmup"), ["warmup"])
    _sync(st.dev)
    return st


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _points(sc: dict) -> int:
    return int((sc["point2seg"] < len(sc["weak_ins"])).sum())


def window(st: State, seconds: float, trace: bool) -> harness.Outcome:
    exported: list[tuple[int, str]] = []
    ctx: dict = {}

    def one(k, phases=None):
        i = int(st.order[k % len(st.order)])
        name = f"w{k:05d}"
        with torch.profiler.record_function("bench.infer_scenes"):
            st.infer(st.model, [st.scenes[i]], st.mode, st.results, [name],
                     phase_seconds=phases)
        exported.append((i, name))

    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    if trace:
        units = st.spec.traffic["trace_units"]
        with torch.profiler.profile(activities=_activities(st.dev)) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                one(k)
                k += 1
            _sync(st.dev)
            prof_s = time.perf_counter() - t0
        ctx["trace"] = harness.summarize_trace(prof, prof_s)
        ctx["trace_scenes"] = [i for i, _ in exported]
        phases: dict = {}
        n0 = k
        while time.perf_counter() < deadline or k == n0:
            one(k, phases)
            k += 1
        ctx["phases"] = phases
        ctx["phase_units"] = k - n0
    else:
        while time.perf_counter() < deadline:
            one(k)
            k += 1
    _sync(st.dev)
    elapsed = time.perf_counter() - start
    points = sum(_points(st.pool[i]) for i, _ in exported)
    st.exported = exported
    out = harness.Outcome({"s1_infer_points_per_s": points / elapsed}, ctx, len(exported))
    if trace:
        out.breakdown = harness.breakdown(ctx["trace"])
    return out


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def memory_peak(st: State) -> int:
    return torch.cuda.max_memory_allocated(st.dev) if st.dev.type == "cuda" else 0


def release(st: State) -> None:
    """Free the program's state before the reference runs."""
    st.model = st.scenes = None
    gc.collect()
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def assume_exported(st: State, n: int) -> None:
    """Take the first `n` scenes a window runs as exported, without running
    it: the control's readings over as many scenes as a run compares."""
    st.exported = [(int(st.order[k % len(st.order)]), None) for k in range(n)]


def read_labels(st: State, name: str) -> dict[str, np.ndarray]:
    out = {}
    for f in FILES:
        with open(os.path.join(st.results, name, st.mode, f + ".txt")) as fh:
            out[f] = np.array(fh.read().split(), dtype=np.int64)
    return out


def reference_labels(st: State, i: int, model: ref.SegGroupGNN, lower: bool = False
                     ) -> dict[str, np.ndarray]:
    out = model(scenes.to_tensors(st.pool[i], st.dev), lower=lower)
    labels = {"final.sem": out.final_sem, "final.ins": out.final_ins, "final.seg": out.final_root}
    for li in range(4):
        labels[f"layer_{li + 1}.seg"] = out.layer_roots[li]
        labels[f"layer_{li + 1}.sem"] = out.layer_sem[li]
        labels[f"layer_{li + 1}.ins"] = out.layer_ins[li]
    if not lower:
        st.ref_roots[i] = out.layer_roots.cpu().numpy()
    return {k: v.cpu().numpy().astype(np.int64) for k, v in labels.items()}


def mismatch(a: dict, b: dict) -> float:
    return max(float(np.mean(a[f] != b[f])) for f in FILES)


def _reference(st: State, i: int) -> dict[str, np.ndarray]:
    """The reference's labels of pool scene `i`, run once."""
    if st.ref_model is None:
        st.ref_model = ref_model(st.spec.config).to(st.dev)
        harness.load_params(st.ref_model, harness.make_weights(
            harness.param_spec(st.ref_model), st.weight_seed, st.dev))
    if i not in st.want:
        st.want[i] = reference_labels(st, i, st.ref_model)
    return st.want[i]


def readings(st: State, lower: bool = False) -> dict[str, float]:
    """label_mismatch of every export of the window against the reference
    or, with `lower`, of the reference at the control's precision in the
    program's place over the same scenes; beside it the count of scenes
    compared and of those whose labels differ, for the record."""
    worst, moved = 0.0, set()
    scenes_run = sorted({i for i, _ in st.exported})
    for i in scenes_run:
        want = _reference(st, i)
        if lower:
            got = [reference_labels(st, i, st.ref_model, lower=True)]
        else:
            got = [read_labels(st, name) for j, name in st.exported if j == i]
        for g in got:
            gap = mismatch(g, want)
            worst = max(worst, gap)
            if gap > 0:
                moved.add(i)
    return {"label_mismatch": worst, "scenes": len(scenes_run), "scenes_differing": len(moved)}


def check(st: State, outcome: harness.Outcome) -> dict:
    release(st)
    try:
        values = readings(st)
        if outcome.context.get("trace") is not None:
            _trace_counts(st, outcome.context)
    finally:
        shutil.rmtree(st.work, ignore_errors=True)
    limits = st.spec.config["limits"]["s1_infer"]
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}


def _trace_counts(st: State, ctx: dict) -> None:
    """The dense FLOPs of the profiled scenes' forwards, counted from the
    scenes and the reference's clusters."""
    m = st.spec.config["model"]
    flops = 0.0
    for i in ctx["trace_scenes"]:
        sc = st.pool[i]
        roots = st.ref_roots[i]
        n = _points(sc)
        flops += counts.stage1_forward_flops(
            n, int(np.unique(sc["point2seg"][sc["point2seg"] < len(sc["weak_ins"])]).size),
            [np.bincount(roots[li][roots[li] < len(sc["weak_ins"])]) for li in (1, 2)],
            m["knn_k"], m["knn_window"], m["mlp1_points"])
    ctx["flops"] = flops
