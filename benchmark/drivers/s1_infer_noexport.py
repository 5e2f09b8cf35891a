"""Driver of stage-1 pseudo-label inference kept in memory:
seggroup_tpu_torch.infer.infer_scenes over one scene at a time with no
`results_root`, so nothing is written; in the window each scene's 15 label
arrays are read to the host, as a caller that keeps them in memory reads
them. The labelling rate without the export's files.

Set-up, the weights, the pool and its order are s1_infer's (the same
configuration; the traffic names a larger pool, so that no scene repeats
in a window). A traced window profiles its first `trace_units` scenes and
clocks the port's phases ("grouping", "cluster_knn") over the rest. The
check compares every scene's 15 arrays with the plain reference
(benchmark/reference/stage1.py), run on the card once over each scene the
window ran: `label_mismatch` is the largest share of points whose label
differs, over the arrays and the scenes."""

from __future__ import annotations

import shutil
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import s1_infer
from benchmark.drivers.s1_infer import (State, _activities, _points, _reference, _sync,
                                        memory_peak, mismatch, reference_labels, release)

__all__ = ["setup", "window", "memory_peak", "check", "readings", "release",
           "assume_exported", "State"]


def setup(spec: harness.RunSpec) -> State:
    return s1_infer.setup(spec)


def host_labels(out) -> dict[str, np.ndarray]:
    """The 15 label arrays of one forward's output, read to the host under
    the names of the export's files."""
    from seggroup_tpu_torch.utils import profiling

    arrays = {"final.sem": out.final_sem, "final.ins": out.final_ins,
              "final.seg": out.final_root}
    for li in range(out.layer_roots.shape[0]):
        arrays[f"layer_{li + 1}.seg"] = out.layer_roots[li]
        arrays[f"layer_{li + 1}.sem"] = out.layer_sem[li]
        arrays[f"layer_{li + 1}.ins"] = out.layer_ins[li]
    return {k: profiling.to_host(v).numpy().astype(np.int64) for k, v in arrays.items()}


def window(st: State, seconds: float, trace: bool) -> harness.Outcome:
    ran: list[int] = []
    st.got = []  # each scene's labels, in the order the window ran them
    ctx: dict = {}

    def one(k, phases=None):
        i = int(st.order[k % len(st.order)])
        with torch.profiler.record_function("bench.infer_scenes"):
            out = st.infer(st.model, [st.scenes[i]], st.mode, phase_seconds=phases)[0]
            st.got.append(host_labels(out))
        ran.append(i)

    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    if trace:
        with torch.profiler.profile(activities=_activities(st.dev)) as prof:
            t0 = time.perf_counter()
            for _ in range(st.spec.traffic["trace_units"]):
                one(k)
                k += 1
            _sync(st.dev)
            prof_s = time.perf_counter() - t0
        ctx["trace"] = harness.summarize_trace(prof, prof_s)
        ctx["trace_scenes"] = list(ran)
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
    st.exported = [(i, j) for j, i in enumerate(ran)]
    points = sum(_points(st.pool[i]) for i in ran)
    out = harness.Outcome({"s1_infer_points_per_s": points / elapsed}, ctx, len(ran))
    if trace:
        out.breakdown = harness.breakdown(ctx["trace"])
    return out


def assume_exported(st: State, n: int) -> None:
    """Take the first `n` scenes a window runs as run, without running it:
    the control's readings over as many scenes as a run compares."""
    st.exported = [(int(st.order[k % len(st.order)]), None) for k in range(n)]


def readings(st: State, lower: bool = False) -> dict[str, float]:
    """label_mismatch of every scene the window ran against the reference
    or, with `lower`, of the reference at the control's precision in the
    program's place over the same scenes; beside it the count of scenes
    compared and of those whose labels differ."""
    worst, moved = 0.0, set()
    scenes_run = sorted({i for i, _ in st.exported})
    for i in scenes_run:
        want = _reference(st, i)
        if lower:
            got = [reference_labels(st, i, st.ref_model, lower=True)]
        else:
            got = [st.got[j] for k, j in st.exported if k == i]
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
            s1_infer._trace_counts(st, outcome.context)
    finally:
        shutil.rmtree(st.work, ignore_errors=True)
    limits = st.spec.config["limits"]["s1_infer"]
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}

