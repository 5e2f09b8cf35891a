"""What every cell of the benchmark shares: finding its configuration,
traffic, driver and metric readers by name, the seeds, the weights, the
reading of a profiler trace, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its `config` names
benchmark/configs/<config>.json, its `traffic` names
benchmark/traffic/<traffic>.json, whose `driver` names
benchmark/drivers/<driver>.py, and each per-layer metric <m> of
BENCHMARK.json is read by benchmark/metrics/<m>.py. A cell, a traffic mix, a
configuration or a metric is added as a new file, without an edit here."""

from __future__ import annotations

import heapq
import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# modules that must not be loaded in a run's process, compared by their
# top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "seggroup_tpu")


@dataclass
class RunSpec:
    """One run of one cell."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    chips: int = 1
    device: str = "cuda"
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    t0_wall: float = 0.0  # wall-clock time the run started, for set-up across processes


@dataclass
class Outcome:
    """What a driver's window gave: the end-to-end values, the per-layer
    readers' context, and the requests attempted and failed."""

    end_to_end: dict
    context: dict
    attempted: int
    failed: int = 0
    breakdown: dict | None = None
    foreign: list = field(default_factory=list)  # forbidden modules loaded in other processes


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """benchmark/drivers/<name>.py, imported as a module of the package so
    that the ranks a driver spawns can unpickle its functions."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def cell_spec(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda") -> RunSpec:
    """The RunSpec of `workload` from BENCHMARK.json's contents."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in e2e_names
                                      else [])]
    return RunSpec(workload, seed, seconds, trace,
                   load_json(HERE / "configs" / f"{w['config']}.json"),
                   load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                   int(w["chips"]), device, e2e, per_layer)


def sub_seeds(seed: int, n: int) -> list[int]:
    """n independent 32-bit seeds from a run's seed (any size)."""
    return [int(x) for x in np.random.SeedSequence(int(seed)).generate_state(n)]


def make_weights(spec: list[tuple[str, tuple]], seed: int, device) -> dict:
    """Seeded float32 parameters for `spec` [(name, shape)]: every matrix or
    kernel drawn in one call on the device from a normal of variance
    1 / fan-in, cut at two standard deviations (fan-in: a (out, in)
    matrix's in, a (K, Cin, Cout) kernel's K * Cin); scales 1, every other
    vector 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    mats = [(n, s) for n, s in spec if len(s) >= 2]
    flat = torch.randn(sum(math.prod(s) for _, s in mats), generator=gen, device=device)
    out, i = {}, 0
    for name, shape in spec:
        if len(shape) >= 2:
            fan = shape[1] if len(shape) == 2 else math.prod(shape[:-1])
            n = math.prod(shape)
            out[name] = flat[i:i + n].view(shape).clamp(-2.0, 2.0) / math.sqrt(fan)
            i += n
        elif name.endswith("scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def param_spec(module: torch.nn.Module) -> list[tuple[str, tuple]]:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def load_params(model: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into every parameter of `model`; raises if a
    parameter is missing or has another shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ: {sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])


def scratch_dir() -> str:
    """A fresh directory under the run's TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR"))


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def require(stated, built, what: str) -> None:
    """Raises where the program built or runs something other than what the
    configuration states."""
    if stated != built:
        raise ValueError(f"the configuration states {what} {stated!r}; the program has {built!r}")


def float32_products(stated: str) -> None:
    """Sets the card's float32 matrix products as the configuration states
    them; TF32 off is the one setting the benchmark knows."""
    if stated != "full float32, TF32 off":
        raise ValueError(f"float32_products {stated!r}: only 'full float32, TF32 off' is known")
    torch.backends.cuda.matmul.allow_tf32 = False


# --- the profiler trace ----------------------------------------------------------


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize_trace(prof, window_s: float) -> dict:
    """Device busy seconds (the union of kernel intervals), seconds by
    kernel name, and idle seconds between kernels grouped by the innermost
    host operation open when each gap began, from a torch.profiler run
    whose wall time was `window_s`."""
    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name.startswith(("bench.", "nccl:")):
            continue  # a record_function's span on the device's timeline
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    by_name: dict[str, float] = {}
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    busy = _union([(a, b) for a, b, _ in kernels])
    busy_s = sum(b - a for a, b in busy) / 1e6
    host.sort()
    gaps: dict[str, float] = {}
    open_ops: list = []  # heap of (-start, end, name)
    i = 0
    for (_, end), (nxt, _) in zip(busy[:-1], busy[1:]):
        while i < len(host) and host[i][0] <= end:
            heapq.heappush(open_ops, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        # the innermost (latest-starting) host operation still open at `end`
        while open_ops and open_ops[0][1] < end:
            heapq.heappop(open_ops)
        label = open_ops[0][2] if open_ops else "no host operation"
        gaps[label] = gaps.get(label, 0.0) + (nxt - end) / 1e6
    return {"busy_s": busy_s, "window_s": window_s, "kernels": by_name, "idle_gaps": gaps,
            "launches": len(kernels)}


def kernel_seconds(trace: dict, fragments) -> float:
    """Summed device seconds of the kernels whose names hold a fragment."""
    low = [f.lower() for f in fragments]
    return sum(s for n, s in trace["kernels"].items() if any(f in n.lower() for f in low))


def breakdown(trace: dict) -> dict:
    top = sorted(trace["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}


# --- the result line -----------------------------------------------------------------


def device_info(chips: int, peak_bytes: int, trace: dict | None) -> dict:
    on_card = torch.cuda.is_available()
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": chips,
            "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
