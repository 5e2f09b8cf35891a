"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the port
(seggroup_tpu_torch). The cell's driver makes its inputs and weights from
the seed, warms up (set-up, timed as setup_s from the start of this
module), runs its closed loop for the given seconds, frees the program's
state and holds what the window produced against the plain reference.
With --trace 0 the metrics are the cell's end-to-end ones, with --trace 1
its per-layer ones, read from a torch.profiler run over the start of the
window and from the port's phase clocks over the rest.

The last lines of standard error name each compared number beside its
limit; the last line of standard output is one JSON object. A run without
enough cards exits 2 and prints no result; one in which jax, jaxlib, flax
or the JAX package was loaded, in this process or in a rank it started,
exits 3 and prints no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
CACHE = ROOT / ".bench_cache"


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds them."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    from benchmark import harness

    spec = harness.cell_spec(harness.load_json(ROOT / "BENCHMARK.json"), args.workload,
                             args.seed, args.seconds, bool(args.trace))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA cards; {n_cards} available",
              file=sys.stderr)
        return 2
    return report(spec, T0)


def report(spec, t0: float) -> int:
    """Runs the cell `spec` and prints its checks and its result line; or,
    where a module that must not load was loaded here or in a process the
    cell started, names it and returns 3 without a result."""
    from benchmark import harness

    result, foreign = run_cell(spec, t0)
    found = sorted(set(harness.forbidden_modules()) | set(foreign))
    if found:
        print(f"modules that must not load were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(spec, t0: float) -> tuple[dict, list[str]]:
    """One run of the cell `spec`: the driver's set-up, window and check;
    returns the result line's object and the modules that must not load
    that the cell's other processes reported."""
    from benchmark import harness

    drv = harness.driver(spec.traffic["driver"])
    spec.t0_wall = time.time() - (time.perf_counter() - t0)
    state = drv.setup(spec)
    setup_s = time.perf_counter() - t0
    outcome = drv.window(state, spec.seconds, spec.trace)
    peak = drv.memory_peak(state)
    checks = drv.check(state, outcome)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    values = {"setup_s": setup_s, **outcome.end_to_end}
    if spec.trace:
        metrics = {}
        for m in spec.per_layer:
            v = harness.metric_reader(m["name"]).read(outcome.context)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}
    trace = (outcome.context.get("device_trace", outcome.context.get("trace"))
             if spec.trace else None)
    out = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": harness.device_info(spec.chips, peak, trace)}
    if spec.trace and outcome.breakdown is not None:
        out["breakdown"] = outcome.breakdown
    out["checks"] = checks
    return out, outcome.foreign


if __name__ == "__main__":
    sys.exit(main())
