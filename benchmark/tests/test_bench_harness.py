"""Whole runs of the cells at a small size on the CPU, past the harness's
look for a card: the result line, and `correct` false with the timed path
broken underneath and with the control in the program's place."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.control import plant
from benchmark.run import report, run_cell
from benchmark.tests.conftest import ROOT, small_spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _keys_ok(out: dict, trace: bool) -> None:
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


CELLS = ["s1-infer-scannet", "mink-train-b8-2cm", "s1-train-dp4"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_result_line(workload, trace):
    spec = small_spec(workload, seconds=1.0, trace=trace)
    out, _ = run_cell(spec, time.perf_counter())
    _keys_ok(out, trace)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    json.dumps(out)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in spec.per_layer}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}


@pytest.mark.parametrize("workload,fault", [("s1-infer-scannet", "altered_label"),
                                            ("mink-train-b8-2cm", "half_batch"),
                                            ("mink-train-b8-2cm", "unchanged_state"),
                                            ("s1-train-dp4", "no_exchange"),
                                            ("s1-train-dp4", "half_batch")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    spec = small_spec(workload)
    if spec.traffic["driver"] == "s1_train_dp":
        spec.traffic["fault"] = fault  # planted inside each spawned rank
    else:
        plant(fault, monkeypatch.setattr)
    out, _ = run_cell(spec, time.perf_counter())
    assert out["correct"] is False, out["checks"]


# the stage-1 labels are decided by thresholds on feature distances, and
# the control's rounding moves one across on some scenes only (at this size
# in the pool of seed 6 of seeds 1-12; on the card at the bench size in
# about one scene of 15): the seed is one whose pool it does, and the
# control reads every scene of it, whatever the CPU's pace
@pytest.mark.parametrize("workload,seed", [("s1-infer-scannet", 6),
                                           ("mink-train-b8-2cm", 2 ** 34 + 1),
                                           ("s1-train-dp4", 2 ** 34 + 1)])
def test_the_control_in_the_programs_place_is_not_correct(workload, seed):
    spec = small_spec(workload, seed=seed)
    drv = harness.driver(spec.traffic["driver"])
    st = drv.setup(spec)
    if hasattr(drv, "assume_exported"):
        drv.assume_exported(st, spec.traffic["scene_pool"])
    else:
        drv.window(st, 1.0, False)
    drv.release(st)
    limits = spec.config["limits"][spec.traffic["driver"]]
    control = drv.readings(st, lower=True)
    assert any(control[k] > limits[k] for k in limits), control


def test_a_forbidden_module_in_a_rank_gives_no_result(capsys):
    """A rank of the data-parallel cell (2 gloo ranks) loads a stand-in named
    as the JAX package: the run exits 3 and prints no result."""
    spec = small_spec("s1-train-dp4")
    spec.traffic["fault"] = "foreign_module"
    assert "seggroup_tpu" not in sys.modules
    assert report(spec, time.perf_counter()) == 3
    out = capsys.readouterr()
    assert out.out.strip() == "" and "seggroup_tpu" in out.err


def test_a_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "s1-infer-scannet", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_runs_on_the_card(cuda_card):
    """One short run of every one-card cell through the command, on the card."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["chips"] > 1:
            continue
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", w["name"],
                              "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
