"""The readers of the per-layer metrics that read the port's recorder: each
gives None where the traced window's context lacks its keys (as a program
without the recorder's span or counter leaves it) and its ratio where it
holds them."""

from __future__ import annotations

import pytest

from benchmark import harness

# metric: (its key, its divisor: the phase units or the key's own count)
READERS = {
    "s1_infer.export_format_s": ("export.format", "units"),
    "s1_infer.export_write_s": ("export.write", "units"),
    "s1_infer.host_read_s": ("host.read", "units"),
    "s1_infer.host_reads": ("count.host.read", "units"),
    "s1_infer.grouping_unions": ("count.unions", "units"),
    "mink_train.plan_s": ("plan", "count.plan"),
    "mink_train.optimizer_s": ("optimizer", "units"),
    "mink_train.make_batch_s": ("prefetch.make", "count.prefetch.make"),
    "mink_train.prefetch_wait_s": ("prefetch_wait", "count.prefetch_wait"),
    "s1_dp4.allreduce_wait_s": ("all-reduce.wait", "units"),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_without_its_keys(name):
    read = harness.metric_reader(name).read
    assert read({}) is None
    assert read({"phases": {}, "phase_units": 4}) is None
    # the phases the parent's program records, without the new keys
    assert read({"phases": {"forward": 1.0, "export": 2.0, "all-reduce": 0.5},
                 "phase_units": 4}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_its_ratio(name):
    key, per = READERS[name]
    phases = {key: 6.0, "count.plan": 3, "count.prefetch.make": 3, "count.prefetch_wait": 3,
              "forward": 1.0}
    phases.setdefault(f"count.{key}", 3)
    want = 6.0 / (4 if per == "units" else 3)
    assert harness.metric_reader(name).read({"phases": phases, "phase_units": 4}) == want


def test_every_recorder_metric_is_in_the_benchmark_with_its_one_cell():
    import json

    from benchmark.tests.conftest import ROOT

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = by_name[name]
        assert len(m["workloads"]) == 1
        assert m["workloads"][0].split("-")[0] in ("s1", "mink")
