"""The reader of s1_infer.export_native_files, the label files a scene that
the port's native library formatted: None where the traced window's context
lacks "count.export.native" (as a program without the counter leaves it),
the count over the clocked scenes where it holds it, and declared in
BENCHMARK.json for s1-infer-scannet alone."""

from __future__ import annotations

import json

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = "s1_infer.export_native_files"


def test_reader_is_none_without_the_counter():
    read = harness.metric_reader(NAME).read
    assert read({}) is None
    assert read({"phases": {}, "phase_units": 4}) is None
    # the keys the parent's program records, without the counter
    assert read({"phases": {"export": 2.0, "export.format": 1.5, "count.export.format": 60},
                 "phase_units": 4}) is None
    assert read({"phases": {"count.export.native": 60}, "phase_units": 0}) is None


def test_reader_gives_files_a_scene():
    read = harness.metric_reader(NAME).read
    phases = {"count.export.native": 60, "count.export.format": 60, "export.format": 0.5}
    assert read({"phases": phases, "phase_units": 4}) == 15.0
    # the numpy fallback ran for every file: counted as none
    phases["count.export.native"] = 0
    assert read({"phases": phases, "phase_units": 4}) == 0.0


def test_declared_for_the_exporting_cell_alone():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m["workloads"] == ["s1-infer-scannet"]
    assert m["source"] == "program_counter" and m["moves"] == "s1_infer_points_per_s"
    assert m["layer"] == {x["name"]: x for x in bench["per_layer"]}["s1_infer.export_s"]["layer"]
