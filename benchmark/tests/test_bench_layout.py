"""BENCHMARK.json against the files it names, the imports of the benchmark's
modules, and the lookup of configurations, cells and metrics by name."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(BENCH, w["name"], 1, 1.0, False)
        names = [m["name"] for m in spec.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        for m in spec.per_layer:
            assert m["moves"] in names and m["moves"] in e2e
        driver = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "drivers" / f"{driver['driver']}.py").is_file()


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module `path` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "seggroup_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "seggroup_tpu_torch" not in _imports(path)


def test_a_new_config_cell_and_metric_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    cfg["name"] = "new-config"
    (tmp_path / "benchmark" / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "new-traffic.json").write_text(
        json.dumps({"driver": "new_driver"}))
    (tmp_path / "benchmark" / "drivers" / "new_driver.py").write_text("NAME = 'new'\n")
    (tmp_path / "benchmark" / "metrics" / "new.metric_s.py").write_text(
        "def read(ctx):\n    return ctx.get('x')\n")
    bench["configs"].append({"name": "new-config", "source": "s",
                             "file": "benchmark/configs/new-config.json", "reduced": [],
                             "why": "w"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-traffic", "chips": 1, "why": "w"})
    bench["end_to_end"].append({"name": "new_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["new-cell"]})
    bench["per_layer"].append({"name": "new.metric_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "l", "moves": "new_rate"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from benchmark import harness\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "s = harness.cell_spec(b, 'new-cell', 1, 1.0, True)\n"
            "assert s.config['name'] == 'new-config', s.config\n"
            "assert {m['name'] for m in s.end_to_end} == {'new_rate', 'setup_s'}\n"
            "assert [m['name'] for m in s.per_layer] == ['new.metric_s']\n"
            "assert harness.driver(s.traffic['driver']).NAME == 'new'\n"
            "assert harness.metric_reader('new.metric_s').read({'x': 3}) == 3\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
