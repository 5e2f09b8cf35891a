"""Whole runs of pg-train-b4 and s1-infer-noexport at a small size on the
CPU: the result line, traced and untraced, and `correct` false with the
timed path broken underneath."""

from __future__ import annotations

import json
import time

import pytest

from benchmark.run import run_cell
from benchmark.tests.conftest import small_spec

# limits of the PointGroup check at the small size (m 8, two scenes of
# 4,096 points a step, caps of 8,192), set from its own readings on the CPU:
# the first step's point losses 0.017 and 0.079 on two seeds (the offset
# direction's, a mean near 0 after two prepare steps), the control 0.035
# and 0.24, half the batch left out 1.44 and 0.21
SMALL_PG_LIMITS = {"point_loss_gap_first": 0.1, "change_gap": 0.5, "proposal_mismatch": 0.0,
                   "points_dropped": 0.0, "voxels_dropped": 0.0, "score_voxels_dropped": 0.0,
                   "cc_unconverged": 0.0}


def small(workload: str, trace: bool = False):
    spec = small_spec(workload, seconds=1.0, trace=trace)
    if spec.traffic["driver"] == "pg_train":
        spec.config["model"]["m"] = 8
        spec.config["train"].update(batch_size=2, point_cap=8192, voxel_cap=8192,
                                    score_cap=8192, prefetch_depth=1)
        spec.traffic.update(prepare_batches=1, prepare_steps_setup=2, warmup_steps=2,
                            trace_units=1)
        spec.config["limits"]["pg_train"] = dict(SMALL_PG_LIMITS)
    return spec


@pytest.mark.parametrize("workload", ["pg-train-b4", "s1-infer-noexport"])
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_result_line(workload, trace):
    spec = small(workload, trace)
    out, _ = run_cell(spec, time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0, out["checks"]
    json.dumps(out)
    if trace:
        names = {m["name"] for m in spec.per_layer}
        assert set(out["metrics"]) <= names
    else:
        assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}


def _drop_points(set_attr):
    from seggroup_tpu_torch.cli import stage2_train_pointgroup as trainer

    whole = trainer.make_pg_batch

    def cropped(tuples, *a, **k):
        return whole(tuples, *a, **{**k, "max_points_per_scene": 4000})

    set_attr(trainer, "make_pg_batch", cropped)


def _half_batch(set_attr):
    from benchmark.drivers import pg_train

    pg_train.plant("half_batch", set_attr, keep=1)  # the first of the two scenes


def _altered_labels(set_attr):
    from seggroup_tpu_torch import infer

    whole = infer.infer_scenes

    def altered(*a, **k):
        outs = whole(*a, **k)
        for o in outs:  # every hundredth point's label changed
            o.final_sem[::100] += 1
        return outs

    set_attr(infer, "infer_scenes", altered)


@pytest.mark.parametrize("workload,fault", [("pg-train-b4", _drop_points),
                                            ("pg-train-b4", _half_batch),
                                            ("s1-infer-noexport", _altered_labels)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    spec = small(workload)
    fault(monkeypatch.setattr)
    out, _ = run_cell(spec, time.perf_counter())
    assert out["correct"] is False, out["checks"]
