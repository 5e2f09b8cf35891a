"""Small versions of the cells, for runs on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
# limits of the MinkUNet check at the small size, set from its own readings
# on the CPU (3 seeds): the program's grad_gap 0.0080-0.0138, the control's
# 0.027-0.030; the worst leaf's gaps (4 seeds) program up to 0.128 and
# 0.167, a state left unchanged 1
SMALL_MINK_LIMITS = {"loss_gap": 0.003, "grad_gap": 0.02, "change_gap": 0.05,
                     "grad_gap_worst": 0.4, "change_gap_worst": 0.4}
SMALL_SCENE = dict(num_points=4096, num_slots=128, num_edges=1024, num_instances=8,
                   segs_per_instance=6)


def small_spec(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 1.0,
               trace: bool = False) -> harness.RunSpec:
    """The cell's spec at a size the CPU runs in seconds."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = harness.cell_spec(bench, workload, seed, seconds, trace, device="cpu")
    spec.config["scene"] = dict(SMALL_SCENE)
    spec.traffic["scene_pool"] = 3
    if "model" in spec.config and "knn_window" in spec.config["model"]:
        spec.config["model"].update(knn_window=2048, cluster_cap=256)
    if "capacity" in spec.config.get("train", {}):
        spec.config["train"].update(capacity=8192, batch_size=2, prefetch_workers=1)
        spec.config["limits"]["mink_train"] = dict(SMALL_MINK_LIMITS)
    if "world_size" in spec.config:
        spec.config["world_size"] = 2
        spec.traffic["scene_pool"] = 4
    return spec


@pytest.fixture
def cuda_card():
    """Skips a test where no CUDA card is present (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
