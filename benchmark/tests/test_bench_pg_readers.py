"""The readers of pg-train-b4's per-layer metrics: each gives None where
the traced window's context lacks its keys (as a program without the
recorder's span or counter leaves it) and its ratio where it holds them;
and benchmark/roofline/pointgroup.py's counts on batches small enough to
count by hand."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.roofline import pointgroup as rl
from benchmark.roofline.peaks import BF16_FLOPS, HBM_BYTES_PER_S

# metric: (its key, its divisor's key)
SPANS = {
    "pg_train.unet_s": ("unet", "count.unet"),
    "pg_train.clustering_s": ("clustering", "count.clustering"),
    "pg_train.scorenet_s": ("scorenet", "count.scorenet"),
    "pg_train.backward_s": ("backward", "count.backward"),
    "pg_train.cc_sweeps": ("count.cc.sweeps", "count.clustering"),
    "pg_train.proposals": ("count.clustering.proposals", "count.clustering"),
}
TRACE = ("pg_train.k4_roofline", "pg_train.mfu")


@pytest.mark.parametrize("name", sorted(SPANS) + list(TRACE))
def test_reader_is_none_without_its_keys(name):
    read = harness.metric_reader(name).read
    assert read({}) is None
    assert read({"phases": {}, "phase_units": 4}) is None
    # the phases a program without the clustering's counters records
    assert read({"phases": {"forward": 1.0, "unet": 2.0, "count.unet": 2} if name not in
                 ("pg_train.unet_s",) else {}, "phase_units": 4}) is None


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_gives_its_ratio(name):
    key, per = SPANS[name]
    phases = {key: 6.0, per: 3}
    assert harness.metric_reader(name).read({"phases": phases, "phase_units": 4}) == 2.0


def test_sweeps_and_proposals_read_zero_where_clustering_found_none():
    phases = {"clustering": 1.0, "count.clustering": 2, "count.clustering.proposals": 0}
    assert harness.metric_reader("pg_train.proposals").read({"phases": phases}) == 0.0
    assert harness.metric_reader("pg_train.cc_sweeps").read({"phases": phases}) == 0.0


def test_trace_readers_give_their_shares():
    tr = {"busy_s": 1.0, "window_s": 4.0, "launches": 10, "kernels": {}}
    ctx = {"trace": tr, "flops": 0.5 * 4.0 * BF16_FLOPS / 100.0, "k4_s": 2e-3,
           "k4_bound_s": 5e-4}
    assert harness.metric_reader("pg_train.mfu").read(ctx) == pytest.approx(0.5)
    assert harness.metric_reader("pg_train.k4_roofline").read(ctx) == pytest.approx(25.0)


def test_level_sizes_by_hand():
    # two neighbouring voxels of one batch, one lone voxel of another: at
    # level 0, 3 voxels and 2 + 2 + 1 present pairs (self included); the
    # first two share their stride-2 cell, so level 1 holds 2 voxels of one
    # pair each, and so on down
    coords = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 1], [1, 4, 4, 4]])
    rows, pairs = rl.level_sizes(coords, (8, 4, 2))
    assert rows == [3, 2, 2] and pairs == [5, 2, 2]
    # a cap of one coarse voxel keeps the first in order
    rows, pairs = rl.level_sizes(coords, (8, 1))
    assert rows == [3, 1] and pairs == [5, 1]


def test_step_flops_by_hand():
    # m 1, 2 levels, 1 block a level, 2 input channels, 3 classes: the stem
    # (2 -> 1), at level 0 a block (1 -> 1, twice), the down conv (1 -> 2),
    # at level 1 a block (2 -> 2, twice), the up conv (2 -> 1), the tail
    # block from the concatenation (2 -> 1, 1 -> 1) and its K = 1 conv
    # (2 -> 1), then the heads (1 -> 3, 1 -> 1, 1 -> 3) per point
    layers = rl.pointgroup_layers(m=1, levels=2, reps=1, in_channels=2, classes=3)
    assert layers == [("stem", 0, 2, 1), ("subm", 0, 1, 1), ("subm", 0, 1, 1),
                      ("down", 0, 1, 2), ("subm", 1, 2, 2), ("subm", 1, 2, 2),
                      ("up", 0, 2, 1), ("subm", 0, 2, 1), ("subm", 0, 1, 1),
                      ("dense", 0, 2, 1), ("point", 0, 1, 3), ("point", 0, 1, 1),
                      ("point", 0, 1, 3)]
    rows, pairs, points = [3, 2], [5, 2], 7
    want = (2 * 5 * 2 * 1 * 2  # stem: forward and weight gradient
            + 3 * 2 * 5 * (1 + 1 + 2 + 1)  # level-0 submanifold convs
            + 3 * 2 * 2 * (4 + 4)  # level-1 submanifold convs
            + 3 * 2 * 3 * (2 + 2 + 2)  # down, up, K = 1 over level 0's voxels
            + 3 * 2 * 7 * (3 + 1 + 3))  # the heads over the points
    got = rl.pointgroup_step_flops(rows, pairs, points, m=1, levels=2, reps=1,
                                   in_channels=2, classes=3)
    assert got == want


def test_k4_sweep_bytes_by_hand():
    # 512 rows: 28 bytes a row, two tiles' 9 lo and 9 hi, 9 offsets
    assert rl.k4_sweep_bytes(512) == 512 * 28 + 2 * 18 * 4 + 36
    assert rl.k4_sweep_least_s(512) == rl.k4_sweep_bytes(512) / HBM_BYTES_PER_S
