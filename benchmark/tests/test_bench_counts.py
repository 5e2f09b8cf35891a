"""The roofline counts against counts made by hand at tiny sizes."""

from __future__ import annotations

import math

import torch

from benchmark.reference.res16unet import Res16UNet34C
from benchmark.roofline import counts, peaks


def test_level_sizes_by_hand():
    coords = torch.tensor([[0, 0, 0, 0], [0, 1, 0, 0], [0, 5, 5, 5], [1, 0, 0, 0]])
    rows, pairs = counts.level_sizes(coords, [8, 8, 8, 8])
    # level 0: four voxels, the first two adjacent; the batch column keeps
    # the fourth apart from the first
    assert rows == [4, 3, 3, 2, 2]
    assert pairs == [6, 3, 5, 2, 2]


def test_level_sizes_keep_at_most_the_cap():
    coords = torch.tensor([[0, 0, 0, 0], [0, 4, 0, 0], [0, 8, 0, 0]])
    rows, _ = counts.level_sizes(coords, [2, 2, 2, 2])
    assert rows == [3, 2, 2, 1, 1]


def test_layer_list_matches_the_reference_network():
    layers = counts.res16unet34c_layers()
    kinds = [k for k, *_ in layers]
    assert kinds.count("stem") + kinds.count("subm") == 47
    assert kinds.count("down") == kinds.count("up") == 4
    net = Res16UNet34C()
    # with one voxel and one pair at every level, every layer costs 2 * Cin
    # * Cout per pass: three passes, the stem two
    want = 0.0
    for name, p in net.named_parameters():
        if p.ndim == 3:
            passes = 2 if name == "conv0.kernel" else 3
            want += passes * 2.0 * p.shape[1] * p.shape[2]
        elif p.ndim == 2:
            want += 3 * 2.0 * p.shape[0] * p.shape[1]
    got = counts.res16unet34c_step([1] * 5, [1] * 5)
    assert math.isclose(got["flops"], want)


def test_k2_and_k3_bounds_by_hand():
    one = [(k, lvl, ci, co) for k, lvl, ci, co in counts.res16unet34c_layers()
           if k == "stem"]
    assert one == [("stem", 0, 3, 32)]
    rows, pairs = [10, 0, 0, 0, 0], [30, 0, 0, 0, 0]
    got = counts.res16unet34c_step(rows, pairs)
    flops = 2.0 * 30 * 3 * 32
    stem_k2 = max(flops / peaks.BF16_FLOPS,
                  (10 * 3 * 2 + 27 * 3 * 32 * 2 + 30 * 4 + 10 * 32 * 4) / peaks.HBM_BYTES_PER_S)
    assert got["k2_bound_s"] >= stem_k2
    assert math.isclose(peaks.least_seconds(989e12, 0), 1.0)
    assert math.isclose(peaks.least_seconds(0, 3.35e12), 1.0)


def test_stage1_forward_flops_by_hand():
    got = counts.stage1_forward_flops(n_points=2, n_segments=1, cluster_sizes=[[2], [3]],
                                      knn_k=1, knn_window=2, mlp1_points=1)
    want = (1 * 1 * 1 * 2 * 3 + 1 * 1 * 10 * 2 * 6 * 64
            + 2 * 1 * 2 * 18 * 64 + 2 * 1 * (2 * 18 * 64 + 2 * 64 * 64)
            + 2 * 192 + 2 * 192 * 192 + 2 * 256 + 2 * 256 * 256
            + (2 * 2 + 3 * 2) * 2 * 3)
    assert got == want
