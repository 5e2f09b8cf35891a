"""Operations of a PointGroup train step and the least seconds of a K4
sweep (the pg-train-b4 cell), counted from a batch's own voxel coordinates
and sizes with the benchmark's hashing (benchmark/reference/res16unet.py),
never from the program's plans.

PointGroup (Jiang et al. 2020) at m: a 3^3 submanifold stem from the
voxel features to m, a U-Net of `levels` levels of widths m * (i + 1), each
level `reps` pre-activation blocks (two submanifold convs) and, above the
coarsest, a stride-2 down conv, the level below, a stride-2 up conv and
`reps` tail blocks, the first from the concatenation (2 * width) with a
K = 1 conv beside it; then per point the semantic head (m -> classes) and
the offset head (m -> m -> 3). A submanifold conv costs 2 * Cin * Cout
operations for each present (voxel, neighbour) pair, self included, in the
forward, as many again for the data gradient (not at the stem, whose input
needs none) and for the weight gradient; a K = 1 conv, a stride-2 conv and
a head's dense layer cost 2 * Cin * Cout for each fine voxel or point,
three times over in a train step. The ScoreNet runs over the proposals'
voxels, which the batch alone does not give: it is left out, so a share of
a peak from these counts is a lower bound.

K4 (csrc/cc_sweep.cu), one label-min sweep over the doubled point set,
2 * the batch's valid points (the rows past them need no work): it must
read each row once (xyz 12 B, class, key and label 4 B each), write one
label (4 B), and read the two range tables (9 int32 a tile of 256 rows
each); its pair tests are under a microsecond of operations at any density
here, so the bytes bound it."""

from __future__ import annotations

import torch

from benchmark.roofline.peaks import least_seconds

K4_TILE = 256


def pointgroup_layers(m: int = 16, levels: int = 7, reps: int = 2, in_channels: int = 6,
                      classes: int = 20):
    """The network's layers: (kind, level, Cin, Cout), kind "stem", "subm",
    "dense" (K = 1 convs), "down", "up" or "point" (the heads)."""
    out = [("stem", 0, in_channels, m)]

    def ublock(lvl):
        c = m * (lvl + 1)
        for _ in range(reps):
            out.extend([("subm", lvl, c, c), ("subm", lvl, c, c)])
        if lvl + 1 < levels:
            out.append(("down", lvl, c, m * (lvl + 2)))
            ublock(lvl + 1)
            out.append(("up", lvl, m * (lvl + 2), c))
            for i in range(reps):
                cin = 2 * c if i == 0 else c
                out.extend([("subm", lvl, cin, c), ("subm", lvl, c, c)])
                if cin != c:
                    out.append(("dense", lvl, cin, c))

    ublock(0)
    out.extend([("point", 0, m, classes), ("point", 0, m, m), ("point", 0, m, 3)])
    return out


def level_sizes(coords: torch.Tensor, caps) -> tuple[list[int], list[int]]:
    """(voxels, present neighbour pairs) at each level of a batch's valid
    voxel coordinates (n, 4), each level capped as `caps` give."""
    from benchmark.reference.res16unet import down_map, neighbour_table

    rows, pairs = [], []
    c = coords
    for lvl in range(len(caps)):
        nbr = neighbour_table(c)
        rows.append(int(c.shape[0]))
        pairs.append(int((nbr < c.shape[0]).sum()))
        if lvl + 1 < len(caps):
            c = down_map(c, caps[lvl + 1])[0]
    return rows, pairs


def pointgroup_step_flops(rows, pairs, points: int, **layers) -> float:
    """A train step's operations over the U-Net and the heads."""
    flops = 0.0
    for kind, lvl, cin, cout in pointgroup_layers(**layers):
        if kind in ("stem", "subm"):
            flops += 2.0 * pairs[lvl] * cin * cout * (2 if kind == "stem" else 3)
        else:
            n = points if kind == "point" else rows[lvl]
            flops += 3 * 2.0 * n * cin * cout
    return flops


def k4_sweep_bytes(rows: int, tile: int = K4_TILE) -> int:
    """Bytes one K4 sweep must move over `rows` rows."""
    return rows * (12 + 4 + 4 + 4 + 4) + (rows // tile) * 9 * 2 * 4 + 9 * 4


def k4_sweep_least_s(rows: int) -> float:
    return least_seconds(0.0, k4_sweep_bytes(rows))
