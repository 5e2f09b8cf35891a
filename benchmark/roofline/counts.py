"""Operations and bytes of the benchmark's cells, counted from the inputs the
benchmark made (scene sizes, a batch's voxel coordinates) with the
benchmark's own hashing (benchmark/reference/res16unet.py), never from the
program's rulebooks or plans.

Res16UNet34C (Choy et al. 2019): a submanifold conv costs 2 * Cin * Cout
operations for each present (voxel, neighbour) pair, self included, in the
forward, as many again for the data gradient (not at the stem, whose input
needs none) and for the weight gradient. A stride-2 down or up conv, a 1x1
residual projection and the classifier cost 2 * Cin * Cout for each fine
voxel, three times over in a train step. Bytes count each input byte read
once and each output byte written once: bfloat16 operands, int32 neighbour
indices (one a present pair), float32 outputs and weight gradients."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.roofline.peaks import least_seconds

PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
INIT_DIM = 32


def res16unet34c_layers(in_channels: int = 3, out_channels: int = 20):
    """The network's layers: (kind, level, Cin, Cout) with kind "stem",
    "subm", "down", "up" or "dense" (1x1 projections and the classifier)."""
    out = [("stem", 0, in_channels, INIT_DIM)]
    cur, skip = INIT_DIM, [INIT_DIM]

    def blocks(level, cin, planes, n):
        for i in range(n):
            c = cin if i == 0 else planes
            out.append(("subm", level, c, planes))
            out.append(("subm", level, planes, planes))
            if c != planes:
                out.append(("dense", level, c, planes))
        return planes

    for lvl in range(4):
        out.append(("down", lvl, cur, cur))
        cur = blocks(lvl + 1, cur, PLANES[lvl], LAYERS[lvl])
        skip.append(cur)
    for lvl in range(4):
        up = PLANES[4 + lvl]
        out.append(("up", 3 - lvl, cur, up))
        cur = blocks(3 - lvl, up + skip[3 - lvl], up, LAYERS[4 + lvl])
    out.append(("dense", 0, cur, out_channels))
    return out


def level_sizes(coords: torch.Tensor, caps) -> tuple[list[int], list[int]]:
    """(voxels, present neighbour pairs) at each of the five levels of a
    batch's valid voxel coordinates (n, 4)."""
    from benchmark.reference.res16unet import down_map, neighbour_table

    rows, pairs = [], []
    c = coords
    for lvl in range(5):
        nbr = neighbour_table(c)
        rows.append(int(c.shape[0]))
        pairs.append(int((nbr < c.shape[0]).sum()))
        if lvl < 4:
            c = down_map(c, caps[lvl])[0]
    return rows, pairs


def res16unet34c_step(rows, pairs) -> dict:
    """A train step's operations (all layers), and K2's and K3's least
    seconds summed over their calls: K2 runs each submanifold conv's forward
    and data gradient, K3 its weight gradient."""
    flops = k2_s = k3_s = 0.0
    for kind, lvl, cin, cout in res16unet34c_layers():
        if kind in ("stem", "subm"):
            n, p = rows[lvl], pairs[lvl]
            f = 2.0 * p * cin * cout
            fwd_b = n * cin * 2 + 27 * cin * cout * 2 + p * 4 + n * cout * 4
            k2_s += least_seconds(f, fwd_b)
            if kind == "subm":
                k2_s += least_seconds(f, n * cout * 2 + 27 * cin * cout * 2 + p * 4
                                      + n * cin * 4)
            k3_s += least_seconds(f, n * cin * 2 + n * cout * 2 + p * 4 + 27 * cin * cout * 4)
            flops += f * (3 if kind == "subm" else 2)
        else:
            fine = rows[lvl]
            flops += 3 * 2.0 * fine * cin * cout
    return {"flops": flops, "k2_bound_s": k2_s, "k3_bound_s": k3_s}


def stage1_forward_flops(n_points: int, n_segments: int, cluster_sizes, knn_k: int,
                         knn_window: int, mlp1_points: int) -> float:
    """Dense operations of one stage-1 forward: MLP1's kNN distance products
    and 6->64 projection over every segment's cloud, the two edge convs
    (18->64; 18->64->64) over every point's k neighbours, the GCNs' row-
    normalised products over the segment graph and their projections
    (192, 256 wide), and the per-cluster kNN's distance products of the two
    semantic layers (each point against the members of its cluster within
    the candidate window). `cluster_sizes` holds the two layers' cluster
    sizes."""
    s, p = n_segments, mlp1_points
    f = s * p * p * 2 * 3 + s * p * 10 * 2 * 6 * 64
    f += n_points * knn_k * 2 * 18 * 64
    f += n_points * knn_k * (2 * 18 * 64 + 2 * 64 * 64)
    f += 2 * s * s * 192 + 2 * s * 192 * 192 + 2 * s * s * 256 + 2 * s * 256 * 256
    for sizes in cluster_sizes:
        sizes = np.asarray(sizes, np.float64)
        f += float(np.sum(sizes * np.minimum(sizes, knn_window))) * 2 * 3
    return float(f)
