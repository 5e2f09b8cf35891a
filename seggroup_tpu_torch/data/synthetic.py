"""Synthetic ScanNet-like scenes with exact ground truth, for tests and
benchmarks (the reference has no test fixtures at all; SURVEY.md §4).

Generates a room of axis-aligned "objects" (instances), over-segments each
into contiguous chunks (standing in for the mesh over-segmentation that
seeds the reference's DisjointSet, seggroup/model.py:712-721), builds a
segment adjacency graph from spatial proximity, and produces seg-level weak
labels in the reference's convention (one annotated over-segment per
instance; 0-based, -1 = unlabeled).

A copy of seggroup_tpu/data/synthetic.py: the same seed gives the same
scene. The fields are numpy arrays; `Scene.to(device)` makes tensors."""

from __future__ import annotations

import numpy as np

from seggroup_tpu_torch.types import Scene

# The stage-1 bench scene (bench.py:31-33 of the JAX package): 150,528
# points, the size the reference resamples every ScanNet scene to.
BENCH_SCENE = dict(num_points=150528, num_slots=512, num_edges=4096,
                   num_instances=24, segs_per_instance=12)


def make_synthetic_scene(
    seed: int = 0,
    num_points: int = 4096,
    num_slots: int = 128,
    num_edges: int = 1024,
    num_instances: int = 8,
    segs_per_instance: int = 6,
) -> Scene:
    rng = np.random.default_rng(seed)
    n, s = num_points, num_slots
    n_segs = num_instances * segs_per_instance
    assert n_segs <= s

    inst_centers = rng.uniform(-5, 5, size=(num_instances, 3))
    inst_sem = rng.integers(0, 20, size=num_instances)  # 0-based sem classes

    pts = np.zeros((n, 6), np.float32)
    point2seg = np.zeros(n, np.int32)
    real_sem = np.zeros(n, np.int32)
    real_ins = np.zeros(n, np.int32)
    seg_centers = np.zeros((n_segs, 3), np.float32)
    weak_ins = np.full(s, -1, np.int32)
    weak_sem = np.full(s, -1, np.int32)

    pts_per_seg = n // n_segs
    color = rng.uniform(-1, 1, size=(num_instances, 3)).astype(np.float32)
    k = 0
    for inst in range(num_instances):
        for j in range(segs_per_instance):
            seg = inst * segs_per_instance + j
            c = inst_centers[inst] + rng.normal(scale=0.3, size=3)
            seg_centers[seg] = c
            cnt = pts_per_seg if seg < n_segs - 1 else n - k
            p = c + rng.normal(scale=0.1, size=(cnt, 3))
            pts[k : k + cnt, :3] = p
            pts[k : k + cnt, 3:] = color[inst] + rng.normal(
                scale=0.05, size=(cnt, 3)
            )
            point2seg[k : k + cnt] = seg
            real_sem[k : k + cnt] = inst_sem[inst] + 1  # GT convention 1..40
            real_ins[k : k + cnt] = inst + 1
            k += cnt
        # weak label: annotate one (the first) over-segment per instance
        weak_ins[inst * segs_per_instance] = inst
        weak_sem[inst * segs_per_instance] = inst_sem[inst]

    # adjacency: connect each segment to its 3 nearest segments of the same
    # instance plus 1 nearest overall (gives cross-instance edges too)
    edges = set()
    d = ((seg_centers[:, None] - seg_centers[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    for seg in range(n_segs):
        inst = seg // segs_per_instance
        same = [
            x
            for x in np.argsort(d[seg])
            if x // segs_per_instance == inst
        ][:3]
        near = np.argsort(d[seg])[:1]
        for other in list(same) + list(near):
            edges.add((min(seg, int(other)), max(seg, int(other))))
    edges = sorted(edges)
    e_arr = np.zeros((num_edges, 2), np.int32)
    ev = np.zeros(num_edges, bool)
    e_arr[: len(edges)] = np.array(edges, np.int32)
    ev[: len(edges)] = True

    return Scene(
        points=pts,
        point2seg=point2seg,
        weak_ins=weak_ins,
        weak_sem=weak_sem,
        edges=e_arr,
        edge_valid=ev,
        real_sem=real_sem,
        real_ins=real_ins,
    )
