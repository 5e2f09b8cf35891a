"""The benchmark's scenes: synthetic ScanNet-like rooms from a seed, the one
generator every traffic mix reads (its `scene` parameters: points, segment
slots, edge slots, instances and segments per instance).

A room of axis-aligned objects (instances), each over-segmented into
contiguous chunks standing in for the mesh over-segmentation, a segment
adjacency graph from spatial proximity, and weak labels in the reference's
convention (one annotated segment per instance; 0-based, -1 unlabelled).
The same seed gives the same scene, field for field, as the port's own
synthetic generator (seggroup_tpu_torch/data/synthetic.py), of which this
is a copy: the benchmark makes its inputs itself."""

from __future__ import annotations

import numpy as np

FIELDS = ("points", "point2seg", "weak_ins", "weak_sem", "edges", "edge_valid", "real_sem",
          "real_ins")


def make_scene(seed: int, num_points: int, num_slots: int, num_edges: int,
               num_instances: int, segs_per_instance: int) -> dict:
    """One scene as numpy arrays under FIELDS."""
    rng = np.random.default_rng(seed)
    n, s = num_points, num_slots
    n_segs = num_instances * segs_per_instance
    if n_segs > s:
        raise ValueError(f"{n_segs} segments do not fit {s} slots")
    inst_centers = rng.uniform(-5, 5, size=(num_instances, 3))
    inst_sem = rng.integers(0, 20, size=num_instances)
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
            pts[k:k + cnt, :3] = c + rng.normal(scale=0.1, size=(cnt, 3))
            pts[k:k + cnt, 3:] = color[inst] + rng.normal(scale=0.05, size=(cnt, 3))
            point2seg[k:k + cnt] = seg
            real_sem[k:k + cnt] = inst_sem[inst] + 1
            real_ins[k:k + cnt] = inst + 1
            k += cnt
        weak_ins[inst * segs_per_instance] = inst
        weak_sem[inst * segs_per_instance] = inst_sem[inst]
    edges = set()
    d = ((seg_centers[:, None] - seg_centers[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    for seg in range(n_segs):
        inst = seg // segs_per_instance
        same = [x for x in np.argsort(d[seg]) if x // segs_per_instance == inst][:3]
        for other in list(same) + list(np.argsort(d[seg])[:1]):
            edges.add((min(seg, int(other)), max(seg, int(other))))
    edges = sorted(edges)
    e_arr = np.zeros((num_edges, 2), np.int32)
    ev = np.zeros(num_edges, bool)
    e_arr[:len(edges)] = np.array(edges, np.int32)
    ev[:len(edges)] = True
    return dict(points=pts, point2seg=point2seg, weak_ins=weak_ins, weak_sem=weak_sem,
                edges=e_arr, edge_valid=ev, real_sem=real_sem, real_ins=real_ins)


def scene_pool(seed: int, size: int, shape: dict) -> list[dict]:
    """`size` scenes of one shape, each from its own seed drawn from `seed`."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(size)
    return [make_scene(int(s), **shape) for s in seeds]


class TensorScene(dict):
    """A scene's fields as tensors, read as attributes (scene.points), as
    the plain references take them."""

    __getattr__ = dict.__getitem__


def to_tensors(scene: dict, device) -> TensorScene:
    import torch

    return TensorScene({f: torch.as_tensor(scene[f]).to(device) for f in FIELDS})
