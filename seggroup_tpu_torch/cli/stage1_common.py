"""Shared plumbing of the drivers (cli/stage1_common.py of the JAX
package): the run configuration dump, the STOP file, the common flags, the
scene source (prepared npz or synthetic scenes) and the static-budget
buckets of the stage-1 auto caps.

A rank runs one scene at a time, so the JAX side's `stack_scenes` has no
counterpart: `batches` yields the scenes of a step as a list, and
`batch_indices` the indices alone, from which rank d of a data-parallel
run loads its own scene d. The JAX side's `export_scene` is
`infer.export_scene`. `--fast_knn` and `--parallel_grouping` reach the
stage-1 model as `fast_knn=True` and `sequential=False`; `--num_devices`
starts that many ranks (parallel/dp.py `launch`)."""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from seggroup_tpu_torch.data.scannet import ScanNetScenes
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.types import Scene


def dump_config(args, name: str):
    """Persist the run configuration under checkpoints/<exp>/ (the reference
    saves config.json per run, minkowski/main.py:40-43)."""
    d = os.path.join("checkpoints", args.exp_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}.config.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)


def should_stop(exp_name: str) -> bool:
    """Graceful stop: a file checkpoints/<exp>/STOP asks a training loop to
    save and exit."""
    return os.path.exists(os.path.join("checkpoints", exp_name, "STOP"))


def add_common_args(p):
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--data_root", type=str, default="dataset/scannet/prepared")
    p.add_argument("--label_style", type=str, default="manual",
                   choices=["manual", "maxseg", "mainseg", "rand"])
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic scenes instead of prepared ScanNet")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks, one process each (default: every "
                        "visible card, 1 with --device cpu)")
    p.add_argument("--dist_timeout", type=float, default=1800.0,
                   help="seconds a rank waits in a collective before it fails")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--tensorboard", action="store_true",
                   help="write tensorboard scalars next to the run log")
    p.add_argument("--fast_knn", action="store_true",
                   help="the approximate top-k inside the cluster kNN; off the "
                        "TPU XLA computes it exactly, so this selects the "
                        "exact top-k, kept for parity with the JAX driver")
    p.add_argument("--parallel_grouping", action="store_true",
                   help="the parallel-rounds merge engine instead of the "
                        "sequential one")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")


class SceneSource:
    """Uniform access to prepared npz scenes under
    <data_root>/<label_style> or to `--synthetic N` scenes; `get(i)` gives
    (Scene of numpy arrays, host extras). Safe to share between the
    prefetcher's threads."""

    def __init__(self, args):
        self.synthetic = args.synthetic > 0
        if self.synthetic:
            self.names = [f"synthetic{i:04d}" for i in range(args.synthetic)]
            self._cache = {}
            self._lock = threading.Lock()
        else:
            self.ds = ScanNetScenes(os.path.join(args.data_root, args.label_style))
            self.names = self.ds.scene_list

    def __len__(self):
        return len(self.names)

    def get(self, i: int) -> tuple[Scene, dict]:
        if not self.synthetic:
            return self.ds[i]
        with self._lock:
            if i not in self._cache:
                self._cache[i] = (make_synthetic_scene(seed=i), {})
            return self._cache[i]


# Static budgets of the stage-1 auto caps: a scene runs at the smallest
# bucket covering its largest layer-1 segment (cluster_cap) and its largest
# merged cluster (knn_window), so that no budget binds and the labels stay
# the exact path's.
CLUSTER_CAP_BUCKETS = (1024, 2048, 4096, 8192, 16384)
KNN_WINDOW_BUCKETS = (8192, 16384, 32768, 65536, 131072, 262144)


def pick_bucket(size: int, buckets, minimum: int = 0) -> int:
    """Smallest of {minimum} | buckets covering max(size, minimum); the
    largest bucket if none covers. The caller's minimum is a candidate, so
    a small --cluster_cap holds on scenes it covers."""
    need = max(int(size), int(minimum))
    for b in sorted({int(minimum), *buckets}):
        if b >= need:
            return b
    return max(buckets)


def host_max_segment_size(scene: Scene) -> int:
    """Largest layer-1 segment, on the host before the forward: the size
    that makes cluster_cap bind."""
    p2s = np.asarray(scene.point2seg)
    sizes = np.bincount(p2s[p2s < scene.num_slots], minlength=1)
    return int(sizes.max())


def group_scenes_by_cap(source, minimum: int,
                        buckets=CLUSTER_CAP_BUCKETS) -> dict[int, list[int]]:
    """cluster_cap bucket -> indices of the scenes whose largest layer-1
    segment it is the smallest to cover."""
    groups: dict[int, list[int]] = {}
    for i in range(len(source)):
        sc, _ = source.get(i)
        cc = pick_bucket(host_max_segment_size(sc), buckets, minimum)
        groups.setdefault(cc, []).append(i)
    return groups


def batch_indices(order, batch: int):
    """The JAX side's `batches` as indices: for each step, the `batch`
    scene indices order[(i + j) % n] (the tail wraps to the start of
    `order`, so every step is full) and how many of them are real (not
    wrapped)."""
    n = len(order)
    for i in range(0, n, batch):
        yield [int(order[(i + j) % n]) for j in range(batch)], min(batch, n - i)


def batches(source: SceneSource, batch: int, order):
    """Yield (names of the real scenes, scenes, extras) for each step of
    `batch_indices`, the scenes as a list (cli/stage1_common.py `batches`
    of the JAX package stacks them)."""
    for idx, real in batch_indices(order, batch):
        got = [source.get(k) for k in idx]
        yield ([source.names[k] for k in idx[:real]], [sc for sc, _ in got],
               [ex for _, ex in got])
