"""Shared plumbing of the training drivers (cli/stage1_common.py:39-104 of
the JAX package): the run configuration dump, the STOP file, the common
flags and the scene source.

Not ported: prepared ScanNet scenes (`SceneSource` raises without
`--synthetic`; they wait for data/scannet.py), the stage-1 flags
`--fast_knn` and `--parallel_grouping` (their code paths are not ported),
and the batching, auto-cap and export helpers of the stage-1 drivers."""

from __future__ import annotations

import json
import os
import threading

from seggroup_tpu_torch.data.synthetic import make_synthetic_scene


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
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--tensorboard", action="store_true",
                   help="write tensorboard scalars next to the run log")


class SceneSource:
    """Uniform access to synthetic scenes (prepared ScanNet raises). Safe to
    share between the prefetcher's threads."""

    def __init__(self, args):
        if args.synthetic <= 0:
            raise NotImplementedError("prepared ScanNet scenes wait for the port of "
                                      "data/scannet.py; use --synthetic N")
        self.names = [f"synthetic{i:04d}" for i in range(args.synthetic)]
        self._cache = {}
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.names)

    def get(self, i: int):
        with self._lock:
            if i not in self._cache:
                self._cache[i] = (make_synthetic_scene(seed=i), {})
            return self._cache[i]
