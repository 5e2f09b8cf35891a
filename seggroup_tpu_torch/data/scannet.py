"""Prepared ScanNet scenes on disk (the reader half of
seggroup_tpu/data/scannet.py:359-389): one compressed .npz per scene
holding the `Scene` fields and host-side extras (`unmap`, `mapping`,
`real_sem_raw`, `real_ins_raw`).

The preparation from raw ScanNet (`prepare_scene`, `read_scene_raw`,
data/ply.py) is not ported."""

from __future__ import annotations

import os

import numpy as np

from seggroup_tpu_torch.types import Scene

SCENE_KEYS = Scene._fields


def save_scene_npz(path: str, prepared: dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **prepared)


def load_scene_npz(path: str) -> tuple[Scene, dict[str, np.ndarray]]:
    """(Scene of numpy arrays, extras) of one prepared scene."""
    z = np.load(path)
    scene = Scene(*(z[k] for k in SCENE_KEYS))
    extras = {k: z[k] for k in z.files if k not in SCENE_KEYS}
    return scene, extras


class ScanNetScenes:
    """The prepared scenes under `root`, one .npz each, in name order (the
    reference's ScanNet Dataset, seggroup/data.py:18-41)."""

    def __init__(self, root: str, scene_list: list[str] | None = None):
        self.root = root
        if scene_list is None:
            scene_list = sorted(f[:-4] for f in os.listdir(root) if f.endswith(".npz"))
        self.scene_list = scene_list

    def __len__(self):
        return len(self.scene_list)

    def __getitem__(self, i: int) -> tuple[Scene, dict[str, np.ndarray]]:
        return load_scene_npz(os.path.join(self.root, self.scene_list[i] + ".npz"))
