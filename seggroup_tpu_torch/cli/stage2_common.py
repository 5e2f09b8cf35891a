"""Host-side helpers shared by the stage-2 CLIs: copies of the label maps
and the scene conversion of cli/stage2_train_minkunet.py:29-56;
CLASS_NAMES_20 comes from utils/logging.py, its home in the JAX package."""

from __future__ import annotations

import os

import numpy as np

from seggroup_tpu_torch.utils.logging import CLASS_NAMES_20  # noqa: F401 (the CLIs' name for it)

# scannet 20-class training ids from nyu40 (reference minkowski
# lib/datasets/scannet.py VALID_CLASS_IDS / IGNORE_LABELS)
VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
NYU40_TO_20 = np.full(41, 255, np.int32)
for _i, _c in enumerate(VALID_CLASS_IDS):
    NYU40_TO_20[_c] = _i


def scene_to_training_tuple(scene, extras, pseudo_root, name, use_pseudo):
    """coords (N,3) m, colors (N,3) 0..255, labels (N,) 20-class or 255.
    With `use_pseudo`, the labels are the stage-1 layer-2 pseudo labels
    that infer.export_scene writes under pseudo_root/<name>/sem_infer/."""
    pts = np.asarray(scene.points)
    coords = pts[:, :3].astype(np.float32)
    colors = ((pts[:, 3:] + 1.0) * 127.5).astype(np.float32)
    if use_pseudo:
        # exported pseudo labels align to the original mesh vertices; pull
        # them back onto the resampled points via the forward mapping
        path = os.path.join(pseudo_root, name, "sem_infer", "layer_2.sem.txt")
        sem = np.loadtxt(path, dtype=np.int64)
        if "mapping" in extras:
            sem = sem[extras["mapping"]]
        else:
            sem = sem[: len(coords)]
        labels = NYU40_TO_20[np.clip(sem, 0, 40)]
    else:
        sem = np.asarray(scene.real_sem)
        labels = NYU40_TO_20[np.clip(sem, 0, 40)]
    return coords, colors, labels.astype(np.int32)
