"""Label colours (seggroup_tpu/data/visualize.py:17-60, copied: numpy
only): the NYU40 palette, the instance palette and `colorize_labels`. The
mesh recolouring of that module is not ported here."""

from __future__ import annotations

import numpy as np

# nyu40 color palette (index 0 = unlabeled; same table the reference uses,
# dataset/scannet/util.py:24-66 — the standard ScanNet colors)
NYU40_PALETTE = np.array([
    (255, 255, 255), (174, 199, 232), (152, 223, 138), (31, 119, 180),
    (255, 187, 120), (188, 189, 34), (140, 86, 75), (255, 152, 150),
    (214, 39, 40), (197, 176, 213), (148, 103, 189), (196, 156, 148),
    (23, 190, 207), (178, 76, 76), (247, 182, 210), (66, 188, 102),
    (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
    (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82),
    (255, 127, 14), (91, 163, 138), (153, 98, 156), (140, 153, 101),
    (158, 218, 229), (100, 125, 154), (178, 127, 135), (120, 185, 128),
    (146, 111, 194), (44, 160, 44), (112, 128, 144), (96, 207, 209),
    (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
    (100, 85, 144),
], np.uint8)


def _instance_palette(n: int, shuffle: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    hues = np.linspace(0, 1, max(n, 1), endpoint=False)
    if shuffle:
        rng.shuffle(hues)
    h = (hues * 6) % 6
    x = (1 - np.abs(h % 2 - 1))
    rgb = np.zeros((len(h), 3))
    for i, (hh, xx) in enumerate(zip(h, x)):
        k = int(hh)
        rgb[i] = [(1, xx, 0), (xx, 1, 0), (0, 1, xx),
                  (0, xx, 1), (xx, 0, 1), (1, 0, xx)][k % 6]
    return (rgb * 255).astype(np.uint8)


def colorize_labels(labels: np.ndarray, label_type: str = "semantic",
                    shuffle: bool = False) -> np.ndarray:
    """(N,) int labels -> (N, 3) uint8 colors. semantic: nyu40 palette
    (expects 0..40 with 0/-1 = unlabeled); instance/segment: modulo palette."""
    labels = np.asarray(labels)
    if label_type == "semantic":
        idx = np.clip(labels, 0, 40)
        colors = NYU40_PALETTE[idx]
        colors[labels <= 0] = 255
        return colors
    pal = _instance_palette(64, shuffle=shuffle)
    colors = pal[np.maximum(labels, 0) % 64]
    colors[labels < 0] = 255
    return colors
