"""Label colours and mesh recolouring (seggroup_tpu/data/visualize.py,
copied: numpy only): the NYU40 palette, the instance palette,
`colorize_labels`, and the PLY writers of the reference's label views
(seggroup/dataset/scannet/util.py:431-527, pointgroup/util/visualize.py):
`visualize_labels`, `colorize_grouping`, `visualize_grouping_process`,
`write_point_cloud`."""

from __future__ import annotations

import numpy as np

from seggroup_tpu_torch.data.ply import read_ply, write_ply

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


def visualize_labels(mesh_path: str, labels: np.ndarray, out_path: str,
                     label_type: str = "semantic", shuffle: bool = False):
    """Recolor a ScanNet mesh PLY by per-vertex labels and write `out_path`
    (reference visualize_labels, util.py:431-486)."""
    ply = read_ply(mesh_path)
    v = ply["vertex"]
    colors = colorize_labels(labels, label_type, shuffle)
    write_ply(out_path, {
        "x": v["x"], "y": v["y"], "z": v["z"],
        "red": colors[:, 0], "green": colors[:, 1], "blue": colors[:, 2],
    }, faces=ply.get("face"))


def colorize_grouping(ins_labels: np.ndarray, seg_labels: np.ndarray,
                      shuffle: bool = True, seed: int = 0) -> np.ndarray:
    """Merge-progress coloring (reference visualize_grouping_process,
    dataset/scannet/util.py:489-527): vertices already absorbed into an
    instance (ins != -1) take that instance's color; still-ungrouped
    vertices take their over-segment's color. Across layers, the mesh
    visibly 'fills in' with instance colors as merges progress."""
    ins_labels = np.asarray(ins_labels)
    seg_labels = np.asarray(seg_labels)
    ins_ids = np.unique(ins_labels)
    ins_ids = ins_ids[ins_ids >= 0]
    rank = np.full(int(ins_ids.max()) + 2 if len(ins_ids) else 1, 0,
                   np.int64)
    for r, iid in enumerate(ins_ids):
        rank[iid] = r
    ins_pal = _instance_palette(max(len(ins_ids), 1), shuffle=False)
    seg_pal = _instance_palette(64, shuffle=shuffle, seed=seed)
    colors = seg_pal[np.maximum(seg_labels, 0) % 64]
    grouped = ins_labels >= 0
    colors[grouped] = ins_pal[rank[ins_labels[grouped]] % len(ins_pal)]
    colors[(~grouped) & (seg_labels < 0)] = 255
    return colors


def visualize_grouping_process(mesh_path: str, ins_labels: np.ndarray,
                               seg_labels: np.ndarray, out_path: str,
                               shuffle: bool = True, seed: int = 0):
    """Recolor a mesh by grouping progress and write `out_path` (reference
    visualize_grouping_process, util.py:489-527)."""
    ply = read_ply(mesh_path)
    v = ply["vertex"]
    colors = colorize_grouping(ins_labels, seg_labels, shuffle, seed)
    write_ply(out_path, {
        "x": v["x"], "y": v["y"], "z": v["z"],
        "red": colors[:, 0], "green": colors[:, 1], "blue": colors[:, 2],
    }, faces=ply.get("face"))


def write_point_cloud(out_path: str, points: np.ndarray,
                      labels: np.ndarray | None = None,
                      label_type: str = "semantic"):
    """Write an (N, 3/6) point cloud as PLY, optionally colored by labels
    (pointgroup/util/visualize.py analog)."""
    if labels is not None:
        colors = colorize_labels(labels, label_type)
    elif points.shape[1] >= 6:
        colors = ((points[:, 3:6] + 1) * 127.5).astype(np.uint8)
    else:
        colors = np.full((len(points), 3), 160, np.uint8)
    write_ply(out_path, {
        "x": points[:, 0].astype(np.float32),
        "y": points[:, 1].astype(np.float32),
        "z": points[:, 2].astype(np.float32),
        "red": colors[:, 0], "green": colors[:, 1], "blue": colors[:, 2],
    })
