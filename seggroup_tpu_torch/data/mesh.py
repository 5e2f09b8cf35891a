"""Mesh rasterization for the host preparation (seggroup_tpu/data/mesh.py,
copied: numpy only).

Replaces the reference's `rasterize_mesh` (reference kpconv/utils/mesh.py:
37-123, used by ScannetDataset.prepare_pointcloud_ply at 3 mm,
Scannet.py:174-302): turns a triangle mesh into a dense point cloud by
laying a regular grid of pitch `dl` over each face, so large faces (walls,
floors) contribute interior points instead of only their vertices.

Vectorized re-design: faces are bucketed by their sample budget and each
bucket is rasterized with one barycentric-lattice broadcast (the reference
loops per face in Python). Every face always contributes its 3 vertices, so
`dl` larger than all faces degenerates to the vertex cloud exactly like the
reference's small-face branch (mesh.py:60-66).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rasterize_mesh"]


def _bary_lattice(m: int) -> np.ndarray:
    """Barycentric lattice with m subdivisions per edge: all (i, j) with
    i + j <= m, as (L, 3) weights (i/m, j/m, 1 - i/m - j/m)."""
    ij = np.array([(i, j) for i in range(m + 1) for j in range(m + 1 - i)],
                  np.float64)
    w = np.stack([ij[:, 0], ij[:, 1], m - ij[:, 0] - ij[:, 1]], 1) / m
    return w


def rasterize_mesh(vertices: np.ndarray, faces: np.ndarray, dl: float,
                   features: np.ndarray | None = None,
                   max_subdiv: int = 64):
    """Sample each face on a barycentric lattice of pitch ~dl.

    vertices: (V, 3) float; faces: (F, 3) int; dl: target spacing (m);
    features: optional (V, C) per-vertex attributes, barycentrically
    interpolated onto the samples (the reference re-projects colors/labels
    by nearest vertex; interpolation is exact for colors and reduces to
    nearest-vertex at lattice corners).

    Returns (points (N, 3), feats (N, C) | None, face_id (N,),
    corner (N,)) — `corner` is the barycentric-nearest face corner (0..2),
    so integer per-vertex labels map to samples via
    `labels[faces[face_id, corner]]` (the reference re-projects labels by
    nearest vertex).
    """
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    tri = vertices[faces]  # (F, 3, 3)
    # subdivisions per face: longest edge / dl (reference uses the max side
    # length to pick the grid, mesh.py:70-78)
    e = np.stack([
        np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1),
        np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1),
        np.linalg.norm(tri[:, 0] - tri[:, 2], axis=1),
    ], 1).max(1)
    m = np.clip(np.ceil(e / max(dl, 1e-9)).astype(np.int64), 1, max_subdiv)

    pts_out, feat_out, fid_out = [], [], []
    fvals = None if features is None else np.asarray(features,
                                                     np.float64)[faces]
    corner_out = []
    for mv in np.unique(m):
        sel = np.where(m == mv)[0]
        w = _bary_lattice(int(mv))  # (L, 3)
        p = np.einsum("lk,fkd->fld", w, tri[sel]).reshape(-1, 3)
        pts_out.append(p)
        fid_out.append(np.repeat(sel, len(w)))
        corner_out.append(np.tile(np.argmax(w, 1), len(sel)))
        if fvals is not None:
            feat_out.append(
                np.einsum("lk,fkc->flc", w, fvals[sel]).reshape(
                    -1, fvals.shape[-1]))
    pts = np.concatenate(pts_out).astype(np.float32)
    fid = np.concatenate(fid_out).astype(np.int64)
    corner = np.concatenate(corner_out).astype(np.int64)
    feats = (np.concatenate(feat_out).astype(np.float32)
             if fvals is not None else None)
    return pts, feats, fid, corner
