"""ScanNet-v2 data layer (seggroup_tpu/data/scannet.py): raw scans ->
fixed-shape scene arrays -> one compressed .npz per scene, and the reader
of those files. Numpy only, with the reference's semantics (reference
seggroup/dataset/scannet/prepare_data.py + util.py):

  * every scene resampled to a fixed point count by whole-cloud repetition
    and a random remainder (util.py:669-681), with the inverse `unmap`
    (the nearest resampled point of each original vertex, util.py:538-550;
    native.nearest_neighbor_map);
  * colours normalised to [-1, 1] by /127.5 - 1 (util.py:656);
  * real labels from segs.json + aggregation.json + the scannetv2 TSV
    mapper (util.py:129-170): sem 1..40, ins 1..K, 0 = unannotated;
  * weak segment-level labels in 4 styles (manual, maxseg, mainseg, rand;
    util.py:268-427), each instance's disconnected parts of at least 100
    points annotated on their own (util.py:355-381);
  * the segment adjacency of shared mesh-face edges (util.py:224-244);

all padded to static budgets (N points, S segments, E edges). A prepared
file holds the `Scene` fields and host-side extras (`unmap`, `mapping`,
`real_sem_raw`, `real_ins_raw`)."""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass

import numpy as np

from seggroup_tpu_torch import native
from seggroup_tpu_torch.data.ply import read_ply
from seggroup_tpu_torch.types import Scene


@dataclass(frozen=True)
class PrepConfig:
    num_points: int = 150528   # 150k rounded up to a multiple of 1024
    max_segments: int = 1024
    max_edges: int = 8192
    num_instances_cap: int = 128


# ---------------------------------------------------------------------------
# raw readers
# ---------------------------------------------------------------------------


def read_label_mapper(tsv_path: str, label_from: str = "raw_category",
                      label_to: str = "nyu40id") -> dict[str, int]:
    """(reference util.py:103-109)"""
    mapper = {}
    with open(tsv_path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapper[row[label_from]] = int(row[label_to])
    return mapper


def load_aggregation(agg_path: str, mapper: dict[str, int]):
    """segment id -> (instance id 1.., nyu40 class) (reference util.py:112-125)"""
    with open(agg_path) as f:
        agg = json.load(f)
    seg2ins, seg2sem = {}, {}
    for grp in agg["segGroups"]:
        for seg in grp["segments"]:
            seg2ins[seg] = grp["objectId"] + 1
            seg2sem[seg] = mapper[grp["label"]]
    return seg2ins, seg2sem


def read_scene_raw(scans_dir: str, scene: str, tsv_path: str | None = None):
    """Returns dict with vertices (V,6), faces (F,3), seg_labels (V,) raw seg
    ids, real_sem (V,), real_ins (V,)."""
    mesh_path = os.path.join(scans_dir, scene, f"{scene}_vh_clean_2.ply")
    segs_path = os.path.join(scans_dir, scene, f"{scene}_vh_clean_2.0.010000.segs.json")
    agg_path = os.path.join(scans_dir, scene, f"{scene}.aggregation.json")
    if tsv_path is None:
        tsv_path = os.path.join(scans_dir, "..", "scannetv2-labels.combined.tsv")

    ply = read_ply(mesh_path)
    v = ply["vertex"]
    verts = np.stack(
        [v["x"], v["y"], v["z"],
         v["red"].astype(np.float32), v["green"].astype(np.float32),
         v["blue"].astype(np.float32)], axis=1
    ).astype(np.float32)
    faces = ply["face"]
    with open(segs_path) as f:
        seg_labels = np.array(json.load(f)["segIndices"], np.int64)

    # scene0217_00 ships duplicated vertices (reference util.py:120 special-case)
    if scene == "scene0217_00" and seg_labels.shape[0] == 2 * len(verts):
        seg_labels = seg_labels[: len(verts)]

    mapper = read_label_mapper(tsv_path)
    seg2ins, seg2sem = load_aggregation(agg_path, mapper)
    real_ins = np.array([seg2ins.get(s, 0) for s in seg_labels], np.int32)
    real_sem = np.array([seg2sem.get(s, 0) for s in seg_labels], np.int32)
    return dict(vertices=verts, faces=faces, seg_labels=seg_labels,
                real_sem=real_sem, real_ins=real_ins)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


def resample_map(num_verts: int, num_points: int, rng: np.random.Generator):
    """Whole-cloud repeats + random remainder (reference util.py:669-681)."""
    rep = num_points // num_verts
    rem = num_points % num_verts
    parts = [np.tile(np.arange(num_verts), rep)]
    if rem:
        parts.append(rng.permutation(num_verts)[:rem])
    return np.concatenate(parts).astype(np.int32) if rep else \
        rng.permutation(num_verts)[:num_points].astype(np.int32)


def compute_unmap(verts: np.ndarray, mapping: np.ndarray, chunk: int = 100_000):
    """Original vertex -> nearest resampled point (reference util.py:538-550).
    When every vertex appears in the resample (rep >= 1) this is the identity
    into the first copy; otherwise grid-accelerated NN (native C++ when
    available, csrc/nearest_neighbor_map)."""
    num_verts = len(verts)
    if len(mapping) >= num_verts and (mapping[:num_verts] == np.arange(num_verts)).all():
        return np.arange(num_verts, dtype=np.int32)
    return native.nearest_neighbor_map(verts[:, :3], verts[mapping, :3])


# ---------------------------------------------------------------------------
# adjacency + weak labels
# ---------------------------------------------------------------------------


def segment_adjacency(faces: np.ndarray, point2seg: np.ndarray) -> np.ndarray:
    """Unique segment pairs sharing a mesh edge (reference util.py:224-244,
    vectorized instead of the per-face python loop)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [0, 2]], faces[:, [1, 2]]])
    s = point2seg[e]
    s = s[s[:, 0] != s[:, 1]]
    lo = np.minimum(s[:, 0], s[:, 1])
    hi = np.maximum(s[:, 0], s[:, 1])
    return np.unique(np.stack([lo, hi], 1), axis=0).astype(np.int32)


def _connected_components(nodes: np.ndarray, edges: np.ndarray) -> list[list[int]]:
    """CC over the node subset (reference group_adjacency_segs,
    util.py:252-265)."""
    idx = {n: i for i, n in enumerate(nodes)}
    parent = list(range(len(nodes)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    node_set = set(nodes.tolist())
    for a, b in edges:
        if a in node_set and b in node_set:
            ra, rb = find(idx[a]), find(idx[b])
            if ra != rb:
                parent[ra] = rb
    comps: dict[int, list[int]] = {}
    for n in nodes:
        comps.setdefault(find(idx[n]), []).append(int(n))
    return list(comps.values())


def generate_weak_seg_ids(
    seg_labels: np.ndarray,
    real_ins: np.ndarray,
    adjacency: np.ndarray,
    style: str = "maxseg",
    manual: dict | None = None,
    main_num: int = -1,
    anno_num: int = 1,
    rng: np.random.Generator | None = None,
    min_component_points: int = 100,
) -> list[int]:
    """Choose the annotated over-segments (reference generate_weak_labels,
    util.py:268-427). Styles:
      manual  — segment ids straight from the annotator JSON {ins: [seg,..]}
      maxseg  — top-anno_num segments by point count per component
      rand    — uniformly random segment per component
      mainseg — point-count-weighted random among the top main_num segments
    Each instance's disconnected components >= min_component_points are
    annotated separately."""
    if style == "manual":
        assert manual is not None
        return [int(s) for segs in manual.values() for s in segs]
    rng = rng or np.random.default_rng(0)
    chosen: list[int] = []

    def pick(segs_sorted: np.ndarray, counts_sorted: np.ndarray):
        if style == "maxseg":
            for i in range(min(anno_num, len(segs_sorted))):
                chosen.append(int(segs_sorted[i]))
        elif style == "rand":
            chosen.append(int(segs_sorted[rng.integers(0, len(segs_sorted))]))
        elif style == "mainseg":
            top = segs_sorted[:main_num] if main_num != -1 else segs_sorted
            cnts = counts_sorted[: len(top)]
            for _ in range(min(anno_num, len(top))):
                for _try in range(1000):
                    r = rng.integers(0, cnts.sum())
                    j = int(np.searchsorted(np.cumsum(cnts), r, side="right"))
                    if int(top[j]) not in chosen:
                        chosen.append(int(top[j]))
                        break
        else:
            raise ValueError(style)

    for ins in np.unique(real_ins):
        if ins == 0:
            continue
        segs = np.unique(seg_labels[real_ins == ins])
        comps = _connected_components(segs, adjacency)
        sizes = []
        per_comp = []
        for comp in comps:
            cnt = np.array([(seg_labels == s).sum() for s in comp])
            order = np.argsort(-cnt)
            per_comp.append((np.array(comp)[order], cnt[order]))
            sizes.append(cnt.sum())
        main = int(np.argmax(sizes))
        pick(*per_comp[main])
        for j, comp in enumerate(comps):
            if j == main or sizes[j] < min_component_points:
                continue
            pick(*per_comp[j])
    return chosen


# ---------------------------------------------------------------------------
# scene assembly
# ---------------------------------------------------------------------------


def prepare_scene(
    raw: dict,
    cfg: PrepConfig = PrepConfig(),
    style: str = "maxseg",
    manual: dict | None = None,
    seed: int = 0,
    **weak_kw,
) -> dict[str, np.ndarray]:
    """raw (from read_scene_raw) -> fixed-shape arrays + host-side extras
    (unmap, original-resolution labels) for export/eval."""
    rng = np.random.default_rng(seed)
    verts = raw["vertices"]
    v = len(verts)
    # rasterized clouds (data/mesh.py) carry per-point arrays while `faces`
    # still indexes the ORIGINAL mesh vertices; adjacency is a segment-level
    # property, so it is built from the per-mesh-vertex seg ids when present
    mesh_seg = raw.get("seg_labels_mesh", raw["seg_labels"])

    mapping = resample_map(v, cfg.num_points, rng)
    unmap = compute_unmap(verts, mapping)

    pts = verts[mapping].copy()
    pts[:, 3:] = pts[:, 3:] / 127.5 - 1.0

    # compact segment ids, largest-first so budget overflow drops the smallest
    raw_seg = raw["seg_labels"]
    uniq, counts = np.unique(raw_seg, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    uniq_sorted = uniq[order]
    compact_of = {int(s): i for i, s in enumerate(uniq_sorted)}
    seg_compact_v = np.array([compact_of[int(s)] for s in raw_seg], np.int32)

    n_seg = len(uniq)
    if n_seg > cfg.max_segments:
        # fold overflow segments into an adjacent kept segment (nearest
        # centroid fallback) so no point is dropped
        seg_compact_mesh = np.array(
            [compact_of.get(int(s), 0) for s in mesh_seg], np.int32)
        adj_raw = segment_adjacency(raw["faces"], seg_compact_mesh)
        keep = cfg.max_segments
        centroid = np.zeros((n_seg, 3))
        for sidx in range(n_seg):
            centroid[sidx] = verts[seg_compact_v == sidx, :3].mean(0)
        remap = np.arange(n_seg)
        nbrs: dict[int, list[int]] = {}
        for a, b in adj_raw:
            nbrs.setdefault(int(a), []).append(int(b))
            nbrs.setdefault(int(b), []).append(int(a))
        for sidx in range(keep, n_seg):
            cands = [x for x in nbrs.get(sidx, []) if x < keep]
            if cands:
                d = ((centroid[cands] - centroid[sidx]) ** 2).sum(-1)
                remap[sidx] = cands[int(np.argmin(d))]
            else:
                d = ((centroid[:keep] - centroid[sidx]) ** 2).sum(-1)
                remap[sidx] = int(np.argmin(d))
        seg_compact_v = remap[seg_compact_v].astype(np.int32)
        n_seg = keep

    point2seg_v = seg_compact_v  # per original vertex
    point2seg = point2seg_v[mapping]

    # adjacency over compact ids (from the mesh-vertex seg ids; identical to
    # point2seg_v when the cloud is the raw vertex cloud)
    seg_compact_mesh2 = np.array(
        [compact_of.get(int(s), 0) for s in mesh_seg], np.int32)
    if n_seg < len(uniq):  # overflow fold applied above
        seg_compact_mesh2 = remap[seg_compact_mesh2].astype(np.int32)
    adj = segment_adjacency(raw["faces"], seg_compact_mesh2)
    adj = adj[(adj[:, 0] < n_seg) & (adj[:, 1] < n_seg)]
    if len(adj) > cfg.max_edges:
        adj = adj[: cfg.max_edges]
    e_arr = np.zeros((cfg.max_edges, 2), np.int32)
    ev = np.zeros(cfg.max_edges, bool)
    e_arr[: len(adj)] = adj
    ev[: len(adj)] = True

    # weak labels: choose segments, label them with GT ins/sem, 0-based / -1
    chosen_raw = generate_weak_seg_ids(
        raw_seg, raw["real_ins"], segment_adjacency(raw["faces"], mesh_seg)
        if style != "manual" else np.zeros((0, 2), np.int32),
        style=style, manual=manual, rng=rng, **weak_kw,
    )
    weak_ins = np.full(cfg.max_segments, -1, np.int32)
    weak_sem = np.full(cfg.max_segments, -1, np.int32)
    for rs in chosen_raw:
        if int(rs) not in compact_of:
            continue
        cidx = compact_of[int(rs)]
        if cidx >= n_seg:
            continue
        sel = seg_compact_v == cidx
        ins_vals = raw["real_ins"][sel]
        sem_vals = raw["real_sem"][sel]
        ins_mode = np.bincount(ins_vals[ins_vals > 0]).argmax() if (ins_vals > 0).any() else 0
        sem_mode = np.bincount(sem_vals[sem_vals > 0]).argmax() if (sem_vals > 0).any() else 0
        if ins_mode > 0:
            weak_ins[cidx] = ins_mode - 1   # 0-based (util.py:741-744)
            weak_sem[cidx] = sem_mode - 1

    return dict(
        points=pts.astype(np.float32),
        point2seg=point2seg.astype(np.int32),
        weak_ins=weak_ins,
        weak_sem=weak_sem,
        edges=e_arr,
        edge_valid=ev,
        real_sem=raw["real_sem"][mapping].astype(np.int32),
        real_ins=raw["real_ins"][mapping].astype(np.int32),
        # host-side extras
        unmap=unmap.astype(np.int32),
        mapping=mapping.astype(np.int32),  # resampled -> original vertex
        real_sem_raw=raw["real_sem"].astype(np.int32),
        real_ins_raw=raw["real_ins"].astype(np.int32),
    )



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
