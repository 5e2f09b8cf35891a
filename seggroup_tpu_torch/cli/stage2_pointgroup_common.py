"""Host-side batch assembly for PointGroup
(cli/stage2_pointgroup_common.py of the JAX package): scenes -> one padded
point batch with compact instance ids, per-point instance centroids and
per-instance point counts, and the batch's voxelisation for training.

Numpy only; the same scenes give the same batch as the JAX package's. The
wire format is `data/pg_wire.py`. `host_voxelize_plan(level_caps=...)`
also builds the U-Net's pyramid plan on the host (sparse/plan.py, the
trainers' `--plan_mode host`)."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from seggroup_tpu_torch.data import transforms as T
from seggroup_tpu_torch.models.pointgroup import IGNORE
from seggroup_tpu_torch.sparse.plan import build_unet_plan
from seggroup_tpu_torch.utils import profiling

VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
NYU40_TO_20 = np.full(41, IGNORE, np.int32)
for _i, _c in enumerate(VALID_CLASS_IDS):
    NYU40_TO_20[_c] = _i


class PGHostBatch(NamedTuple):
    coords: np.ndarray             # (N, 3) float
    feats: np.ndarray              # (N, C)
    batch_ids: np.ndarray          # (N,)
    valid: np.ndarray              # (N,)
    labels: np.ndarray             # (N,) 20-class or IGNORE
    instance_labels: np.ndarray    # (N,) compact or IGNORE
    instance_centroid: np.ndarray  # (N, 3)
    instance_pointnum: np.ndarray  # (I_cap,)
    sem_nyu40: np.ndarray          # (N,) for the evaluation's ground-truth ids


def scene_instance_tuple(scene, extras, pseudo_root, name):
    """(coords, colors 0..255, sem nyu40, ins) of a Scene, its labels the
    ground truth or, with `pseudo_root`, the stage-1 export of scene `name`."""
    pts = np.asarray(scene.points)
    coords = pts[:, :3].astype(np.float32)
    colors = ((pts[:, 3:] + 1.0) * 127.5).astype(np.float32)
    if pseudo_root is not None:
        sem = np.loadtxt(os.path.join(pseudo_root, name, "ins_infer", "final.sem.txt"),
                         dtype=np.int64)
        ins = np.loadtxt(os.path.join(pseudo_root, name, "ins_infer", "final.ins.txt"),
                         dtype=np.int64)
        if "mapping" in extras:  # exported at original-vertex resolution
            sem = sem[extras["mapping"]]
            ins = ins[extras["mapping"]]
        else:
            sem = sem[: len(coords)]
            ins = ins[: len(coords)]
        # wall and floor carry no instances
        ins = np.where((sem == 1) | (sem == 2), 0, np.maximum(ins, 0))
        sem = np.clip(sem, 0, 40)
    else:
        sem = np.asarray(scene.real_sem).astype(np.int64)
        ins = np.asarray(scene.real_ins).astype(np.int64)
    return coords, colors, sem.astype(np.int32), ins.astype(np.int32)


def make_pg_batch(tuples, n_cap, i_cap, rng=None, augment=False,
                  max_points_per_scene=None, crop_scale=50.0, crop_full_scale=512):
    """tuples: list of (coords, colors, sem_nyu40 (0 = unlabeled), ins (0 =
    none)). Scenes over the point budget are cut by the spatial crop (a
    [0, full_scale)^3 window on voxel-scaled coords whose xy extent shrinks
    until the scene fits), so the surviving points stay one region."""
    cs, fs, bs, ls, il, sn = [], [], [], [], [], []
    total, next_inst = 0, 0
    for b, (coords, colors, sem, ins) in enumerate(tuples):
        if augment:
            coords, colors = T.default_train_transform(coords, colors, rng)
        budget = n_cap - total
        if max_points_per_scene:
            budget = min(budget, max_points_per_scene)
        if len(coords) > budget:
            # evaluation (rng=None): deterministic crops, seeded per scene
            # index so that scenes do not all share one window
            crop_rng = rng if rng is not None else np.random.default_rng(b)
            xyz = (coords - coords.min(0)) * crop_scale
            _, mask = T.spatial_crop(xyz, budget, crop_rng, full_scale=crop_full_scale)
            coords, colors, sem, ins = coords[mask], colors[mask], sem[mask], ins[mask]
        lab20 = NYU40_TO_20[np.clip(sem, 0, 40)]
        inst = np.full(len(ins), IGNORE, np.int32)
        for u in np.unique(ins):
            if u <= 0:
                continue
            inst[ins == u] = next_inst
            next_inst += 1
        cs.append(coords)
        fs.append(colors / 127.5 - 1.0)
        bs.append(np.full(len(coords), b, np.int32))
        ls.append(lab20)
        il.append(inst)
        sn.append(sem)
        total += len(coords)
        if total >= n_cap:
            break

    n = min(total, n_cap)
    coords = np.zeros((n_cap, 3), np.float32)
    feats = np.zeros((n_cap, 3), np.float32)
    batch_ids = np.zeros(n_cap, np.int32)
    labels = np.full(n_cap, IGNORE, np.int32)
    inst = np.full(n_cap, IGNORE, np.int32)
    semn = np.zeros(n_cap, np.int32)
    coords[:n] = np.concatenate(cs)[:n]
    feats[:n] = np.concatenate(fs)[:n]
    batch_ids[:n] = np.concatenate(bs)[:n]
    labels[:n] = np.concatenate(ls)[:n]
    inst[:n] = np.concatenate(il)[:n]
    semn[:n] = np.concatenate(sn)[:n]
    valid = np.zeros(n_cap, bool)
    valid[:n] = True

    centroid = np.zeros((n_cap, 3), np.float32)
    pointnum = np.zeros(i_cap, np.int32)
    for u in np.unique(inst):
        if u == IGNORE or u >= i_cap:
            continue
        sel = inst == u
        centroid[sel] = coords[sel].mean(0)
        pointnum[u] = sel.sum()
    inst = np.where((inst != IGNORE) & (inst < i_cap), inst, IGNORE)
    return PGHostBatch(coords, feats, batch_ids, valid, labels, inst, centroid, pointnum, semn)


def host_voxelize_plan(hb: PGHostBatch, voxel_size: float, voxel_cap: int,
                       level_caps=None, window_levels: int | None = 0):
    """The training batch's voxelisation on the host: the valid points'
    cells floor(coords / voxel_size), shifted so that their least is 0, one
    voxel per distinct (batch, x, y, z) in lexicographic order, the first
    `voxel_cap` kept. Returns (voxel_coords (voxel_cap, 4) int32,
    num_voxels (those kept), point2voxel (N,) int32 with voxel_cap for
    dropped and invalid points), and with `level_caps` the U-Net's pyramid
    plan over them as a fourth element (sparse/plan.build_unet_plan;
    windows on the first `window_levels` levels, none by default, as the
    JAX trainer builds it). The voxels past the cap are counted as
    "count.pg.voxels_dropped" while the recorder is bound."""
    n_valid = int(hb.valid.sum())
    ic = np.floor(hb.coords[:n_valid] / voxel_size).astype(np.int32)
    if n_valid:
        ic -= ic.min(0)
    keys = np.concatenate([hb.batch_ids[:n_valid, None].astype(np.int32), ic], axis=1)
    vc, rank = np.unique(keys, axis=0, return_inverse=True)
    rank = rank.reshape(-1).astype(np.int32)
    m = min(len(vc), voxel_cap)
    profiling.count("pg.voxels_dropped", len(vc) - m)
    vcoords = np.zeros((voxel_cap, 4), np.int32)
    vcoords[:m] = vc[:m]
    p2v = np.full(len(hb.coords), voxel_cap, np.int32)
    p2v[:n_valid] = np.where(rank < voxel_cap, rank, voxel_cap)
    if level_caps is None:
        return vcoords, np.int32(m), p2v
    return (vcoords, np.int32(m), p2v,
            build_unet_plan(vcoords, m, level_caps, window_levels=window_levels))
