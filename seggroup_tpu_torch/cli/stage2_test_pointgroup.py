"""PointGroup evaluation (cli/stage2_test_pointgroup.py of the JAX package):
one scene per forward, proposals -> score and size thresholds -> NMS ->
ScanNet-benchmark mAP.

    python -m seggroup_tpu_torch.cli.stage2_test_pointgroup --synthetic 4 --exp_name pg
    python -m seggroup_tpu_torch.cli.stage2_test_pointgroup --synthetic 2 --device cpu \\
        --point_cap 16384 --voxel_cap 8192

Runs on the card unless `--device cpu`. The weights are the latest
checkpoint of checkpoints/<exp_name>/pointgroup (a dict whose "model" entry
is the model's state dict); without one the model runs on random weights
from seed 0, with a warning, as the JAX CLI does. With `--dump_dir` it
writes the benchmark's layout: instance/<scene>.txt (one line per kept
proposal), instance/predicted_masks/<scene>_<k>.txt (0/1 per point) and
semantic/<scene>.txt (nyu40 ids). Not ported: prepared ScanNet scenes (they
wait for data/scannet.py)."""

from __future__ import annotations

import argparse
import os
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage1_common import SceneSource, add_common_args
from seggroup_tpu_torch.cli.stage2_pointgroup_common import (VALID_CLASS_IDS, make_pg_batch,
                                                             scene_instance_tuple)
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.eval.instance_ap import (assign_instances_for_scan, compute_averages,
                                                 evaluate_matches, non_max_suppression)
from seggroup_tpu_torch.models.pointgroup import IGNORE, PointGroup
from seggroup_tpu_torch.ops.voxelize import voxel_gather_mean, voxelize
from seggroup_tpu_torch.sparse.tensor import SparseTensor
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager
from seggroup_tpu_torch.utils.logging import IOStream


def _dump_scene(dump_dir, name, masks, labels, confs, sem20, n):
    """The benchmark's files for one scene: the proposal list, one 0/1 mask
    file per kept proposal, and the semantic predictions as nyu40 ids."""
    mask_dir = os.path.join(dump_dir, "instance", "predicted_masks")
    os.makedirs(mask_dir, exist_ok=True)
    os.makedirs(os.path.join(dump_dir, "semantic"), exist_ok=True)
    lines = []
    for pid in range(len(confs)):
        rel = f"predicted_masks/{name}_{pid:03d}.txt"
        lines.append(f"{rel} {labels[pid]} {confs[pid]:.4f}")
        np.savetxt(os.path.join(mask_dir, f"{name}_{pid:03d}.txt"),
                   masks[pid][:n].astype(np.int8), fmt="%d")
    with open(os.path.join(dump_dir, "instance", f"{name}.txt"), "w") as f:
        f.write("\n".join(lines))
    np.savetxt(os.path.join(dump_dir, "semantic", f"{name}.txt"),
               np.array(VALID_CLASS_IDS)[sem20[:n]], fmt="%d")


def make_eval_model(m: int, voxel_cap: int, device, seed: int = 0) -> PointGroup:
    """The evaluation's model: 20 classes, 7 levels of voxel_cap >> i rows,
    a ScoreNet over voxel_cap / 8 rows."""
    return PointGroup(classes=20, m=m, score_cap=voxel_cap // 8,
                      level_caps=[voxel_cap >> i for i in range(7)], seed=seed, device=device)


def test_instance_pointgroup(model: PointGroup, scenes: Sequence[tuple], point_cap: int,
                             voxel_cap: int, voxel_size: float = 0.02,
                             instance_cap: int = 256, score_thresh: float = 0.09,
                             npoint_thresh: int = 100, nms_thresh: float = 0.3,
                             dump_dir: str | None = None, phase_seconds: dict | None = None,
                             scene_log: list | None = None, log=None):
    """Score `model` on `scenes`, each (name, coords (N, 3) m, colors (N, 3)
    0..255, sem (N,) nyu40, ins (N,) with 0 = none), one scene per forward
    on the model's device. Returns (AP array (classes, overlaps), the
    benchmark's averages).

    With `phase_seconds`, the wall seconds of "host batch" (crop, padding,
    instance bookkeeping), "voxelize" (transfer, voxelisation, voxel
    features), the model's phases ("unet", "clustering", "scorenet" and
    inside them "rulebooks", "subm_conv") and "proposals to AP" (the reads
    from the card, thresholds, NMS, matching) are added to the dict. With
    `scene_log`, one dict per scene is appended: name, points, voxels,
    proposals found and kept, and whether the outputs are finite."""
    dev = model.device
    phase = PhaseClock(dev, phase_seconds)
    matches = []
    for i, (name, coords, colors, sem, ins) in enumerate(scenes):
        with phase("host batch"):
            hb = make_pg_batch([(coords, colors, sem, ins)], point_cap, instance_cap)
            ic = np.floor(hb.coords / voxel_size).astype(np.int32)
            ic -= ic.min(0)
        with phase("voxelize"), torch.no_grad():
            pts = torch.from_numpy(hb.coords).to(dev)
            batch_ids = torch.from_numpy(hb.batch_ids).to(dev)
            valid = torch.from_numpy(hb.valid).to(dev)
            vm = voxelize(torch.from_numpy(ic).to(dev), batch_ids, valid, voxel_cap)
            feats = torch.cat([torch.from_numpy(hb.feats).to(dev), pts], dim=1)
            st = SparseTensor(vm.voxel_coords, voxel_gather_mean(feats, vm), vm.voxel_valid,
                              vm.num_voxels)
        with torch.no_grad():
            out = model(st, vm.point2voxel, pts, batch_ids, valid, do_clustering=True,
                        train=False, phase_seconds=phase_seconds)
        with phase("proposals to AP"):
            n = int(hb.valid.sum())
            sem20 = out.semantic_scores.argmax(dim=1).cpu().numpy()
            scores = 1 / (1 + np.exp(-out.scores.cpu().numpy()))
            pvalid = out.proposal_valid.cpu().numpy()
            prop = out.proposal_of_point.cpu().numpy()  # (2, N)

            masks, labels, confs = [], [], []
            for pid in range(pvalid.shape[0]):
                if not pvalid[pid] or scores[pid] <= score_thresh:
                    continue
                mask = ((prop[0] == pid) | (prop[1] == pid)) & hb.valid
                if mask.sum() < npoint_thresh:
                    continue
                cls = np.bincount(sem20[mask], minlength=20).argmax()
                masks.append(mask)
                labels.append(VALID_CLASS_IDS[cls] if cls < 20 else 0)
                confs.append(scores[pid])
            if masks:
                masks = np.stack(masks)
                inter = (masks[:, None] & masks[None]).sum(-1).astype(np.float64)
                area = masks.sum(-1)
                ious = inter / np.maximum(area[:, None] + area[None] - inter, 1)
                keep = non_max_suppression(ious, np.array(confs), nms_thresh)
                masks, labels, confs = masks[keep], np.array(labels)[keep], np.array(confs)[keep]
            else:
                masks = np.zeros((0, len(hb.valid)), bool)
                labels, confs = np.zeros(0, np.int64), np.zeros(0)
            if dump_dir:
                _dump_scene(dump_dir, name, masks, labels, confs, sem20, n)

            # ground-truth ids = sem * 1000 + instance index
            gt_ids = np.where(hb.instance_labels != IGNORE,
                              hb.sem_nyu40.astype(np.int64) * 1000 + hb.instance_labels,
                              hb.sem_nyu40.astype(np.int64) * 1000)
            gt_ids = np.where(hb.valid, gt_ids, 0)
            matches.append(assign_instances_for_scan(masks, labels, confs, gt_ids))
            if scene_log is not None:
                scene_log.append(dict(
                    name=name, points=n, voxels=int(vm.num_voxels),
                    proposals=int(out.num_proposals), kept=len(confs),
                    finite=bool(torch.isfinite(out.semantic_scores).all()
                                and torch.isfinite(out.pt_offsets).all()
                                and torch.isfinite(out.scores).all())))
        if log is not None:
            log(f"[{i + 1}/{len(scenes)}] {name}: {len(confs)} proposals kept")
    aps = evaluate_matches(matches)
    return aps, compute_averages(aps)


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("PointGroup eval (mAP)")
    add_common_args(p)
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--point_cap", type=int, default=2 ** 17)
    p.add_argument("--voxel_cap", type=int, default=2 ** 16)
    p.add_argument("--instance_cap", type=int, default=256)
    p.add_argument("--score_thresh", type=float, default=0.09)
    p.add_argument("--npoint_thresh", type=int, default=100)
    p.add_argument("--nms_thresh", type=float, default=0.3)
    p.add_argument("--m", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dump_dir", type=str, default=None,
                   help="write ScanNet-benchmark instance outputs: per scene a "
                        "<scene>.txt proposal list + predicted_masks/ 0/1 mask files, "
                        "plus semantic/<scene>.txt nyu40 predictions")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    source = SceneSource(args)
    io = IOStream(os.path.join("checkpoints", args.exp_name, "pg_test.log"))
    model = make_eval_model(args.m, args.voxel_cap, dev)
    ckpt = CheckpointManager(os.path.join("checkpoints", args.exp_name, "pointgroup"))
    restored = ckpt.restore(map_location=dev)
    if restored is not None:
        model.load_state_dict(restored["model"])
        io.cprint(f"loaded checkpoint step {ckpt.latest_step()}")
    else:
        io.cprint("WARNING: no checkpoint, random weights")

    scenes = []
    for i in range(len(source)):
        scene, extras = source.get(i)
        scenes.append((source.names[i],
                       *scene_instance_tuple(scene, extras, None, source.names[i])))
    aps, avg = test_instance_pointgroup(
        model, scenes, args.point_cap, args.voxel_cap, args.voxel_size, args.instance_cap,
        args.score_thresh, args.npoint_thresh, args.nms_thresh, dump_dir=args.dump_dir,
        log=io.cprint)
    io.cprint("AP %.3f  AP50 %.3f  AP25 %.3f"
              % (avg["all_ap"], avg["all_ap_50%"], avg["all_ap_25%"]))
    for k, v in avg["classes"].items():
        io.cprint("  %-16s ap %.3f  ap50 %.3f" % (k, v["ap"], v["ap50%"]))
    io.close()
    return aps, avg


if __name__ == "__main__":
    main()
