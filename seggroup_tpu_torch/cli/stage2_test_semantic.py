"""Stage-2 semantic segmentation evaluation, MinkUNet branch
(cli/stage2_test_semantic.py:73-120, 202-212 of the JAX package):
full-scene voxel inference one scene per forward, voxel -> point mapping,
confusion-matrix mIoU and per-class AP.

    python -m seggroup_tpu_torch.cli.stage2_test_semantic --synthetic 2
    python -m seggroup_tpu_torch.cli.stage2_test_semantic --synthetic 2 --device cpu

Runs on the card unless `--device cpu`. The weights are the latest
checkpoint of checkpoints/<exp_name>/minkunet that the training driver
(cli/stage2_train_minkunet.py) wrote; without one the model runs on random
weights from seed 0, with a warning. Not ported: the KPConv branch, and
prepared ScanNet scenes (they wait for data/scannet.py)."""

from __future__ import annotations

import argparse
import os
import warnings
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage2_common import (CLASS_NAMES_20, VALID_CLASS_IDS,
                                                  scene_to_training_tuple)
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.data.voxel_dataset import IGNORE_LABEL, make_voxel_batch
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.eval.semantic import (average_precision, confusion_matrix,
                                              miou_from_confusion)
from seggroup_tpu_torch.models.minkunet import MinkUNet, make_minkunet
from seggroup_tpu_torch.sparse.tensor import SparseTensor
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager


def level_caps(capacity: int) -> list[int]:
    """The evaluation's per-level voxel capacities."""
    return [capacity, capacity // 2, capacity // 4, capacity // 8, capacity // 8]


def test_semantic_minkunet(model: MinkUNet,
                           scenes: Sequence[tuple[str, np.ndarray, np.ndarray, np.ndarray]],
                           capacity: int, voxel_size: float, num_classes: int,
                           dump_dir: str | None = None,
                           phase_seconds: dict | None = None,
                           scene_log: list | None = None):
    """Score `model` on `scenes`, each (name, coords (N,3) m, colors (N,3)
    0..255, labels (N,) 20-class or 255), one scene per forward on the
    model's device. Returns (miou, per-class IoU, per-class AP).

    Points whose voxel overflowed `capacity` are excluded from the scores.
    With `dump_dir`, each scene's per-point predictions are written as
    nyu40 ids to <dump_dir>/<name>.txt. With `phase_seconds`, the wall
    seconds of "voxelize", "forward" (and the model's own phases inside it)
    and "score" are added to the dict. With `scene_log`, one dict per scene
    is appended: name, voxels, dropped points, and whether the logits are
    finite and zero on padding rows."""
    dev = model.device
    phase = PhaseClock(dev, phase_seconds)
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=dev)
    ap_rows = []  # per-scene per-class AP, nanmean'd like reference test.py:143
    nyu40_of = np.array(VALID_CLASS_IDS, np.int64)
    for name, coords, colors, labels in scenes:
        with phase("voxelize"):
            vb = make_voxel_batch([(coords, colors, labels)], capacity, voxel_size)
            st = SparseTensor(torch.from_numpy(vb.coords), torch.from_numpy(vb.feats),
                              torch.from_numpy(vb.valid), torch.tensor(int(vb.num))).to(dev)
        with phase("forward"), torch.no_grad():
            logits = model(st, train=False, phase_seconds=phase_seconds)
        with phase("score"):
            # voxel -> point; p2v == -1 marks points whose voxel overflowed
            # capacity: excluded, not mis-scored
            p2v = vb.point2voxel[0]
            lab_pts = np.asarray(labels[: len(p2v)])
            kept = p2v >= 0
            rows = torch.from_numpy(np.where(kept, p2v, 0)).to(dev).long()
            pred_pts = torch.argmax(logits, dim=1)[rows]
            hist += confusion_matrix(
                pred_pts, torch.from_numpy(np.where(kept, lab_pts, IGNORE_LABEL)).to(dev),
                num_classes)
            probs_pts = torch.softmax(logits, dim=1)[rows].cpu().numpy()
            ok = (lab_pts != IGNORE_LABEL) & kept
            if ok.any():
                ap_rows.append(average_precision(probs_pts[ok], lab_pts[ok], num_classes,
                                                 ignore=IGNORE_LABEL))
            if dump_dir:
                os.makedirs(dump_dir, exist_ok=True)
                np.savetxt(os.path.join(dump_dir, f"{name}.txt"),
                           nyu40_of[probs_pts.argmax(1)], fmt="%d")
            if scene_log is not None:
                n = int(vb.num)
                scene_log.append(dict(
                    name=name, voxels=n, dropped=int((~kept).sum()),
                    logits_finite=bool(torch.isfinite(logits).all()),
                    padding_zero=bool((logits[n:] == 0).all())))
    miou, per_class = miou_from_confusion(hist.cpu().numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        ap_class = (np.nanmean(np.stack(ap_rows), 0) if ap_rows
                    else np.full(num_classes, np.nan))
    return miou, per_class, ap_class


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-2 semantic eval (mIoU), MinkUNet")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic scenes instead of prepared ScanNet")
    p.add_argument("--variant", type=str, default="Res16UNet34C")
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--capacity", type=int, default=2 ** 17)
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dump_dir", type=str, default=None,
                   help="write per-scene nyu40 prediction .txt files")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    if args.synthetic <= 0:
        raise NotImplementedError("prepared ScanNet scenes wait for the port of "
                                  "data/scannet.py; use --synthetic N")
    model = make_minkunet(args.variant, out_channels=args.num_classes,
                          level_caps=level_caps(args.capacity), device=dev)
    ckpt = CheckpointManager(os.path.join("checkpoints", args.exp_name, "minkunet"))
    restored = ckpt.restore(map_location=dev)
    if restored is not None:
        model.load_state_dict(restored["model"])
        print(f"loaded checkpoint {ckpt.latest_step()}", flush=True)
    else:
        print("WARNING: random weights", flush=True)
    scenes = []
    for i in range(args.synthetic):
        name = f"synthetic{i:04d}"
        c, col, lab = scene_to_training_tuple(make_synthetic_scene(seed=i), {}, None,
                                              name, False)
        scenes.append((name, c, col, lab))
    log: list = []
    miou, per_class, ap_class = test_semantic_minkunet(
        model, scenes, args.capacity, args.voxel_size, args.num_classes,
        dump_dir=args.dump_dir, scene_log=log)
    for i, rec in enumerate(log):
        print(f"[{i + 1}/{len(log)}] {rec['name']}"
              + (f"  ({rec['dropped']} pts over capacity excluded)" if rec["dropped"] else ""))
    print("mIoU: %.2f%%  mAP: %.2f%%" % (100 * miou, 100 * np.nanmean(ap_class)))
    print("  %-16s %8s %8s" % ("class", "IoU", "AP"))
    for name, iou, ap in zip(CLASS_NAMES_20, per_class, ap_class):
        print("  %-16s %7.2f%% %7.2f%%" % (name, 100 * iou, 100 * ap))
    return miou, per_class, ap_class


if __name__ == "__main__":
    main()
