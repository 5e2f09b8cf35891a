"""Stage-2 semantic segmentation evaluation (cli/stage2_test_semantic.py of
the JAX package), on prepared npz scenes under <data_root>/<label_style>/
or on `--synthetic N` scenes.

MinkUNet (`--model minkunet`): full-scene voxel inference one scene per
forward, voxel -> point mapping, confusion-matrix mIoU and per-class AP.
KPConv (`--model kpconv`): in-radius spheres at the potential sampler's
minimum until every point has `--votes` votes, each sphere's points (a
random `--point_cap` of them past the cap) through the device pyramid and
KPFCNN, the softmax folded into each point's vote as 0.95 * old + 0.05 *
new (reference kpconv/utils/tester.py:742), then the same scores.

    python -m seggroup_tpu_torch.cli.stage2_test_semantic --synthetic 2
    python -m seggroup_tpu_torch.cli.stage2_test_semantic --model kpconv --synthetic 2
    python -m seggroup_tpu_torch.cli.stage2_test_semantic --data_root dataset/scannet/prepared
    python -m seggroup_tpu_torch.cli.stage2_test_semantic --synthetic 2 --device cpu

Runs on the card unless `--device cpu`, and logs to
checkpoints/<exp_name>/<model>_test.log. The weights are the latest
checkpoint of checkpoints/<exp_name>/<model> (`{"model": state_dict}`:
cli/stage2_train_minkunet.py writes MinkUNet's; KPConv's comes from
models.convert until its trainer is ported); without one the model runs on
random weights from seed 0, with a warning. Data parallelism
(`--num_devices` > 1) raises."""

from __future__ import annotations

import argparse
import os
import warnings
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage1_common import SceneSource, add_common_args
from seggroup_tpu_torch.cli.stage2_common import (CLASS_NAMES_20, VALID_CLASS_IDS,
                                                  scene_to_training_tuple)
from seggroup_tpu_torch.data.potentials import PotentialSampler
from seggroup_tpu_torch.data.voxel_dataset import IGNORE_LABEL, make_voxel_batch
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.eval.semantic import (average_precision, confusion_matrix,
                                              miou_from_confusion)
from seggroup_tpu_torch.models.kpconv import KPFCNN, build_pyramid
from seggroup_tpu_torch.models.minkunet import MinkUNet, make_minkunet
from seggroup_tpu_torch.sparse.tensor import SparseTensor
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager
from seggroup_tpu_torch.utils.logging import IOStream

KPCONV_LAYERS = 5  # the pyramid's levels, as the JAX driver builds it


def level_caps(capacity: int) -> list[int]:
    """The evaluation's per-level voxel capacities."""
    return [capacity, capacity // 2, capacity // 4, capacity // 8, capacity // 8]


def _nanmean_rows(rows: list, num_classes: int) -> np.ndarray:
    """Per-class mean of per-scene AP rows, ignoring NaN (absent classes)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        return np.nanmean(np.stack(rows), 0) if rows else np.full(num_classes, np.nan)


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
    return miou, per_class, _nanmean_rows(ap_rows, num_classes)


def kpconv_level_caps(point_cap: int) -> list[int]:
    """The KPConv pyramid's row capacities below level 0."""
    return [point_cap // 2, point_cap // 4, point_cap // 8, point_cap // 16]


def test_semantic_kpconv(model: KPFCNN,
                         scenes: Sequence[tuple[str, np.ndarray, np.ndarray, np.ndarray]],
                         point_cap: int, in_radius: float, votes: int, num_classes: int,
                         dump_dir: str | None = None, phase_seconds: dict | None = None,
                         scene_log: list | None = None):
    """Score `model` on `scenes`, each (name, coords (N,3) m, colors (N,3)
    0..255, labels (N,) 20-class or 255), by voting spheres as the JAX
    driver does (cli/stage2_test_semantic.py:121-203): per scene a
    potential sampler of radius `in_radius` (seed 0) draws centres until its
    least potential reaches `votes` (at most votes * 64 spheres); the points
    within the radius (a random `point_cap` of them, from one generator of
    seed 0 over all scenes, past the cap) go through the pyramid and the
    model on its device; their softmax enters an EMA vote. The points never
    voted on are excluded. Returns (miou, per-class IoU, per-class AP over
    the renormalised votes).

    With `dump_dir`, each scene's per-point predictions are written as
    nyu40 ids to <dump_dir>/<name>.txt. With `phase_seconds`, the wall
    seconds of "pyramid", "forward" (and "encoder", "decoder" inside it)
    and "vote" (the host's share: sphere selection, softmax, the vote) are
    added to the dict. With `scene_log`, one dict per scene is appended:
    name, spheres, coverage, whether every logit was finite, and the
    pyramid's per-level neighbour-overflow rates averaged over spheres."""
    dev = model.device
    phase = PhaseClock(dev, phase_seconds)
    caps = kpconv_level_caps(point_cap)
    hist = np.zeros((num_classes, num_classes), np.int64)
    ap_rows = []
    nyu40_of = np.array(VALID_CLASS_IDS, np.int64)
    rng = np.random.default_rng(0)
    batch = torch.zeros(point_cap, dtype=torch.int32, device=dev)
    for name, c, col, lab in scenes:
        probs = np.zeros((len(c), num_classes), np.float32)
        counts = np.zeros(len(c), np.int32)
        sampler = PotentialSampler([c], in_radius=in_radius, seed=0)
        spheres, finite, over = 0, True, np.zeros(KPCONV_LAYERS)
        for _ in range(votes * 64):
            with phase("vote"):
                if sampler.min_potential() >= votes:
                    break
                _, center = sampler.next_center()
                sel = np.where(((c - center) ** 2).sum(1) < in_radius ** 2)[0]
                if len(sel) > point_cap:
                    sel = sel[rng.permutation(len(sel))[:point_cap]]
                pts = np.zeros((point_cap, 3), np.float32)
                feats = np.ones((point_cap, 4), np.float32)
                pts[: len(sel)] = c[sel]
                feats[: len(sel), 1:] = col[sel] / 255.0
                valid = np.zeros(point_cap, bool)
                valid[: len(sel)] = True
            with phase("pyramid"):
                pyr, rates = build_pyramid(torch.from_numpy(pts).to(dev), batch,
                                           torch.from_numpy(valid).to(dev), KPCONV_LAYERS,
                                           model.dl0, level_caps=caps, return_overflow=True)
            with phase("forward"), torch.no_grad():
                logits, _ = model(pyr, torch.from_numpy(feats).to(dev),
                                  phase_seconds=phase_seconds)
                logits = logits[: len(sel)].cpu().numpy()
            with phase("vote"):
                finite &= bool(np.isfinite(logits).all())
                over += torch.stack(rates).cpu().numpy()
                sm = np.exp(logits - logits.max(1, keepdims=True))
                sm /= sm.sum(1, keepdims=True)
                probs[sel] = 0.95 * probs[sel] + 0.05 * sm
                counts[sel] += 1
                spheres += 1
        pred = probs.argmax(1)
        ok = (lab != IGNORE_LABEL) & (counts > 0)
        np.add.at(hist, (lab[ok], pred[ok]), 1)
        # the EMA leaves each point's row summing to 1 - 0.95^votes, which
        # would bias the ranking across points that AP depends on
        row_sum = probs.sum(1, keepdims=True)
        probs_n = np.divide(probs, row_sum, out=np.zeros_like(probs), where=row_sum > 0)
        if ok.any():
            ap_rows.append(average_precision(probs_n[ok], lab[ok], num_classes,
                                             ignore=IGNORE_LABEL))
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            np.savetxt(os.path.join(dump_dir, f"{name}.txt"), nyu40_of[probs_n.argmax(1)],
                       fmt="%d")
        if scene_log is not None:
            scene_log.append(dict(name=name, spheres=spheres,
                                  coverage=float(np.mean(counts > 0)), logits_finite=finite,
                                  overflow=(over / max(spheres, 1)).tolist()))
    miou, per_class = miou_from_confusion(hist)
    return miou, per_class, _nanmean_rows(ap_rows, num_classes)


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-2 semantic eval (mIoU)")
    add_common_args(p)
    p.add_argument("--model", type=str, default="minkunet", choices=["minkunet", "kpconv"])
    p.add_argument("--variant", type=str, default="Res16UNet34C")
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--capacity", type=int, default=2 ** 17)
    p.add_argument("--point_cap", type=int, default=2 ** 15)
    p.add_argument("--first_features_dim", type=int, default=64)
    p.add_argument("--dl0", type=float, default=0.04)
    p.add_argument("--in_radius", type=float, default=2.0)
    p.add_argument("--votes", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--dump_dir", type=str, default=None,
                   help="write per-scene nyu40 prediction .txt files")
    args = p.parse_args(argv)

    if args.num_devices not in (None, 1):
        raise NotImplementedError("data parallelism waits for the port of parallel/dp.py")
    dev = resolve_device(args.device)
    io = IOStream(os.path.join("checkpoints", args.exp_name, f"{args.model}_test.log"))
    source = SceneSource(args)
    scenes = ((source.names[i], *scene_to_training_tuple(*source.get(i), None,
                                                         source.names[i], False))
              for i in range(len(source)))
    if args.model == "minkunet":
        model = make_minkunet(args.variant, out_channels=args.num_classes,
                              level_caps=level_caps(args.capacity), device=dev)
    else:
        model = KPFCNN(num_classes=args.num_classes,
                       first_features_dim=args.first_features_dim, dl0=args.dl0, device=dev)
    ckpt = CheckpointManager(os.path.join("checkpoints", args.exp_name, args.model))
    restored = ckpt.restore(map_location=dev)
    if restored is not None:
        model.load_state_dict(restored["model"])
        io.cprint(f"loaded checkpoint {ckpt.latest_step()}")
    else:
        io.cprint("WARNING: random weights")
    log: list = []
    try:
        if args.model == "minkunet":
            miou, per_class, ap_class = test_semantic_minkunet(
                model, scenes, args.capacity, args.voxel_size, args.num_classes,
                dump_dir=args.dump_dir, scene_log=log)
            for i, rec in enumerate(log):
                io.cprint(f"[{i + 1}/{len(log)}] {rec['name']}"
                          + (f"  ({rec['dropped']} pts over capacity excluded)"
                             if rec["dropped"] else ""))
        else:
            miou, per_class, ap_class = test_semantic_kpconv(
                model, scenes, args.point_cap, args.in_radius, args.votes, args.num_classes,
                dump_dir=args.dump_dir, scene_log=log)
            for i, rec in enumerate(log):
                io.cprint(f"[{i + 1}/{len(log)}] {rec['name']} "
                          f"(coverage {100 * rec['coverage']:.0f}%)")
        io.cprint("mIoU: %.2f%%  mAP: %.2f%%" % (100 * miou, 100 * np.nanmean(ap_class)))
        io.cprint("  %-16s %8s %8s" % ("class", "IoU", "AP"))
        for name, iou, ap in zip(CLASS_NAMES_20, per_class, ap_class):
            io.cprint("  %-16s %7.2f%% %7.2f%%" % (name, 100 * iou, 100 * ap))
    finally:
        io.close()
    return miou, per_class, ap_class


if __name__ == "__main__":
    main()
