"""Offline pseudo-label evaluator (cli/stage1_evaluate.py of the JAX
package; reference seggroup/evaluate.py with its bugs fixed): re-reads the
exported label files, compares them with the ground truth at the mesh
vertices of a prepared scene (the points of a synthetic one), and sums
intersection and union over the 40 nyu40 classes. Numpy only.

    python -m seggroup_tpu_torch.cli.stage1_evaluate --exp_name exp --mode sem_infer
    python -m seggroup_tpu_torch.cli.stage1_evaluate --synthetic 2 --mode ins_infer --workers 1
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from collections.abc import Sequence
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from seggroup_tpu_torch.cli.stage1_common import SceneSource, add_common_args
from seggroup_tpu_torch.utils.logging import IOStream

SEM_VALID_CLASS_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


def eval_scene(task):
    """(i_sem, u_sem, i_ins, u_ins, acc) of one scene's exported `layer`
    labels, or None when they were not exported. `task` is (results_root,
    name, mode, layer, real_sem, real_ins)."""
    results_root, name, mode, layer, real_sem, real_ins = task
    sem_path = os.path.join(results_root, name, mode, layer + ".sem.txt")
    ins_path = os.path.join(results_root, name, mode, layer + ".ins.txt")
    if not os.path.exists(sem_path):
        return None
    sem_pred = np.loadtxt(sem_path, dtype=np.int64)
    ins_pred = np.loadtxt(ins_path, dtype=np.int64)
    valid = real_sem != 0
    sp, st = sem_pred[valid], real_sem[valid]
    ip, it = ins_pred[valid], real_ins[valid]
    i_sem = np.zeros(40); u_sem = np.zeros(40)
    for c in range(1, 41):
        i_sem[c - 1] = np.sum((sp == c) & (st == c))
        u_sem[c - 1] = np.sum((sp == c) | (st == c))
    i_ins = np.zeros(40); u_ins = np.zeros(40)
    for ins in np.unique(ip):
        if ins <= 0:
            continue
        # the instance's class is the semantic label at its first point
        sem_of = sp[np.where(ip == ins)[0][0]]
        c = int(np.clip(sem_of - 1, 0, 39))
        i_ins[c] += np.sum((ip == ins) & (it == ins))
        u_ins[c] += np.sum((ip == ins) | (it == ins))
    acc = float(np.mean(sp == st))
    return i_sem, u_sem, i_ins, u_ins, acc


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("offline pseudo-label evaluation")
    add_common_args(p)
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--mode", type=str, default="sem_infer",
                   choices=["sem_infer", "ins_infer"])
    p.add_argument("--layer", type=str, default=None,
                   help="default: layer_2 for sem_infer, final for ins_infer")
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    layer = args.layer or ("layer_2" if args.mode == "sem_infer" else "final")

    io = IOStream(os.path.join("checkpoints", args.exp_name, "evaluate.log"))
    source = SceneSource(args)
    results_root = os.path.join(args.results_root, args.exp_name)

    tasks = []
    for i, name in enumerate(source.names):
        scene, extras = source.get(i)
        real_sem = extras.get("real_sem_raw", np.asarray(scene.real_sem))
        real_ins = extras.get("real_ins_raw", np.asarray(scene.real_ins))
        tasks.append((results_root, name, args.mode, layer, real_sem, real_ins))

    try:
        if args.workers > 1 and len(tasks) > 4:
            with ProcessPoolExecutor(args.workers,
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                results = list(ex.map(eval_scene, tasks))
        else:
            results = [eval_scene(t) for t in tasks]

        results = [r for r in results if r is not None]
        if not results:
            io.cprint("no exported labels found — run cli.stage1_infer first")
            return None
        i_sem = sum(r[0] for r in results); u_sem = sum(r[1] for r in results)
        i_ins = sum(r[2] for r in results); u_ins = sum(r[3] for r in results)
        acc = float(np.mean([r[4] for r in results]))
        with np.errstate(invalid="ignore", divide="ignore"):
            iou_sem = np.where(u_sem > 0, i_sem / u_sem, np.nan)
            iou_ins = np.where(u_ins > 0, i_ins / u_ins, np.nan)
        io.cprint(f"scenes evaluated: {len(results)}")
        io.cprint("semantic mIoU (all 40): %.2f%%" % (100 * np.nanmean(iou_sem)))
        io.cprint("semantic mIoU (20 valid): %.2f%%"
                  % (100 * np.nanmean(iou_sem[SEM_VALID_CLASS_IDS - 1])))
        io.cprint("instance mIoU: %.2f%%" % (100 * np.nanmean(iou_ins)))
        io.cprint("semantic acc: %.2f%%" % (100 * acc))
        return iou_sem, iou_ins, acc
    finally:
        io.close()


if __name__ == "__main__":
    main()
