"""Stage-1 pseudo-label inference (cli/stage1_infer.py of the JAX package;
reference seggroup/infer.py): restores the trained GNN, runs `sem_infer`
or `ins_infer` over the scenes one at a time and writes each scene's label
files under results/<exp>/<scene>/<mode>/ in the reference's format (one
int per line, at the mesh vertices of a prepared scene).

    python -m seggroup_tpu_torch.cli.stage1_infer --sem_infer --exp_name exp
    python -m seggroup_tpu_torch.cli.stage1_infer --ins_infer --synthetic 2 --device cpu \\
        --cluster_cap 256

Auto caps (the default): each scene runs at the smallest cluster_cap
bucket covering its largest layer-1 segment, and a scene whose merged
clusters outgrow knn_window is run again at the covering window bucket,
so no budget binds. `--no-auto_caps` keeps the given budgets and warns
where they bind. Runs on the card unless `--device cpu`.

`--num_devices N` (default every visible card; 1 on the CPU) starts N
ranks (parallel/dp.py): rank d runs scene d of each of the JAX driver's
batches of N scenes (per cap bucket, `batch_indices`), exports it unless
it is the wrapped tail, and runs all of its own auto-caps retries itself
(they are not sharded again); the IoU sums are summed over the ranks at
the end. Each scene's files are those of `--num_devices 1`, byte for
byte. Rank 0 alone logs, its own scenes' progress and the totals."""

from __future__ import annotations

import argparse
import os
import time
from datetime import timedelta
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage1_common import (KNN_WINDOW_BUCKETS, SceneSource,
                                                  add_common_args, batch_indices, dump_config,
                                                  group_scenes_by_cap, pick_bucket)
from seggroup_tpu_torch.device import resolve_device
from seggroup_tpu_torch.infer import export_scene
from seggroup_tpu_torch.models.seggroup import SegGroupGNN
from seggroup_tpu_torch.parallel.dp import (Mesh, build_stage1_infer_step, launch,
                                            resolve_num_devices)
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager
from seggroup_tpu_torch.utils.logging import IOStream


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("stage-1 pseudo-label inference")
    add_common_args(p)
    p.add_argument("--sem_infer", action="store_true")
    p.add_argument("--ins_infer", action="store_true")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--cluster_cap", type=int, default=1024,
                   help="MINIMUM per-cluster point budget; with --auto_caps "
                        "(default) each scene escalates to the smallest "
                        "bucket covering its largest layer-1 segment")
    p.add_argument("--knn_window", type=int, default=8192,
                   help="MINIMUM cluster-kNN Morton-window budget; with "
                        "--auto_caps scenes whose merged clusters overflow "
                        "it are re-run at an escalated bucket")
    p.add_argument("--auto_caps", action=argparse.BooleanOptionalAction, default=True,
                   help="per-scene static-budget escalation from a fixed "
                        "bucket set, so exports stay on the exact path "
                        "(--no-auto_caps keeps fixed budgets + warnings)")
    args = p.parse_args(argv)
    if args.sem_infer == args.ins_infer:
        p.error("pick exactly one of --sem_infer/--ins_infer")
    mode = "sem_infer" if args.sem_infer else "ins_infer"

    n_dev = resolve_num_devices(args.num_devices, args.device)
    if n_dev == 1:
        resolve_device(args.device)
    dump_config(args, "stage1_infer")
    if n_dev > 1:
        return launch(_infer, n_dev, args.device, args, mode,
                      timeout=timedelta(seconds=args.dist_timeout))
    return _infer(None, args, mode)


def _infer(mesh: Mesh | None, args, mode: str):
    """The inference of one rank (`mesh`), or of the only process."""
    dev = resolve_device(args.device if mesh is None else mesh.device)
    n_dev, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    io = IOStream(os.path.join("checkpoints", args.exp_name, "infer.log"), enabled=rank == 0)
    source = SceneSource(args)

    def make_model(cc: int, kw: int) -> SegGroupGNN:
        # random weights from seed 0, as the JAX driver initialises them
        return SegGroupGNN(cluster_cap=cc, knn_window=kw,
                           sequential=not args.parallel_grouping, fast_knn=args.fast_knn,
                           seed=0, device=dev)

    base = make_model(args.cluster_cap, args.knn_window)
    ckpt = CheckpointManager(os.path.join("checkpoints", args.exp_name, "models"))
    restored = ckpt.restore(map_location=dev)
    if restored is not None:
        base.load_state_dict(restored["model"])
        io.cprint(f"loaded checkpoint epoch {ckpt.latest_step()}")
    else:
        io.cprint("WARNING: no checkpoint found, using random init")

    # one model per (cluster_cap, knn_window) bucket, sharing the weights
    models: dict[tuple[int, int], SegGroupGNN] = {}

    def model_for(cc: int, kw: int) -> SegGroupGNN:
        if (cc, kw) not in models:
            m = make_model(cc, kw)
            m.load_state_dict(base.state_dict())
            models[cc, kw] = m
        return models[cc, kw]

    # the host knows every scene's largest layer-1 segment before the
    # forward; the largest merged cluster only after it, so scenes over the
    # window run again below
    if args.auto_caps:
        groups = group_scenes_by_cap(source, args.cluster_cap)
        if len(groups) > 1 or next(iter(groups)) != args.cluster_cap:
            io.cprint("auto caps: " + ", ".join(
                f"{len(v)} scenes @ cluster_cap {k}" for k, v in sorted(groups.items())))
    else:
        groups = {args.cluster_cap: list(range(len(source)))}

    results_root = os.path.join(args.results_root, args.exp_name)
    i_sem = np.zeros(40); u_sem = np.zeros(40)
    i_ins = np.zeros(40); u_ins = np.zeros(40)
    t0 = time.time()
    done = 0
    over_budget = 0
    retries: dict[tuple[int, int], list[int]] = {}

    def process(cc: int, kw: int, order, shard: bool):
        """Runs the scenes `order`: this rank's share of them where `shard`
        (the first pass), else all of them (the rank's own retries)."""
        nonlocal done, over_budget
        if mesh is None:
            run = model_for(cc, kw)
        else:
            run = build_stage1_infer_step(model_for(cc, kw), mesh, mode)
        mine = list(order)
        if mesh is not None and shard:
            mine = [idx[rank] for idx, real in batch_indices(order, n_dev) if rank < real]
        for i in mine:
            name = source.names[i]
            scene, extras = source.get(i)
            out = run(scene.to(dev)) if mesh is not None else run(scene.to(dev), mode=mode)
            mseg, mclu = int(out.max_segment_size), int(out.max_cluster_size)
            nkw = pick_bucket(mclu, KNN_WINDOW_BUCKETS, kw + 1)
            if args.auto_caps and mclu > kw and nkw > kw:
                # merged clusters outgrew the window: run again at the
                # covering bucket instead of exporting approximate labels
                retries.setdefault((cc, nkw), []).append(i)
                io.cprint(f"auto caps: {name} largest cluster {mclu} > "
                          f"window {kw}; re-running @ {nkw}")
                continue
            export_scene(results_root, name, mode, out, extras)
            iou_sem, iou_ins = out.iou_sem.cpu().numpy(), out.iou_ins.cpu().numpy()
            i_sem[:] += iou_sem[0]; u_sem[:] += iou_sem[1]
            i_ins[:] += iou_ins[0]; u_ins[:] += iou_ins[1]
            if not args.auto_caps and (mseg > cc or mclu > kw):
                over_budget += 1
                io.cprint(
                    f"WARNING: {name} exceeds a static budget (largest "
                    f"segment {mseg} vs --cluster_cap {cc}; largest "
                    f"cluster {mclu} vs --knn_window {kw}) — labels are "
                    f"approximate; re-run with budgets >= those sizes "
                    f"(or --auto_caps) for the exact reference-"
                    f"semantics path")
            done += 1
            with np.errstate(invalid="ignore", divide="ignore"):
                miou_s = np.nanmean(np.where(u_sem > 0, i_sem / u_sem, np.nan))
                miou_i = np.nanmean(np.where(u_ins > 0, i_ins / u_ins, np.nan))
            io.cprint("[%s] (%04d/%04d)  Sem mIoU: %.2f%%  Ins mIoU: %.2f%%  (%.2fs/scene)"
                      % (mode, done, len(source), 100 * miou_s, 100 * miou_i,
                         (time.time() - t0) / max(done, 1)))

    try:
        for cc in sorted(groups):
            process(cc, args.knn_window, groups[cc], shard=True)
        while retries:
            (cc, kw), idxs = retries.popitem()
            process(cc, kw, idxs, shard=False)
        if mesh is not None:
            # every rank reaches this once, whatever its retries
            iou = torch.from_numpy(np.stack([i_sem, u_sem, i_ins, u_ins])).to(dev)
            tot = mesh.psum({"iou": iou,
                             "counts": torch.tensor([done, over_budget], device=dev)})
            i_sem, u_sem, i_ins, u_ins = tot["iou"].cpu().numpy()
            done, over_budget = (int(x) for x in tot["counts"].cpu())
            with np.errstate(invalid="ignore", divide="ignore"):
                miou_s = np.nanmean(np.where(u_sem > 0, i_sem / u_sem, np.nan))
                miou_i = np.nanmean(np.where(u_ins > 0, i_ins / u_ins, np.nan))
            io.cprint("[%s] all %d ranks (%04d/%04d)  Sem mIoU: %.2f%%  Ins mIoU: %.2f%%"
                      % (mode, n_dev, done, len(source), 100 * miou_s, 100 * miou_i))
        if over_budget:
            io.cprint(f"WARNING: {over_budget}/{len(source)} scenes exceeded a "
                      f"static budget (see per-scene warnings above)")
        io.cprint(f"wrote pseudo labels under {results_root}/<scene>/{mode}/")
    finally:
        io.close()


if __name__ == "__main__":
    main()
