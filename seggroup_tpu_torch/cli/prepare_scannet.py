"""Offline ScanNet preprocessing: raw scans -> fixed-shape scene .npz files
(cli/prepare_scannet.py of the JAX package; reference
seggroup/dataset/scannet/prepare_data.py + prepare_weak_label.py, with the
four label styles), one scene a task over a process pool. Host only: numpy
and the native library (seggroup_tpu_torch/native.py), no card.

    python -m seggroup_tpu_torch.cli.prepare_scannet --scans_dir /data/scannet/scans \
        --scene_list scannetv2_train.txt --label_style maxseg \
        --out dataset/scannet/prepared

Each scene directory holds <scene>_vh_clean_2.ply,
<scene>_vh_clean_2.0.010000.segs.json and <scene>.aggregation.json; the
label table defaults to <scans_dir>/../scannetv2-labels.combined.tsv.
Writes <out>/<label_style>/<scene>.npz, which the drivers read with
--data_root <out> --label_style <label_style>."""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from seggroup_tpu_torch.data.scannet import (
    PrepConfig, prepare_scene, read_scene_raw, save_scene_npz,
)


def prep_one(task):
    (scans_dir, tsv, scene, out_dir, style, manual_dir, num_points,
     max_segments, max_edges, seed, rasterize_dl) = task
    try:
        raw = read_scene_raw(scans_dir, scene, tsv)
        if rasterize_dl:
            # densify the mesh before resampling (reference
            # prepare_pointcloud_ply rasterizes at 3 mm, Scannet.py:174-302)
            from seggroup_tpu_torch.data.mesh import rasterize_mesh

            pts, cols, fid, corner = rasterize_mesh(
                raw["vertices"][:, :3], raw["faces"], rasterize_dl,
                features=raw["vertices"][:, 3:])
            vidx = raw["faces"][fid, corner]
            raw = dict(
                vertices=np.concatenate([pts, cols], 1).astype(np.float32),
                faces=raw["faces"],
                seg_labels=raw["seg_labels"][vidx],
                seg_labels_mesh=raw["seg_labels"],
                real_sem=raw["real_sem"][vidx],
                real_ins=raw["real_ins"][vidx],
            )
        manual = None
        if style == "manual":
            with open(os.path.join(manual_dir, scene + ".json")) as f:
                manual = json.load(f)
        cfg = PrepConfig(num_points=num_points, max_segments=max_segments,
                         max_edges=max_edges)
        prep = prepare_scene(raw, cfg, style=style, manual=manual, seed=seed)
        save_scene_npz(os.path.join(out_dir, scene + ".npz"), prep)
        n_lab = int((prep["weak_ins"] >= 0).sum())
        return scene, n_lab, None
    except Exception as e:  # noqa: BLE001 — report per-scene failures
        return scene, 0, str(e)


def main(argv=None):
    p = argparse.ArgumentParser("ScanNet preprocessing")
    p.add_argument("--scans_dir", type=str, required=True)
    p.add_argument("--tsv", type=str, default=None,
                   help="scannetv2-labels.combined.tsv path")
    p.add_argument("--scene_list", type=str, default=None,
                   help="txt with one scene name per line; default: all dirs")
    p.add_argument("--out", type=str, default="dataset/scannet/prepared")
    p.add_argument("--label_style", type=str, default="manual",
                   choices=["manual", "maxseg", "mainseg", "rand"])
    p.add_argument("--manual_dir", type=str, default=None,
                   help="dir with per-scene annotator JSONs (manual style)")
    p.add_argument("--num_points", type=int, default=150528)
    p.add_argument("--max_segments", type=int, default=1024)
    p.add_argument("--max_edges", type=int, default=8192)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--rasterize_dl", type=float, default=0.0,
                   help="densify the mesh at this pitch (m) before "
                        "resampling, like the reference's 3 mm "
                        "rasterization (0 = use raw vertices)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.scene_list:
        with open(args.scene_list) as f:
            scenes = [ln.strip() for ln in f if ln.strip()]
    else:
        scenes = sorted(d for d in os.listdir(args.scans_dir)
                        if d.startswith("scene"))
    out_dir = os.path.join(args.out, args.label_style)
    os.makedirs(out_dir, exist_ok=True)

    tasks = [(args.scans_dir, args.tsv, s, out_dir, args.label_style,
              args.manual_dir, args.num_points, args.max_segments,
              args.max_edges, args.seed, args.rasterize_dl) for s in scenes]
    if args.workers > 1:
        with ProcessPoolExecutor(args.workers) as ex:
            results = list(ex.map(prep_one, tasks))
    else:
        results = [prep_one(t) for t in tasks]
    ok = [r for r in results if r[2] is None]
    bad = [r for r in results if r[2] is not None]
    print(f"prepared {len(ok)}/{len(scenes)} scenes -> {out_dir}")
    print(f"avg labeled segments/scene: "
          f"{np.mean([r[1] for r in ok]) if ok else 0:.1f}")
    for scene, _, err in bad[:10]:
        print(f"FAILED {scene}: {err}")
    return results


if __name__ == "__main__":
    main()
