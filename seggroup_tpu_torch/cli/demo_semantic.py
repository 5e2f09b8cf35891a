"""Standalone semantic-segmentation demo: one PLY in, one coloured PLY out
(cli/demo_semantic.py of the JAX package; reference minkowski/demo/
scannet.py:100-159). Reads a point cloud, voxelises it at --voxel_size,
runs a semantic U-Net of the registry (Res16UNet, ResUNet and MinkUNetHyper
variants; the ST variants on the cloud's 3-D coords), maps the 20-class
argmax to NYU40 ids and the NYU40 palette, and writes `--out` with one
coloured vertex per kept input point (reprojected through the point ->
voxel map; --voxel_centers writes the voxel centres instead).

    python -m seggroup_tpu_torch.cli.demo_semantic --synthetic --out pred.ply
    python -m seggroup_tpu_torch.cli.demo_semantic --ply scene.ply \\
        --checkpoint_dir checkpoints/exp/minkunet --out pred.ply

Runs on the card unless `--device cpu`. --checkpoint_dir restores the
latest `{"model": state_dict}` checkpoint there (the trainer's
checkpoints/<exp>/minkunet); without one the demo warns and runs on the
seeded init. As the JAX demo, it cannot run a CRF variant (the CRF needs
each voxel's colours, which the demo does not pass) or a sparse ResNet
(a classifier without conv1_kernel_size): it refuses them before it reads
or writes anything."""

from __future__ import annotations

import argparse
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage2_common import VALID_CLASS_IDS
from seggroup_tpu_torch.data.ply import read_ply, write_ply
from seggroup_tpu_torch.data.visualize import colorize_labels
from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models import get_model, model_names
from seggroup_tpu_torch.sparse.tensor import SparseTensor
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager


def load_ply_points(path: str):
    """PLY -> (coords (N, 3) float64, colors (N, 3) 0..255 float32; 160
    where the file has no colours)."""
    v = read_ply(path)["vertex"]
    coords = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    if "red" in v.dtype.names:
        colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
    else:
        colors = np.full((len(coords), 3), 160.0, np.float32)
    return coords, colors


def refusal(variant: str) -> str | None:
    """Why the demo cannot run `variant` (as the JAX demo cannot), or None."""
    from seggroup_tpu_torch.models.minkunet import (HYPER_VARIANTS, RESUNET_VARIANTS,
                                                    ST_RESUNET_VARIANTS, ST_VARIANTS,
                                                    VARIANTS)
    from seggroup_tpu_torch.models.resnet_sparse import RESNET_VARIANTS, ST_RESNET_VARIANTS

    if variant.startswith(("BilateralCRF-", "TrilateralCRF-")):
        return (f"{variant} needs each voxel's colours, which the demo does not pass "
                "(the JAX demo fails on it too)")
    if variant in RESNET_VARIANTS or variant in ST_RESNET_VARIANTS:
        return (f"{variant} is a per-scene classifier without conv1_kernel_size, not a "
                "segmentation net (the JAX demo fails on it too)")
    if variant not in {**VARIANTS, **ST_VARIANTS, **RESUNET_VARIANTS, **ST_RESUNET_VARIANTS,
                       **HYPER_VARIANTS}:
        return (f"{variant!r} is not a semantic U-Net of the registry; have "
                f"{model_names()}")
    return None


def main(argv: Sequence[str] | None = None, phase_seconds: dict | None = None):
    """Runs the demo; returns (the written points (N, 3), their NYU40
    labels (N,)). With `phase_seconds`, the wall seconds of "voxelize",
    "model", "forward" and "write" are added to the dict, the card
    synchronised around each."""
    p = argparse.ArgumentParser("standalone semantic inference demo")
    p.add_argument("--ply", type=str, default=None, help="input point cloud")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a synthetic scene instead of a PLY")
    p.add_argument("--variant", type=str, default="Res16UNet34C")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="checkpoint dir of cli.stage2_train_minkunet (random weights and "
                        "a warning otherwise, like the reference demo without its .pth)")
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--conv1_kernel_size", type=int, default=3,
                   help="reference demo weights use 5 (demo/scannet.py:43)")
    p.add_argument("--capacity", type=int, default=2 ** 17)
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--out", type=str, default="pred.ply")
    p.add_argument("--voxel_centers", action="store_true",
                   help="write voxel centers instead of reprojected points")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if not args.ply and not args.synthetic:
        p.error("pass --ply FILE or --synthetic")
    why = refusal(args.variant)
    if why:
        p.error(why)
    dev = resolve_device(args.device)
    phase = PhaseClock(dev, phase_seconds)

    with phase("voxelize"):
        if args.ply:
            coords, colors = load_ply_points(args.ply)
        else:
            from seggroup_tpu_torch.data.synthetic import make_synthetic_scene

            scene = make_synthetic_scene(seed=0, num_points=20000)
            coords = np.asarray(scene.points[:, :3], np.float64)
            colors = (np.asarray(scene.points[:, 3:6]) + 1.0) * 127.5
        labels = np.full(len(coords), 255, np.int32)  # unlabeled: inference only
        vb = make_voxel_batch([(coords, colors, labels)], args.capacity, args.voxel_size)
        st = SparseTensor(torch.from_numpy(vb.coords), torch.from_numpy(vb.feats),
                          torch.from_numpy(vb.valid),
                          torch.tensor(int(vb.num), dtype=torch.int32)).to(dev)

    with phase("model"):
        c = args.capacity
        model = get_model(args.variant, out_channels=args.num_classes,
                          level_caps=[c, c // 2, c // 4, c // 8, c // 8],
                          conv1_kernel_size=args.conv1_kernel_size, ndim=3, device=dev)
        restored = None
        if args.checkpoint_dir:
            restored = CheckpointManager(args.checkpoint_dir).restore(map_location=dev)
        if restored is not None:
            model.load_state_dict(restored["model"])
            print(f"loaded checkpoint from {args.checkpoint_dir}")
        else:
            print("WARNING: random weights (no --checkpoint_dir or empty dir)")

    with phase("forward"), torch.no_grad():
        logits = model(st, train=False)[: int(vb.num)].cpu().numpy()

    with phase("write"):
        # 20-class -> NYU40 ids -> palette (reference demo VALID_CLASS_IDS +
        # COLOR_MAP, demo/scannet.py:45-87 == the NYU40 palette rows)
        vox_nyu40 = np.asarray(VALID_CLASS_IDS, np.int64)[logits.argmax(1)]
        if args.voxel_centers:
            pts = (vb.coords[: int(vb.num), 1:4].astype(np.float64) + 0.5) * args.voxel_size
            lab = vox_nyu40
        else:
            p2v = vb.point2voxel[0]
            keep = p2v >= 0
            pts = coords[: len(p2v)][keep]
            lab = vox_nyu40[p2v[keep]]
            if (~keep).any():
                print(f"{int((~keep).sum())} points over capacity dropped")
        rgb = colorize_labels(lab, "semantic")
        write_ply(args.out, {
            "x": pts[:, 0].astype(np.float32),
            "y": pts[:, 1].astype(np.float32),
            "z": pts[:, 2].astype(np.float32),
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
        })
    uniq, cnt = np.unique(lab, return_counts=True)
    top = ", ".join(f"nyu40:{u}={c}" for u, c in
                    sorted(zip(uniq, cnt), key=lambda t: -t[1])[:5])
    print(f"wrote {args.out}: {len(pts)} points, top classes [{top}]")
    return pts, lab


if __name__ == "__main__":
    main()
