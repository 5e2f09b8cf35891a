"""KPConv model introspection (cli/introspect_kpconv.py of the JAX package;
reference kpconv/visualize_features.py, visualize_ERFs.py,
visualize_deformations.py): PLY clouds for any viewer, one sphere of each
scene (centred at its middle point) through KPFCNN.

  features      per-point max-abs response of one feature map, coloured
                on the input cloud. The maps are every module's output
                with one row per input point, named by their flax paths
                ('b1/bn1/__call__/[0]') and ordered as jax.tree_util
                flattens flax's captured intermediates (keys sorted); the
                last one matching `--block` (by default the last of all)
                is shown, as the JAX driver picks it;
  erf           the effective receptive field of one query point: |d
                sum(logits[q]) / d input features| per point, by autograd;
  deformations  the deformed kernel points of every deformable layer around
                one query point (models.kpconv.capture_deformed_kp).

    python -m seggroup_tpu_torch.cli.introspect_kpconv --mode erf --synthetic 1 --out erf
    python -m seggroup_tpu_torch.cli.introspect_kpconv --mode features --synthetic 1 \\
        --device cpu --point_cap 512 --first_features_dim 16 --dl0 0.2 --in_radius 5.0

Runs on the card unless `--device cpu`. Restores the latest checkpoint of
checkpoints/<exp>/kpconv (cli/stage2_train_kpconv.py writes it), or runs
on random weights from seed 0 with a warning; logs to
checkpoints/<exp>/introspect.log."""

from __future__ import annotations

import argparse
import os
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch.cli.stage1_common import SceneSource, add_common_args
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.cli.stage2_test_semantic import KPCONV_LAYERS, kpconv_level_caps
from seggroup_tpu_torch.data.ply import write_ply
from seggroup_tpu_torch.device import resolve_device
from seggroup_tpu_torch.models.kpconv import KPFCNN, build_pyramid, capture_deformed_kp
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager
from seggroup_tpu_torch.utils.logging import IOStream


def heat_colors(x: np.ndarray) -> np.ndarray:
    """Scalar [0..1] -> blue->red heat, uint8 (N, 3)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], 1) * 255).astype(np.uint8)


def dump_cloud(path, pts, colors):
    write_ply(path, {"x": pts[:, 0].astype(np.float32), "y": pts[:, 1].astype(np.float32),
                     "z": pts[:, 2].astype(np.float32), "red": colors[:, 0],
                     "green": colors[:, 1], "blue": colors[:, 2]})


def _flatten(node, prefix=()):
    """Leaves of nested dicts (keys sorted) and tuples ('[i]'), with paths."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _flatten(node[key], prefix + (key,))
    elif isinstance(node, (tuple, list)):
        for i, x in enumerate(node):
            yield from _flatten(x, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), node


def feature_responses(model: KPFCNN, pyramid, feats: torch.Tensor) -> list[tuple[str, np.ndarray]]:
    """(flax path, per-row max |response|) of every module output with one
    row per input point, in the order jax.tree_util flattens flax's
    `capture_intermediates` tree."""
    rows = feats.shape[0]
    tree: dict = {}
    hooks = []
    for name, mod in model.named_modules():
        node = tree
        for key in name.split(".") if name else ():
            node = node.setdefault(key, {})

        def keep(_mod, _inputs, out, node=node):
            node["__call__"] = (out,)
        hooks.append(mod.register_forward_hook(keep))
    try:
        with torch.no_grad():
            model(pyramid, feats)
    finally:
        for h in hooks:
            h.remove()
    return [(path, v.abs().amax(dim=1).cpu().numpy()) for path, v in _flatten(tree)
            if isinstance(v, torch.Tensor) and v.ndim == 2 and v.shape[0] == rows]


def erf_gradient(model: KPFCNN, pyramid, feats: torch.Tensor, q: int) -> np.ndarray:
    """d sum(logits[q]) / d feats, (N, Cin)."""
    f = feats.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        logits, _ = model(pyramid, f)
        (grad,) = torch.autograd.grad(logits[q].sum(), f)
    return grad.cpu().numpy()


def deformed_kernel_points(model: KPFCNN, pyramid, feats: torch.Tensor) -> dict:
    """{flax path of the layer's 'deformed_kp': (Nq, P, 3)} of one forward."""
    with capture_deformed_kp(model) as kps, torch.no_grad():
        model(pyramid, feats)
    return {k: v.cpu().numpy() for k, v in kps.items()}


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("KPConv introspection")
    add_common_args(p)
    p.add_argument("--mode", type=str, required=True,
                   choices=["features", "erf", "deformations"])
    p.add_argument("--out", type=str, default="introspect")
    p.add_argument("--point_cap", type=int, default=2 ** 13)
    p.add_argument("--dl0", type=float, default=0.04)
    p.add_argument("--in_radius", type=float, default=2.0)
    p.add_argument("--first_features_dim", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--block", type=str, default=None,
                   help="features mode: intermediates path substring to "
                        "visualize (default: the deepest encoder block)")
    p.add_argument("--query_point", type=int, default=None,
                   help="erf/deformations: input point row (default center)")
    p.add_argument("--num_scenes", type=int, default=1)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    io = IOStream(os.path.join("checkpoints", args.exp_name, "introspect.log"))
    os.makedirs(args.out, exist_ok=True)
    source = SceneSource(args)
    n_cap = args.point_cap
    caps = kpconv_level_caps(n_cap)
    model = KPFCNN(num_classes=args.num_classes, first_features_dim=args.first_features_dim,
                   dl0=args.dl0, device=dev)
    ckpt = CheckpointManager(os.path.join("checkpoints", args.exp_name, "kpconv"))
    restored = ckpt.restore(map_location=dev)
    rng = np.random.default_rng(args.seed)

    def scene_sphere(i):
        scene, extras = source.get(i)
        c, col, _ = scene_to_training_tuple(scene, extras, None, source.names[i], False)
        center = c[len(c) // 2]
        sel = np.where(((c - center) ** 2).sum(1) < args.in_radius ** 2)[0]
        if len(sel) > n_cap:
            sel = sel[rng.permutation(len(sel))[:n_cap]]
        pts = np.zeros((n_cap, 3), np.float32)
        feats = np.ones((n_cap, 4), np.float32)
        pts[: len(sel)] = c[sel]
        feats[: len(sel), 1:] = col[sel] / 255.0
        valid = np.zeros(n_cap, bool)
        valid[: len(sel)] = True
        return pts, feats, valid, len(sel)

    def pyramid(pts, valid):
        return build_pyramid(torch.from_numpy(pts).to(dev),
                             torch.zeros(n_cap, dtype=torch.int32, device=dev),
                             torch.from_numpy(valid).to(dev), KPCONV_LAYERS, args.dl0,
                             level_caps=caps)

    # the JAX driver draws its first sphere before the weights
    scene_sphere(0)
    if restored is not None:
        model.load_state_dict(restored["model"])
        io.cprint(f"loaded checkpoint {ckpt.latest_step()}")
    else:
        io.cprint("WARNING: random weights")

    try:
        for i in range(min(args.num_scenes, len(source))):
            pts, feats, valid, n = scene_sphere(i)
            name = source.names[i]
            pyr = pyramid(pts, valid)
            f = torch.from_numpy(feats).to(dev)
            if args.mode == "features":
                cands = [(path, v) for path, v in feature_responses(model, pyr, f)
                         if args.block is None or args.block in path]
                if not cands:
                    io.cprint(f"no intermediates match block={args.block!r}")
                    return
                path, v = cands[-1]
                resp = v[:n]
                resp = resp / max(resp.max(), 1e-9)
                dump_cloud(os.path.join(args.out, f"{name}_features.ply"), pts[:n],
                           heat_colors(resp))
                io.cprint(f"[{name}] features of {path} -> {args.out}/{name}_features.ply")
            elif args.mode == "erf":
                q = args.query_point if args.query_point is not None else n // 2
                g = erf_gradient(model, pyr, f, q)[:n]
                mag = np.abs(g).sum(1)
                mag = (mag / max(mag.max(), 1e-9)) ** 0.25  # gamma, ERFs are peaky
                colors = heat_colors(mag)
                colors[q] = (255, 255, 255)
                dump_cloud(os.path.join(args.out, f"{name}_erf.ply"), pts[:n], colors)
                io.cprint(f"[{name}] ERF of point {q} -> {args.out}/{name}_erf.ply")
            else:
                kps = deformed_kernel_points(model, pyr, f)
                for path in sorted(kps):
                    kp = kps[path]
                    q = min(args.query_point or kp.shape[0] // 2, kp.shape[0] - 1)
                    layer = path.split("/deformed_kp")[0].replace("/", "_")
                    kpq = kp[q]  # (P, 3) offsets around the query
                    col = np.full((len(kpq), 3), (255, 64, 64), np.uint8)
                    dump_cloud(os.path.join(args.out, f"{name}_{layer}_kp.ply"), kpq, col)
                io.cprint(f"[{name}] {len(kps)} deformable layers -> {args.out}/")
    finally:
        io.close()


if __name__ == "__main__":
    main()
