"""KPCNN point-cloud classification evaluation with vote averaging
(cli/stage2_test_classification.py of the JAX package; reference
kpconv/utils/tester.py:127-215): repeated augmented passes over the test
set, the incremental mean of each object's probabilities over the votes
(tester.py:195-196), the accuracy from the confusion matrix
(tester.py:203-209). Without ModelNet40 the default input is a synthetic
set of parametric shapes (sphere, cube, cylinder, plane, torus, cone); or
`--data_root` with `clouds.npy` (an object array of (Ni, 3) float32) and
`labels.npy`.

    python -m seggroup_tpu_torch.cli.stage2_test_classification --synthetic 16 --votes 3
    python -m seggroup_tpu_torch.cli.stage2_test_classification --device cpu

Runs on the card unless `--device cpu`. Restores the latest checkpoint of
checkpoints/<exp>/kpcnn (`{"model": state_dict}`; models.convert's
kpcnn_params_from_flax maps a JAX one), or runs on random weights from
seed 0 with a warning; logs to checkpoints/<exp>/kpcnn_test.log."""

from __future__ import annotations

import argparse
import os
from collections.abc import Callable, Sequence

import numpy as np
import torch

from seggroup_tpu_torch.data import transforms as T
from seggroup_tpu_torch.device import resolve_device
from seggroup_tpu_torch.models.kpconv import KPCNN, build_pyramid
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager
from seggroup_tpu_torch.utils.logging import IOStream

SHAPE_NAMES = ("sphere", "cube", "cylinder", "plane", "torus", "cone")
KPCNN_LAYERS = 5


def make_shape_cloud(cls: int, rng: np.random.Generator, n: int = 512,
                     noise: float = 0.01) -> np.ndarray:
    """Surface-sampled parametric shape, unit scale, class = shape family."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(-1, 1, n)
    if cls == 0:  # sphere
        phi = np.arccos(v)
        p = np.stack([np.sin(phi) * np.cos(u), np.sin(phi) * np.sin(u), np.cos(phi)], 1)
    elif cls == 1:  # cube surface
        p = rng.uniform(-1, 1, (n, 3))
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        p[np.arange(n), face] = sign
    elif cls == 2:  # cylinder (side + caps)
        p = np.stack([np.cos(u), np.sin(u), v], 1)
        cap = rng.random(n) < 0.25
        r = np.sqrt(rng.random(cap.sum()))
        p[cap, 0] = r * np.cos(u[cap])
        p[cap, 1] = r * np.sin(u[cap])
        p[cap, 2] = rng.choice([-1.0, 1.0], cap.sum())
    elif cls == 3:  # plane
        p = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), np.zeros(n)], 1)
    elif cls == 4:  # torus
        w = rng.uniform(0, 2 * np.pi, n)
        p = np.stack([(1 + 0.35 * np.cos(w)) * np.cos(u),
                      (1 + 0.35 * np.cos(w)) * np.sin(u), 0.35 * np.sin(w)], 1)
    else:  # cone
        h = np.sqrt(rng.random(n))  # area-uniform along the slant
        p = np.stack([(1 - h) * np.cos(u), (1 - h) * np.sin(u), 2 * h - 1], 1)
    return (p + rng.normal(0, noise, (n, 3))).astype(np.float32)


def vote_augment(coords: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-vote augmentation (the reference's tf_augment_input for
    classification: z-rotation + scale + noise, kpconv common.py:225-293)."""
    c = T.random_rotation_z(coords, rng)
    c = T.random_scale(c, rng, lo=0.9, hi=1.1)
    return c + rng.normal(0, 0.002, c.shape).astype(np.float32)


def kpcnn_level_caps(n_cap: int) -> list[int]:
    """The classification pyramid's row capacities below level 0."""
    return [max(n_cap >> i, 64) for i in range(1, KPCNN_LAYERS)]


def vote_classify(model: KPCNN, clouds: Sequence[np.ndarray], labels: np.ndarray,
                  num_classes: int, votes: int, points_per_cloud: int,
                  rng: np.random.Generator, log: Callable[[str], None] = print):
    """Vote passes over `clouds` in batches of the model's `num_batches`
    clouds (each cloud's augmented points in its own slot of
    `points_per_cloud` rows) until every object has `votes` votes; after
    each pass `log` gets the accuracy line. Returns (the mean probabilities
    (objects, classes) in float64, the confusion matrix, the accuracy in
    percent)."""
    dev = model.device
    b = model.num_batches
    n_cap = b * points_per_cloud
    caps = kpcnn_level_caps(n_cap)
    ones = torch.ones((n_cap, 1), dtype=torch.float32, device=dev)
    num_objects = len(clouds)
    average_probs = np.zeros((num_objects, num_classes))
    average_counts = np.zeros(num_objects)
    while average_counts.min() < votes:
        for start in range(0, num_objects, b):
            idx = np.arange(start, min(start + b, num_objects))
            pts = np.zeros((n_cap, 3), np.float32)
            bids = np.zeros(n_cap, np.int32)
            valid = np.zeros(n_cap, bool)
            for j, oi in enumerate(idx):
                c = vote_augment(clouds[oi], rng)
                sl = slice(j * points_per_cloud, j * points_per_cloud + len(c))
                pts[sl] = c
                bids[sl] = j
                valid[sl] = True
            with torch.no_grad():
                pyr = build_pyramid(torch.from_numpy(pts).to(dev), torch.from_numpy(bids).to(dev),
                                    torch.from_numpy(valid).to(dev), KPCNN_LAYERS, model.dl0,
                                    level_caps=caps)
                logits, _ = model(pyr, ones)
            logits = logits.cpu().numpy()[: len(idx)]
            sm = np.exp(logits - logits.max(1, keepdims=True))
            sm /= sm.sum(1, keepdims=True)
            average_counts[idx] += 1
            average_probs[idx] += (sm - average_probs[idx]) / average_counts[idx, None]
        pred = average_probs.argmax(1)
        conf = np.zeros((num_classes, num_classes), np.int64)
        np.add.at(conf, (labels, pred), 1)
        acc = 100.0 * np.trace(conf) / max(conf.sum(), 1)
        log(f"Vote {average_counts.min():.0f} : Test Accuracy = {acc:.1f}%")
    return average_probs, conf, acc


def main(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser("KPCNN classification eval (vote accuracy)")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--synthetic", type=int, default=16,
                   help="number of synthetic shape clouds (ignored when "
                        "--data_root is given)")
    p.add_argument("--data_root", type=str, default=None,
                   help="dir with clouds.npy (object array of (Ni,3)) and "
                        "labels.npy")
    p.add_argument("--num_classes", type=int, default=len(SHAPE_NAMES))
    p.add_argument("--votes", type=int, default=3)
    p.add_argument("--points_per_cloud", type=int, default=512)
    p.add_argument("--batch_clouds", type=int, default=8)
    p.add_argument("--first_features_dim", type=int, default=32)
    p.add_argument("--dl0", type=float, default=0.08)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    io = IOStream(os.path.join("checkpoints", args.exp_name, "kpcnn_test.log"))
    rng = np.random.default_rng(args.seed)
    if args.data_root:
        clouds = list(np.load(os.path.join(args.data_root, "clouds.npy"), allow_pickle=True))
        labels = np.load(os.path.join(args.data_root, "labels.npy"))
    else:
        labels = np.arange(args.synthetic) % args.num_classes
        clouds = [make_shape_cloud(int(c), rng, args.points_per_cloud) for c in labels]

    model = KPCNN(num_classes=args.num_classes, first_features_dim=args.first_features_dim,
                  dl0=args.dl0, num_batches=args.batch_clouds, device=dev)
    ckpt = CheckpointManager(os.path.join("checkpoints", args.exp_name, "kpcnn"))
    restored = ckpt.restore(map_location=dev)
    if restored is not None:
        model.load_state_dict(restored["model"])
        io.cprint(f"loaded checkpoint {ckpt.latest_step()}")
    else:
        io.cprint("WARNING: random weights")
    try:
        _, conf, acc = vote_classify(model, clouds, labels, args.num_classes, args.votes,
                                     args.points_per_cloud, rng, io.cprint)
        io.cprint("confusion matrix:")
        for row in conf:
            io.cprint(" ".join(f"{int(x):d}" for x in row))
        io.cprint(f"FINAL accuracy {acc:.2f}% over {len(clouds)} objects, "
                  f"{args.votes} votes")
    finally:
        io.close()
    return acc


if __name__ == "__main__":
    main()
