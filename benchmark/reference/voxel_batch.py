"""Plain reference of the MinkUNet trainer's batches: the training tuple of
a scene, the ScanNet augmentation recipe, 2 cm voxelisation and the packing
of a step's scenes into one batch of fixed capacity, in numpy.

A frozen copy of the port's host pipeline as it stood when the benchmark
was written (its numpy augmentations draw from the generator in the
reference recipe's order), so that the reference can work out each step's
batch again from the scenes and the step's seed. `wire_round` is what the
device-plan wire does to a batch: float16 features, int16 coordinates."""

from __future__ import annotations

import numpy as np

IGNORE_LABEL = 255
VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
NYU40_TO_20 = np.full(41, IGNORE_LABEL, np.int32)
NYU40_TO_20[list(VALID_CLASS_IDS)] = np.arange(len(VALID_CLASS_IDS))
ELASTIC = ((0.2, 0.4), (0.8, 1.6))


def training_tuple(points: np.ndarray, real_sem: np.ndarray):
    """(coords m, colours 0..255, 20-class labels or 255) of a scene."""
    coords = points[:, :3].astype(np.float32)
    colors = ((points[:, 3:] + 1.0) * 127.5).astype(np.float32)
    return coords, colors, NYU40_TO_20[np.clip(real_sem, 0, 40)].astype(np.int32)


def _box3(x, axis):
    w = np.float64(np.float32(1 / 3))
    xd = np.moveaxis(x, axis, 0).astype(np.float64)
    pad = np.zeros((xd.shape[0] + 2,) + xd.shape[1:])
    pad[1:-1] = xd
    out = pad[1:-1] * w + (pad[2:] + pad[:-2]) * w
    return np.moveaxis(out.astype(x.dtype), 0, axis)


def _elastic(coords, rng, granularity, magnitude):
    mins = coords.min(0)
    dims = ((coords - mins).max(0) // granularity).astype(int) + 3
    noise = rng.standard_normal(size=(*dims, 3), dtype=np.float32)
    for _ in range(2):
        for axis in range(3):
            noise = _box3(noise, axis)
    c = np.ascontiguousarray(coords, np.float32)
    nd = np.asarray(noise.shape[:3], np.int64)
    f = (c - np.asarray(mins, np.float32)) * (np.float32(1.0) / np.float32(granularity)) \
        + np.float32(1.0)
    f = np.maximum(f, np.float32(0.0))
    i0 = np.minimum(np.floor(f).astype(np.int64), nd - 2)
    w1 = f - i0.astype(np.float32)
    w0 = np.float32(1.0) - w1
    x, y, z = i0[:, 0], i0[:, 1], i0[:, 2]

    def corner(dx, dy, dz):
        return noise[x + dx, y + dy, z + dz]

    wx0, wy0, wz0 = (w0[:, d:d + 1] for d in range(3))
    wx1, wy1, wz1 = (w1[:, d:d + 1] for d in range(3))
    v = (wx0 * (wy0 * (wz0 * corner(0, 0, 0) + wz1 * corner(0, 0, 1))
                + wy1 * (wz0 * corner(0, 1, 0) + wz1 * corner(0, 1, 1)))
         + wx1 * (wy0 * (wz0 * corner(1, 0, 0) + wz1 * corner(1, 0, 1))
                  + wy1 * (wz0 * corner(1, 1, 0) + wz1 * corner(1, 1, 1))))
    return c + np.float32(magnitude) * v


def augment(coords, colors, labels, rng):
    """Point dropout, upright rotation, scale, flips, two elastic
    distortions, chromatic auto-contrast, translation and jitter."""
    if rng.random() < 0.2:
        n = len(coords)
        inds = rng.choice(n, int(n * 0.8), replace=False)
        coords, colors, labels = coords[inds], colors[inds], labels[inds]
    t = rng.uniform(-np.pi, np.pi)
    c, s = np.cos(t), np.sin(t)
    coords = coords @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32).T
    coords = coords * rng.uniform(0.9, 1.1)
    coords = coords.copy()
    for axis in (0, 1):
        if rng.random() < 0.5:
            coords[:, axis] = -coords[:, axis]
    for gran, mag in ELASTIC:
        if rng.random() < 0.95:
            coords = _elastic(coords, rng, gran, mag)
    if rng.random() < 0.2:
        lo, hi = colors.min(0, keepdims=True), colors.max(0, keepdims=True)
        stretched = (colors - lo) * (255 / np.maximum(hi - lo, 1e-6))
        bf = rng.random()
        colors = (1 - bf) * colors + bf * stretched
    if rng.random() < 0.95:
        colors = np.clip(colors + (rng.random((1, 3)) - 0.5) * 255 * 2 * 0.1, 0, 255)
    if rng.random() < 0.95:
        colors = np.clip(colors + rng.standard_normal(colors.shape) * 255 * 0.05, 0, 255)
    return coords.astype(np.float32), colors.astype(np.float32), labels


def voxelize(coords, colors, labels, voxel_size):
    """Voxels sorted by (x, y, z) after a shift to non-negative coordinates,
    each voxel's first point as its representative."""
    ic = np.floor(np.ascontiguousarray(coords, np.float32) / np.float32(voxel_size))
    ic = ic.astype(np.int32)
    rel = (ic - ic.min(0)).astype(np.int64)
    key = (rel[:, 0] << 32) | (rel[:, 1] << 16) | rel[:, 2]
    order = np.argsort(key, kind="stable")
    s_key = key[order]
    firsts = np.ones(len(order), bool)
    firsts[1:] = s_key[1:] != s_key[:-1]
    first = order[firsts]
    return rel[first].astype(np.int32), colors[first], labels[first]


def train_batch(tuples, step_seed, batch_size, capacity, voxel_size):
    """The batch of one step: `batch_size` scenes drawn from `tuples` by
    the generator seeded with `step_seed` (a tuple), each augmented and
    voxelised, concatenated with their scene index up to `capacity` rows.
    Returns (coords (capacity, 4) int32, feats (capacity, 3) float32 in
    [-1, 1], labels (capacity,) int32, num)."""
    rng = np.random.default_rng(step_seed)
    idx = rng.integers(0, len(tuples), size=batch_size)
    cs, fs, ls = [], [], []
    total = 0
    for b, i in enumerate(idx):
        c, f, l = augment(*tuples[int(i)], rng)
        ic, vf, vl = voxelize(c, f, l, voxel_size)
        keep = min(len(ic), capacity - total)
        cs.append(np.concatenate([np.full((keep, 1), b, np.int32), ic[:keep]], axis=1))
        fs.append(vf[:keep])
        ls.append(vl[:keep])
        total += keep
        if total >= capacity:
            break
    coords = np.zeros((capacity, 4), np.int32)
    feats = np.zeros((capacity, 3), np.float32)
    labels = np.full((capacity,), IGNORE_LABEL, np.int32)
    coords[:total] = np.concatenate(cs)
    feats[:total] = np.concatenate(fs)
    labels[:total] = np.concatenate(ls)
    return coords, feats / 127.5 - 1.0, labels, total


def wire_round(coords, feats, labels, num):
    """The batch as the float16 wire carries it to the card."""
    return (coords.astype(np.int16).astype(np.int32),
            feats.astype(np.float16).astype(np.float32), labels.astype(np.uint8).astype(np.int32),
            num)
