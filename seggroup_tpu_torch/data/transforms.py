"""Host-side point-cloud augmentations for stage-2 training
(seggroup_tpu/data/transforms.py).

A numpy copy of the JAX package's augmentations (reference
minkowski/lib/transforms.py:20-235, lib/voxelizer.py:44-131, and pointgroup
data/scannetv2_inst.py:81-139): rotation/scale/flip, elastic distortion,
chromatic autocontrast/translation/jitter, dropout, spatial crop. All
operate on (N, 3) coords / (N, 3) colors in [0, 255] float. Each function
draws from the generator in the same order as the JAX package's, so one
seed gives the same stream of augmentations.

The one difference: the JAX package samples the elastic displacement field
in C++ (seggroup_tpu/csrc/seggroup_native.cpp:466-499); here the same loop
is vectorised float32 numpy (`_elastic_interp`) with the same clamps and the
same order of operations. The C++ build may contract a multiply-add into an
FMA, so the two agree to about 1e-6 m, not bit for bit.
"""

from __future__ import annotations

import numpy as np

# the reference ScanNet training recipe's parameters
ROTATION_BOUND = 2 * np.pi  # full upright rotation
SCALE_RANGE = (0.9, 1.1)
ELASTIC = ((0.2, 0.4), (0.8, 1.6))  # (granularity, magnitude) pairs
TRANSLATION_RATIO = 0.1
JITTER_STD = 0.05
DROPOUT_RATIO = 0.2


def random_rotation_z(coords: np.ndarray, rng: np.random.Generator,
                      max_angle: float = ROTATION_BOUND) -> np.ndarray:
    """Upright rotation (reference voxelizer ROTATION_AUGMENTATION_BOUND z-axis)."""
    t = rng.uniform(-max_angle / 2, max_angle / 2)
    c, s = np.cos(t), np.sin(t)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return coords @ rot.T


def random_scale(coords: np.ndarray, rng: np.random.Generator,
                 lo: float = SCALE_RANGE[0], hi: float = SCALE_RANGE[1]) -> np.ndarray:
    return coords * rng.uniform(lo, hi)


def random_flip(coords: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    out = coords.copy()
    for axis in (0, 1):
        if rng.random() < 0.5:
            out[:, axis] = -out[:, axis]
    return out


def elastic_distortion(coords: np.ndarray, rng: np.random.Generator,
                       granularity: float, magnitude: float) -> np.ndarray:
    """Blurred-noise displacement field (reference transforms.py:203-235 /
    pointgroup scannetv2_inst.py:81-98).

    The box blurs run as separable 3-tap correlations (same kernel as the
    reference's ones(3)/3 convolve passes; a symmetric kernel makes convolve
    == correlate)."""
    mins = coords.min(0)
    dims = ((coords - mins).max(0) // granularity).astype(int) + 3
    noise = rng.standard_normal(size=(*dims, 3), dtype=np.float32)
    for _ in range(2):
        for axis in range(3):
            noise = _box3(noise, axis)
    return _elastic_interp(coords, mins, granularity, magnitude, noise)


def _box3(x: np.ndarray, axis: int) -> np.ndarray:
    """The 3-tap box correlation along `axis` with zeros past the ends, as
    scipy.ndimage.correlate1d(x, float32 [1/3] * 3, mode="constant")
    computes it: in float64, the centre tap plus the sum of the two outer
    ones times the weight (its symmetric-kernel path), cast back to x's
    dtype."""
    w = np.float64(np.float32(1 / 3))
    xd = np.moveaxis(x, axis, 0).astype(np.float64)
    pad = np.zeros((xd.shape[0] + 2,) + xd.shape[1:])
    pad[1:-1] = xd
    out = pad[1:-1] * w + (pad[2:] + pad[:-2]) * w
    return np.moveaxis(out.astype(x.dtype), 0, axis)


def _elastic_interp(coords: np.ndarray, mins: np.ndarray, granularity: float,
                    magnitude: float, noise: np.ndarray) -> np.ndarray:
    """coords + magnitude * trilinear(noise) at each point, in float32. Grid
    axis d has noise.shape[d] samples at spacing `granularity` starting at
    -granularity from the cloud minimum, so a point's grid position is
    (p - min) / granularity + 1, clamped to [0, shape - 2] for the base
    cell."""
    c = np.ascontiguousarray(coords, np.float32)
    dims = np.asarray(noise.shape[:3], np.int64)
    inv_g = np.float32(1.0) / np.float32(granularity)
    f = (c - np.asarray(mins, np.float32)) * inv_g + np.float32(1.0)
    f = np.maximum(f, np.float32(0.0))
    i0 = np.minimum(np.floor(f).astype(np.int64), dims - 2)
    w1 = f - i0.astype(np.float32)
    w0 = np.float32(1.0) - w1
    x, y, z = i0[:, 0], i0[:, 1], i0[:, 2]

    def corner(dx, dy, dz):
        return noise[x + dx, y + dy, z + dz]  # (N, 3)

    wx0, wy0, wz0 = (w0[:, d:d + 1] for d in range(3))
    wx1, wy1, wz1 = (w1[:, d:d + 1] for d in range(3))
    v = (wx0 * (wy0 * (wz0 * corner(0, 0, 0) + wz1 * corner(0, 0, 1))
                + wy1 * (wz0 * corner(0, 1, 0) + wz1 * corner(0, 1, 1)))
         + wx1 * (wy0 * (wz0 * corner(1, 0, 0) + wz1 * corner(1, 0, 1))
                  + wy1 * (wz0 * corner(1, 1, 0) + wz1 * corner(1, 1, 1))))
    return c + np.float32(magnitude) * v


def chromatic_auto_contrast(colors: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(reference transforms.py:38-53)"""
    if rng.random() >= 0.2:
        return colors
    lo = colors.min(0, keepdims=True)
    hi = colors.max(0, keepdims=True)
    scale = 255 / np.maximum(hi - lo, 1e-6)
    stretched = (colors - lo) * scale
    bf = rng.random()
    return (1 - bf) * colors + bf * stretched


def chromatic_translation(colors: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(reference transforms.py:56-66)"""
    if rng.random() >= 0.95:
        return colors
    tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * TRANSLATION_RATIO
    return np.clip(colors + tr, 0, 255)


def chromatic_jitter(colors: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(reference transforms.py:69-78)"""
    if rng.random() >= 0.95:
        return colors
    noise = rng.standard_normal(colors.shape) * 255 * JITTER_STD
    return np.clip(colors + noise, 0, 255)


def random_dropout(coords: np.ndarray, feats: np.ndarray,
                   labels: np.ndarray, rng: np.random.Generator):
    """Random point dropout (reference minkowski/lib/transforms.py:141-156,
    wired into training at lib/dataset.py:451).

    Faithful to the reference's behaviour, including its quirk: the
    *application* probability is DROPOUT_RATIO itself (the constructor's
    dropout_application_ratio is never read), and when applied it keeps a
    uniform sample of N*(1-DROPOUT_RATIO) points."""
    if rng.random() < DROPOUT_RATIO:
        n = len(coords)
        inds = rng.choice(n, int(n * (1 - DROPOUT_RATIO)), replace=False)
        return coords[inds], feats[inds], labels[inds]
    return coords, feats, labels


def spatial_crop(xyz: np.ndarray, max_npoint: int, rng: np.random.Generator,
                 full_scale: int = 512, shrink: int = 32):
    """Reference PointGroup spatial crop (pointgroup data/scannetv2_inst.py:
    142-158): shift the (voxel-scaled, >= 0) cloud by a random offset inside
    a [0, full_scale)^3 window and shrink the window's xy extent by `shrink`
    until <= max_npoint points survive. Returns (xyz_offset, valid_mask) —
    a spatially coherent crop, unlike first-N truncation.

    Guaranteed to terminate: once full_scale[:2] <= 0 no point is valid."""
    xyz_offset = xyz.copy()
    valid = np.ones(len(xyz), bool)
    fs = np.array([full_scale] * 3, np.float64)
    room_range = xyz.max(0) - xyz.min(0)
    while valid.sum() > max_npoint:
        offset = np.clip(fs - room_range + 0.001, None, 0) * rng.random(3)
        xyz_offset = xyz + offset
        valid = (xyz_offset.min(1) >= 0) & ((xyz_offset < fs).sum(1) == 3)
        fs[:2] -= shrink
    return xyz_offset, valid


def default_train_transform(coords, colors, rng):
    """The reference ScanNet training recipe (minkowski scannet.py
    ELASTIC_DISTORT_PARAMS + voxelizer augs)."""
    coords = random_rotation_z(coords, rng)
    coords = random_scale(coords, rng)
    coords = random_flip(coords, rng)
    for gran, mag in ELASTIC:
        if rng.random() < 0.95:
            coords = elastic_distortion(coords, rng, gran, mag)
    colors = chromatic_auto_contrast(colors, rng)
    colors = chromatic_translation(colors, rng)
    colors = chromatic_jitter(colors, rng)
    return coords.astype(np.float32), colors.astype(np.float32)
