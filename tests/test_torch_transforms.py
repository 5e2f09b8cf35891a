"""The port's training augmentations (seggroup_tpu_torch.data.transforms)
and augmented voxel batches against the JAX package's, with the same
numpy generator seed on both sides.

Every transform draws in the same order, so each leaves the generator in
the same state. Rotation, scale, flip, dropout, crop and the chromatic
transforms are numpy on both sides and equal. The elastic distortion's
noise grid and blur are equal; its trilinear sampling runs in C++ on the
JAX side (built with -O3 -march=native, free to contract a multiply-add
into an FMA) and in float32 numpy here: measured at most 4.8e-7 m apart,
held to 1e-5 m. Augmented voxel batches: `num` and the dropout are equal,
and the voxel sets agree on at least 99.9% of rows (a point within 1e-6 m
of a voxel face may land in the neighbour), with labels and feats equal on
the shared voxels (measured: every row equal)."""

import numpy as np
import pytest

from seggroup_tpu.data import transforms as J
from seggroup_tpu.data import voxel_dataset as JV
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.data import transforms as T
from seggroup_tpu_torch.data import voxel_dataset as TV
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene


@pytest.fixture(scope="module")
def cloud():
    return scene_to_training_tuple(make_synthetic_scene(seed=2, num_points=20000), {}, None,
                                   "s", False)


def _same_state(r1, r2):
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", ["random_rotation_z", "random_scale", "random_flip"])
def test_geometric_transforms_equal(cloud, name, seed):
    coords = cloud[0]
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    a, b = getattr(J, name)(coords, r1), getattr(T, name)(coords, r2)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    _same_state(r1, r2)


@pytest.mark.parametrize("name,kw", [("random_rotation_z", dict(max_angle=np.pi / 6)),
                                     ("random_scale", dict(lo=0.9, hi=1.1)),
                                     ("random_scale", dict(lo=0.5, hi=2.0))])
def test_geometric_transform_keywords_equal(cloud, name, kw):
    """The keywords the classification driver's vote augmentation passes
    (`lo`, `hi`) and the rotation bound, as the JAX signatures take them."""
    coords = cloud[0]
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(getattr(J, name)(coords, r1, **kw),
                                  getattr(T, name)(coords, r2, **kw))
    _same_state(r1, r2)


@pytest.mark.parametrize("seed", range(8))  # each applies in some seeds, not in others
@pytest.mark.parametrize("name", ["chromatic_auto_contrast", "chromatic_translation",
                                  "chromatic_jitter"])
def test_chromatic_transforms_equal(cloud, name, seed):
    colors = cloud[1]
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(getattr(J, name)(colors, r1), getattr(T, name)(colors, r2))
    _same_state(r1, r2)


@pytest.mark.parametrize("seed", range(4))
def test_dropout_equal(cloud, seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for a, b in zip(J.random_dropout(*cloud, r1), T.random_dropout(*cloud, r2)):
        np.testing.assert_array_equal(a, b)
    _same_state(r1, r2)


@pytest.mark.parametrize("gran,mag", [(0.2, 0.4), (0.8, 1.6)])
def test_elastic_distortion_within_1e5(cloud, gran, mag):
    coords = J.random_rotation_z(cloud[0], np.random.default_rng(0))
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    a = J.elastic_distortion(coords, r1, gran, mag)
    b = T.elastic_distortion(coords, r2, gran, mag)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-5
    assert np.abs(b - coords).max() > 0.01  # it did displace
    _same_state(r1, r2)


def test_spatial_crop_equal():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(0, 700, size=(5000, 3))
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    for a, b in zip(J.spatial_crop(xyz, 2000, r1), T.spatial_crop(xyz, 2000, r2)):
        np.testing.assert_array_equal(a, b)
    _same_state(r1, r2)


@pytest.mark.parametrize("seed", range(3))
def test_default_train_transform_within_1e5(cloud, seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    (ca, fa), (cb, fb) = (J.default_train_transform(*cloud[:2], r1),
                          T.default_train_transform(*cloud[:2], r2))
    assert np.abs(ca - cb).max() <= 1e-5
    np.testing.assert_array_equal(fa, fb)
    _same_state(r1, r2)


@pytest.mark.parametrize("seed", range(4))
def test_augmented_voxel_batch_matches_jax(seed):
    scenes = [scene_to_training_tuple(make_synthetic_scene(seed=i), {}, None, "s", False)
              for i in range(3)]
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    a = JV.make_voxel_batch(scenes, 8192, 0.02, rng=r1, augment=True)
    b = TV.make_voxel_batch(scenes, 8192, 0.02, rng=r2, augment=True)
    _same_state(r1, r2)
    assert int(a.num) == int(b.num)
    np.testing.assert_array_equal(a.valid, b.valid)
    assert [len(x) for x in a.point2voxel] == [len(x) for x in b.point2voxel]  # the dropout
    n = int(a.num)
    row_of = {tuple(c): i for i, c in enumerate(a.coords[:n])}
    pairs = [(row_of[tuple(c)], i) for i, c in enumerate(b.coords[:n]) if tuple(c) in row_of]
    assert len(pairs) >= 0.999 * n
    ia, ib = np.array(pairs).T
    np.testing.assert_array_equal(a.labels[ia], b.labels[ib])
    np.testing.assert_array_equal(a.feats[ia], b.feats[ib])



@pytest.mark.parametrize("axis", [0, 1, 2])
def test_box_blur_equals_scipy_correlate1d(axis):
    """The elastic field's box blur, numpy here, equals the JAX side's
    scipy.ndimage.correlate1d with the float32 [1/3] * 3 kernel bit for bit."""
    import scipy.ndimage

    x = np.random.default_rng(axis).standard_normal((11, 7, 5, 3)).astype(np.float32)
    want = scipy.ndimage.correlate1d(x, np.full(3, 1 / 3, np.float32), axis=axis,
                                     mode="constant")
    got = T._box3(x, axis)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
