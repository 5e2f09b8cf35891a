"""Port voxelization (seggroup_tpu_torch.data.voxel_dataset) against the JAX
package's, which runs the native voxelize_sorted: coords, feats, labels and
point2voxel must be exactly equal, including the -1 of points whose voxel
overflowed capacity."""

import numpy as np
import pytest
import torch

from seggroup_tpu.data import voxel_dataset as J
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.data import voxel_dataset as T
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene

torch.set_num_threads(1)


def _scene(seed, **kw):
    return scene_to_training_tuple(make_synthetic_scene(seed=seed, **kw), {}, None,
                                   "s", False)


def _points_on_cell_boundaries(seed):
    """Points exactly on multiples of the voxel size, and negative ones:
    the float32 division and the floor must round as the native code does."""
    rng = np.random.default_rng(seed)
    c = (rng.integers(-200, 200, size=(3000, 3)) * np.float32(0.02)).astype(np.float32)
    c[:1000] += rng.normal(scale=0.01, size=(1000, 3)).astype(np.float32)
    col = rng.uniform(0, 255, size=(3000, 3)).astype(np.float32)
    lab = rng.integers(0, 20, size=3000).astype(np.int32)
    return c, col, lab


@pytest.mark.parametrize("case", ["synthetic0", "synthetic1", "boundaries"])
@pytest.mark.parametrize("voxel_size", [0.02, 0.05])
def test_voxelize_scene_equals_native(case, voxel_size):
    c, col, lab = (_points_on_cell_boundaries(7) if case == "boundaries"
                   else _scene(int(case[-1])))
    want = J.voxelize_scene(c, col, lab, voxel_size)
    got = T.voxelize_scene(c, col, lab, voxel_size)
    for name, g, w in zip(("coords", "feats", "labels", "point2voxel"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("capacity", [2 ** 13, 3000, 700])  # 3000 and 700 bind
def test_make_voxel_batch_equals_jax(capacity):
    scenes = [_scene(0), _scene(1)]
    want = J.make_voxel_batch(scenes, capacity, 0.02)
    got = T.make_voxel_batch(scenes, capacity, 0.02)
    for name in ("coords", "feats", "labels", "valid", "num"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    colors = T.voxelize_scene(*scenes[0], 0.02)[1][:capacity]
    np.testing.assert_array_equal(got.feats[:len(colors)], colors / 127.5 - 1.0)  # normalised
    assert len(got.point2voxel) == len(want.point2voxel)
    for g, w in zip(got.point2voxel, want.point2voxel):
        np.testing.assert_array_equal(g, w)
    if capacity < 4000:
        assert (np.concatenate(got.point2voxel) < 0).any()


def test_augment_raises():
    """Augmentation needs a generator, as on the JAX side (where it is an
    assert); tests/test_torch_transforms.py holds the augmented batches
    against JAX."""
    with pytest.raises(ValueError):
        T.make_voxel_batch([_scene(0)], 2 ** 13, augment=True)
