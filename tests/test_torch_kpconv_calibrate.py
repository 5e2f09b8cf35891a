"""The KPConv calibrations of the port (seggroup_tpu_torch.models.kpconv)
against the JAX package's, on the CPU: the per-level neighbour caps and the
probe's overflow rates exactly equal (the port's ball_query_pair, voxelize
and sorted segment mean at probe cap 192 and 64 rows a cell), the
saturation warning too; the sphere sizes and the batch limit (numpy on
both sides) exactly equal under the same generators."""

import warnings

import numpy as np
import pytest

from seggroup_tpu.models import kpconv as J
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.cli.stage2_test_semantic import kpconv_level_caps
from seggroup_tpu_torch.cli.stage2_train_kpconv import sample_batch
from seggroup_tpu_torch.data.potentials import PotentialSampler
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import kpconv as T

POINT_CAP, RADIUS = 1024, 5.0


@pytest.fixture(scope="module")
def scenes():
    return [scene_to_training_tuple(make_synthetic_scene(seed=i), {}, None, "s", False)
            for i in range(2)]


@pytest.fixture(scope="module")
def probe_batches(scenes):
    """Two batches of 2 spheres as the trainer draws its calibration
    batches (a sampler of seed 2, a generator of seed 1)."""
    sampler = PotentialSampler([c for c, _, _ in scenes], in_radius=RADIUS, seed=2)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        pts, _, _, bids, valid = sample_batch(scenes, sampler, rng, 2, RADIUS, POINT_CAP)
        out.append((pts, bids, valid))
    assert all(v.sum() > POINT_CAP // 4 for _, _, v in out)
    return out


def _both(batches, **kw):
    """(JAX's caps, rates, warnings; the port's)."""
    res = []
    for mod, extra in ((J, {}), (T, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            caps, rates = mod.calibrate_neighbor_caps(batches, num_layers=5, **kw, **extra)
        res.append((caps, rates, [str(x.message) for x in w
                                  if "calibrate_neighbor_caps" in str(x.message)]))
    return res


@pytest.mark.parametrize("dl0,probe", [(0.1, {}), (0.2, dict(probe_cap=24, probe_bucket=16))])
def test_neighbor_caps_equal_jax(probe_batches, dl0, probe):
    """At the trainer's probe (192 neighbours, 64 rows a cell) and at a
    probe small enough to saturate and overflow, which must warn alike."""
    want, got = _both(probe_batches, dl0=dl0, level_caps=kpconv_level_caps(POINT_CAP),
                      **probe)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert all(isinstance(c, int) and c % 8 == 0 for c in got[0])
    if probe:
        assert got[2] and max(got[1]) > 0  # saturated, and the probe truncated


def test_neighbor_caps_default_level_caps(probe_batches):
    want, got = _both(probe_batches[:1], dl0=0.15, keep_ratio=0.5)
    assert got == want


@pytest.mark.parametrize("seed", [0, 3])
def test_sphere_sizes_and_batch_limit_equal_jax(scenes, seed):
    clouds = [c for c, _, _ in scenes]
    want = J.sample_sphere_sizes(clouds, 2.0, rng=np.random.default_rng(seed))
    got = T.sample_sphere_sizes(clouds, 2.0, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    for batch_num in (1, 4):
        lim_j, cap_j = J.calibrate_batch_limit(want, batch_num, iters=3000,
                                               rng=np.random.default_rng(seed + 1))
        lim_t, cap_t = T.calibrate_batch_limit(got, batch_num, iters=3000,
                                               rng=np.random.default_rng(seed + 1))
        assert (lim_t, cap_t) == (lim_j, cap_j)
        assert cap_t % 1024 == 0 and cap_t >= lim_t
    with pytest.raises(ValueError):
        T.calibrate_batch_limit([], 4)
