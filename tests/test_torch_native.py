"""The port's native host library (seggroup_tpu_torch/native.py) against
its numpy fallbacks and against the JAX package's library
(seggroup_tpu/native.py) on the same seeded inputs: the library equals
the fallbacks exactly and the JAX library exactly (integers, and floats bit
for bit, except where the JAX build fuses multiply-adds); and the loader
reports a failed build."""

import shutil

import numpy as np
import pytest

from seggroup_tpu import native as jax_native
from seggroup_tpu_torch import native

pytestmark = pytest.mark.skipif(shutil.which("c++") is None and shutil.which("g++") is None,
                                reason="no host C++ compiler")


@pytest.fixture(scope="module")
def libs():
    assert native.available(), native.load_error()
    assert jax_native.available()
    return native, jax_native


def _both_paths(fn, *args):
    """(native result, fallback result) of native.<fn>(*args)."""
    got = getattr(native, fn)(*args)
    with native.numpy_fallbacks():
        assert not native.available()
        fb = getattr(native, fn)(*args)
    assert native.available()
    return got, fb


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, (a.dtype, np.asarray(b).dtype)
        np.testing.assert_array_equal(a, b)
    else:
        assert int(a) == int(b)


def _sorted_coords(rng, cap, n, grid, batches=2):
    keys = rng.choice(batches * grid ** 3, size=n, replace=False)
    keys.sort()
    b, r = np.divmod(keys, grid ** 3)
    x, r = np.divmod(r, grid ** 2)
    y, z = np.divmod(r, grid)
    coords = np.zeros((cap, 4), np.int32)
    coords[:n] = np.stack([b, x, y, z], 1)
    return coords


def _cases():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 2.0, (3000, 3)).astype(np.float32)
    q = rng.uniform(-1.0, 2.0, (200, 3)).astype(np.float32)
    icoords = rng.integers(0, 12, (2000, 3)).astype(np.int32)
    batch = rng.integers(0, 3, 2000).astype(np.int32)
    coords = _sorted_coords(rng, 1024, 900, 14)
    shuffled = coords.copy()
    shuffled[:900] = coords[rng.permutation(900)]
    rb = jax_native.subm_rulebook3(coords, 900, 1024)
    noise = rng.normal(size=(9, 8, 7, 3)).astype(np.float32)
    ec = rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
    edges = rng.integers(0, 500, (700, 2)).astype(np.int32)
    return {
        "grid_subsample": ("grid_subsample", (pts, 0.13)),
        "radius_neighbors": ("radius_neighbors", (pts, q, 0.2, 16)),
        "voxelize_rulebook": ("voxelize_rulebook", (icoords, batch)),
        "nearest_neighbor_map": ("nearest_neighbor_map", (pts, q, 0.1)),
        "subm_rulebook3_sorted": ("subm_rulebook3", (coords, 900, 1024)),
        "subm_rulebook3_unsorted": ("subm_rulebook3", (shuffled, 900, 1024)),
        "subm_windows": ("subm_windows", (rb, 128, 256)),
        "downsample_plan_sorted": ("downsample_plan", (coords, 900, 300)),
        "downsample_plan_unsorted": ("downsample_plan", (shuffled, 900, 256)),
        "elastic_interp": ("elastic_interp", (ec, ec.min(0), 0.2, 0.4, noise)),
        "voxelize_sorted": ("voxelize_sorted", (pts, 0.05)),
        "connected_components": ("connected_components", (edges, 500)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_fallback_equals_jax(libs, case):
    fn, args = CASES[case]
    got, fb = _both_paths(fn, *args)
    _equal(got, fb)
    ref = getattr(jax_native, fn)(*args)
    if fn == "elastic_interp":
        # the JAX package's Makefile builds with -march=native, and on a host
        # with FMA GCC fuses the trilinear multiply-adds; the port's build
        # keeps each product rounded (-ffp-contract=off), as numpy does
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * np.spacing(np.float32(2.0)))
    else:
        _equal(got, ref)


def test_radius_neighbors_hits_caps(libs):
    """max_k below the hit counts: both paths keep the same first max_k."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
    got, fb = _both_paths("radius_neighbors", pts, pts[:50], 0.15, 4)
    assert (got[1] == 4).all()
    _equal(got, fb)
    _equal(got, jax_native.radius_neighbors(pts, pts[:50], 0.15, 4))


def test_failed_build_is_reported(monkeypatch, tmp_path):
    """A source that does not compile: available() is False, load_error()
    holds the compiler's message, a warning names it, and the fallbacks
    still answer."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int grid_subsample( { this is not C++ }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "STEM", "libbroken_native_test")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_warned", False)
    with pytest.warns(RuntimeWarning, match="numpy fallbacks run"):
        assert not native.available()
    err = native.load_error()
    assert err is not None and "failed on" in err and "broken.cpp" in err
    labels = native.connected_components(np.array([[0, 1], [2, 1]], np.int32), 4)
    np.testing.assert_array_equal(labels, [0, 0, 0, 3])
