"""Port neighbour search (seggroup_tpu_torch.ops.knn) against the JAX ops on
the CPU: Morton codes, squared distances and every kNN index exactly equal,
on inputs with duplicate points (exact distance ties). The JAX ops run under
jit, as the JAX model runs them: XLA's fusion decides the float rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.ops import knn as J
from seggroup_tpu_torch.ops import knn as T

torch.set_num_threads(1)


def _points(seed, n, dup=True):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    if dup:
        pts[n // 8: n // 4] = pts[: n // 8]  # exact duplicates: distance ties
    return pts


@pytest.mark.parametrize("masked", [False, True])
def test_morton3d_matches_jax(masked):
    """Also pins the scale's true division: `float / tensor` in torch
    multiplies by a rounded reciprocal and moved one code in 4096."""
    pts = _points(0, 4096, dup=False)
    valid = np.random.default_rng(1).random(4096) < 0.95 if masked else None
    want = np.asarray(jax.jit(J.morton3d)(
        jnp.asarray(pts), None if valid is None else jnp.asarray(valid)))
    got = T.morton3d(torch.from_numpy(pts),
                     None if valid is None else torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(256,), (4, 64)])
def test_pairwise_sqdist_bit_equal(shape):
    """The |x|^2 - 2<x,y> + |y|^2 values equal XLA's bit for bit (fma-chain
    order, ops/fma.py), so near-ties resolve identically."""
    x = _points(2, int(np.prod(shape))).reshape(shape + (3,))
    want = np.asarray(jax.jit(J.pairwise_sqdist)(jnp.asarray(x), jnp.asarray(x)))
    got = T.pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_brute_matches_jax():
    pts = _points(3, 8 * 64).reshape(8, 64, 3)
    pts[:, 32:] = pts[:, :32]  # tiled clusters, as cluster_pointclouds makes
    want = np.asarray(jax.jit(J.knn_brute, static_argnums=1)(jnp.asarray(pts), 10))
    got = T.knn_brute(torch.from_numpy(pts), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_knn_matches_jax():
    pts = _points(4, 4 * 40).reshape(4, 40, 3)
    valid = np.random.default_rng(5).random((4, 40)) < 0.6
    valid[0, 3:] = False  # fewer valid candidates than k: self repeats
    want = np.asarray(jax.jit(J.masked_knn, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(valid), 6))
    got = T.masked_knn(torch.from_numpy(pts), torch.from_numpy(valid), 6).numpy()
    np.testing.assert_array_equal(got, want)


def _cluster_case(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    pts = _points(seed, n)
    cid = rng.integers(0, 200, size=n).astype(np.int32)
    cid[:1500] = 1000          # one cluster wider than the small window
    cid[1500:1503] = 5000      # a cluster smaller than k
    valid = rng.random(n) < 0.97
    cid[~valid] = 0x3FFFFFFF   # padding points, as the model marks them
    return pts, cid, valid


@pytest.mark.parametrize("small_window", [0, 512, None])
def test_cluster_knn_matches_jax(small_window):
    pts, cid, valid = _cluster_case(6)
    kw = dict(k=8, row_block=256, window=2048, small_window=small_window)
    want = np.asarray(J.cluster_knn(jnp.asarray(pts), jnp.asarray(cid),
                                    valid=jnp.asarray(valid), **kw))
    got = T.cluster_knn(torch.from_numpy(pts), torch.from_numpy(cid),
                        valid=torch.from_numpy(valid), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cluster_knn_window_truncation_matches_jax():
    """A cluster larger than the window gets the kNN of its centred window,
    the same candidates on both sides."""
    pts, cid, valid = _cluster_case(7)
    kw = dict(k=6, row_block=256, window=512)
    want = np.asarray(J.cluster_knn(jnp.asarray(pts), jnp.asarray(cid),
                                    valid=jnp.asarray(valid), **kw))
    got = T.cluster_knn(torch.from_numpy(pts), torch.from_numpy(cid),
                        valid=torch.from_numpy(valid), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    # rows of the 3-point cluster reference only its members, then self
    rows = np.arange(1500, 1503)
    assert set(got[rows].ravel()) <= set(rows)


def test_approx_max_k_is_top_k_off_the_tpu():
    """The probe behind the port's `cluster_knn` having no `approx` option: off the TPU, jitted
    `lax.approx_max_k` gives `lax.top_k`'s values and indices, lowest index
    first on ties, on integer-valued rows full of ties and on normal rows."""
    rng = np.random.default_rng(12)
    for x in (rng.integers(0, 6, (64, 300)).astype(np.float32),
              rng.normal(size=(256, 2048)).astype(np.float32)):
        av, ai = jax.jit(lambda a: jax.lax.approx_max_k(a, 20, recall_target=0.95))(x)
        tv, ti = jax.jit(lambda a: jax.lax.top_k(a, 20))(x)
        np.testing.assert_array_equal(np.asarray(av), np.asarray(tv))
        np.testing.assert_array_equal(np.asarray(ai), np.asarray(ti))


@pytest.mark.parametrize("ties", [False, True])
def test_cluster_knn_approx_matches_jax(ties):
    """The JAX side's `approx=True` branch (approx_max_k) against the port's
    `cluster_knn`, which has only the exact top-k; with `ties`, points on a
    coarse integer grid make most distances tie."""
    pts, cid, valid = _cluster_case(9)
    if ties:
        pts = np.round(pts * 1.5).astype(np.float32)
    kw = dict(k=8, row_block=256, window=2048)
    want = np.asarray(jax.jit(
        lambda p, c, v: J.cluster_knn(p, c, valid=v, approx=True, **kw))(
        jnp.asarray(pts), jnp.asarray(cid), jnp.asarray(valid)))
    got = T.cluster_knn(torch.from_numpy(pts), torch.from_numpy(cid),
                        valid=torch.from_numpy(valid), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_cluster_knn_refuses_unpadded_rows():
    pts, cid, _ = _cluster_case(8)
    with pytest.raises(ValueError):
        T.cluster_knn(torch.from_numpy(pts[:100]), torch.from_numpy(cid[:100]),
                      row_block=256)


