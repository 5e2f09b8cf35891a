"""Port ball queries (seggroup_tpu_torch.ops.knn.ball_query_pair,
_windowed, _fast) against the jitted JAX ops on the CPU: neighbour indices
(nearest first, ties by ascending candidate), counts and overflow flags
exactly equal, on two point sets with batch ids, padding rows and exact
duplicates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.ops import knn as J
from seggroup_tpu_torch.ops import knn as T

torch.set_num_threads(1)


def _sets(seed, ns=900, nq=700, spread=1.0, same=False):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(ns, 3)) * spread).astype(np.float32)
    s[ns // 8: 2 * (ns // 8)] = s[: ns // 8]  # exact duplicates: distance ties
    sb = rng.integers(0, 2, ns).astype(np.int32)
    sv = rng.random(ns) < 0.9
    if same:
        return s, sb, sv, s, sb, sv
    q = (rng.normal(size=(nq, 3)) * spread).astype(np.float32)
    q[: nq // 4] = s[: nq // 4]  # queries that sit on support points
    qb = rng.integers(0, 2, nq).astype(np.int32)
    qv = rng.random(nq) < 0.9
    return s, sb, sv, q, qb, qv


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _t(args):
    return tuple(torch.from_numpy(a) for a in args)


def _equal(got, want, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed,radius,k,cap", [(0, 0.25, 16, 16), (1, 0.4, 8, 4),
                                               (2, 0.15, 64, 16)])
def test_ball_query_pair_matches_jax(seed, radius, k, cap):
    """The second case overflows both the bucket cap and K."""
    args = _sets(seed)
    want = J.ball_query_pair(*_j(args), radius, max_neighbors=k, bucket_cap=cap)
    got = T.ball_query_pair(*_t(args), radius, max_neighbors=k, bucket_cap=cap)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    _equal(got, want, ("neighbors", "counts", "overflow"))
    assert bool(np.asarray(want[2]).any()) == (seed == 1)
    nbrs, counts = got[0].numpy(), got[1].numpy()
    assert ((nbrs < len(args[0])).sum(1) == counts).all()
    assert (counts[~args[5]] == 0).all()


@pytest.mark.parametrize("seed,radius,k,window,same", [
    (3, 0.25, 16, 4096, False), (4, 0.3, 32, 4096, True), (5, 0.25, 16, 64, False)])
def test_ball_query_pair_windowed_matches_jax(seed, radius, k, window, same):
    """The last case overflows its 64-row window and reports it."""
    args = _sets(seed, same=same)
    want = J.ball_query_pair_windowed(*_j(args), radius, max_neighbors=k, window=window)
    got = T.ball_query_pair_windowed(*_t(args), radius, max_neighbors=k, window=window)
    _equal(got, want, ("neighbors", "counts", "overflow", "window_overflow_any"))
    assert bool(got[3]) == (window == 64)
    if window != 64 and not bool(np.asarray(want[2]).any()):
        # no truncation anywhere: the bucket form finds the same neighbours
        exact = T.ball_query_pair(*_t(args), radius, max_neighbors=k, bucket_cap=64)
        _equal(got[:2], exact[:2], ("neighbors", "counts"))


def test_ball_query_pair_windowed_key_space_overflow_matches_jax():
    """An extent of 2,000 cells per axis passes 2^31 keys: flagged."""
    args = list(_sets(6, ns=300, nq=200, spread=20.0))
    want = J.ball_query_pair_windowed(*_j(args), 0.03, max_neighbors=8)
    got = T.ball_query_pair_windowed(*_t(args), 0.03, max_neighbors=8)
    assert bool(got[3]) and bool(want[3])


@pytest.mark.parametrize("window", [4096, 64])
def test_ball_query_pair_fast_matches_jax(window):
    """The windowed result, or, when a window overflows, the bucket form's."""
    args = _sets(7, same=True)
    want = J.ball_query_pair_fast(*_j(args), 0.25, max_neighbors=16, window=window)
    got = T.ball_query_pair_fast(*_t(args), 0.25, max_neighbors=16, window=window)
    _equal(got, want, ("neighbors", "counts", "overflow"))
    bucket = T.ball_query_pair(*_t(args), 0.25, max_neighbors=16)
    same_as_bucket = all(torch.equal(a, b) for a, b in zip(got, bucket))
    assert same_as_bucket or window == 4096


def test_ball_query_radius_edge_matches_jax():
    """Support points at the radius to within a few float32 steps: the
    rounding of the squared distance decides membership, as in JAX."""
    rng = np.random.default_rng(8)
    nq = 64
    # queries a metre apart: only a query's own ring is near it
    q = (np.stack(np.unravel_index(np.arange(nq), (4, 4, 4)), 1)
         + rng.uniform(0.2, 0.8, (nq, 3))).astype(np.float32)
    r = np.float32(0.1)
    dirs = rng.normal(size=(nq, 24, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    steps = (1 + np.arange(-12, 12) * 2.0 ** -23)[None, :, None]
    s = (q[:, None, :] + dirs * (float(r) * steps)).reshape(-1, 3).astype(np.float32)
    zeros_s, zeros_q = np.zeros(len(s), np.int32), np.zeros(nq, np.int32)
    args = (s, zeros_s, np.ones(len(s), bool), q, zeros_q, np.ones(nq, bool))
    for jf, tf, kw in ((J.ball_query_pair, T.ball_query_pair, dict(bucket_cap=64)),
                       (J.ball_query_pair_windowed, T.ball_query_pair_windowed, {})):
        want = jf(*_j(args), r, max_neighbors=32, **kw)
        got = tf(*_t(args), float(r), max_neighbors=32, **kw)
        _equal(got[:3], want[:3], ("neighbors", "counts", "overflow"))
        counts = got[1].numpy()
        assert 0 < counts.sum() < nq * 24  # some in, some out
