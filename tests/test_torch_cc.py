"""Port connected components, label compaction and voxelisation
(seggroup_tpu_torch.ops.cc, ops.voxelize) against the JAX ops and the numpy
oracles of tests/test_cc_voxelize_iou.py. Integer outputs exactly equal; the
per-voxel mean within 1e-6 (float sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sys

import torch

from seggroup_tpu.ops import cc as JC
import seggroup_tpu.ops.voxelize  # noqa: F401  (the package exports the function under this name)
from seggroup_tpu.ops.segment_ops import segment_max as j_max, segment_mean as j_mean
from seggroup_tpu.ops.segment_ops import segment_min as j_min
from seggroup_tpu_torch.ops import cc as TC
from seggroup_tpu_torch.ops import segment_ops as TS
from seggroup_tpu_torch.ops import voxelize as TV
from test_cc_voxelize_iou import cc_oracle

JV = sys.modules["seggroup_tpu.ops.voxelize"]
torch.set_num_threads(1)


def _graph(seed, n, k, p_edge=0.5, n_invalid=4):
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nv = rng.random((n, k)) < p_edge
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return nbrs, nv, valid


@pytest.mark.parametrize("seed,n,k,p_edge", [(0, 64, 4, 0.5), (1, 500, 3, 0.3),
                                             (2, 300, 2, 0.9)])
def test_connected_components_matches_jax_and_oracle(seed, n, k, p_edge):
    nbrs, nv, valid = _graph(seed, n, k, p_edge)
    pairs = [(i, int(nbrs[i, j])) for i in range(n) for j in range(k)
             if nv[i, j] and valid[i] and valid[nbrs[i, j]]]
    got = TC.connected_components(torch.from_numpy(nbrs), torch.from_numpy(nv),
                                  torch.from_numpy(valid))
    want = np.asarray(JC.connected_components(jnp.array(nbrs), jnp.array(nv),
                                              jnp.array(valid)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), cc_oracle(n, pairs, valid))


def test_connected_components_max_iters_matches_jax():
    """A chain needs several sweeps: a bounded run equals JAX's bounded run."""
    n = 256
    nbrs = np.minimum(np.arange(n) + 1, n - 1).astype(np.int32)[:, None]
    nv = np.ones((n, 1), bool)
    valid = np.ones(n, bool)
    for iters in (1, 2, None):
        got = TC.connected_components(torch.from_numpy(nbrs), torch.from_numpy(nv),
                                      torch.from_numpy(valid), max_iters=iters).numpy()
        want = np.asarray(JC.connected_components(jnp.array(nbrs), jnp.array(nv),
                                                  jnp.array(valid), max_iters=iters))
        np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


@pytest.mark.parametrize("ignore", [(), (1,)])
def test_semantic_cc_matches_jax(ignore):
    nbrs, nv, valid = _graph(3, 400, 4, 0.6)
    sem = np.random.default_rng(4).integers(0, 3, 400).astype(np.int32)
    got = TC.semantic_connected_components(
        torch.from_numpy(nbrs), torch.from_numpy(nv), torch.from_numpy(valid),
        torch.from_numpy(sem), ignore_labels=ignore).numpy()
    want = np.asarray(JC.semantic_connected_components(
        jnp.array(nbrs), jnp.array(nv), jnp.array(valid), jnp.array(sem),
        ignore_labels=ignore))
    np.testing.assert_array_equal(got, want)
    ok = got < 400
    assert (sem[got[ok]] == sem[ok]).all()  # a component holds one class
    for ig in ignore:
        assert (got[sem == ig] == 400).all()


@pytest.mark.parametrize("max_labels", [8, 3])
def test_compact_labels_matches_jax(max_labels):
    rng = np.random.default_rng(0)
    n = 50
    lab = rng.choice([3, 17, 42, 99, 7], size=n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[45:] = False
    got = TC.compact_labels(torch.from_numpy(lab), torch.from_numpy(valid), max_labels)
    want = JC.compact_labels(jnp.array(lab), jnp.array(valid), max_labels)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    compact, num, sizes = (g.numpy() for g in got)
    present = np.unique(lab[valid])
    assert int(num) == len(present)
    for ci, orig in enumerate(present[:max_labels]):
        sel = (lab == orig) & valid
        assert (compact[sel] == ci).all() and sizes[ci] == sel.sum()
    assert (compact[~valid] == max_labels).all()


@pytest.mark.parametrize("n,m,grid", [(200, 256, 8), (3000, 256, 12), (500, 64, 3)])
def test_voxelize_matches_jax(n, m, grid):
    """The capacity binds in the second case (more voxels than rows)."""
    rng = np.random.default_rng(n)
    coords = rng.integers(0, grid, size=(n, 3)).astype(np.int32)
    batch = rng.integers(0, 2, size=n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[n - 10:] = False
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    want = JV.voxelize(jnp.array(coords), jnp.array(batch), jnp.array(valid), m)
    got = TV.voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                      torch.from_numpy(valid), m)
    for g, w, name in zip(got, want, got._fields):
        assert g.dtype == (torch.bool if name == "voxel_valid" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the numpy oracle of the JAX package's test
    p2v = got.point2voxel.numpy()
    keys = {}
    for i in range(n):
        if not valid[i]:
            assert p2v[i] == m
        elif p2v[i] < m:
            assert keys.setdefault((batch[i], *coords[i]), p2v[i]) == p2v[i]
    assert int(got.num_voxels) >= len(keys) and (int(got.num_voxels) > m) == (n == 3000)

    vf = TV.voxel_gather_mean(torch.from_numpy(feats), got)
    np.testing.assert_allclose(vf.numpy(), np.asarray(JV.voxel_gather_mean(jnp.array(feats),
                                                                            want)),
                               rtol=1e-6, atol=1e-6)
    for kk, v in keys.items():
        sel = valid & (batch == kk[0]) & (coords == np.array(kk[1:])).all(1)
        np.testing.assert_allclose(vf.numpy()[v], feats[sel].mean(0), rtol=1e-5, atol=1e-6)
    rec = TV.point_recover(vf, got).numpy()
    np.testing.assert_array_equal(rec, np.asarray(JV.point_recover(jnp.asarray(vf.numpy()),
                                                                   want)))
    assert (rec[p2v == m] == 0).all()


@pytest.mark.parametrize("op", ["min", "max", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_reductions_match_the_sorted_engine(op, dtype):
    """PointGroup's reductions run in JAX through the sort-and-scan engine
    (method="sorted"); the port's scatter reductions give the same values:
    ids outside [0, S) are padding, empty segments give fill_value (min,
    max) or 0 (mean). Integers and extremes exactly, float means to 1e-6."""
    rng = np.random.default_rng(1)
    n, s = 400, 12
    ids = rng.integers(-2, s + 2, n).astype(np.int32)
    ids[ids == 5] = 6  # segment 5 stays empty
    data = (rng.normal(size=(n, 3)) * 10).astype(dtype)
    jd, td = jnp.array(data), torch.from_numpy(data)
    if op == "mean":
        want = j_mean(jd, jnp.array(ids), s, method="sorted")
        got = TS.segment_mean(td, torch.from_numpy(ids), s)
        if dtype == "int32":
            got = TS.segment_mean(td.float(), torch.from_numpy(ids), s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert (got[5] == 0).all()
        return
    fill = {"float32": 0.5, "int32": 77}[dtype]
    jf, tf = (j_min, TS.segment_min) if op == "min" else (j_max, TS.segment_max)
    want = jf(jd, jnp.array(ids), s, fill_value=jnp.asarray(fill, dtype), method="sorted")
    got = tf(td, torch.from_numpy(ids), s, fill_value=fill)
    assert got.dtype == td.dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[5] == fill).all()
