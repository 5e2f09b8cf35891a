"""The port's mean-field CRF (seggroup_tpu_torch.models.crf) against
seggroup_tpu/models/crf.py on the CPU, the same numpy inputs through both.

The integer rows are exactly JAX's: each voxel's cell (`cell_id`), each
hypercross offset's neighbour cell (`tgt_rows`) and its presence
(`tgt_ok`), read on the JAX side from the jitted apply itself (its raw
lower bounds and its stacked rows, through ordered debug callbacks). The
floors divide as jitted XLA divides by a constant, through the float32
reciprocal: colours at exact multiples of 12 and just below them, where a
true division gives other cells, pin it. The refined logits are within
rtol = atol = 1e-5 (the same float32 scatter-adds and products in another
order). CRFWrapped at shared weights, the backbone's bf16 convs on both
sides: within the MinkUNet tolerance of tests/test_torch_minkunet.py with
the filter off and on."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import crf as J
from seggroup_tpu.models import minkunet as JM
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch.models import crf as T
from seggroup_tpu_torch.models import minkunet as TM
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.sparse.tensor import SparseTensor as TST

from test_torch_minkunet import ATOL, RTOL, _randomize_stats, make_sparse_input

torch.set_num_threads(1)


def make_input(rng, m_cap=256, n=180, c=5, extent=8, batches=2, colors=None):
    coords = np.zeros((m_cap, 4), np.int32)
    coords[:n, 0] = rng.integers(0, batches, n)
    coords[:n, 1:] = rng.integers(0, extent, (n, 3))
    valid = np.zeros(m_cap, bool)
    valid[:n] = True
    perm = rng.permutation(m_cap)
    coords, valid = coords[perm], valid[perm]
    logits = rng.normal(size=(m_cap, c)).astype(np.float32)
    if colors is None:
        colors = (rng.random((m_cap, 3)) * 255).astype(np.float32)
    times = rng.integers(0, 4, m_cap).astype(np.int32)
    return coords, valid, logits, colors, times


@contextlib.contextmanager
def jax_rows(store):
    """Records, in order, the JAX CRF's raw lower bounds (the fori_loop
    results: the voxels' own cells first, then one per offset) and its
    stacked (M, K) `tgt_rows` and `tgt_ok`."""
    fori, stack = jax.lax.fori_loop, jnp.stack

    def rec(tag, x):
        jax.debug.callback(lambda v: store.append((tag, np.asarray(v))), x, ordered=True)

    def fori_loop(lo, hi, body, init):
        out = fori(lo, hi, body, init)
        rec("lower_bound", out[0])
        return out

    def stack_(xs, axis=0):
        out = stack(xs, axis=axis)
        if axis == 1:
            rec("stack", out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "fori_loop", fori_loop)
        mp.setattr(jnp, "stack", stack_)
        yield


def run_both(coords, valid, logits, colors, times, temporal=False, spatial_sigma=1.0,
             chromatic_sigma=12.0, iterations=3, kernel=None, seed=0):
    """(JAX's out, cell_id, tgt_rows, tgt_ok), (the port's) at one kernel."""
    m, c = logits.shape
    n = int(valid.sum())
    js = JST(jnp.asarray(coords), jnp.zeros((m, 1)), jnp.asarray(valid), jnp.int32(n))
    ts = TST(torch.from_numpy(coords), torch.zeros((m, 1)), torch.from_numpy(valid),
             torch.tensor(n, dtype=torch.int32))
    kw = dict(spatial_sigma=spatial_sigma, chromatic_sigma=chromatic_sigma,
              iterations=iterations, temporal=temporal)
    jcrf = J.MeanFieldCRF(c, **kw)
    args = (jnp.asarray(logits), js, jnp.asarray(colors), jnp.asarray(times))
    if kernel is None:
        kernel = np.asarray(jcrf.init(jax.random.PRNGKey(seed), *args)["params"]["kernel"])
    store = []
    with jax_rows(store):
        out = jax.jit(jcrf.apply)({"params": {"kernel": jnp.asarray(kernel)}}, *args)
        out = np.asarray(out)
        jax.effects_barrier()
    bounds = [v for tag, v in store if tag == "lower_bound"]
    tgt_rows, tgt_ok = [v for tag, v in store if tag == "stack"]
    want = (out, np.where(valid, bounds[0], m), tgt_rows, tgt_ok)

    tcrf = T.MeanFieldCRF(c, **kw)
    tcrf.load_state_dict({"kernel": torch.from_numpy(np.array(kernel))})
    tt = torch.from_numpy(times)
    with torch.no_grad():
        got_out = tcrf(torch.from_numpy(logits), ts, torch.from_numpy(colors), tt).numpy()
    got = (got_out, *(x.numpy() for x in tcrf.cells(ts, torch.from_numpy(colors), tt)))
    return want, got


def _check(want, got, valid):
    for name, w, g in zip(("cell_id", "tgt_rows", "tgt_ok"), want[1:], got[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert (got[0][~valid] == 0).all()


@pytest.mark.parametrize("temporal", [False, True], ids=["bilateral", "trilateral"])
def test_meanfield_matches_jax(temporal):
    rng = np.random.default_rng(3 + temporal)
    coords, valid, logits, colors, times = make_input(rng)
    want, got = run_both(coords, valid, logits, colors, times, temporal=temporal,
                         spatial_sigma=3.0, chromatic_sigma=96.0)
    _check(want, got, valid)
    assert want[2].shape[1] == (15 if temporal else 13)
    ok = want[3][:, 1:]
    assert ok.sum() > 40  # neighbour cells are found, not only the own cell
    # voxels share cells: fewer cells than voxels
    assert len(np.unique(want[1][valid])) < valid.sum()


def test_colours_at_multiples_of_12():
    """Colours at exact multiples of 12 and at their float32 predecessors:
    the reciprocal's floor puts about half of the predecessors in the next
    cell, where a true division would not."""
    rng = np.random.default_rng(8)
    k = rng.integers(1, 21, (256, 3)).astype(np.float32)
    exact = k * np.float32(12)
    below = np.nextafter(exact, np.float32(0))
    colors = np.where(rng.random((256, 3)) < 0.5, exact, below).astype(np.float32)
    recip = np.float32(1) / np.float32(12)
    assert (np.floor(colors * recip) != np.floor(colors / np.float32(12))).sum() > 50
    coords, valid, logits, _, times = make_input(rng, colors=colors)
    want, got = run_both(coords, valid, logits, colors, times, iterations=2)
    _check(want, got, valid)


def test_realistic_grid_no_key_aliasing():
    """tests/test_crf.py's case: ~600 spatial cells per axis at sigma 1 and
    ~22 chromatic cells at sigma 12 (a 6-D cell space of ~1e12); with the
    centre offset alone the output is the unary plus the softmax summed over
    each voxel's own cell, and the cells are exactly JAX's."""
    rng = np.random.default_rng(0)
    c = 4
    coords, valid, logits, colors, times = make_input(rng, c=c, extent=600)
    kernel = np.zeros((13, c, c), np.float32)
    kernel[0] = np.eye(c)
    want, got = run_both(coords, valid, logits, colors, times, iterations=1, kernel=kernel)
    _check(want, got, valid)
    n_valid = np.flatnonzero(valid)
    cell = np.concatenate([coords[:, :1], coords[:, 1:4],
                           np.floor(colors / 12.0).astype(int)], axis=1)
    sm = np.exp(logits - logits.max(1, keepdims=True))
    sm /= sm.sum(1, keepdims=True)
    oracle = logits.copy()
    for i in n_valid:
        same = n_valid[(cell[n_valid] == cell[i]).all(1)]
        oracle[i] += sm[same].sum(0)
    np.testing.assert_allclose(got[0][valid], oracle[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("apply_filter", [False, True], ids=["backbone", "filtered"])
def test_crf_wrapped_matches_jax(apply_filter):
    rng = np.random.default_rng(9)
    m, n, c = 256, 160, 6
    caps = [256, 128, 64, 32, 32]
    js, ts = make_sparse_input(rng, m_cap=m, n=n, grid=10)
    colors = (rng.random((m, 3)) * 255).astype(np.float32)
    small = dict(planes=(8, 8, 16, 16, 16, 8, 8, 8), layers=(1,) * 8, init_dim=8,
                 level_caps=caps)
    jmodel = J.CRFWrapped(backbone=JM.MinkUNet(out_channels=c, **small), num_classes=c,
                          iterations=3)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, s, col: jmodel.init(r, s, col, train=False))(jax.random.PRNGKey(2), js,
                                                                jnp.asarray(colors)))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
    assert variables["params"]["crf"]["kernel"].shape == (13, c, c)
    port = T.CRFWrapped(TM.MinkUNet(out_channels=c, device="cpu", **small), num_classes=c,
                        iterations=3)
    port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    want = np.asarray(jax.jit(lambda v, s, col: jmodel.apply(
        v, s, col, train=False, apply_filter=apply_filter))(variables, js, jnp.asarray(colors)))
    with torch.no_grad():
        got = port(ts, torch.from_numpy(colors), train=False,
                   apply_filter=apply_filter).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[n:] == 0).all()
