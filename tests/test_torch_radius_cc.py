"""Port windowed radius CC (seggroup_tpu_torch.ops.radius_cc) against
seggroup_tpu.ops.pallas_cc on the CPU: `_prep`'s sort, ranges, offsets and
`use_window`; one `sweep_plain` against one interpret-mode `_sweep`; and
`semantic_radius_cc` labels and `use_window` on every case of
tests/test_pallas_cc.py. Everything is integer: exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.ops import pallas_cc as J
from seggroup_tpu_torch.ops import radius_cc as T
from seggroup_tpu_torch.ops.fma import sqdist_fma
from test_pallas_cc import make_scene, oracle_labels

torch.set_num_threads(1)


def _case(name):
    """(coords, radius, batch, valid, sem, kwargs) of one case of
    tests/test_pallas_cc.py, from its seed."""
    rng = np.random.default_rng(0)
    kw = {}
    if name == "oracle":
        coords, batch, sem, valid = make_scene(rng)
        r = 0.12
    elif name == "batch_and_semantics":
        n_cap = 2048
        coords = np.zeros((n_cap, 3), np.float32)
        coords[:4] = [[0, 0, 0], [0.01, 0, 0], [0, 0.01, 0], [0.01, 0.01, 0]]
        coords[4] = [2.0, 2.0, 2.0]
        coords[5] = [-2.0, -2.0, -2.0]
        batch = np.array([0, 0, 1, 1, 0, 1] + [0] * (n_cap - 6), np.int32)
        sem = np.array([5, 5, 5, 6, 9, 9] + [0] * (n_cap - 6), np.int32)
        valid = np.zeros(n_cap, bool)
        valid[:6] = True
        r = 0.05
    elif name == "many_blobs":
        coords, batch, sem, valid = make_scene(rng, n=600, blobs=30)
        r = 0.12
    elif name == "window_overflow":
        coords, batch, sem, valid = make_scene(rng, n=1800, blobs=2, spread=0.2)
        r, kw = 0.12, dict(window=32, max_neighbors_fallback=128)
    elif name == "non_tile_multiple":
        coords, batch, sem, valid = make_scene(rng, n_cap=1000, n=700)
        r, kw = 0.12, dict(max_neighbors_fallback=128)
    elif name in ("degenerate", "empty"):
        n_cap = 2048
        coords = np.zeros((n_cap, 3), np.float32)
        coords[:3] = [[0, 0, 0], [0.01, 0, 0], [1.0, 1.0, 1.0]]
        batch = np.zeros(n_cap, np.int32)
        sem = np.full(n_cap, 4, np.int32)
        valid = np.zeros(n_cap, bool)
        valid[:3] = name == "degenerate"
        r = 0.05
    elif name == "large_key_space":
        n_cap, n = 2048, 1800
        coords = np.zeros((n_cap, 3), np.float32)
        centers = rng.uniform(24.0, 26.8, (10, 3)).astype(np.float32)
        which = rng.integers(0, 10, n)
        coords[:n] = centers[which] + rng.normal(0, 0.04, (n, 3)).astype(np.float32)
        coords[0] = 0.0
        batch = np.zeros(n_cap, np.int32)
        sem = np.full(n_cap, 3, np.int32)
        sem[:n] = rng.integers(2, 5, n)
        valid = np.zeros(n_cap, bool)
        valid[:n] = True
        r = 0.03
    elif name == "huge_extent":
        n_cap, n = 2048, 400
        coords = np.zeros((n_cap, 3), np.float32)
        centers = rng.uniform(0, 60.0, (12, 3)).astype(np.float32)
        which = rng.integers(0, 12, n)
        coords[:n] = centers[which] + rng.normal(0, 0.04, (n, 3)).astype(np.float32)
        batch = np.zeros(n_cap, np.int32)
        sem = np.full(n_cap, 3, np.int32)
        sem[:n] = rng.integers(2, 5, n)
        valid = np.zeros(n_cap, bool)
        valid[:n] = True
        r = 0.03
    else:
        raise KeyError(name)
    return coords, r, batch, valid, sem, kw


WINDOWED = ["oracle", "batch_and_semantics", "many_blobs", "degenerate", "empty",
            "large_key_space", "huge_extent"]
CASES = WINDOWED + ["window_overflow", "non_tile_multiple"]


def _both(coords, r, batch, valid, sem, **kw):
    want, want_uw = J.semantic_radius_cc(
        jnp.asarray(coords), jnp.float32(r), jnp.asarray(batch), jnp.asarray(valid),
        jnp.asarray(sem), return_use_window=True, **kw)
    got, got_uw = T.semantic_radius_cc(
        torch.from_numpy(coords), r, torch.from_numpy(batch), torch.from_numpy(valid),
        torch.from_numpy(sem), return_use_window=True, **kw)
    assert got.dtype == torch.int32
    return got.numpy(), bool(got_uw), np.asarray(want), bool(want_uw)


@pytest.mark.parametrize("name", CASES)
def test_semantic_radius_cc_matches_jax(name):
    """Labels and use_window equal the JAX package's; where the test there
    holds an oracle, the port's labels equal it too."""
    coords, r, batch, valid, sem, kw = _case(name)
    got, got_uw, want, want_uw = _both(coords, r, batch, valid, sem, **kw)
    assert got_uw == want_uw == (name in WINDOWED)
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == len(coords)).all()
    if name in ("oracle", "large_key_space", "huge_extent"):
        oracle = oracle_labels(coords, r, batch, valid, sem)
        np.testing.assert_array_equal(got[valid], oracle[valid])


@pytest.mark.parametrize("name", WINDOWED + ["window_overflow"])
def test_prep_matches_jax(name):
    """The sort order (stable: points of one cell share a key), the sorted
    rows, the range starts (as the reference's 128-aligned bases), the
    group offsets and use_window."""
    coords, r, batch, valid, sem, kw = _case(name)
    window = kw.get("window", 1024)
    order, slab, base, offs, uw = J._prep(
        jnp.asarray(coords), jnp.float32(r), jnp.asarray(batch), jnp.asarray(valid),
        jnp.asarray(sem), 256, window)
    p = T._prep(torch.from_numpy(coords), torch.tensor(r, dtype=torch.float32),
                torch.from_numpy(batch), torch.from_numpy(valid), torch.from_numpy(sem),
                256, window)
    n = len(coords)
    slab = np.asarray(slab)
    assert bool(p.use_window) == bool(uw)
    np.testing.assert_array_equal(p.order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(p.xyz.numpy(), slab[:3, :n].T)
    np.testing.assert_array_equal(p.sem.numpy(), slab[3, :n].astype(np.int32))
    key = slab[4, :n].astype(np.int64) * 4096 + slab[5, :n].astype(np.int64)
    np.testing.assert_array_equal(p.key.numpy(), key)
    np.testing.assert_array_equal(p.offs.numpy(), np.asarray(offs).astype(np.int32))
    np.testing.assert_array_equal((p.lo & ~127).numpy(), np.asarray(base))
    # a range never ends past the rows the reference fetches when it is exact
    if bool(uw):
        real = (p.key.reshape(-1, 256) < 2 ** 30).any(1).numpy()
        assert ((p.hi - (p.lo & ~127)).numpy()[real] <= window).all()


def _sweep_inputs(name):
    coords, r, batch, valid, sem, _ = _case(name)
    args = (jnp.asarray(coords), jnp.float32(r), jnp.asarray(batch), jnp.asarray(valid),
            jnp.asarray(sem))
    order, slab, base, offs, _ = J._prep(*args, 256, 1024)
    p = T._prep(torch.from_numpy(coords), torch.tensor(r, dtype=torch.float32),
                torch.from_numpy(batch), torch.from_numpy(valid), torch.from_numpy(sem),
                256, 1024)
    return coords, r, valid, order, slab, base, offs, p


@pytest.mark.parametrize("name", ["oracle", "large_key_space", "huge_extent"])
def test_sweep_plain_matches_interpret_sweep(name):
    """One sweep, from the initial labels and from labels two sweeps on:
    the plain version equals the Pallas kernel in interpret mode exactly."""
    coords, r, valid, order, slab, base, offs, p = _sweep_inputs(name)
    n = len(coords)
    s_valid = valid[np.asarray(order)]
    lab = np.where(s_valid, np.arange(n), n).astype(np.int32)
    r2 = jnp.float32(r) * jnp.float32(r)
    r2_t = torch.tensor(r, dtype=torch.float32) ** 2
    for _ in range(3):
        want = np.asarray(J._sweep(jnp.asarray(lab, jnp.float32), slab, base, offs, r2))
        got = T.sweep_plain(torch.from_numpy(lab), p, r2_t).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int32))
        assert (got <= lab).all() and (got < lab).any()
        lab = got


def test_distance_order_decides_edges_as_the_reference():
    """Two points at exactly the radius: the squared distance's rounding
    decides the edge. On pairs where the candidate summation orders
    disagree about d2 <= r2, sweep_plain links exactly the pairs the
    interpret-mode kernel links (XLA's contraction,
    fma(dz, dz, fma(dx, dx, dy*dy)); the plain float32 sum would not)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 4, (100000, 3)).astype(np.float32)
    b = (a + rng.uniform(-0.03, 0.03, a.shape)).astype(np.float32)
    d = a - b
    plain = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    fused = sqdist_fma(*(torch.from_numpy(d[:, c].copy()) for c in range(3))).numpy()
    differ = np.where(plain != fused)[0][:12]
    assert len(differ) == 12
    n = 2048
    links = []
    for i in differ:
        coords = np.zeros((n, 3), np.float32)
        coords[0], coords[1] = a[i], b[i]
        valid = np.zeros(n, bool)
        valid[:2] = True
        zeros = np.zeros(n, np.int32)
        r2 = min(plain[i], fused[i])  # one order links the pair, the other not
        order, slab, base, offs, _ = J._prep(
            jnp.asarray(coords), jnp.float32(0.05), jnp.asarray(zeros), jnp.asarray(valid),
            jnp.asarray(zeros), 256, 1024)
        p = T._prep(torch.from_numpy(coords), torch.tensor(0.05), torch.from_numpy(zeros),
                    torch.from_numpy(valid), torch.from_numpy(zeros), 256, 1024)
        lab = np.where(valid[np.asarray(order)], np.arange(n), n).astype(np.int32)
        want = np.asarray(J._sweep(jnp.asarray(lab, jnp.float32), slab, base, offs,
                                   jnp.float32(r2))).astype(np.int32)
        got = T.sweep_plain(torch.from_numpy(lab), p, torch.tensor(r2)).numpy()
        np.testing.assert_array_equal(got, want)
        links.append(bool(got[1] == 0))
        assert links[-1] == bool(fused[i] <= r2)
    assert any(links) and not all(links)


def _dual(rng, n):
    pts = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    shift = (pts + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    bids = rng.integers(0, 2, n).astype(np.int32)
    ok = rng.uniform(size=n) < 0.8
    sem = rng.integers(2, 5, n).astype(np.int32)
    return pts, shift, bids, ok, sem


@pytest.mark.parametrize("n,fused", [(1024, False), (1024, True), (768, True), (768, False)])
def test_fused_dual_cc_matches_jax(n, fused):
    """PointGroup's doubled point set with interleaved batch ids, windowed
    (2n = 2048) and through the fallback (2n = 1536), with and without
    the fallback's half split: labels equal JAX's, and each half equals a
    separate run."""
    pts, shift, bids, ok, sem = _dual(np.random.default_rng(0), n)
    args = (np.concatenate([pts, shift]), 0.12, np.concatenate([bids * 2, bids * 2 + 1]),
            np.concatenate([ok, ok]), np.concatenate([sem, sem]))
    got, got_uw, want, want_uw = _both(*args, fused_halves=fused)
    assert got_uw == want_uw == (n == 1024)
    np.testing.assert_array_equal(got, want)
    la = T.semantic_radius_cc(torch.from_numpy(pts), 0.12, torch.from_numpy(bids),
                              torch.from_numpy(ok), torch.from_numpy(sem)).numpy()
    lb = T.semantic_radius_cc(torch.from_numpy(shift), 0.12, torch.from_numpy(bids),
                              torch.from_numpy(ok), torch.from_numpy(sem)).numpy()
    np.testing.assert_array_equal(np.where(la < n, la, -1),
                                  np.where(got[:n] < 2 * n, got[:n], -1))
    np.testing.assert_array_equal(np.where(lb < n, lb, -1),
                                  np.where(got[n:] < 2 * n, got[n:] - n, -1))


def test_cuda_tensor_never_takes_the_plain_sweep(monkeypatch):
    """The dispatch sends a CUDA tensor to the kernel's wrapper (which
    raises on what it cannot launch) and only a CPU tensor to sweep_plain."""
    coords, r, valid, order, slab, base, offs, p = _sweep_inputs("oracle")
    lab = torch.arange(len(coords), dtype=torch.int32)
    calls = []
    monkeypatch.setattr(T, "sweep_plain", lambda *a, **k: calls.append("plain") or lab)
    monkeypatch.setattr(T.cuda_cc, "cc_sweep_cuda", lambda *a, **k: calls.append("cuda") or lab)
    T.sweep(lab, p, torch.tensor(0.01))

    class OnCard:
        is_cuda = True
    T.sweep(OnCard(), p, torch.tensor(0.01))
    assert calls == ["plain", "cuda"]
    with pytest.raises(ValueError, match="CUDA"):
        monkeypatch.undo()
        T.cuda_cc.cc_sweep_cuda(lab, p.xyz, p.sem, p.key, p.lo, p.hi, p.offs,
                                torch.tensor(0.01), 256)
