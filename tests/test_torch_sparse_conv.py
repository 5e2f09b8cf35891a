"""Port sparse engine (seggroup_tpu_torch.sparse) against the JAX engine on
the CPU: the same numpy inputs through both.

Rulebooks and downsample maps are integer outputs and must be exactly
equal. Convolutions: at compute_dtype float32 both sides sum the same
float32 products in another order, so they agree within rtol = atol = 1e-5;
at bfloat16 both round the operands to bf16 the same way and sum the exact
products in float32, so the same 1e-5 holds (the real figure here is about
5e-7 of the output's magnitude). The Pallas window kernels (interpret mode)
are held to the port's plain version within 1e-5 as well."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.sparse import conv as J
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch.sparse import conv as T
from seggroup_tpu_torch.sparse.tensor import SparseTensor as TST

torch.set_num_threads(1)


def make_coords(rng, m_cap, n, grid, batches=2, extremes=True, shuffle=True):
    """(coords, valid): n unique sites among m_cap rows, padding rows
    interleaved (shuffle), with sites at coordinate 0 and at large x/y."""
    seen, rows = set(), []
    if extremes:
        for c in ((0, 0, 0, 0), (0, 0, 1, 0), (1, 16383, 16383, 5),
                  (1, 16383, 16382, 5), (1, 16382, 16383, 6)):
            seen.add(c)
            rows.append(c)
    while len(rows) < n:
        c = (int(rng.integers(0, batches)), *(int(v) for v in rng.integers(0, grid, 3)))
        if c not in seen:
            seen.add(c)
            rows.append(c)
    coords = np.zeros((m_cap, 4), np.int32)
    coords[:n] = np.array(rows, np.int32)
    valid = np.zeros(m_cap, bool)
    valid[:n] = True
    if shuffle:
        perm = rng.permutation(m_cap)
        coords, valid = coords[perm], valid[perm]
    return coords, valid


def pair(coords, valid, feats):
    n = int(valid.sum())
    j = JST(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid), jnp.int32(n))
    t = TST(torch.from_numpy(coords.copy()), torch.from_numpy(feats.copy()),
            torch.from_numpy(valid.copy()), torch.tensor(n, dtype=torch.int32))
    return j, t


@pytest.fixture(scope="module")
def sites():
    rng = np.random.default_rng(3)
    coords, valid = make_coords(rng, 512, 300, grid=12)
    feats = rng.normal(size=(512, 5)).astype(np.float32)
    return pair(coords, valid, feats)


@pytest.mark.parametrize("kernel_size,conv_type", [
    (3, "spatial_hypercube"),                      # grouped z-run search
    (3, "spatial_hypercube_temporal_hypercross"),  # the blocks' region in 3-D
    (5, "spatial_hypercube"),                      # generic offsets (conv1_kernel_size 5)
    (3, "hypercross"),                             # explicit region offsets
])
def test_rulebook_equals_jax(sites, kernel_size, conv_type):
    js, ts = sites
    want = np.asarray(jax.jit(lambda s: J.build_subm_rulebook(
        s, kernel_size, conv_type=conv_type))(js))
    got = T.build_subm_rulebook(ts, kernel_size, conv_type=conv_type)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 512).sum() > 300  # neighbours present beyond the centre


@pytest.mark.parametrize("n", [1, 37, 200])
def test_rulebook_k3_dense_grid_equals_jax(n):
    """Dense small grids: most offsets present, many z-runs of three."""
    rng = np.random.default_rng(n)
    coords, valid = make_coords(rng, 256, n, grid=6, extremes=False)
    js, ts = pair(coords, valid, np.zeros((256, 1), np.float32))
    want = np.asarray(jax.jit(lambda s: J.build_subm_rulebook(s, 3))(js))
    np.testing.assert_array_equal(T.build_subm_rulebook(ts, 3).numpy(), want)


def test_rulebook_wide_batch_ids_narrow_keys():
    """xy_bits=(5, 5) with batch ids up to 39 (the ScoreNet packing)."""
    rng = np.random.default_rng(5)
    coords, valid = make_coords(rng, 512, 300, grid=14, batches=40, extremes=False)
    js, ts = pair(coords, valid, np.zeros((512, 1), np.float32))
    want = np.asarray(jax.jit(lambda s: J.build_subm_rulebook(s, 3, xy_bits=(5, 5)))(js))
    np.testing.assert_array_equal(T.build_subm_rulebook(ts, 3, xy_bits=(5, 5)).numpy(), want)


def test_rulebook_paths_not_ported_raise(sites):
    """The assume_sorted path (once refused) on the sites in lexicographic
    order: equal to JAX's assume_sorted rulebook and to the searched one,
    at 512 rows (the searched branch) and at 4,096 (the merge join)."""
    js, _ = sites
    order = np.lexsort(np.asarray(js.coords).T[::-1])
    valid = np.asarray(js.valid)[order]
    order = np.concatenate([order[valid], order[~valid]])  # the valid prefix first
    for cap in (512, 4096):
        coords = np.zeros((cap, 4), np.int32)
        coords[:512] = np.asarray(js.coords)[order]
        coords[512:] = 0
        valid = np.arange(cap) < int(js.num)
        j, t = pair(coords, valid, np.zeros((cap, 1), np.float32))
        want = np.asarray(jax.jit(lambda s: J.build_subm_rulebook(s, 3, assume_sorted=True))(j))
        got = T.build_subm_rulebook(t, 3, assume_sorted=True)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), T.build_subm_rulebook(t, 3).numpy())


@pytest.mark.parametrize("cap_out", [256, 200, 64])  # 64 and 200 bind: num_out is 223
def test_downsample_coords_equals_jax(sites, cap_out):
    js, ts = sites
    want = [np.asarray(x) for x in J.downsample_coords(js, cap_out)]
    got = [x.numpy() for x in T.downsample_coords(ts, cap_out)]
    for name, g, w in zip(("coords_out", "valid_out", "num_out", "out_row", "delta"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if cap_out < 223:
        assert int(want[2]) > cap_out and (want[3] == cap_out).sum() > 0


def _subm_case(cin, cout, m_cap, n, seed):
    rng = np.random.default_rng(seed)
    coords, valid = make_coords(rng, m_cap, n, grid=max(8, round(2 * n ** (1 / 3))))
    feats = rng.normal(size=(m_cap, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    js, ts = pair(coords, valid, feats)
    rb = np.asarray(jax.jit(lambda s: J.build_subm_rulebook(s, 3))(js))
    return js, ts, w, rb


_JAX_SUBM = jax.jit(J.subm_conv, static_argnames=("compute_dtype",))


@pytest.mark.parametrize("cin,cout,m_cap,n", [
    (3, 8, 32768, 20000),  # the stem's width; M > 16384 runs the row tiling
    (32, 32, 512, 300),
    (64, 48, 512, 300),
    (96, 96, 512, 300),
    (384, 16, 256, 150),
])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
def test_subm_conv_equals_jax(cin, cout, m_cap, n, dtypes):
    js, ts, w, rb = _subm_case(cin, cout, m_cap, n, seed=cin)
    jd, td = dtypes
    want = np.asarray(_JAX_SUBM(js, jnp.asarray(w), jnp.asarray(rb), compute_dtype=jd))
    got = T.subm_conv(ts, torch.from_numpy(w), torch.from_numpy(rb), compute_dtype=td)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[~np.asarray(js.valid)] == 0).all()


def test_subm_conv_refuses_window_plans(sites):
    """A window plan (once refused) selects nothing: subm_conv with a
    level's windows equals it without them and JAX's plain branch
    (use_window false), forward and both gradients, at float32; a dict
    that is not a window plan is refused."""
    from seggroup_tpu_torch.sparse.device_plan import build_windows_device

    rng = np.random.default_rng(11)
    m, cin, cout = 2048, 6, 5
    coords = np.zeros((m, 4), np.int32)
    keys = np.sort(rng.choice(2 * 16 ** 3, size=1900, replace=False))
    coords[:1900] = np.stack([keys // 4096, keys // 256 % 16, keys // 16 % 16, keys % 16], 1)
    valid = np.arange(m) < 1900
    feats = rng.normal(size=(m, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    dout = rng.normal(size=(m, cout)).astype(np.float32)
    js, ts = pair(coords, valid, feats)
    rb = T.build_subm_rulebook(ts, 3)
    win = build_windows_device(rb)
    assert bool(win["use_window"])

    def port(windows):
        f = ts.feats.clone().requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        out = T.subm_conv(ts.with_feats(f), wt, rb, compute_dtype=torch.float32,
                          windows=windows)
        (out * torch.from_numpy(dout)).sum().backward()
        return out.detach().numpy(), f.grad.numpy(), wt.grad.numpy()

    jwin = {"rb_win": jnp.asarray(win["rb_win"].numpy()),
            "win_base": jnp.asarray(win["win_base"].numpy()), "use_window": jnp.asarray(False)}

    def jloss(wj, f):
        out = J.subm_conv(js.with_feats(f), wj, jnp.asarray(rb.numpy()),
                          compute_dtype=jnp.float32, windows=jwin)
        return jnp.sum(out * dout), out

    (_, jout), (jgw, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(w), js.feats)
    with_w, without = port(win), port(None)
    for a, b in zip(with_w, without):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(with_w, (jout, jgf, jgw)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="window plan"):
        T.subm_conv(ts, torch.from_numpy(w), rb, windows={"rb_win": None})


def test_strided_down_and_inverse_up_equal_jax(sites):
    js, ts = sites
    rng = np.random.default_rng(11)
    wd = rng.normal(size=(8, 5, 6)).astype(np.float32)
    wu = rng.normal(size=(8, 6, 4)).astype(np.float32)
    for cap in (256, 128):  # 128 binds: fine rows of dropped sites read nothing
        ja, ka = J.strided_conv_down(js, jnp.asarray(wd), cap)
        ta, kb = T.strided_conv_down(ts, torch.from_numpy(wd), cap)
        np.testing.assert_allclose(ta.feats.numpy(), np.asarray(ja.feats), rtol=1e-5, atol=1e-5)
        for name in ("out_row", "delta"):
            np.testing.assert_array_equal(kb[name].numpy(), np.asarray(ka[name]))
        ju = J.inverse_conv_up(ja, jnp.asarray(wu), ka)
        tu = T.inverse_conv_up(ta, torch.from_numpy(wu), kb)
        np.testing.assert_allclose(tu.feats.numpy(), np.asarray(ju.feats), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tu.coords.numpy(), np.asarray(ju.coords))


@pytest.mark.parametrize("cin,cout", [(8, 6), (48, 40), (96, 70)])
def test_plain_version_equals_pallas_window_kernels(cin, cout):
    """Cin 8 / 48 / 96 reach the three forward Pallas variants' regimes
    (lane-pack shift 2, shift 1, and the chunked one-hot). The Pallas
    kernels run in interpret mode over a host window plan, built as
    tests/test_sparse_plan.py builds it."""
    from seggroup_tpu import native
    from seggroup_tpu.sparse import pallas_conv

    rng = np.random.default_rng(cin)
    m = 8 * pallas_conv.TILE
    base = np.arange(m)[:, None]
    rb = np.clip(base + rng.integers(-40, 40, size=(m, 27)), 0, m - 1)
    rb = np.where(rng.random((m, 27)) < 0.3, m, rb).astype(np.int32)
    win_base, rb_win, ovf = native.subm_windows(rb, pallas_conv.TILE, pallas_conv.WINDOW)
    assert ovf == 0
    feats = rng.normal(size=(m, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv.subm_conv_windowed(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(rb_win), jnp.asarray(win_base),
        compute_dtype=jnp.bfloat16))
    got = T.subm_conv_plain(torch.from_numpy(feats), torch.from_numpy(w),
                            torch.from_numpy(rb), torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
