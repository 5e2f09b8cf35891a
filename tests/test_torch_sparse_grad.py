"""The port's sparse-conv gradients (seggroup_tpu_torch.sparse.conv) against
the JAX engine on the CPU: the same numpy inputs through both.

  * `subm_dw_plain`, K3's plain version, against the Pallas weight-gradient
    kernels in interpret mode (K3b lane-packed at Cin 8 and 48, K3a at
    Cin 96) over a host window plan. Both round the operands to bf16 and
    sum exact products in float32, in another order: measured here at most
    3.8e-5 at max|dW| 198 (1.9e-7 of it); held to 1e-5 of max|dW|.
  * The autograd `subm_conv` (SubmConvFunction) against `jax.grad` through
    the JAX `subm_conv` (its custom VJP), at float32 and bf16, on sites with
    padding rows interleaved and absent neighbours: dfeats within rtol =
    atol = 1e-5 (27 products a row, summed in another order), dW, a sum over
    every row, within 1e-5 of max|dW| (measured: at most 2.0e-4 at max|dW|
    258 over 20,000 rows, 7.7e-7 of it; dfeats at most 7.2e-7), and a zero
    gradient on invalid rows.
  * The stride-2 down and up convs' gradients against `jax.grad`, within
    rtol = atol = 1e-5 (float32 matmuls, segment sums in another order).
  * The symmetry the data gradient rests on, nbr[i,k] = j <=> nbr[j,K-1-k]
    = i, on rulebooks with ragged and absent rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.sparse import conv as J
from seggroup_tpu_torch.sparse import conv as T
from seggroup_tpu_torch.sparse import cuda_subm_dw

from test_torch_sparse_conv import _subm_case, make_coords, pair

torch.set_num_threads(1)


@pytest.mark.parametrize("cin,cout", [(8, 6), (48, 40), (96, 70)])
def test_subm_dw_plain_equals_pallas_kernels(cin, cout):
    """Cin 8 / 48 / 96 reach K3b (lane-pack shift 2 and 1) and K3a, in
    interpret mode over a host window plan (tests/test_sparse_plan.py)."""
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
    dout = rng.normal(size=(m, cout)).astype(np.float32)
    want = np.asarray(pallas_conv.subm_dw_windowed(
        jnp.asarray(feats), jnp.asarray(dout), jnp.asarray(rb_win), jnp.asarray(win_base),
        compute_dtype=jnp.bfloat16))
    got = T.subm_dw_plain(torch.from_numpy(feats), torch.from_numpy(dout),
                          torch.from_numpy(rb), torch.bfloat16).numpy()
    assert got.shape == want.shape == (27, cin, cout)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _jax_grads(js, w, rb, cot, jd):
    def loss(feats, weights):
        out = J.subm_conv(js._replace(feats=feats), weights, rb, compute_dtype=jd)
        return jnp.sum(out * cot)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(js.feats, jnp.asarray(w))


@pytest.mark.parametrize("cin,cout,m_cap,n", [
    (3, 8, 32768, 20000),  # the stem's width; M > 16384 runs the row tiling
    (32, 32, 512, 300),
    (64, 48, 512, 300),
    (96, 70, 512, 300),
])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
def test_subm_conv_grads_equal_jax(cin, cout, m_cap, n, dtypes):
    js, ts, w, rb = _subm_case(cin, cout, m_cap, n, seed=cin + 1)
    jd, td = dtypes
    cot = np.random.default_rng(cin).normal(size=(m_cap, cout)).astype(np.float32)
    want_df, want_dw = (np.asarray(x) for x in _jax_grads(js, w, jnp.asarray(rb),
                                                          jnp.asarray(cot), jd))
    feats = ts.feats.clone().requires_grad_(True)
    weights = torch.from_numpy(w).requires_grad_(True)
    out = T.subm_conv(ts._replace(feats=feats), weights, torch.from_numpy(rb), td)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(feats.grad.numpy(), want_df, rtol=1e-5, atol=1e-5)
    assert np.abs(weights.grad.numpy() - want_dw).max() <= 1e-5 * np.abs(want_dw).max()
    invalid = ~ts.valid.numpy()
    assert invalid.any() and (feats.grad.numpy()[invalid] == 0).all()


def test_subm_conv_skips_the_data_gradient_without_need():
    """The stem's input needs no gradient: the backward then computes dW
    alone (on the card, no K2 launch for it)."""
    _, ts, w, rb = _subm_case(8, 8, 512, 300, seed=4)
    weights = torch.from_numpy(w).requires_grad_(True)
    calls = []
    orig = T._subm_apply
    try:
        T._subm_apply = lambda *a: calls.append(a[0].shape) or orig(*a)
        T.subm_conv(ts, weights, torch.from_numpy(rb)).sum().backward()
    finally:
        T._subm_apply = orig
    assert calls == [(512, 8)]  # the forward only
    assert weights.grad is not None and ts.feats.grad is None


def test_down_and_up_grads_equal_jax():
    rng = np.random.default_rng(12)
    coords, valid = make_coords(rng, 512, 300, grid=12)
    feats = rng.normal(size=(512, 5)).astype(np.float32)
    js, ts = pair(coords, valid, feats)
    wd = rng.normal(size=(8, 5, 6)).astype(np.float32)
    wu = rng.normal(size=(8, 6, 4)).astype(np.float32)
    cot = rng.normal(size=(512, 4)).astype(np.float32)
    for cap in (256, 128):  # 128 binds
        def loss(f, a, b):
            dn, key = J.strided_conv_down(js._replace(feats=f), a, cap)
            return jnp.sum(J.inverse_conv_up(dn, b, key).feats * cot)

        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(js.feats, jnp.asarray(wd),
                                                          jnp.asarray(wu))
        f = ts.feats.clone().requires_grad_(True)
        a = torch.from_numpy(wd).requires_grad_(True)
        b = torch.from_numpy(wu).requires_grad_(True)
        dn, key = T.strided_conv_down(ts._replace(feats=f), a, cap)
        (T.inverse_conv_up(dn, b, key).feats * torch.from_numpy(cot)).sum().backward()
        for got, w, name in zip((f.grad, a.grad, b.grad), want, ("dfeats", "dWdown", "dWup")):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} cap {cap}")


@pytest.mark.parametrize("conv_type", ["spatial_hypercube", "hypercross"])
def test_rulebook_is_symmetric(conv_type):
    """nbr[i,k] = j  <=>  nbr[j,K-1-k] = i, on sites with padding rows
    interleaved, neighbours at coordinate 0 and absent ones."""
    rng = np.random.default_rng(7)
    coords, valid = make_coords(rng, 512, 300, grid=9)
    _, ts = pair(coords, valid, np.zeros((512, 1), np.float32))
    rb = T.build_subm_rulebook(ts, 3, conv_type=conv_type).numpy()
    m, kvol = rb.shape
    present = rb < m
    assert 0 < present.mean() < 1 and (~present[~valid]).all()
    i, k = np.nonzero(present)
    assert (rb[rb[i, k], kvol - 1 - k] == i).all()
    # and no one-sided pair: the counts per mirrored offset agree
    np.testing.assert_array_equal(present.sum(0), present.sum(0)[::-1])


@pytest.mark.parametrize("m,cin,cout", [(131072, 8, 32), (131072, 128, 96), (65536, 64, 128),
                                        (16384, 384, 256), (16384, 256, 256), (2048, 96, 96)])
def test_k3_slabs_fill_the_card_within_the_workspace(m, cin, cout):
    """K3's row slabs (sparse/cuda_subm_dw.slabs_for) at Res16UNet34C's
    shapes on 132 SMs: at least two CTAs per SM where the rows allow, slabs
    of at most 16,384 rows (the length of a CTA's sum) and a bounded
    workspace, and slabs that cover the rows in whole chunks."""
    sms = 132
    slabs, rows = cuda_subm_dw.slabs_for(m, 27, cin, cout, sms)
    tm, tn = cuda_subm_dw.TILES[cuda_subm_dw.regime(cin)]
    per_slab = 27 * -(-cin // tm) * -(-cout // tn)
    assert rows % cuda_subm_dw.CHUNK_ROWS == 0 and (slabs - 1) * rows < m <= slabs * rows
    assert slabs * 27 * cin * cout * 4 <= cuda_subm_dw.WORKSPACE_BYTES
    assert rows <= cuda_subm_dw.MAX_SLAB_ROWS
    if -(-m // cuda_subm_dw.MIN_SLAB_ROWS) * per_slab >= 2 * sms:  # the rows allow it
        assert slabs * per_slab >= 2 * sms
    else:
        assert rows <= cuda_subm_dw.MIN_SLAB_ROWS
