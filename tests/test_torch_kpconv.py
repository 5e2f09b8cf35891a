"""The port's KPConv inference (seggroup_tpu_torch.models.kpconv) against
the JAX package's (seggroup_tpu.models.kpconv) on the CPU, with jitted JAX
references: kernel points bit for bit; the influence distances and weights
bit for bit (XLA's fused rounding, reproduced through ops/fma.py); the
pyramid's integer arrays and points exactly; the layers, each bottleneck
kind and KPFCNN at first_features_dim 16 on 1,024 points within float32
tolerances, with nonzero deformable offsets (at init they are zero and a
deformable layer is the rigid one) and random running statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import kpconv as J
from seggroup_tpu_torch.models import kpconv as T
from seggroup_tpu_torch.models.convert import kpconv_params_from_flax

torch.set_num_threads(2)

N, DL0, FDIM = 1024, 0.04, 16
CAPS = [N // 2, N // 4, N // 8, N // 16]
# float32 products and sums in another order than XLA's: a layer within
# 1e-5 of its output's magnitude, the whole network's logits within 1e-5
RTOL = 1e-5


def _cloud(seed, n=N, n_invalid=100, extent=(1.2, 1.2, 0.6)):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * np.array(extent)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    pts[~valid] = 0.0
    return pts, np.zeros(n, np.int32), valid


def _randomize(variables, seed):
    """Nonzero offset kernels and random running statistics."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        if name == "offset_kernel":
            return (rng.normal(size=x.shape) * 0.05).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, variables))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def pyramids():
    """(JAX levels, JAX overflow rates, port levels, port rates) of one cloud
    whose level caps bind."""
    pts, bids, valid = _cloud(0)
    jl, jo = jax.jit(lambda p, b, v: J.build_pyramid(p, b, v, 5, DL0, level_caps=CAPS,
                                                     return_overflow=True))(
        jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(valid))
    tl, to = T.build_pyramid(_t(pts), _t(bids), _t(valid), 5, DL0, level_caps=CAPS,
                             return_overflow=True)
    return jl, jo, tl, to


@pytest.fixture(scope="module")
def network(pyramids):
    """The flax KPFCNN (jitted init), its randomised variables, its jitted
    logits and regulariser on the shared pyramid, and the port's model at
    the converted weights."""
    jl = pyramids[0]
    rng = np.random.default_rng(1)
    feats = np.ones((N, 4), np.float32)
    feats[:, 1:] = rng.random((N, 3))
    model = J.KPFCNN(num_classes=20, first_features_dim=FDIM, dl0=DL0)
    v = jax.jit(lambda r, py, f: model.init(r, py, f, train=False))(
        jax.random.PRNGKey(0), jl, jnp.asarray(feats))
    v = _randomize(v, 2)
    logits, reg = jax.jit(lambda v, py, f: model.apply(v, py, f, train=False))(
        v, jl, jnp.asarray(feats))
    tm = T.KPFCNN(num_classes=20, first_features_dim=FDIM, dl0=DL0, device="cpu")
    tm.load_state_dict(kpconv_params_from_flax(v), strict=True)
    return v, feats, np.asarray(logits), float(reg), tm


@pytest.mark.parametrize("kw", [dict(), dict(num_points=7, fixed="verticals", num_iters=800,
                                             n_restarts=2),
                                dict(num_points=5, fixed="none", num_iters=300, seed=3,
                                     n_restarts=1)])
def test_kernel_points_bit_equal(kw):
    want = J.kernel_point_positions(**kw)
    got = T.kernel_point_positions(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_query", [False, True])
def test_influence_distances_bit_equal(per_query):
    """kpconv_op's squared distances and linear influences equal jitted
    JAX's bit for bit: XLA fuses the sum of squares into
    fma(dz, dz, fma(dy, dy, dx*dx)) and `1 - sqrt(d2) / extent` into
    fma(-sqrt(d2), 1/extent, 1); a plain float32 form differs in about a
    fifth of the distances."""
    rng = np.random.default_rng(4)
    rel = (rng.normal(size=(600, 16, 3)) * 0.1).astype(np.float32)
    kp = (rng.normal(size=(600, 15, 3) if per_query else (15, 3)) * 0.06).astype(np.float32)
    extent = DL0

    @jax.jit
    def ref(rel, kp):
        k = kp[:, None] if per_query else kp[None, None]
        d2 = jnp.sum((rel[:, :, None, :] - k) ** 2, axis=-1)
        return d2, jnp.maximum(0.0, 1.0 - jnp.sqrt(d2 + 1e-12) / extent)

    want_d2, want_infl = map(np.asarray, ref(rel, kp))
    d2 = T.kernel_sqdist(_t(rel), _t(kp))
    np.testing.assert_array_equal(d2.numpy(), want_d2)
    np.testing.assert_array_equal(T._linear_influence(d2, extent).numpy(), want_infl)
    plain = ((rel[:, :, None, :] - (kp[:, None] if per_query else kp)) ** 2).sum(-1)
    assert (plain != want_d2).mean() > 0.05
    assert 0.0 < (want_infl > 0).mean() < 1.0


def test_kpconv_op_matches_jax(pyramids):
    jl, _, tl, _ = pyramids
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(N, 8)).astype(np.float32)
    w = (rng.normal(size=(15, 8, 12)) * 0.1).astype(np.float32)
    kp = J.kernel_point_positions(15) * (1.5 * DL0)
    lvl = jl[0]
    want = np.asarray(jax.jit(J.kpconv_op, static_argnums=(6,))(
        lvl.points, lvl.points, lvl.neighbors, jnp.asarray(feats), jnp.asarray(kp),
        jnp.asarray(w), DL0))
    got = T.kpconv_op(tl[0].points, tl[0].points, tl[0].neighbors, _t(feats), _t(kp), _t(w),
                      DL0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_pyramid_integers_exact(pyramids):
    """Every integer array of every level exactly equal, the barycentres too
    (the sorted segment mean sums in the reference's order), and the
    neighbour-overflow rates."""
    jl, jo, tl, to = pyramids
    assert len(jl) == len(tl) == 5
    for i, (a, b) in enumerate(zip(jl, tl)):
        for name in J.PyramidLevel._fields:
            x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
            assert x.shape == y.shape, (i, name)
            np.testing.assert_array_equal(y, x, err_msg=f"level {i} {name}")
        assert float(to[i]) == float(jo[i])
    # level 1's cap binds: 512 of more occupied cells are kept
    assert int(tl[1].valid.sum()) == CAPS[0]
    assert any(float(r) > 0 for r in to)  # some ball outgrows its 32-neighbour cap


def test_pyramid_with_default_caps_and_batches():
    """Two batch elements and the default caps (none binds)."""
    pts, _, valid = _cloud(6, n=768, n_invalid=40, extent=(0.8, 0.5, 0.5))
    bids = (np.arange(768) >= 400).astype(np.int32)
    jl = jax.jit(lambda p, b, v: J.build_pyramid(p, b, v, 3, DL0))(
        jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(valid))
    tl = T.build_pyramid(_t(pts), _t(bids), _t(valid), 3, DL0)
    for i, (a, b) in enumerate(zip(jl, tl)):
        for name in J.PyramidLevel._fields:
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                          err_msg=f"level {i} {name}")
    assert set(tl[1].batch[tl[1].valid].tolist()) == {0, 1}


@pytest.mark.parametrize("deformable", [False, True])
def test_kpconv_layer_matches_jax(deformable, pyramids):
    jl, _, tl, _ = pyramids
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(N, 8)).astype(np.float32)
    layer = J.KPConvLayer(12, deformable=deformable)
    lvl = jl[0]
    v = jax.jit(lambda r, f: layer.init(r, lvl.points, lvl.points, lvl.neighbors, f, DL0))(
        jax.random.PRNGKey(3), jnp.asarray(feats))
    v = _randomize(v, 8)
    out, reg = jax.jit(lambda v, f: layer.apply(v, lvl.points, lvl.points, lvl.neighbors,
                                                f, DL0))(v, jnp.asarray(feats))
    tlayer = T.KPConvLayer(8, 12, deformable=deformable)
    tlayer.load_state_dict(kpconv_params_from_flax(v), strict=True)
    with torch.no_grad():
        got, got_reg = tlayer(tl[0].points, tl[0].points, tl[0].neighbors, _t(feats), DL0)
    out = np.asarray(out)
    np.testing.assert_allclose(got.numpy(), out, rtol=0, atol=RTOL * np.abs(out).max())
    np.testing.assert_allclose(float(got_reg), float(reg), rtol=RTOL)
    assert (float(reg) > 0) == deformable


@pytest.mark.parametrize("deformable", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_resnet_bottleneck_matches_jax(deformable, strided, pyramids):
    """Unstrided blocks with a shortcut projection (8 -> 2 * 16 channels),
    strided ones with the max-pooled shortcut (32 channels in and out)."""
    jl, _, tl, _ = pyramids
    cin = 32 if strided else 8
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(N, cin)).astype(np.float32)
    block = J.ResnetBottleneck(16, deformable, strided)
    nxt = jl[1] if strided else None
    v = jax.jit(lambda r, f: block.init(r, jl[0], nxt, f, DL0, False))(
        jax.random.PRNGKey(4), jnp.asarray(feats))
    v = _randomize(v, 10)
    out, reg = jax.jit(lambda v, f: block.apply(v, jl[0], nxt, f, DL0, False))(
        v, jnp.asarray(feats))
    tblock = T.ResnetBottleneck(cin, 16, deformable, strided)
    tblock.load_state_dict(kpconv_params_from_flax(v), strict=True)
    with torch.no_grad():
        got, got_reg = tblock(tl[0], tl[1] if strided else None, _t(feats), DL0, False)
    out = np.asarray(out)
    assert got.shape == out.shape == ((CAPS[0] if strided else N), 32)
    np.testing.assert_allclose(got.numpy(), out, rtol=0, atol=RTOL * np.abs(out).max())
    np.testing.assert_allclose(float(got_reg), float(reg), rtol=RTOL)
    assert hasattr(tblock, "shortcut") != strided


def test_kpfcnn_matches_jax(network, pyramids):
    """The whole network: logits within 1e-5 of their magnitude, zero on
    invalid rows, the same argmax nearly everywhere, the summed
    regulariser within 1e-5."""
    _, feats, want, want_reg, tm = network
    with torch.no_grad():
        got, reg = tm(pyramids[2], _t(feats))
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(reg), want_reg, rtol=RTOL)
    assert want_reg > 0  # the deformable stages moved their kernel points
    valid = pyramids[2][0].valid.numpy()
    assert (got[~valid] == 0).all()
    assert (got[valid].argmax(1) == want[valid].argmax(1)).mean() >= 0.99


def test_params_from_flax(network):
    variables, *_, tm = network
    n_jax = sum(x.size for x in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    np.testing.assert_array_equal(tm.b11_unary.weight.detach().numpy(),
                                  variables["params"]["b11_unary"]["kernel"].T)
    np.testing.assert_array_equal(tm.b5.kp.offset_kernel.detach().numpy(),
                                  variables["params"]["b5"]["kp"]["offset_kernel"])
    np.testing.assert_array_equal(tm.b9.bn2.var.numpy(),
                                  variables["batch_stats"]["b9"]["bn2"]["var"])
    fresh = T.KPFCNN(num_classes=20, first_features_dim=FDIM, device="cpu", seed=5)
    assert float(fresh.b5.kp.offset_kernel.detach().abs().max()) == 0  # zero, as flax initialises it
    assert float(fresh.logits.bias.detach().abs().max()) == 0

