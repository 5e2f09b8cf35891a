"""The port's 4-D spatio-temporal engine and models against the JAX package
on the CPU: 5-column (batch, x, y, z, t) coords, the ST kernel regions,
SparseInstanceNorm and the ST/Tesseract MinkUNets, the same numpy inputs
from a seed through both.

Integer outputs (keys, rulebooks, downsample maps) are exactly equal to
jitted JAX. SparseInstanceNorm is within rtol = atol = 1e-5 (the same
float32 segment sums in another order). The nets run at the variants'
depths and block regions at narrow widths (the planes below, stem 8),
with the BatchNorm statistics randomised: logits at the default bf16 convs
within the MinkUNet tolerance of tests/test_torch_minkunet.py (atol 2e-4 +
rtol 1e-3, argmax on 99% of the voxels), and one float32 train step of the
Tesseract (K = 81) through cli/stage2_train_minkunet.train_step against
jax.value_and_grad of the JAX driver's loss: the loss within 1e-5
relative, each gradient within 1e-4 of its tensor's max|JAX|, the new
batch statistics within rtol = atol = 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import minkunet as J
from seggroup_tpu.sparse import conv as JC
from seggroup_tpu.sparse import hashing as JH
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch import solvers as TS
from seggroup_tpu_torch.cli.stage2_train_minkunet import train_step
from seggroup_tpu_torch.models import minkunet as T
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.sparse import conv as TC
from seggroup_tpu_torch.sparse import hashing as TH
from seggroup_tpu_torch.sparse.tensor import SparseTensor as TST

from test_torch_minkunet import ARGMAX, ATOL, RTOL, _randomize_stats
from test_torch_minkunet_train import C, LR, MAX_ITER, _close, _jax_train, _stats_close, f32_convs

torch.set_num_threads(1)

M_CAP, N = 256, 170
CAPS = [256, 128, 64, 32, 32]
PLANES = (8, 16, 16, 32, 16, 16, 8, 8)


def make_st_input(rng, m_cap=M_CAP, n=N, cin=3, grid=8, frames=3, batches=2,
                  t_max=None):
    """n unique (batch, x, y, z, t) sites among m_cap rows, padding rows
    interleaved; a few sites at t = t_max - 1 and at large x, y, z when
    t_max is given."""
    seen, rows = set(), []
    if t_max:
        for c in ((0, 0, 0, 0, t_max - 1), (1, 16383, 16383, 4000, t_max - 1),
                  (1, 16383, 16383, 4000, t_max - 2), (1, 16383, 16383, 4001, 0)):
            seen.add(c)
            rows.append(c)
    while len(rows) < n:
        c = (int(rng.integers(0, batches)), *(int(v) for v in rng.integers(0, grid, 3)),
             int(rng.integers(0, frames)))
        if c not in seen:
            seen.add(c)
            rows.append(c)
    coords = np.zeros((m_cap, 5), np.int32)
    coords[:n] = np.array(rows, np.int32)
    feats = np.zeros((m_cap, cin), np.float32)
    feats[:n] = rng.normal(size=(n, cin)).astype(np.float32)
    valid = np.zeros(m_cap, bool)
    valid[:n] = True
    perm = rng.permutation(m_cap)
    return pair(coords[perm], valid[perm], feats[perm])


def pair(coords, valid, feats):
    n = int(valid.sum())
    j = JST(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid), jnp.int32(n))
    t = TST(torch.from_numpy(coords.copy()), torch.from_numpy(feats.copy()),
            torch.from_numpy(valid.copy()), torch.tensor(n, dtype=torch.int32))
    return j, t


@pytest.fixture(scope="module")
def sites():
    return make_st_input(np.random.default_rng(11), grid=6, t_max=512)


def test_pack_keys_5col_equals_jax(sites):
    js, ts = sites
    want = jax.jit(JH.pack_keys)(js.coords)
    got = TH.pack_keys(ts.coords)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    order, hi, lo = TH.sort_coords(ts.coords, ts.valid)
    for g, w in zip((order, hi, lo), jax.jit(JH.sort_coords)(js.coords, js.valid)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("conv_type,kvol", [
    ("spatial_hypercube_temporal_hypercross", 29),  # the ST blocks' hybrid region
    ("hypercube", 81),                              # the Tesseract's
    ("hypercross", 9),                              # the 4-D cross
    ("spatial_hypercube", 27),                      # the stem's
])
def test_st_rulebook_equals_jax(sites, conv_type, kvol):
    js, ts = sites
    want = np.asarray(jax.jit(lambda s: JC.build_subm_rulebook(s, 3, conv_type=conv_type))(js))
    got = TC.build_subm_rulebook(ts, 3, conv_type=conv_type)
    assert got.dtype == torch.int32 and got.shape == (M_CAP, kvol)
    assert TC.rulebook_volume(3, conv_type, 4) == kvol
    np.testing.assert_array_equal(got.numpy(), want)
    present = (want < M_CAP) & (want != np.arange(M_CAP)[:, None])
    assert present.sum() > N // 2  # neighbours beyond the centre


@pytest.mark.parametrize("cap_out", [128, 90])  # 90 binds
def test_downsample_coords_5col_equals_jax(sites, cap_out):
    js, ts = sites
    want = [np.asarray(x) for x in JC.downsample_coords(js, cap_out)]
    got = [x.numpy() for x in TC.downsample_coords(ts, cap_out)]
    for name, g, w in zip(("coords_out", "valid_out", "num_out", "out_row", "delta"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # t rides through unchanged
    assert (want[0][:min(int(want[2]), cap_out), 4] >= 0).all()
    if cap_out == 90:
        assert int(want[2]) > cap_out


def test_instance_norm_matches_jax():
    """Batch ids past max_batches clamp to its last segment; padding rows
    go to the extra one."""
    rng = np.random.default_rng(2)
    m, c = 300, 12
    feats = rng.normal(0.5, 2.0, size=(m, c)).astype(np.float32)
    ids = rng.integers(0, 19, m).astype(np.int32)  # 16, 17, 18 clamp to 15
    valid = rng.random(m) < 0.8
    norm = J.SparseInstanceNorm()
    variables = jax.tree.map(np.asarray, norm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                                   jnp.asarray(ids), jnp.asarray(valid)))
    variables["params"] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                           "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    want = np.asarray(jax.jit(norm.apply)(variables, feats, ids, valid))
    port = T.SparseInstanceNorm(c)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in variables["params"].items()})
    got = port(torch.from_numpy(feats), torch.from_numpy(ids), torch.from_numpy(valid))
    np.testing.assert_allclose(got.detach().numpy()[valid], want[valid], rtol=1e-5, atol=1e-5)
    # padding rows: feats / sqrt(epsilon) * scale + bias on both sides
    np.testing.assert_allclose(got.detach().numpy()[~valid], want[~valid], rtol=1e-5)


NETS = ["STRes16UNet14A", "STResTesseract16UNet18A"]


def _nets(variant):
    cfg = J.ST_VARIANTS[variant]
    kw = dict(out_channels=C, planes=PLANES, layers=cfg["layers"], init_dim=8,
              block_conv_type=cfg.get("block_conv_type", T.HYBRID), level_caps=CAPS)
    return J.MinkUNet(**kw), T.MinkUNet(ndim=4, device="cpu", **kw)


@pytest.fixture(scope="module")
def st_input():
    rng = np.random.default_rng(4)
    js, ts = make_st_input(rng)
    labels = rng.integers(0, C, size=M_CAP).astype(np.int32)
    labels[~np.asarray(js.valid)] = 255
    return js, ts, labels, rng


def _shared_weights(variant, js, rng):
    jmodel, port = _nets(variant)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, s: jmodel.init(r, s, train=False))(jax.random.PRNGKey(5), js))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
    port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    return jmodel, port, variables


@pytest.mark.parametrize("variant", NETS)
def test_st_logits_match_jax(st_input, variant):
    js, ts, _, rng = st_input
    jmodel, port, variables = _shared_weights(variant, js, rng)
    kvol = 81 if "Tesseract" in variant else 29
    assert port.block1_0.conv1.kernel.shape[0] == kvol
    assert port.conv0.kernel.shape[0] == 27  # the stem spans space only
    want = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(variables, js))
    with torch.no_grad():
        got = port(ts, train=False).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ok = np.asarray(js.valid)
    assert (got[ok].argmax(1) == want[ok].argmax(1)).mean() >= ARGMAX
    assert (got[~ok] == 0).all()


def test_tesseract_train_step_matches_jax(st_input):
    js, ts, labels, rng = st_input
    jmodel, port, variables = _shared_weights("STResTesseract16UNet18A", js, rng)
    with f32_convs():
        want = _jax_train(jmodel, variables, js, jnp.asarray(labels))
        optimizer, scheduler = TS.make_optimizer(
            "SGD", port.parameters(), TS.make_schedule("PolyLR", LR, max_iter=MAX_ITER))
        loss, _ = train_step(port, optimizer, scheduler, ts, torch.from_numpy(labels))
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    grads = minkunet_params_from_flax({"params": want["grads"]})
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    for key, p in named.items():
        _close(p.grad.numpy(), grads[key].numpy(), 1e-4, f"grad {key}")
    _stats_close(port, want["stats"], 1e-5, 1e-5)


def test_4col_input_to_st_model_raises():
    _, port = _nets("STRes16UNet14A")
    st4 = TST(torch.zeros((16, 4), dtype=torch.int32), torch.zeros((16, 3)),
              torch.ones(16, dtype=torch.bool), torch.tensor(16, dtype=torch.int32))
    with pytest.raises(ValueError):
        port(st4)
