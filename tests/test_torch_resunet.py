"""The port's ResUNet and MinkUNetHyper (seggroup_tpu_torch.models.minkunet)
against the flax modules on the CPU at shared weights
(models.convert.minkunet_params_from_flax), the BatchNorm statistics
randomised, at the variants' depths and norm types and narrow widths (the
planes below, stem 8).

Logits at the default bf16 convs within the MinkUNet tolerance of
tests/test_torch_minkunet.py (atol 2e-4 + rtol 1e-3, argmax on 99% of the
voxels). `_pool_transpose` within rtol = atol = 1e-6 of JAX's (a gather
and a true division by the child counts on both sides). One float32 train
step of MinkUNetHyper14INBN (instance then batch norms, the pooling
transposes' backward) through cli/stage2_train_minkunet.train_step against
jax.value_and_grad: the loss within 1e-5 relative, each gradient within
1e-4 of its tensor's max|JAX|, the running statistics within rtol = atol =
1e-5. The instance norms' scales and shifts, which the batch norm after
each removes, have gradients of rounding noise (under 1e-5 of the net's
largest on the JAX side); they are held within 1e-4 of that largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import minkunet as J
from seggroup_tpu.sparse.conv import strided_conv_down as j_down
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch import solvers as TS
from seggroup_tpu_torch.cli.stage2_train_minkunet import train_step
from seggroup_tpu_torch.models import minkunet as T
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.sparse.conv import strided_conv_down as t_down

from test_torch_minkunet import ARGMAX, ATOL, RTOL, _randomize_stats, make_sparse_input
from test_torch_minkunet_train import C, LR, MAX_ITER, _close, _jax_train, _stats_close, f32_convs

torch.set_num_threads(1)

M_CAP, N = 320, 200
CAPS = [320, 160, 80, 40]
PLANES = (8, 16, 16, 32, 16, 16, 8)

NETS = {
    "ResUNet14": (J.ResUNet, T.ResUNet, J.RESUNET_VARIANTS["ResUNet14"]),
    "ResUNet18INBN": (J.ResUNet, T.ResUNet, J.RESUNET_VARIANTS["ResUNet18INBN"]),
    "MinkUNetHyper": (J.MinkUNetHyper, T.MinkUNetHyper, J.HYPER_VARIANTS["MinkUNetHyper"]),
    "MinkUNetHyper14INBN": (J.MinkUNetHyper, T.MinkUNetHyper,
                            J.HYPER_VARIANTS["MinkUNetHyper14INBN"]),
}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(6)
    js, ts = make_sparse_input(rng, m_cap=M_CAP, n=N, grid=14)
    labels = rng.integers(0, C, size=M_CAP).astype(np.int32)
    labels[N:] = 255
    return js, ts, labels, rng


def _shared(name, js, rng):
    jcls, tcls, cfg = NETS[name]
    kw = dict(out_channels=C, planes=PLANES, init_dim=8, level_caps=CAPS, **cfg)
    jmodel, port = jcls(**kw), tcls(device="cpu", **kw)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, s: jmodel.init(r, s, train=False))(jax.random.PRNGKey(7), js))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
    port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    return jmodel, port, variables


@pytest.mark.parametrize("name", list(NETS))
def test_logits_match_jax(inputs, name):
    js, ts, _, rng = inputs
    jmodel, port, variables = _shared(name, js, rng)
    if "INBN" in name:
        assert hasattr(port.block1_0, "norm1_in") and hasattr(port, "final_bn_in")
    want = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(variables, js))
    with torch.no_grad():
        got = port(ts, train=False).numpy()
    assert got.shape == (M_CAP, C)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:N].argmax(1) == want[:N].argmax(1)).mean() >= ARGMAX
    assert (got[N:] == 0).all()


def test_pool_transpose_matches_jax(inputs):
    """Level 0 -> 1 and, through the padded level-1 map, level 0 -> 2, at
    a level-2 capacity that drops sites (their fine rows read 0)."""
    js, ts, _, rng = inputs
    w = rng.normal(size=(8, 3, 5)).astype(np.float32)
    j1, jk1 = j_down(js, jnp.asarray(w[:, :, :3]), 160)
    j2, jk2 = j_down(j1, jnp.asarray(w[:, :3]), 30)
    t1, tk1 = t_down(ts, torch.from_numpy(w[:, :, :3]), 160)
    t2, tk2 = t_down(t1, torch.from_numpy(w[:, :3]), 30)
    assert int(j2.num) > 30
    j02 = jnp.concatenate([jk2["out_row"], jnp.full((1,), 30, jnp.int32)])[
        jnp.minimum(jk1["out_row"], 160)]
    t02 = torch.cat([tk2["out_row"], torch.full((1,), 30, dtype=torch.int32)])[
        torch.clamp(tk1["out_row"], max=160).long()]
    np.testing.assert_array_equal(t02.numpy(), np.asarray(j02))
    for jc, tc, jr, tr in ((j1, t1, jk1["out_row"], tk1["out_row"]), (j2, t2, j02, t02)):
        want = np.asarray(jax.jit(J._pool_transpose)(jc, jr, js.valid))
        got = T._pool_transpose(tc, tr, ts.valid).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert (np.abs(want[:N]).sum(1) > 0).any() and (want[N:] == 0).all()


def test_hyper14inbn_train_step_matches_jax(inputs):
    js, ts, labels, rng = inputs
    jmodel, port, variables = _shared("MinkUNetHyper14INBN", js, rng)
    with f32_convs():
        want = _jax_train(jmodel, variables, js, jnp.asarray(labels))
        optimizer, scheduler = TS.make_optimizer(
            "SGD", port.parameters(), TS.make_schedule("PolyLR", LR, max_iter=MAX_ITER))
        loss, _ = train_step(port, optimizer, scheduler, ts, torch.from_numpy(labels))
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    grads = minkunet_params_from_flax({"params": want["grads"]})
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    gmax = max(float(g.abs().max()) for g in grads.values())
    for key, p in named.items():
        if "_in." in key:
            # the batch norm after each instance norm removes its per-channel
            # scale and shift: their gradients are rounding noise on both
            # sides, held against the largest gradient of the net
            assert float(grads[key].abs().max()) <= 1e-5 * gmax, key
            assert float((p.grad - grads[key]).abs().max()) <= 1e-4 * gmax, key
        else:
            _close(p.grad.numpy(), grads[key].numpy(), 1e-4, f"grad {key}")
    _stats_close(port, want["stats"], 1e-5, 1e-5)


def test_variant_tables_and_param_counts():
    """The variant tables are JAX's, and three variants build with JAX's
    parameter count (counted on the JAX side through eval_shape)."""
    coords = np.zeros((64, 4), np.int32)
    coords[:, 1:] = np.arange(64)[:, None] % 4
    js = JST(jnp.asarray(coords), jnp.zeros((64, 3)), jnp.ones(64, bool), jnp.int32(64))
    tables = [(J.RESUNET_VARIANTS, J.make_resunet, T.make_resunet),
              (J.HYPER_VARIANTS, J.make_hyper, T.make_hyper)]
    assert T.RESUNET_VARIANTS.keys() == J.RESUNET_VARIANTS.keys()
    assert T.ST_RESUNET_VARIANTS.keys() == J.ST_RESUNET_VARIANTS.keys()
    assert T.HYPER_VARIANTS.keys() == J.HYPER_VARIANTS.keys()
    for table, jmake, tmake in tables:
        for name in ("ResUNet14", "ResUNet34F", "MinkUNetHyper14INBN"):
            if name not in table:
                continue
            shapes = jax.eval_shape(lambda r, s: jmake(name, level_caps=[64, 32, 16, 8]).init(
                r, s, train=False), jax.random.PRNGKey(0), js)
            n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
            port = tmake(name, device="cpu")
            assert sum(p.numel() for p in port.parameters()) == n_jax, name
            n_stats = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["batch_stats"]))
            assert sum(b.numel() for b in port.buffers()) == n_stats, name
    small = dict(planes=PLANES, init_dim=8, device="cpu")
    tess = T.make_resunet("STResTesseractUNet14", **small)
    assert tess.block2_0.conv1.kernel.shape[0] == 81 and tess.conv1.kernel.shape[0] == 27
    assert T.make_resunet("STResUNet14", **small).block1_0.conv1.kernel.shape[0] == 29
