"""Port MinkUNet (seggroup_tpu_torch.models.minkunet) against the flax
MinkUNet on the CPU, at shared weights converted by
models.convert.minkunet_params_from_flax, with the BatchNorm running
statistics randomised so the converter's mean/var mapping is exercised.

Both sides run the submanifold convs in bf16 with float32 sums and the rest
in float32; only the order of the sums differs, and a last-bit difference
upstream can flip a later bf16 rounding. Measured here: the logits differ
by at most 2e-5 (Res16UNet14A, magnitude 0.4), 1.2e-7 (the narrow
bottleneck net) and 6.6e-5 (Res16UNet34C, magnitude 0.35); argmax agrees
on every valid voxel.
The tests hold the logits to atol 2e-4 + rtol 1e-3 and argmax to 99%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import minkunet as J
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch.models import minkunet as T
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.sparse.tensor import SparseTensor as TST

torch.set_num_threads(1)

M_CAP, N = 512, 300
CAPS = [512, 256, 128, 64, 64]
ATOL, RTOL, ARGMAX = 2e-4, 1e-3, 0.99


def make_sparse_input(rng, m_cap=M_CAP, n=N, cin=3, grid=24, batches=2):
    """tests/test_minkunet.py's input: n unique sites of a grid^3 box over
    `batches` batch ids, the valid prefix first."""
    coords = np.zeros((m_cap, 4), np.int32)
    seen, rows = set(), []
    while len(rows) < n:
        c = (int(rng.integers(0, batches)), *(int(v) for v in rng.integers(0, grid, 3)))
        if c not in seen:
            seen.add(c)
            rows.append(c)
    coords[:n] = np.array(rows, np.int32)
    feats = np.zeros((m_cap, cin), np.float32)
    feats[:n] = rng.normal(size=(n, cin)).astype(np.float32)
    valid = np.zeros(m_cap, bool)
    valid[:n] = True
    j = JST(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid), jnp.int32(n))
    t = TST(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(valid),
            torch.tensor(n, dtype=torch.int32))
    return j, t


def _randomize_stats(stats, rng):
    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, stats)


NETS = {
    "Res16UNet14A": dict(variant="Res16UNet14A"),
    "bottleneck8": dict(block="bottleneck", planes=(8,) * 8, layers=(1,) * 8),
}


def _models(name):
    cfg = dict(NETS[name])
    variant = cfg.pop("variant", None)
    if variant:
        return (J.make_minkunet(variant, out_channels=20, level_caps=CAPS),
                lambda: T.make_minkunet(variant, out_channels=20, level_caps=CAPS,
                                        device="cpu"))
    return (J.MinkUNet(out_channels=20, level_caps=CAPS, **cfg),
            lambda: T.MinkUNet(out_channels=20, level_caps=CAPS, device="cpu", **cfg))


@pytest.fixture(scope="module")
def shared():
    """Per net: (port model at the JAX weights, JAX variables, JAX logits,
    port input), from one jitted JAX init and forward each."""
    rng = np.random.default_rng(0)
    js, ts = make_sparse_input(rng)
    out = {}
    for name in NETS:
        jmodel, make_port = _models(name)
        variables = jax.jit(lambda r, s: jmodel.init(r, s, train=False))(
            jax.random.PRNGKey(0), js)
        variables = jax.tree.map(np.asarray, variables)
        variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
        logits = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(
            variables, js))
        port = make_port()
        port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
        out[name] = (port, variables, logits, ts)
    return out


def test_res16unet34c_param_count():
    """Counted on the JAX side through eval_shape, so nothing compiles."""
    rng = np.random.default_rng(1)
    js, _ = make_sparse_input(rng, m_cap=256, n=150)
    jmodel = J.make_minkunet("Res16UNet34C", out_channels=20,
                             level_caps=[256, 256, 128, 64, 64])
    shapes = jax.eval_shape(lambda r, s: jmodel.init(r, s, train=False),
                            jax.random.PRNGKey(0), js)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    port = T.make_minkunet("Res16UNet34C", out_channels=20, device="cpu")
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax
    assert 35e6 < n_port < 41e6, n_port
    n_stats = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["batch_stats"]))
    assert n_stats == sum(b.numel() for b in port.buffers())


@pytest.mark.parametrize("name", list(NETS))
def test_converter_fills_every_entry(shared, name):
    port, variables, _, _ = shared[name]
    sd = minkunet_params_from_flax(variables)
    assert set(sd) == set(port.state_dict())
    for key, value in port.state_dict().items():
        assert tuple(value.shape) == tuple(sd[key].shape), key
    n_jax = sum(x.size for x in jax.tree.leaves(variables))
    assert n_jax == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_jax(shared, name):
    port, _, want, ts = shared[name]
    with torch.no_grad():  # inference: the forward records no graph
        got = port(ts, train=False).numpy()
    assert got.shape == want.shape == (M_CAP, 20)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    agree = (got[:N].argmax(1) == want[:N].argmax(1)).mean()
    assert agree >= ARGMAX, agree
    assert np.isfinite(got[:N]).all() and (got[N:] == 0).all()


def test_res16unet34c_forward_matches_jax():
    """The full-width flagship at small caps."""
    rng = np.random.default_rng(2)
    js, ts = make_sparse_input(rng, m_cap=256, n=150)
    caps = [256, 128, 64, 32, 32]
    jmodel = J.make_minkunet("Res16UNet34C", out_channels=20, level_caps=caps)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, s: jmodel.init(r, s, train=False))(jax.random.PRNGKey(3), js))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
    want = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(variables, js))
    port = T.make_minkunet("Res16UNet34C", out_channels=20, level_caps=caps, device="cpu")
    port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port(ts, train=False).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:150].argmax(1) == want[:150].argmax(1)).mean() >= ARGMAX
    assert (got[150:] == 0).all()


def test_seeded_init_is_deterministic():
    a = T.make_minkunet("Res16UNet14A", out_channels=5, seed=4, device="cpu")
    b = T.make_minkunet("Res16UNet14A", out_channels=5, seed=4, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.block1_0.conv1.kernel  # (27, 32, 32): fan-in 27 * 32
    assert abs(float(w.detach().std()) - (1 / (27 * 32)) ** 0.5) < 0.1 * (1 / (27 * 32)) ** 0.5
