"""KPCNN (seggroup_tpu_torch.models.kpconv.KPCNN) and the classification
evaluation driver against the JAX package on the CPU, at shared weights
(converted by models.convert.kpcnn_params_from_flax) with nonzero
deformable offsets and random running statistics:

  * the eval forward on 3 synthetic shapes of 512 points in 4 slots: logits within
    1e-5 of their magnitude, zero for absent batch elements;
  * the train forward with JAX's dropout mask injected on both sides (the
    JAX side through flax's `intercept_methods`): logits and the new
    running statistics within tolerance, and the port's own dropout;
  * cli/stage2_test_classification.py end to end, JAX's driver restoring
    the flax variables and the port's the converted ones, on 8 shapes with
    2 votes: the same log lines (each vote's accuracy, the confusion
    matrix, the final accuracy) and each object's mean probabilities
    within 1e-5 (JAX's from the logits its driver computes, captured
    around its jitted forward)."""

import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import kpconv as J
from seggroup_tpu_torch.cli import stage2_test_classification as TC
from seggroup_tpu_torch.models import kpconv as T
from seggroup_tpu_torch.models.convert import kpcnn_params_from_flax

torch.set_num_threads(2)

B, PTS, DL0, FDIM, C = 4, 512, 0.08, 16, 6
N = B * PTS
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def shared_kernel_points():
    """The JAX function's kernel points (bit-equal to the port's,
    tests/test_torch_kpconv.py), so that the numpy optimisation runs once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "kernel_point_positions", J.kernel_point_positions)
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(variables, seed):
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


def _batch(absent: bool):
    """4 slots, the last empty if `absent`, filled with shapes as the
    driver packs them; both pyramids."""
    rng = np.random.default_rng(0)
    pts = np.zeros((N, 3), np.float32)
    bids = np.zeros(N, np.int32)
    valid = np.zeros(N, bool)
    for j in range(B - 1 if absent else B):
        sl = slice(j * PTS, (j + 1) * PTS)
        pts[sl] = TC.vote_augment(TC.make_shape_cloud(j, rng, PTS), rng)
        bids[sl] = j
        valid[sl] = True
    caps = TC.kpcnn_level_caps(N)
    jl = jax.jit(lambda p, b, v: J.build_pyramid(p, b, v, 5, DL0, level_caps=caps))(
        jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(valid))
    tl = T.build_pyramid(_t(pts), _t(bids), _t(valid), 5, DL0, level_caps=caps)
    assert int(jl[4].valid.sum()) >= B  # every present element keeps rows to the last level
    return jl, tl


@pytest.fixture(scope="module")
def batch():
    return _batch(absent=True)


@pytest.fixture(scope="module")
def network(batch):
    jl, _ = batch
    model = J.KPCNN(num_classes=C, first_features_dim=FDIM, dl0=DL0, num_batches=B)
    v = jax.jit(lambda r, py, f: model.init(r, py, f, train=False))(
        jax.random.PRNGKey(0), jl, jnp.ones((N, 1), jnp.float32))
    v = _randomize(v, 1)
    tm = T.KPCNN(num_classes=C, first_features_dim=FDIM, dl0=DL0, num_batches=B, device="cpu")
    tm.load_state_dict(kpcnn_params_from_flax(v), strict=True)
    return model, v, tm


def test_eval_forward_matches_jax(batch, network):
    jl, tl = batch
    model, v, tm = network
    want, want_reg = jax.jit(lambda v, py, f: model.apply(v, py, f, train=False))(
        v, jl, jnp.ones((N, 1), jnp.float32))
    with torch.no_grad():
        got, reg = tm(tl, torch.ones((N, 1)))
    want = np.asarray(want)
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(reg), float(want_reg), rtol=RTOL)
    assert (got[B - 1] == 0).all() and float(want_reg) > 0
    n_jax = sum(x.size for x in jax.tree.leaves(v["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax


def test_train_forward_with_jax_dropout_mask(network):
    """All 4 elements present. The batch statistics amplify rounding (fc_bn
    normalises over the 4 pooled rows, the coarse levels over tens): the
    logits within 1e-4 of their magnitude (measured 2.0e-5), the running
    statistics within 1e-5."""
    jl, tl = _batch(absent=False)
    model, v, _ = network
    keep = np.random.default_rng(2).random((B, 1024)) < 0.5

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            return args[0] * keep / 0.5
        return next_fun(*args, **kwargs)

    def run(v, py, f):
        with fnn.intercept_methods(intercept):
            return model.apply(v, py, f, train=True, mutable=["batch_stats"])

    (want, _), mut = jax.jit(run)(v, jl, jnp.ones((N, 1), jnp.float32))
    tm = T.KPCNN(num_classes=C, first_features_dim=FDIM, dl0=DL0, num_batches=B, device="cpu")
    tm.load_state_dict(kpcnn_params_from_flax(v), strict=True)
    got, _ = tm(tl, torch.ones((N, 1)), train=True, dropout_keep=_t(keep))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    stats = kpcnn_params_from_flax({"params": {}, "batch_stats": mut["batch_stats"]})
    for name, w in stats.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(), w.numpy(), rtol=0,
                                   atol=RTOL * max(1.0, float(w.abs().max())), err_msg=name)
    assert not np.allclose(stats["fc_bn.mean"].numpy(), v["batch_stats"]["fc_bn"]["mean"])
    # the port's own draw keeps about half and doubles what it keeps
    h = torch.ones(B, 1024)
    g = torch.Generator().manual_seed(0)
    kept = torch.rand(h.shape, generator=g) < 0.5
    assert 0.45 < float(kept.float().mean()) < 0.55


ARGS = ["--synthetic", "8", "--votes", "2", "--batch_clouds", "4", "--points_per_cloud",
        "256", "--first_features_dim", "16", "--exp_name", "c"]


def test_driver_matches_jax(tmp_path, monkeypatch):
    from cli import stage2_test_classification as JC
    from seggroup_tpu.utils import jit_cache
    from seggroup_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
    from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
    # the flax variables at the driver's sizes, from its own init
    model = J.KPCNN(num_classes=C, first_features_dim=16, dl0=DL0, num_batches=4)
    pyr = jax.jit(lambda p, b, v: J.build_pyramid(p, b, v, 5, DL0,
                                                  level_caps=TC.kpcnn_level_caps(1024)))(
        jnp.asarray(np.random.default_rng(0).random((1024, 3), np.float32)),
        jnp.zeros(1024, jnp.int32), jnp.ones(1024, bool))
    v = _randomize(jax.jit(lambda r, py: model.init(r, py, jnp.ones((1024, 1)), train=False))(
        jax.random.PRNGKey(3), pyr), 4)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    JaxCkpt(str(jax_dir / "checkpoints" / "c" / "kpcnn")).save(2, v)
    CheckpointManager(port_dir / "checkpoints" / "c" / "kpcnn").save(
        2, {"model": kpcnn_params_from_flax(v)})

    logits = []
    real_jit = jax.jit

    def spy_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "fwd":
            return jitted

        def call(*args):
            out = jitted(*args)
            logits.append(np.asarray(out))
            return out
        return call

    monkeypatch.chdir(jax_dir)
    monkeypatch.setattr(sys, "argv", ["stage2_test_classification", *ARGS])
    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", spy_jit)
        JC.main()
    jax_log = (jax_dir / "checkpoints" / "c" / "kpcnn_test.log").read_text()

    monkeypatch.chdir(port_dir)
    probs_seen = []
    real_vote = TC.vote_classify

    def vote(*a, **k):
        out = real_vote(*a, **k)
        probs_seen.append(out[0])
        return out
    monkeypatch.setattr(TC, "vote_classify", vote)
    acc = TC.main([*ARGS, "--device", "cpu"])
    port_log = (port_dir / "checkpoints" / "c" / "kpcnn_test.log").read_text()
    assert port_log == jax_log
    assert "loaded checkpoint 2" in port_log and "confusion matrix:" in port_log

    # JAX's mean probabilities from the logits its driver computed, in its order
    assert len(logits) == 4
    want = np.zeros((8, C))
    counts = np.zeros(8)
    for i, lg in enumerate(logits):
        idx = np.arange(4) + 4 * (i % 2)
        sm = np.exp(lg[:4] - lg[:4].max(1, keepdims=True))
        sm /= sm.sum(1, keepdims=True)
        counts[idx] += 1
        want[idx] += (sm - want[idx]) / counts[idx, None]
    np.testing.assert_allclose(probs_seen[0], want, rtol=0, atol=1e-5)
    assert 0 <= acc <= 100
