"""Port MinkUNet training (seggroup_tpu_torch.models.minkunet with
train=True, cli/stage2_train_minkunet.train_step, solvers.make_optimizer)
against the flax MinkUNet, jax.value_and_grad of the JAX driver's loss
(cli/stage2_train_minkunet.py:209-219) and optax, on the CPU at shared
weights (models.convert.minkunet_params_from_flax), with the BatchNorm
running statistics randomised.

SparseBatchNorm alone: outputs and updated running statistics within
rtol = atol = 1e-5 (the same float32 sums in another order).

One train step, with the submanifold convs at float32 on both sides (the
exact-parity configuration): the loss within 1e-5, every gradient and
every parameter after one SGD step within 1e-4 of the tensor's max|JAX|,
the new batch statistics within rtol = atol = 1e-5. Measured here: loss
4.8e-7, gradients 3.1e-6 of max|g|, SGD parameters 3.2e-6 of max|p|,
statistics 1.2e-7. Adam's first step moves each weight by about
lr * sign(g + 1e-4 * w): where weight decay all but cancels the gradient
(|g + 1e-4 * w| near Adam's eps of 1e-8) a last-bit difference flips the
step, so the Adam parameters are held to 1e-4 where |g + 1e-4 * w| > 1e-6
and to 2 * lr elsewhere (measured 2.3e-5 and 0.098).

The default bf16 convs round at other places on the two sides, and at this
size (12 voxels at the coarsest level, whose BatchNorm divides by their
spread) the gradients are chaotic under it: JAX's own bf16 gradients
differ from its float32 ones by up to 65% of a tensor's max, 0.23 in
relative L2 norm over all gradients. So at bf16 the step is held on the
loss within 1e-3, the batch statistics within atol 1e-4 + rtol 1e-3, all
gradients within 0.3 in relative L2 norm (about the reference's own
bf16-to-float32 spread) and the classifier head's gradient within 2e-2 of
its max; measured 1.8e-4, 1.1e-5, 0.083 and 2.5e-3. chip_smoke.py holds
the card against the CPU to the same bounds (at 2^14 rows, with 225 voxels
at the coarsest level, the bf16 step is still chaotic), and there holds
every kernel call against its plain version and each gradient of a
backward through running statistics against what bf16 moves it by."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seggroup_tpu import solvers as JS
from seggroup_tpu.models import minkunet as J
from seggroup_tpu_torch import solvers as TS
from seggroup_tpu_torch.cli.stage2_train_minkunet import masked_nll, train_step
from seggroup_tpu_torch.models import minkunet as T
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax

from test_torch_minkunet import CAPS, M_CAP, N, NETS, _models, _randomize_stats, make_sparse_input

torch.set_num_threads(1)

C = 20
LR, MAX_ITER = 0.1, 1000
WD = TS.WEIGHT_DECAY  # the optimizers' weight decay, on both sides


@contextlib.contextmanager
def f32_convs():
    """Both MinkUNets with their submanifold convs at float32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "subm_conv", functools.partial(J.subm_conv, compute_dtype=jnp.float32))
        mp.setattr(T, "subm_conv", functools.partial(T.subm_conv, compute_dtype=torch.float32))
        yield


def _labels(rng):
    lab = rng.integers(0, C, size=M_CAP).astype(np.int32)
    lab[rng.random(M_CAP) < 0.1] = 255  # unlabelled points
    lab[N:] = 255
    return lab


def _jax_train(jmodel, variables, js, labels):
    """Loss, grads and new batch stats of the JAX driver's loss, and the
    parameters after one SGD and one Adam step of seggroup_tpu.solvers."""
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        logits, mut = jmodel.apply({"params": p, "batch_stats": stats}, js, train=True,
                                   mutable=["batch_stats"])
        ok = js.valid & (labels != 255)
        lp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.clip(labels, 0, C - 1)[:, None], axis=1)[:, 0]
        loss = jnp.sum(jnp.where(ok, nll, 0.0)) / jnp.maximum(jnp.sum(ok), 1)
        return loss, (mut["batch_stats"], logits)

    (loss, (new_stats, logits)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    schedule = JS.make_schedule("PolyLR", LR, max_iter=MAX_ITER)
    after = {}
    for name in ("SGD", "Adam"):
        opt = JS.make_optimizer(name, schedule)
        updates, _ = jax.jit(opt.update)(grads, opt.init(params), params)
        after[name] = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, dict(loss=loss, grads=grads, stats=new_stats,
                                         logits=logits, after=after))


@pytest.fixture(scope="module")
def shared():
    """Per net: (JAX variables, JAX results at float32 convs, port input,
    labels), and the JAX results of Res16UNet14A at the default bf16."""
    rng = np.random.default_rng(0)
    js, ts = make_sparse_input(rng)
    labels = _labels(rng)
    out = {}
    for name in NETS:
        jmodel, _ = _models(name)
        variables = jax.tree.map(np.asarray, jax.jit(
            lambda r, s: jmodel.init(r, s, train=False))(jax.random.PRNGKey(1), js))
        variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
        with f32_convs():
            want = _jax_train(jmodel, variables, js, jnp.asarray(labels))
        out[name] = (variables, want, ts, torch.from_numpy(labels))
    jmodel, _ = _models("Res16UNet14A")
    out["bf16"] = _jax_train(jmodel, out["Res16UNet14A"][0], js, jnp.asarray(labels))
    return out


def _port_step(name, variables, ts, labels, opt_name, f32=True):
    _, make_port = _models(name)
    port = make_port()
    port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    optimizer, scheduler = TS.make_optimizer(
        opt_name, port.parameters(), TS.make_schedule("PolyLR", LR, max_iter=MAX_ITER))
    with f32_convs() if f32 else contextlib.nullcontext():
        loss, hist = train_step(port, optimizer, scheduler, ts, labels)
    return port, loss, hist, scheduler


def _close(got, want, rel, what):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


def _stats_close(port, want_stats, rtol, atol):
    stats = minkunet_params_from_flax({"params": {}, "batch_stats": want_stats})
    buffers = dict(port.named_buffers())
    assert set(stats) == set(buffers)
    for key, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), stats[key].numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(NETS))
def test_sgd_step_matches_jax(shared, name):
    variables, want, ts, labels = shared[name]
    port, loss, hist, scheduler = _port_step(name, variables, ts, labels, "SGD")
    assert abs(float(loss) - float(want["loss"])) <= 1e-5
    grads = minkunet_params_from_flax({"params": want["grads"]})
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    for key, p in named.items():
        _close(p.grad.numpy(), grads[key].numpy(), 1e-4, f"grad {key}")
    _stats_close(port, want["stats"], 1e-5, 1e-5)
    after = minkunet_params_from_flax({"params": want["after"]["SGD"]})
    for key, p in named.items():
        _close(p.detach().numpy(), after[key].numpy(), 1e-4, f"SGD {key}")
    # the step's confusion matrix counts every valid labelled row once
    assert int(hist.sum()) == int(((labels != 255) & ts.valid).sum())
    assert scheduler.count == 1


@pytest.mark.parametrize("name", list(NETS))
def test_adam_step_matches_optax(shared, name):
    variables, want, ts, labels = shared[name]
    port, _, _, _ = _port_step(name, variables, ts, labels, "Adam")
    before = minkunet_params_from_flax(variables)
    grads = minkunet_params_from_flax({"params": want["grads"]})
    after = minkunet_params_from_flax({"params": want["after"]["Adam"]})
    for key, p in port.named_parameters():
        err = (p.detach() - after[key]).abs()
        steady = (grads[key] + WD * before[key]).abs() > 1e-6
        if steady.any():
            assert float(err[steady].max()) <= 1e-4, (key, float(err[steady].max()))
        assert float(err.max()) <= 2 * LR, key


def test_bf16_step_matches_jax(shared):
    """The default bf16 convs, to the bounds of the module docstring."""
    variables, _, ts, labels = shared["Res16UNet14A"]
    want = shared["bf16"]
    port, loss, _, _ = _port_step("Res16UNet14A", variables, ts, labels, "SGD", f32=False)
    assert abs(float(loss) - float(want["loss"])) <= 1e-3
    _stats_close(port, want["stats"], 1e-3, 1e-4)
    grads = minkunet_params_from_flax({"params": want["grads"]})
    named = dict(port.named_parameters())
    diff = sum(float(((named[k].grad - g) ** 2).sum()) for k, g in grads.items())
    norm = sum(float((g ** 2).sum()) for g in grads.values())
    assert (diff / norm) ** 0.5 <= 0.3
    for key in ("final.weight", "final.bias"):
        _close(named[key].grad.numpy(), grads[key].numpy(), 2e-2, key)


def test_loss_ignores_invalid_and_unlabelled_rows():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(6, 4, generator=g)
    labels = torch.tensor([0, 3, 255, 1, 2, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False, False])
    want = -torch.log_softmax(logits, -1)[[0, 1, 3], [0, 3, 1]].mean()
    torch.testing.assert_close(masked_nll(logits, labels, valid), want)
    assert float(masked_nll(logits, labels, torch.zeros(6, dtype=torch.bool))) == 0.0


def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(3)
    m, c = 400, 24
    feats = rng.normal(1.5, 2.0, size=(m, c)).astype(np.float32)
    valid = rng.random(m) < 0.7
    bn = J.SparseBatchNorm()
    variables = jax.tree.map(np.asarray, bn.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                                 jnp.asarray(valid), False))
    for coll, key, draw in (("params", "scale", rng.uniform(0.5, 1.5, c)),
                            ("params", "bias", rng.normal(0, 0.1, c)),
                            ("batch_stats", "mean", rng.normal(0, 0.1, c)),
                            ("batch_stats", "var", rng.uniform(0.5, 1.5, c))):
        variables[coll][key] = draw.astype(np.float32)
    y, mut = jax.jit(lambda v, f, ok: bn.apply(v, f, ok, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(feats), jnp.asarray(valid))
    port = T.SparseBatchNorm(c)
    port.load_state_dict({k: torch.from_numpy(v) for coll in variables.values()
                          for k, v in coll.items()})
    got = port(torch.from_numpy(feats), torch.from_numpy(valid), True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, key).numpy(),
                                   np.asarray(mut["batch_stats"][key]), rtol=1e-5, atol=1e-5)
    # the running variance is the biased one, as on the JAX side
    biased = feats[valid].var(0)
    np.testing.assert_allclose(port.var.numpy(), 0.98 * variables["batch_stats"]["var"]
                               + 0.02 * biased, rtol=1e-5)
