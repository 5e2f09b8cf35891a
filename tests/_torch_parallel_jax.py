"""The JAX data-parallel steps' bodies (seggroup_tpu/parallel/dp.py), shard
by shard in one process, and the checks that hold the port's ranks to
them. A JAX DP step runs, in each shard, jax.value_and_grad of the local
loss, the per-variable gradient transform where the step has one (KPConv,
dp.py:254-256), then takes the pmean of the gradients and of the moved
running statistics and applies the optax update; `body_step` does the
same with the shards in turn. The fast parallel tests call it at the
port's own weights before each of its steps (`flax_from_port`), so that
each step is held alone, at the single-card parity tests' tolerances.
`reference_steps` gives the steps' references."""

from __future__ import annotations

from collections.abc import Callable, Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax

from seggroup_tpu_torch.models.convert import minkunet_params_from_flax


def flax_from_port(state: Mapping) -> dict:
    """The flax `{"params", "batch_stats"}` trees of a port state_dict
    (MinkUNet's, PointGroup's or KPConv's): the inverse of
    models.convert.minkunet_params_from_flax, which keeps the flax names
    and turns 2-D `kernel`s into transposed `.weight`s. The port's only
    buffers are the running `mean`s and `var`s."""
    out = {"params": {}, "batch_stats": {}}
    for key, v in state.items():
        path = key.split(".")
        v = np.asarray(v, dtype=np.float32)
        if path[-1] in ("mean", "var"):
            tree = out["batch_stats"]
        else:
            tree = out["params"]
            if path[-1] == "weight":
                path, v = path[:-1] + ["kernel"], v.T
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.ascontiguousarray(v)
    back = minkunet_params_from_flax(out)
    assert back.keys() == state.keys()
    assert all(np.array_equal(back[k].numpy(), np.asarray(state[k])) for k in state)
    return out


def body_step(grad_fn: Callable, variables: Mapping, shards, opt, transform=None) -> dict:
    """One JAX DP step's body over `shards` from `variables`:
    grad_fn(params, stats, shard) -> ((loss, (new_stats, aux)), grads) on
    each shard, `transform` on each shard's gradients, their mean and the
    new statistics' mean, then `opt`'s update (a stateless optax
    optimizer). Returns numpy trees: `params` and `stats` after the step,
    the mean `grads`, and each shard's `loss` and `aux`."""
    params, stats = variables["params"], variables["batch_stats"]
    outs = [grad_fn(params, stats, s) for s in shards]
    grads = [g if transform is None else transform(g) for _, g in outs]
    n = len(shards)
    mean = jax.tree.map(lambda *g: sum(g) / n, *grads)
    new_stats = jax.tree.map(lambda *s: sum(s) / n, *[st for (_, (st, _)), _ in outs])
    updates, _ = opt.update(mean, opt.init(params), params)
    return jax.tree.map(np.asarray, {
        "params": optax.apply_updates(params, updates), "stats": new_stats, "grads": mean,
        "loss": [loss for (loss, _), _ in outs], "aux": [aux for (_, (_, aux)), _ in outs]})


def hold_step(port_grads: Mapping, port_after: Mapping, ref: dict, convert: Callable,
              grad_rtol: float = 1e-4, param_rtol: float = 1e-4, stats_tol: float = 1e-5,
              noise: Mapping | None = None) -> None:
    """The port's mean gradients and state after a step against the JAX
    body's from the same weights (`ref`, from body_step), under the port's
    names: each gradient within grad_rtol of its tensor's max|JAX| (the
    tensors of `noise`, name -> bound, within their absolute bound
    instead), each parameter within param_rtol of its max|JAX|, each
    running statistic within rtol = atol = stats_tol."""
    noise = noise or {}
    grads = convert({"params": ref["grads"]})
    after = convert({"params": ref["params"], "batch_stats": ref["stats"]})
    assert set(grads) == set(port_grads)
    assert set(after) == set(port_after)
    for k, want in grads.items():
        want, got = want.numpy(), np.asarray(port_grads[k])
        err = float(np.abs(got - want).max())
        bound = noise.get(k, grad_rtol * float(np.abs(want).max()))
        assert err <= bound, ("grad", k, err, bound)
    for k, want in after.items():
        want, got = want.numpy(), np.asarray(port_after[k])
        if k in grads:
            err = float(np.abs(got - want).max())
            assert err <= param_rtol * float(np.abs(want).max()), ("param", k, err)
        else:
            np.testing.assert_allclose(got, want, rtol=stats_tol, atol=stats_tol, err_msg=k)


def reference_steps(grad_fn: Callable, befores, batches, lr: float, transform=None) -> list:
    """The JAX body's step k from befores[k] (a port state_dict, the
    port's weights before its step k) on the shards' batches[k], with
    optax.sgd(lr)."""
    return [body_step(grad_fn, flax_from_port(before),
                      [jax.tree.map(jnp.asarray, b) for b in per_shard], optax.sgd(lr),
                      transform)
            for before, per_shard in zip(befores, batches)]


def kpconv_grad_transform(clip: float, offset_scale: float) -> Callable:
    """cli/stage2_train_kpconv.py `per_var_grads`: the offsets' gradients
    scaled by `offset_scale`, then each tensor clipped to norm `clip`."""
    def per_var(path, g):
        if any("offset_kernel" in str(getattr(k, "key", k))
               or "offset_mlp" in str(getattr(k, "key", k)) for k in path):
            g = g * offset_scale
        norm = jnp.sqrt(jnp.sum(jnp.square(g)) + 1e-12)
        return g * jnp.minimum(1.0, clip / norm)
    return lambda grads: jax.tree_util.tree_map_with_path(per_var, grads)
