"""Point sharding of stage 1 (seggroup_tpu_torch.parallel.point_sharding)
on 2 gloo ranks, against the unsharded port and against the JAX package's
point-sharded builders on a 2-device CPU mesh (make_mesh(2, "point")).

The scene is the N = 1,024 synthetic one of seed 5 (S = 32), the convs at
float32, cluster_cap = knn_window = N, one dropout keep mask injected on
every side (a flax interceptor on the JAX side). One spawn of 2 ranks runs
the sharded forward, the sharded gradient and point_sharded_edge_conv.

The forward's labels equal the unsharded port's and JAX's sharded
forward's exactly. The gradients are held at JAX's own bound for its
sharded gradient against its single-device one
(tests/test_point_sharding.py: rtol 2e-4, atol 2e-6) against the
unsharded port's autograd (worst measured here 3.4e-6 of a tensor's
largest), and at the single-card parity bound across the frameworks
(tests/test_torch_stage1_train.py: each tensor within 1e-4 of its
largest) against JAX's build_stage1_point_sharded_grad (worst 1.2e-5; the
unsharded port against it: 1.3e-5); the loss within 1e-5 relative. Both
ranks return the same gradient bits, and the sharded gradient leaves the
running statistics as they were. point_sharded_edge_conv equals the numpy
edge conv as tests/test_point_sharding.py:12-37 holds JAX's."""

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.data.synthetic import make_synthetic_scene as jax_scene
from seggroup_tpu.models import seggroup as J
from seggroup_tpu.parallel.dp import make_mesh
from seggroup_tpu.parallel.point_sharding import (build_stage1_point_sharded_forward,
                                                  build_stage1_point_sharded_grad,
                                                  make_point_sharded_model)
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import seggroup as T
from seggroup_tpu_torch.models.convert import params_from_flax
from seggroup_tpu_torch.parallel.dp import launch

import _torch_parallel_ranks as ranks

N, S = 1024, 32
SCENE = dict(num_points=N, num_slots=S, num_edges=128, num_instances=4, segs_per_instance=4)
MODEL = dict(cluster_cap=N, knn_window=N)
SEED = 5
LABELS = ("final_sem", "final_ins", "final_root")


def _conv_inputs():
    rng = np.random.default_rng(0)
    n, k, f, c = 256, 16, 9, 32
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.integers(0, n, size=(n, k)).astype(np.int32),
            (rng.normal(size=(2 * f, c)) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    model = J.SegGroupGNN(compute_dtype=jnp.float32, **MODEL)
    scene = jax_scene(seed=SEED, **SCENE)
    variables = jax.tree.map(np.asarray, jax.jit(lambda r1, r2, sc: model.init(
        {"params": r1, "dropout": r2}, sc, mode="train", train=True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), scene))
    keep = np.random.default_rng(300).random((128, 128)) < 0.5
    state = params_from_flax(variables)
    pool = ThreadPoolExecutor(1)  # the ranks run while this process works
    port = pool.submit(launch, ranks.sharded, 2, "cpu", ranks._copy(state), SCENE, SEED, keep,
                       MODEL, _conv_inputs(), timeout=timedelta(seconds=60), threads=1,
                       all_ranks=True)

    torch.set_num_threads(1)
    plain = T.SegGroupGNN(compute_dtype=torch.float32, device="cpu", **MODEL)
    plain.load_state_dict(state, strict=True)
    tscene = make_synthetic_scene(seed=SEED, **SCENE).to("cpu")
    out = plain(tscene, mode="ins_infer")
    unsharded = {k: getattr(out, k).numpy() for k in LABELS}
    tout = plain(tscene, mode="train", dropout_keep=torch.from_numpy(keep))
    loss = tout.loss_sum / torch.clamp(tout.loss_count, min=1.0)
    loss.backward()
    unsharded_grads = {n: p.grad.numpy() for n, p in plain.named_parameters()}

    mesh = make_mesh(2, axis="point")
    sharded = make_point_sharded_model(mesh, compute_dtype=jnp.float32, **MODEL)
    jax_fwd = jax.tree.map(np.asarray, build_stage1_point_sharded_forward(sharded, mesh)(
        variables, scene))

    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            return args[0] * jnp.asarray(keep) / 0.5
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(dropout):
        jloss, jgrads = build_stage1_point_sharded_grad(sharded, mesh)(
            variables, scene, jax.random.PRNGKey(7))
    jgrads = ranks.as_numpy(params_from_flax(jax.tree.map(np.asarray, {
        "params": jgrads, "batch_stats": variables["batch_stats"]})))
    port = port.result()
    pool.shutdown()
    return (state, [ranks.as_numpy(r) for r in port], unsharded, loss.item(), unsharded_grads,
            jax_fwd, float(jloss), jgrads)


def test_sharded_forward_labels_exact(runs):
    _, port, unsharded, _, _, jax_fwd, _, _ = runs
    for d in range(2):
        for k in LABELS:
            np.testing.assert_array_equal(port[d]["out"][k], unsharded[k], err_msg=k)
            np.testing.assert_array_equal(port[d]["out"][k], getattr(jax_fwd, k), err_msg=k)
        np.testing.assert_allclose(port[d]["out"]["acc"], jax_fwd.acc, rtol=1e-6)


def test_sharded_grads_match_single_device_and_jax(runs):
    state, port, _, loss, grads, _, jloss, jgrads = runs
    for d in range(2):
        np.testing.assert_allclose(port[d]["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(port[d]["loss"], jloss, rtol=1e-5)
        for name, g in grads.items():
            got = port[d]["grads"][name]
            np.testing.assert_allclose(got, g, rtol=2e-4, atol=2e-6, err_msg=name)
            scale = np.abs(jgrads[name]).max()
            assert np.abs(got - jgrads[name]).max() <= 1e-4 * scale, name
            np.testing.assert_array_equal(got, port[0]["grads"][name])
    assert max(np.abs(g).max() for g in grads.values()) > 0
    for k, v in state.items():  # the running statistics are left alone
        np.testing.assert_array_equal(port[0]["state_after"][k], v.numpy(), err_msg=k)


def test_point_sharded_edge_conv(runs):
    port = runs[1]
    x, idx, w = _conv_inputs()
    nbr = x[idx]
    self_f = x[:, None, :]
    feat = np.concatenate([nbr - self_f, np.broadcast_to(self_f, nbr.shape)], axis=-1)
    want = np.maximum(feat @ w, 0.0).max(1)
    got = np.concatenate([port[0]["conv"], port[1]["conv"]])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
