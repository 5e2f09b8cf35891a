"""The port's stage-1 data-parallel steps (seggroup_tpu_torch.parallel.dp
`build_stage1_train_step`, `build_stage1_infer_step`) on 2 gloo ranks
against the JAX package's builders on a 2-device CPU mesh (make_mesh(2)).

One spawn of 2 ranks (the port's `launch`, a file rendezvous, one thread
a rank, a 60 s collective timeout) runs both steps; rank d holds scene d.
The scenes are the N = 1,024 synthetic ones of seeds 3 and 4 (S = 32),
the convs at float32, cluster_cap = knn_window = N, the running
statistics randomised as in tests/test_torch_stage1_train.py.

Inference: every integer output of rank d equals row d of the JAX step's
stacked outputs exactly.

Training: two steps of the drivers' SGD (100 x lr, momentum 0.9, weight
decay 1e-4). JAX folds the rank into the dropout key inside its
`shard_map`; the same keep mask a shard is injected on both sides, on the
JAX side by a flax interceptor on nn.Dropout that picks the mask of
`jax.lax.axis_index("data")` while the step is traced. Held at the
single-card parity tolerances (tests/test_torch_stage1_train.py): each
parameter's change within 1e-4 of its largest, the running statistics
within rtol = atol = 1e-5, the summed loss within 1e-5 relative and the
summed IoU counts and accuracies equal to 1e-6. The ranks' parameters and
statistics are equal bit for bit."""

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seggroup_tpu.data.synthetic import make_synthetic_scene as jax_scene
from seggroup_tpu.models import seggroup as J
from seggroup_tpu.parallel.dp import (build_stage1_infer_step, build_stage1_train_step,
                                      make_mesh, make_optimizer, replicate, shard_batch)
from seggroup_tpu.types import Scene as JScene
from seggroup_tpu_torch.models.convert import params_from_flax
from seggroup_tpu_torch.parallel.dp import launch

import _torch_parallel_ranks as ranks

N, S = 1024, 32
SCENE = dict(num_points=N, num_slots=S, num_edges=128, num_instances=4, segs_per_instance=4)
MODEL = dict(cluster_cap=N, knn_window=N)
SEEDS = (3, 4)
LR = 0.001
INT_FIELDS = ("final_sem", "final_ins", "final_root", "layer_roots", "max_cluster_size")


def _randomize_stats(stats, rng):
    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, stats)


def _keeps():
    return [np.random.default_rng(200 + d).random((128, 128)) < 0.5 for d in range(2)]


@pytest.fixture(scope="module")
def runs():
    model = J.SegGroupGNN(compute_dtype=jnp.float32, **MODEL)
    scenes = [jax_scene(seed=s, **SCENE) for s in SEEDS]
    variables = jax.jit(lambda r1, r2, sc: model.init(
        {"params": r1, "dropout": r2}, sc, mode="train", train=True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), scenes[0])
    variables = jax.tree.map(np.asarray, variables)
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"],
                                                np.random.default_rng(7))
    state = params_from_flax(variables)
    pool = ThreadPoolExecutor(1)  # the ranks run while JAX compiles
    port = pool.submit(launch, ranks.stage1, 2, "cpu", state, SCENE, SEEDS, _keeps(), MODEL,
                       LR, timeout=timedelta(seconds=60), threads=1, all_ranks=True)

    mesh = make_mesh(2)
    batch = shard_batch(mesh, JScene(*(jnp.stack(x) for x in zip(*scenes))))
    infer = build_stage1_infer_step(model, mesh, "ins_infer")(
        replicate(mesh, {k: variables[k] for k in ("params", "batch_stats")}), batch)

    keep_all = jnp.asarray(np.stack(_keeps()))

    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            return args[0] * keep_all[jax.lax.axis_index("data")] / 0.5
        return next_fun(*args, **kwargs)

    opt = make_optimizer("sgd", lr=LR)
    step = build_stage1_train_step(model, opt, mesh)
    params, stats = replicate(mesh, variables["params"]), replicate(mesh, variables["batch_stats"])
    opt_state = replicate(mesh, opt.init(variables["params"]))
    metrics = []
    with fnn.intercept_methods(dropout):
        for k in range(2):
            params, opt_state, stats, m = step(params, opt_state, stats, batch,
                                               jax.random.PRNGKey(k))
            metrics.append(jax.tree.map(np.asarray, m))
    after = params_from_flax(jax.tree.map(np.asarray, {"params": params,
                                                       "batch_stats": stats}))
    port = port.result()
    pool.shutdown()
    return state, [ranks.as_numpy(r) for r in port], jax.tree.map(np.asarray, infer), \
        ranks.as_numpy(after), metrics


def test_infer_step_matches_jax(runs):
    _, port, infer, _, _ = runs
    for d in range(2):
        for k in INT_FIELDS:
            np.testing.assert_array_equal(port[d]["infer"][k], getattr(infer, k)[d], err_msg=k)


def test_ranks_stay_equal_bit_for_bit(runs):
    _, port, _, _, _ = runs
    for k, v in port[0]["state"].items():
        np.testing.assert_array_equal(port[1]["state"][k], v, err_msg=k)
    for a, b in zip(port[0]["metrics"], port[1]["metrics"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_step_matches_jax(runs):
    state, port, _, after, metrics = runs
    got = port[0]["state"]
    for k, init in state.items():
        init = init.numpy()
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[k], after[k], rtol=1e-5, atol=1e-5, err_msg=k)
            continue
        want = after[k] - init
        scale = max(np.abs(want).max(), 1e-8)
        assert np.abs((got[k] - init) - want).max() <= 1e-4 * scale, k
    for m_port, m_jax in zip(port[0]["metrics"], metrics):
        np.testing.assert_allclose(m_port["loss"], m_jax["loss"], rtol=1e-5)
        for k in ("iou_sem", "iou_ins", "acc"):
            np.testing.assert_allclose(m_port[k], m_jax[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert metrics[0]["loss"] > 0 and metrics[1]["loss"] != metrics[0]["loss"]
