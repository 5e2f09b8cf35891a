"""Port stage-1 training (SegGroupGNN mode="train",
cli/stage1_train.train_step, solvers.make_optimizer) against the flax
SegGroupGNN under jax.value_and_grad of parallel/dp.py's loss and optax's
parallel/dp.py:make_optimizer chains, on the CPU at shared weights
(models.convert.params_from_flax) with the BatchNorm running statistics
randomised as in tests/test_torch_stage1.py.

Configuration: the composed-oracle scene (N=2,048, S=64, E=256, seeds 0
and 1) with cluster_cap = knn_window = N. flax's dropout draw cannot be
reproduced, so one keep mask per seed is injected on both sides: the port
takes it as `dropout_keep`, the JAX side through an interceptor on
nn.Dropout.__call__ (the JAX package is not changed).

At float32: integer outputs exactly equal, loss within 1e-5 relative,
every gradient tensor within 1e-4 of its max|JAX|, new running statistics
within rtol = atol = 1e-5. Worst measured here (seeds 0, 1): loss 1.9e-7
relative, gradients 8.2e-6 of max|g|, statistics 1.1e-6. One SGD step of
train_step lands within 4.9e-6 of max|p| of optax's (bound 1e-4); three
SGD and three Adam steps fed JAX's gradients within 1.2e-7 (bound 1e-6).

At the default bf16 edge-conv intermediates: integer outputs exactly equal
on both seeds. The two frameworks round the bf16 products and the float32
BatchNorm output to bf16 at the same places but sum in other orders, so
the gradients differ a little: the port's bf16 gradients are held within
the JAX package's own bf16-to-float32 spread (relative L2 norm over all
gradients). Measured here: JAX's spread 0.0757 and 0.0781 (seeds 0, 1),
the port against JAX at bf16 9.8e-5 and 9.4e-6.

The trouble spots of autograd against jax.grad: LeakyReLU's gradient at 0
(flax: 1), ties in a segment max (shared evenly), and the similarity
matrix's scatter-set on the edge sets normalize_edges produces, invalid
edges among them (the port's index_put gives every duplicate the cell's
gradient, JAX only the winner: the duplicates must carry no gradient)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seggroup_tpu.data.synthetic import make_synthetic_scene as jax_scene
from seggroup_tpu.models import seggroup as J
from seggroup_tpu.ops import grouping as JG
from seggroup_tpu.ops import segment_ops as JS
from seggroup_tpu.parallel.dp import make_optimizer as jax_make_optimizer
from seggroup_tpu_torch.cli.stage1_train import train_step
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import seggroup as T
from seggroup_tpu_torch.models.convert import params_from_flax
from seggroup_tpu_torch.ops import grouping as TG
from seggroup_tpu_torch.ops import segment_ops as TS
from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

torch.set_num_threads(1)

N, S, E = 2048, 64, 256
SCENE = dict(num_points=N, num_slots=S, num_edges=E, num_instances=6,
             segs_per_instance=6)
MODEL = dict(cluster_cap=N, knn_window=N)
SEEDS = (0, 1)
I_MAX, HIDDEN = 128, 128  # the classifier's instances and hidden units
INT_FIELDS = ("layer_roots", "final_root", "final_sem", "final_ins", "sem_layer2",
              "ins_layer2", "max_segment_size", "max_cluster_size", "layer_sem", "layer_ins")
LR = 0.001  # the driver's default


def _randomize_stats(stats, rng):
    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, stats)


def _keep_mask(seed):
    return np.random.default_rng(100 + seed).random((I_MAX, HIDDEN)) < 0.5


def _jax_train_fn(model):
    """jitted (variables, scene, keep) -> (loss, Stage1Output, new batch
    stats, grads) of dp.py's local loss, with `keep` as the dropout mask."""

    def run(variables, scene, keep):
        def dropout(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                return args[0] * keep / 0.5
            return next_fun(*args, **kwargs)

        def loss_fn(params):
            with fnn.intercept_methods(dropout):
                out, mut = model.apply(
                    {"params": params, "batch_stats": variables["batch_stats"]},
                    scene, mode="train", train=True, mutable=["batch_stats"])
            return out.loss_sum / jnp.maximum(out.loss_count, 1.0), (out, mut["batch_stats"])

        (loss, (out, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        return loss, out, stats, grads

    return jax.jit(run)


@pytest.fixture(scope="module")
def shared():
    """JAX variables (train-mode init, randomised statistics) and, per
    (dtype, seed), the JAX step's results as numpy trees."""
    jm32 = J.SegGroupGNN(compute_dtype=jnp.float32, **MODEL)
    variables = jax.jit(lambda r1, r2, sc: jm32.init(
        {"params": r1, "dropout": r2}, sc, mode="train", train=True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jax_scene(seed=0, **SCENE))
    variables = jax.tree.map(np.asarray, variables)
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"],
                                                np.random.default_rng(7))
    results = {}
    for dtype, jm in (("f32", jm32),
                      ("bf16", J.SegGroupGNN(compute_dtype=jnp.bfloat16, **MODEL))):
        fn = _jax_train_fn(jm)
        for seed in SEEDS:
            loss, out, stats, grads = fn(variables, jax_scene(seed=seed, **SCENE),
                                         jnp.asarray(_keep_mask(seed)))
            results[dtype, seed] = jax.tree.map(np.asarray, dict(
                loss=loss, out=out, stats=stats, grads=grads))
    return variables, results


def _port_model(variables, dtype):
    model = T.SegGroupGNN(compute_dtype=dtype, device="cpu", **MODEL)
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


def _port_forward(variables, dtype, seed):
    """A fresh port model at the shared weights after the train forward
    and backward of dp.py's loss on `seed`'s scene with its keep mask;
    (model, outputs, loss)."""
    model = _port_model(variables, dtype)
    scene = make_synthetic_scene(seed=seed, **SCENE).to("cpu")
    out = model(scene, mode="train", dropout_keep=torch.from_numpy(_keep_mask(seed)))
    loss = out.loss_sum / torch.clamp(out.loss_count, min=1.0)
    loss.backward()
    return model, out, loss.detach()


def _jax_state(want):
    """JAX's gradients and new running statistics under the port's
    state-dict keys."""
    return params_from_flax({"params": want["grads"], "batch_stats": want["stats"]})


def _rel_l2(got: dict, want: dict) -> float:
    diff = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (diff / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port_runs(shared):
    variables, _ = shared
    return {(dtype, seed): _port_forward(variables, tdtype, seed)
            for dtype, tdtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
            for seed in SEEDS}


def _outputs_equal(got, want):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    for name in ("iou_sem", "iou_ins", "acc", "loss_count"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(), getattr(want, name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_forward_matches_jax(seed, shared, port_runs):
    """At float32 with the injected mask, to the bounds of the module
    docstring: outputs, loss, every gradient, the new running statistics."""
    _, results = shared
    want = results["f32", seed]
    model, out, loss = port_runs["f32", seed]
    _outputs_equal(out, want["out"])
    assert float(want["out"].loss_count) > 0
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    ref = _jax_state(want)
    grads = _grads(model)
    buffers = dict(model.named_buffers())
    assert set(grads) | set(buffers) == set(ref) and not set(grads) & set(buffers)
    for key, g in grads.items():
        r = ref[key].numpy()
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()), (key, err, float(np.abs(r).max()))
    for key, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_train_forward_matches_jax(seed, shared, port_runs):
    """At the default bf16: integer outputs exactly equal, the gradients
    within the JAX package's own bf16-to-float32 spread."""
    _, results = shared
    want = results["bf16", seed]
    model, out, loss = port_runs["bf16", seed]
    _outputs_equal(out, want["out"])
    spread = _rel_l2({k: v for k, v in _jax_state(want).items() if k in _grads(model)},
                     {k: v for k, v in _jax_state(results["f32", seed]).items()
                      if k in _grads(model)})
    ref = {k: v for k, v in _jax_state(want).items() if k in _grads(model)}
    assert _rel_l2(_grads(model), ref) <= spread, (_rel_l2(_grads(model), ref), spread)
    assert abs(float(loss) - float(want["loss"])) <= 1e-3 * abs(float(want["loss"]))


def test_train_step_matches_jax_and_optax(shared):
    """cli/stage1_train.train_step: one SGD step (100 x the driver's lr, as
    dp.make_optimizer) from the shared weights lands where optax's chain
    takes JAX's parameters with JAX's gradients, within 1e-4 of each
    tensor's max|p|; the running statistics moved as JAX's."""
    variables, results = shared
    want = results["f32", 0]
    model = _port_model(variables, torch.float32)
    optimizer, _ = make_optimizer("SGD", model.parameters(),
                                  make_schedule("constant", LR * 100))
    loss, metrics = train_step(model, optimizer, make_synthetic_scene(seed=0, **SCENE).to("cpu"),
                               dropout_keep=torch.from_numpy(_keep_mask(0)))
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    for name in ("iou_sem", "iou_ins", "acc", "max_segment_size", "max_cluster_size"):
        np.testing.assert_allclose(metrics[name].numpy(), getattr(want["out"], name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    opt = jax_make_optimizer("sgd", lr=LR)
    params = variables["params"]
    updates, _ = opt.update(want["grads"], opt.init(params), params)
    after = params_from_flax({"params": optax.apply_updates(params, updates),
                              "batch_stats": want["stats"]})
    for key, p in model.named_parameters():
        r = after[key].numpy()
        err = float(np.abs(p.detach().numpy() - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()), (key, err)
    for key, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), after[key].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_steps_match_optax(name, shared):
    """Three steps of solvers.make_optimizer as the driver builds it,
    against dp.make_optimizer's optax chain, both fed JAX's gradients of
    the seeds' steps: parameters within 1e-6."""
    variables, results = shared
    grad_seq = [results["f32", s]["grads"] for s in (0, 1, 0)]
    opt = jax_make_optimizer(name, lr=LR)
    params = variables["params"]
    state = opt.init(params)
    for g in grad_seq:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = params_from_flax({"params": params, "batch_stats": variables["batch_stats"]})

    model = _port_model(variables, torch.float32)
    lr = LR * 100 if name == "sgd" else LR
    optimizer, _ = make_optimizer({"sgd": "SGD", "adam": "Adam"}[name], model.parameters(),
                                  make_schedule("constant", lr))
    named = dict(model.named_parameters())
    for g in grad_seq:
        for key, t in params_from_flax({"params": g, "batch_stats": variables["batch_stats"]}
                                       ).items():
            if key in named:
                named[key].grad = t.clone()
        optimizer.step()
    moved = 0.0
    for key, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
        moved = max(moved, float((p.detach() - params_from_flax(variables)[key]).abs().max()))
    assert moved > 1e-4  # the steps did move the weights


# ---------------------------------------------------------------------------
# the places where autograd and jax.grad could part
# ---------------------------------------------------------------------------


def test_leaky_gradient_at_zero_matches_flax():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0], np.float32)
    w = np.arange(1, 7, dtype=np.float32)
    want_y = np.asarray(J._leaky(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(J._leaky(v) * w))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    y = T._leaky(t)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(t.grad.numpy(), want_g)
    np.testing.assert_array_equal(want_g[1:3], w[1:3])  # slope 1 at exactly 0


def test_segment_max_ties_share_the_gradient():
    """[1, 3, 3, 2] in one segment: the tied maxima share the gradient."""
    data = torch.tensor([[1.0], [3.0], [3.0], [2.0]], requires_grad=True)
    TS.segment_max(data, torch.zeros(4, dtype=torch.int32), 1).sum().backward()
    np.testing.assert_array_equal(data.grad[:, 0].numpy(), [0, 0.5, 0.5, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max_gradient_matches_jax(dtype):
    """Coarse values (many ties within a segment), ids out of range (padding)
    and empty segments; the cotangent drawn at random."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 4, (300, 8)).astype(np.float32)
    ids = rng.integers(-1, 14, 300).astype(np.int32)  # 12 segments: 12, 13 pad
    cot = rng.normal(size=(12, 8)).astype(np.float32)
    jd = jnp.asarray(data, dtype=dtype)
    want_y, vjp = jax.vjp(lambda d: JS.segment_max(d, jnp.asarray(ids), 12), jd)
    (want_g,) = vjp(jnp.asarray(cot, dtype=dtype))
    td = torch.tensor(data, dtype=getattr(torch, dtype), requires_grad=True)
    y = TS.segment_max(td, torch.from_numpy(ids), 12)
    y.backward(torch.tensor(cot, dtype=getattr(torch, dtype)))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(want_y, np.float32))
    # the same tied elements share the same share: zeros exactly where
    # JAX's, each share within one rounding (a division by the tie count
    # against a product with its reciprocal)
    got_g, want_g = td.grad.float().numpy(), np.asarray(want_g, np.float32)
    np.testing.assert_array_equal(got_g == 0, want_g == 0)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-2 if dtype == "bfloat16" else 1e-6,
                               atol=0)


def _merged_graph_edges(scene, lib, grouping):
    """The scene's graph with each odd slot merged into the slot before it,
    and the edges normalize_edges makes of the scene's edges there (dedup
    and self-edges leave invalid slots among them)."""
    def arr(x):
        return lib.asarray(np.array(x))

    g = grouping.init_graph(arr(scene.point2seg), arr(scene.weak_ins), arr(scene.weak_sem), S)
    root = np.arange(S, dtype=np.int32)
    root[1::2] -= 1
    g = g._replace(root=arr(root))
    return (g,) + tuple(grouping.normalize_edges(g, arr(scene.edges), arr(scene.edge_valid)))


def test_similarity_matrix_gradient_matches_jax():
    """edge_similarities into build_similarity_matrix, whose scatter-set
    sends every invalid edge to cell (0, 0): the matrix and the feature
    gradient equal jax.grad's, on normalize_edges' own output."""
    scene = jax_scene(seed=0, **SCENE)
    jg, jedges, jev = _merged_graph_edges(scene, jnp, JG)
    tg, tedges, tev = _merged_graph_edges(scene, torch, TG)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    # duplicates stay invalid between valid edges, and every one sends its
    # value to cell (0, 0)
    last = int(torch.nonzero(tev)[-1])
    assert int((~tev[:last]).sum()) > 0
    rng = np.random.default_rng(2)
    feat = (rng.normal(size=(S, 32)) * 0.3).astype(np.float32)
    cot = rng.normal(size=(S, S)).astype(np.float32)

    def jax_m(f):
        sims = JG.edge_similarities(f, jg, jedges, alpha=0.125)
        return JG.build_similarity_matrix(sims, jedges, jev, S)

    want_m, vjp = jax.vjp(jax_m, jnp.asarray(feat))
    (want_g,) = vjp(jnp.asarray(cot))
    tf = torch.tensor(feat, requires_grad=True)
    m = TG.build_similarity_matrix(TG.edge_similarities(tf, tg, tedges, alpha=0.125),
                                   tedges, tev, S)
    m.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(want_m), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    assert float(np.abs(np.asarray(want_g)).max()) > 0


@pytest.mark.parametrize("masked", ["partial", "none"])
def test_masked_batchnorm_train_matches_flax(masked):
    """MaskedBatchNorm with batch statistics: output, gradients of the input,
    scale and bias, and the new running statistics, within 1e-5."""
    rng = np.random.default_rng(8)
    x = rng.normal(1.0, 2.0, size=(300, 20, 64)).astype(np.float32)
    mask = np.broadcast_to((rng.random(300) < 0.8)[:, None], (300, 20))
    if masked == "none":
        mask = np.zeros_like(mask)  # count clamped to 1
    cot = rng.normal(size=x.shape).astype(np.float32)
    p = {k: rng.normal(size=64).astype(np.float32) for k in ("scale", "bias", "mean")}
    p["var"] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bn = J.MaskedBatchNorm()

    def jax_fn(xx, scale, bias):
        return bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": p["mean"], "var": p["var"]}},
                        xx, jnp.asarray(mask), True, mutable=["batch_stats"])

    want_y, vjp, want_stats = jax.vjp(jax_fn, jnp.asarray(x), p["scale"], p["bias"],
                                      has_aux=True)
    want_stats = want_stats["batch_stats"]
    want_g = vjp(jnp.asarray(cot))

    tbn = T.MaskedBatchNorm(64)
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    tx = torch.tensor(x, requires_grad=True)
    y = tbn(tx, torch.from_numpy(mask.copy()), train=True)
    y.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    for got, want, name in ((tx.grad, want_g[0], "x"), (tbn.scale.grad, want_g[1], "scale"),
                            (tbn.bias.grad, want_g[2], "bias")):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, name).numpy(), np.asarray(want_stats[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_port_dropout_keeps_half_and_scales_by_two():
    """The port's own dropout: a draw from the generator keeps about half of
    the units, the kept ones doubled; the same draw as an injected mask
    gives the same output."""
    clf = T.Classifier()
    x = torch.randn(I_MAX, 256, generator=torch.Generator().manual_seed(0))
    valid = torch.arange(I_MAX) < 100
    keep = torch.rand((I_MAX, HIDDEN), generator=torch.Generator().manual_seed(5)) < 0.5
    assert abs(float(keep.float().mean()) - 0.5) < 0.02  # 16,384 draws: 5 sd
    with torch.no_grad():
        h = T._leaky(clf.bn1(clf.linear1(x), valid, True))
        want = clf.linear2(torch.where(keep, 2.0 * h, 0.0))
        drawn = clf(x, valid, True, generator=torch.Generator().manual_seed(5))
        injected = clf(x, valid, True, dropout_keep=keep)
        inference = clf(x, valid)
    torch.testing.assert_close(drawn, want, rtol=0, atol=0)
    torch.testing.assert_close(injected, want, rtol=0, atol=0)
    assert not torch.equal(inference, want)


def test_inference_modes_build_no_graph_and_keep_statistics():
    """ins_infer and sem_infer run without autograd and leave the running
    statistics; train builds the graph even under an outer no_grad."""
    small = dict(num_points=1024, num_slots=32, num_edges=64, num_instances=4,
                 segs_per_instance=4)
    model = T.SegGroupGNN(cluster_cap=1024, knn_window=1024, device="cpu", seed=1)
    scene = make_synthetic_scene(seed=2, **small).to("cpu")
    stats = {k: v.clone() for k, v in model.named_buffers()}
    for mode in ("ins_infer", "sem_infer"):
        out = model(scene, mode=mode)
        assert not out.loss_sum.requires_grad and float(out.loss_count) == 0
    assert all(torch.equal(v, stats[k]) for k, v in model.named_buffers())
    with torch.no_grad():
        out = model(scene, mode="train", generator=torch.Generator().manual_seed(0))
    assert out.loss_sum.requires_grad and float(out.loss_count) > 0
    assert all(not torch.equal(v, stats[k]) for k, v in model.named_buffers())
