"""Port stage-1 model (seggroup_tpu_torch.models) against the JAX SegGroupGNN
on the CPU, at shared weights converted by models.convert.params_from_flax.

Parity configuration: the composed-oracle scene (N=2048, S=64, E=256, seeds
0 and 1, tests/test_stage1_composed_oracle.py) with cluster_cap = knn_window
= N and compute_dtype float32, BatchNorm running statistics randomized so
the converter's mean/var mapping is exercised. Integer outputs must be
exactly equal; float outputs of the forward agree to 1e-6. Layers and
cluster clouds agree to 1e-5: matmuls and the mean over a cloud's 64 points
sum in another order, and the clouds' scaling by their extent magnifies
that."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.data.synthetic import make_synthetic_scene as jax_scene
from seggroup_tpu.models import seggroup as J
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.infer import entry, infer_scenes
from seggroup_tpu_torch.models import seggroup as T
from seggroup_tpu_torch.models.convert import params_from_flax
from seggroup_tpu_torch.ops import grouping as gr

torch.set_num_threads(1)

N, S, E = 2048, 64, 256
SCENE = dict(num_points=N, num_slots=S, num_edges=E, num_instances=6,
             segs_per_instance=6)
MODEL = dict(cluster_cap=N, knn_window=N)


def _randomize_stats(stats, rng):
    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, stats)


@pytest.fixture(scope="module")
def jax_model():
    model = J.SegGroupGNN(compute_dtype=jnp.float32, **MODEL)
    # train-mode init (so the classifier exists), jitted: eager init runs
    # the whole training forward op by op
    variables = jax.jit(lambda r1, r2, sc: model.init(
        {"params": r1, "dropout": r2}, sc, mode="train", train=True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jax_scene(seed=0, **SCENE))
    variables = jax.tree.map(np.asarray, variables)
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"],
                                                np.random.default_rng(7))
    return model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = T.SegGroupGNN(compute_dtype=torch.float32, device="cpu", **MODEL)
    model.load_state_dict(params_from_flax(jax_model[1]), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_outputs(jax_model):
    model, variables = jax_model
    fwd = {mode: jax.jit(lambda v, sc, mode=mode: model.apply(v, sc, mode=mode, train=False))
           for mode in ("ins_infer", "sem_infer")}
    out = {}
    for seed in (0, 1):
        scene = jax_scene(seed=seed, **SCENE)
        for mode, f in fwd.items():
            out[seed, mode] = jax.tree.map(np.asarray, f(variables, scene))
    return out


def test_params_from_flax(jax_model, port_model):
    _, variables = jax_model
    n_jax = sum(x.size for x in jax.tree.leaves(variables["params"]))
    n_port = sum(p.numel() for p in port_model.parameters())
    assert n_port == n_jax
    # Dense (in, out) -> Linear (out, in); BN statistics land in the buffers
    np.testing.assert_array_equal(port_model.mlp_3.conv2.weight.detach().numpy(),
                                  variables["params"]["mlp_3"]["conv2"]["kernel"].T)
    np.testing.assert_array_equal(port_model.classifier.bn1.var.numpy(),
                                  variables["batch_stats"]["classifier"]["bn1"]["var"])
    # a tree initialised in an inference mode has no classifier
    trimmed = {"params": {k: v for k, v in variables["params"].items() if k != "classifier"},
               "batch_stats": {k: v for k, v in variables["batch_stats"].items()
                               if k != "classifier"}}
    fresh = T.SegGroupGNN(device="cpu", **MODEL)
    missing, unexpected = fresh.load_state_dict(params_from_flax(trimmed), strict=False)
    assert not unexpected and all(k.startswith("classifier.") for k in missing)


def _sub(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


def test_layers_match_jax(jax_model, port_model):
    _, v = jax_model
    rng = np.random.default_rng(3)
    clouds = rng.normal(size=(8, 64, 6)).astype(np.float32)
    clouds[:, 32:] = clouds[:, :32]  # tiled members
    slot_valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    want = J.MLP1().apply(_sub(v, "mlp_1"), jnp.asarray(clouds), jnp.asarray(slot_valid), False)
    got = port_model.mlp_1(torch.from_numpy(clouds), torch.from_numpy(slot_valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    x = rng.normal(size=(300, 9)).astype(np.float32)
    idx = rng.integers(0, 300, (300, 20)).astype(np.int32)
    pv = rng.random(300) < 0.9
    for name, layers in (("mlp_2", 1), ("mlp_3", 2)):
        want = J.EdgeConvBlock(layers=layers, dtype=jnp.float32).apply(
            _sub(v, name), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(pv), False)
        got = getattr(port_model, name)(torch.from_numpy(x), torch.from_numpy(idx),
                                        torch.from_numpy(pv))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)

    feat = rng.normal(size=(S, 192)).astype(np.float32)
    m = np.eye(S, dtype=np.float32) + (rng.random((S, S)) < 0.1) * rng.random((S, S))
    m = ((m + m.T) / 2).astype(np.float32)
    want = J.GCN(192).apply({"params": v["params"]["gcn_2"]}, jnp.asarray(feat), jnp.asarray(m))
    got = port_model.gcn_2(torch.from_numpy(feat), torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [128, N])
def test_cluster_pointclouds_matches_jax(cap):
    """cap=128 is below the largest clusters: FPS gets the strided subsample."""
    scene = make_synthetic_scene(seed=0, **SCENE)
    roots = scene.point2seg.copy()
    roots[roots % 6 == 1] -= 1  # merged clusters of ~110 points
    roots[:30] = S              # padding points
    want_c, want_v = jax.jit(J.cluster_pointclouds, static_argnums=(2, 3, 4))(
        jnp.asarray(scene.points), jnp.asarray(roots), S, 64, cap)
    got_c, got_v = T.cluster_pointclouds(torch.from_numpy(scene.points),
                                         torch.from_numpy(roots), S, 64, cap)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["ins_infer", "sem_infer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed, mode, port_model, jax_outputs):
    want = jax_outputs[seed, mode]
    got = port_model(make_synthetic_scene(seed=seed, **SCENE).to("cpu"), mode=mode)
    for name in J.Stage1Output._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_bf16_default_runs():
    """The default compute dtype (bf16 edge-conv intermediates) is checked
    for running, shapes and label ranges only."""
    model = T.SegGroupGNN(cluster_cap=256, device="cpu", seed=3)
    scene = make_synthetic_scene(seed=2, **SCENE)
    out = model(scene.to("cpu"), mode="ins_infer")
    valid = scene.point2seg < S
    assert tuple(out.layer_roots.shape) == (4, N)
    assert (out.final_ins.numpy()[valid] > 0).all()
    sem = out.final_sem.numpy()[valid]
    assert ((sem >= 1) & (sem <= 40)).all()
    assert out.sem_layer2.max() <= 40
    assert torch.isfinite(out.acc).all() and torch.isfinite(out.iou_sem).all()


@pytest.fixture(scope="module")
def bf16_models(jax_model):
    """The default compute dtype on both sides, bf16 edge-conv
    intermediates, at the shared weights and randomised statistics."""
    _, variables = jax_model
    jm = J.SegGroupGNN(compute_dtype=jnp.bfloat16, **MODEL)
    tm = T.SegGroupGNN(compute_dtype=torch.bfloat16, device="cpu", **MODEL)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("mode", ["ins_infer", "sem_infer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_matches_jax(seed, mode, bf16_models):
    """At bf16 the port's forward equals the jitted JAX forward: every
    integer output exactly (roots, labels, exports), the float outputs
    (metrics over those labels) within 1e-6 as at float32."""
    jm, variables, tm = bf16_models
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, sc: jm.apply(v, sc, mode=mode, train=False))(
            variables, jax_scene(seed=seed, **SCENE)))
    got = tm(make_synthetic_scene(seed=seed, **SCENE).to("cpu"), mode=mode)
    for name in J.Stage1Output._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |x|."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("name,layers", [("mlp_2", 1), ("mlp_3", 2)])
def test_bf16_edge_conv_layers_within_one_ulp(name, layers, bf16_models):
    """The bf16 edge-conv layers against jitted JAX at the shared weights:
    each output element within one bf16 ulp of its magnitude (the two
    frameworks round the float32 BatchNorm output to bf16 at the same
    places; an element whose float32 value falls near a rounding boundary
    can land one ulp apart)."""
    _, v, tm = bf16_models
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2048, 9)).astype(np.float32)
    idx = rng.integers(0, 2048, (2048, 20)).astype(np.int32)
    pv = rng.random(2048) < 0.9
    want = np.asarray(jax.jit(lambda p, a, b, c: J.EdgeConvBlock(
        layers=layers, dtype=jnp.bfloat16).apply(p, a, b, c, False))(
            _sub(v, name), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(pv)))
    got = getattr(tm, name)(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(pv)).detach().numpy()
    assert got.dtype == want.dtype == np.float32
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all()
    assert (got[~pv] == 0).all()


def test_entry_and_infer_scenes(tmp_path):
    fn, (model, scene) = entry(device="cpu")
    loss, final_sem, iou_sem = fn(model, scene)
    assert float(loss) == 0.0 and tuple(final_sem.shape) == (2048,)
    assert tuple(iou_sem.shape) == (2, 40)
    outs = infer_scenes(model, [scene], mode="sem_infer", results_root=str(tmp_path),
                        names=["scene0000_00"])
    stage = tmp_path / "scene0000_00" / "sem_infer"
    assert len(list(stage.iterdir())) == 15
    lines = (stage / "final.sem.txt").read_text().split()
    np.testing.assert_array_equal(np.array(lines, np.int64), outs[0].final_sem.numpy())


def test_evaluate_labels_matches_jax():
    rng = np.random.default_rng(5)
    n = 3000
    sem_true = rng.integers(0, 41, n).astype(np.int32)
    ins_true = rng.integers(0, 300, n).astype(np.int32)   # ids above 256 too
    sem_pred = np.where(rng.random(n) < 0.7, sem_true, rng.integers(-1, 41, n)).astype(np.int32)
    ins_pred = np.where(rng.random(n) < 0.7, ins_true, rng.integers(-1, 300, n)).astype(np.int32)
    pt_valid = rng.random(n) < 0.9
    args = [sem_pred, ins_pred, sem_true, ins_true, pt_valid]
    want = jax.jit(J.evaluate_labels)(*map(jnp.asarray, args))
    got = T.evaluate_labels(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [dict(shard_axis="points")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        T.SegGroupGNN(device="cpu", **kw)


FAST = dict(sequential=False, fast_knn=True)


@pytest.fixture(scope="module")
def fast_models(jax_model):
    """bench.py's `stage1_fast` configuration (the parallel-rounds grouping
    and the approximate kNN) on both sides, at the shared weights."""
    _, variables = jax_model
    jm = J.SegGroupGNN(compute_dtype=jnp.float32, **MODEL, **FAST)
    tm = T.SegGroupGNN(compute_dtype=torch.float32, device="cpu", **MODEL, **FAST)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("mode", ["ins_infer", "sem_infer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fast_forward_matches_jax(seed, mode, fast_models):
    """At `sequential=False, fast_knn=True` every integer output equals
    the jitted JAX forward's, the float ones within 1e-6."""
    jm, variables, tm = fast_models
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, sc: jm.apply(v, sc, mode=mode, train=False))(
            variables, jax_scene(seed=seed, **SCENE)))
    gr.parallel_rounds = 0
    got = tm(make_synthetic_scene(seed=seed, **SCENE).to("cpu"), mode=mode)
    assert gr.parallel_rounds > 0
    for name in J.Stage1Output._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_fast_train_mode_takes_the_parallel_engine(fast_models):
    """Training goes through the same switch: the train forward groups with
    the parallel-rounds engine, and its loss is finite."""
    tm = copy.deepcopy(fast_models[2])  # training moves the running statistics
    gr.parallel_rounds = 0
    out = tm(make_synthetic_scene(seed=0, **SCENE).to("cpu"), mode="train",
             generator=torch.Generator().manual_seed(0))
    assert gr.parallel_rounds > 0
    assert torch.isfinite(out.loss_sum) and float(out.loss_count) > 0
