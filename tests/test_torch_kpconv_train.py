"""KPConv training in the port (seggroup_tpu_torch.models.kpconv with
train=True, cli.stage2_train_kpconv's step) against the JAX package on the
CPU, with jitted JAX references and numpy inputs from seeds:

  * TFBatchNorm's training branch: the output and the new running
    statistics (0.98 old + 0.02 batch over the valid rows);
  * the deformable v2, modulated v2 and strided v2 layers at nonzero
    `offset_mlp` weights: output, regulariser, deformed kernel points and
    the gradients of a scalar of them against jax.grad;
  * the influence's autograd Functions against autograd of the plain
    float32 expression, and at an exact zero of the influence against
    jax.grad (half of the cotangent passes);
  * KPFCNN's train forward, loss and gradients against
    jax.value_and_grad at float32 on 4 batch elements of 1,024 points,
    with nonzero deformable v1 offsets and with modulated v2 blocks on two
    levels: loss within 1e-5 relative, each gradient within 1e-4 of its
    max, the running statistics within 1e-5; and SCANNET_ARCHITECTURE,
    whose five levels make JAX's own gradients chaotic (the test says how
    far, and holds the port to it);
  * the gradient transform (the offsets' 0.1 scale, the per-tensor clip),
    SGD with momentum 0.98 and ExpLR over 3 steps against optax, given the
    same gradients: within 1e-6 of each tensor's max.

The port's kernel points are the JAX function's (bit-equal,
tests/test_torch_kpconv.py), shared here to spend the numpy optimisation
once."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seggroup_tpu.models import kpconv as J
from seggroup_tpu_torch.cli import stage2_train_kpconv as TR
from seggroup_tpu_torch.models import kpconv as T
from seggroup_tpu_torch.models.convert import kpconv_params_from_flax

torch.set_num_threads(2)

N, DL0, FDIM, C = 1024, 0.04, 16, 20
CAPS = [N // 2, N // 4, N // 8, N // 16]
LOSS_RTOL, GRAD_RTOL, STATS_ATOL = 1e-5, 1e-4, 1e-5
# two levels, every block at hundreds of rows: deformable v1 and v2 stages
SHALLOW = {"v1": ("simple", "resnetb_deformable", "resnetb_deformable_strided",
                  "resnetb_deformable", "nearest_upsample", "unary"),
           "v2": ("simple", "resnetb_deformable_v2", "resnetb_deformable_v2_strided",
                  "resnetb_deformable_v2", "nearest_upsample", "unary")}


@pytest.fixture(scope="module", autouse=True)
def shared_kernel_points():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "kernel_point_positions", J.kernel_point_positions)
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, n=N, n_invalid=100):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * np.array([1.2, 1.2, 0.6])).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    pts[~valid] = 0.0
    return pts, np.zeros(n, np.int32), valid


def _randomize(variables, seed, offset_std=0.05):
    """Nonzero offset weights (v1 kernels and v2 MLPs) and random running
    statistics."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] == "offset_kernel" or "offset_mlp" in keys:
            return (rng.normal(size=x.shape) * offset_std).astype(np.float32)
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if keys[-1] == "mean":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, variables))


def _assert_grads(got: dict, jax_grads, label=""):
    """Each port gradient within GRAD_RTOL of its JAX tensor's max."""
    want = kpconv_params_from_flax({"params": jax_grads})
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        w = w.numpy()
        g = got[name]
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_RTOL * np.abs(w).max() + 1e-12,
                                   err_msg=f"{label} {name}")


@pytest.fixture(scope="module")
def pyramids():
    pts, bids, valid = _cloud(0)
    jl = jax.jit(lambda p, b, v: J.build_pyramid(p, b, v, 5, DL0, level_caps=CAPS))(
        jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(valid))
    tl = T.build_pyramid(_t(pts), _t(bids), _t(valid), 5, DL0, level_caps=CAPS)
    return jl, tl


@pytest.mark.parametrize("n_valid", [N - 100, 0])
def test_tf_batchnorm_train_matches_jax(n_valid):
    rng = np.random.default_rng(11)
    x = rng.normal(1.0, 2.0, size=(N, 8)).astype(np.float32)
    valid = np.arange(N) < n_valid
    bn = J.TFBatchNorm()
    v = jax.jit(lambda x, m: bn.init(jax.random.PRNGKey(0), x, m, True))(x, valid)
    v = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.3 + 1).astype(np.float32), v)
    out, mut = jax.jit(lambda v, x, m: bn.apply(v, x, m, True, mutable=["batch_stats"]))(
        v, x, valid)
    tbn = T.TFBatchNorm(8)
    tbn.load_state_dict(kpconv_params_from_flax(v))
    got = tbn(_t(x), _t(valid), True)
    out = np.asarray(out)
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=0,
                               atol=1e-5 * np.abs(out).max())
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, name).numpy(),
                                   np.asarray(mut["batch_stats"][name]), rtol=1e-6, atol=1e-7)
    if n_valid == 0:  # no valid row: batch statistics 0, count clamped to 1
        np.testing.assert_allclose(tbn.mean.numpy(), 0.98 * v["batch_stats"]["mean"],
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["v2", "modulated", "strided_v2"])
def test_v2_layers_match_jax(kind, pyramids):
    """Output, regulariser, deformed points and the gradients of sum(out *
    r) + reg (every parameter and the input features) against jax.grad."""
    jl, tl = pyramids
    strided = kind == "strided_v2"
    modulated = kind == "modulated"
    rng = np.random.default_rng(12)
    feats = rng.normal(size=(N, 8)).astype(np.float32)
    a, b = (jl[0], jl[1]) if strided else (jl[0], jl[0])
    nbrs = a.pools if strided else a.neighbors
    r = rng.normal(size=(b.points.shape[0], 12)).astype(np.float32)
    layer = J.KPConvLayer(12, deformable_v2=True, modulated=modulated)
    v = jax.jit(lambda r_, f: layer.init(r_, b.points, a.points, nbrs, f, DL0))(
        jax.random.PRNGKey(3), jnp.asarray(feats))
    v = _randomize(v, 13, offset_std=0.1)
    assert float(np.abs(v["params"]["offset_mlp"]["kernel"]).max()) > 0

    def scalar(params, f):
        (out, reg), mut = layer.apply({"params": params}, b.points, a.points, nbrs, f, DL0,
                                      mutable=["intermediates"])
        return jnp.sum(out * r) + reg, (out, reg, mut["intermediates"]["deformed_kp"][0])

    (_, (out, reg, kp)), (g_params, g_feats) = jax.jit(
        jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True))(v["params"],
                                                                  jnp.asarray(feats))
    tlayer = T.KPConvLayer(8, 12, deformable_v2=True, modulated=modulated)
    tlayer.load_state_dict(kpconv_params_from_flax(v), strict=True)
    tb = tl[1] if strided else tl[0]
    tf = _t(feats).requires_grad_(True)
    with T.capture_deformed_kp(tlayer) as captured:
        got, got_reg = tlayer(tb.points, tl[0].points, tl[0].pools if strided else tl[0].neighbors,
                              tf, DL0)
    (got * _t(r)).sum().add(got_reg).backward()
    out = np.asarray(out)
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=0, atol=1e-5 * np.abs(out).max())
    np.testing.assert_allclose(float(got_reg.detach()), float(reg), rtol=1e-5)
    np.testing.assert_allclose(captured["/deformed_kp"].numpy(), np.asarray(kp), rtol=0,
                               atol=1e-6)
    _assert_grads({n: p.grad for n, p in tlayer.named_parameters()}, g_params, kind)
    g_feats = np.asarray(g_feats)
    np.testing.assert_allclose(tf.grad.numpy(), g_feats, rtol=0,
                               atol=GRAD_RTOL * np.abs(g_feats).max())
    assert float(reg) > 0 and np.abs(g_params["offset_mlp"]["kernel"]).max() > 0


@pytest.mark.parametrize("per_query", [False, True])
def test_influence_functions_match_plain_autograd(per_query):
    """The emulated forward with the float32 backward against autograd of
    the plain float32 expression (torch.maximum gives half of a tie to each
    side, as jnp.maximum does): gradients of the neighbours and of the
    kernel points within 1e-5 of their max."""
    rng = np.random.default_rng(14)
    extent = 0.05
    rel = (rng.normal(size=(300, 24, 3)) * 0.06).astype(np.float32)
    kp = (rng.normal(size=(300, 15, 3) if per_query else (15, 3)) * 0.05).astype(np.float32)
    cot = rng.normal(size=(300, 24, 15)).astype(np.float32)

    def grads(fn):
        a, b = _t(rel).requires_grad_(True), _t(kp).requires_grad_(True)
        (fn(a, b) * _t(cot)).sum().backward()
        return a.grad.numpy(), b.grad.numpy()

    def plain(a, b):
        k = b[None, None] if b.ndim == 2 else b[:, None]
        d = a[:, :, None, :] - k
        y = 1.0 - torch.sqrt((d * d).sum(-1) + 1e-12) / extent
        return torch.maximum(y, torch.zeros(()))

    got = grads(lambda a, b: T._linear_influence(T.kernel_sqdist(a, b), extent))
    want = grads(plain)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
        assert np.abs(w).max() > 0


def test_influence_at_an_exact_zero_takes_half_the_cotangent():
    """d2 = 1 and extent 1 make 1 - sqrt(d2 + 1e-12) / extent exactly 0 in
    float32: jax.grad of jnp.maximum(0, .) passes half of the cotangent,
    -0.5 * 0.5 / 1 = -0.25, and so does the port; past the zero no
    gradient, inside it the whole."""
    d2 = np.array([1.0, 1.2, 0.64], np.float32)

    def infl(d):
        return jnp.maximum(0.0, 1.0 - jnp.sqrt(d + 1e-12) / 1.0)

    want = np.asarray(jax.jit(jax.grad(lambda d: jnp.sum(infl(d))))(d2))
    t = _t(d2).requires_grad_(True)
    T._linear_influence(t, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[0] == -0.25 and want[1] == 0.0 and want[2] == np.float32(-0.5 / 0.8)


def _jax_step(model, w=0.1):
    """The JAX driver's loss and value_and_grad (cli/stage2_train_kpconv.py
    `step`), jitted: (loss, new batch stats, grads, accuracy)."""

    def run(variables, pyr, feats, labels):
        def loss_fn(p):
            (logits, regs), mut = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, pyr, feats,
                train=True, mutable=["batch_stats"])
            ok = labels != 255
            lp = jax.nn.log_softmax(logits, -1)
            nll = -jnp.take_along_axis(lp, jnp.clip(labels, 0, C - 1)[:, None], 1)[:, 0]
            ce = jnp.sum(jnp.where(ok, nll, 0.0)) / jnp.maximum(jnp.sum(ok), 1)
            return ce + w * regs, (mut["batch_stats"], logits)

        (loss, (stats, logits)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        acc = jnp.sum((jnp.argmax(logits, -1) == labels) & (labels != 255)) \
            / jnp.maximum(jnp.sum(labels != 255), 1)
        return loss, stats, grads, acc
    return jax.jit(run)


# the whole network's step: 4 batch elements of 1,024 points in a 1 m cube at
# dl0 0.05, so that the coarsest level keeps 28 rows for its batch statistics
STEP_N, STEP_DL0, STEP_BATCHES = 4096, 0.05, 4


def _step_inputs():
    rng = np.random.default_rng(15)
    pts = rng.random((STEP_N, 3)).astype(np.float32)
    bids = (np.arange(STEP_N) * STEP_BATCHES // STEP_N).astype(np.int32)
    valid = np.ones(STEP_N, bool)
    valid[-STEP_N // 10:] = False
    pts[~valid] = 0.0
    feats = np.ones((STEP_N, 4), np.float32)
    feats[:, 1:] = rng.random((STEP_N, 3))
    labels = rng.integers(0, C, STEP_N).astype(np.int32)
    labels[rng.random(STEP_N) < 0.1] = 255
    labels[~valid] = 255
    return pts, bids, valid, feats, labels


def _step_pair(architecture, modulated):
    """(JAX loss, stats, grads, accuracy; JAX's grads with the features moved
    by 1e-7 relative; the port's model after loss.backward(), its loss and
    accuracy) on `_step_inputs` at shared weights."""
    pts, bids, valid, feats, labels = _step_inputs()
    caps = [STEP_N >> i for i in range(1, 5)]
    jl = jax.jit(lambda p, b, v: J.build_pyramid(p, b, v, 5, STEP_DL0, level_caps=caps))(
        jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(valid))
    tl = T.build_pyramid(_t(pts), _t(bids), _t(valid), 5, STEP_DL0, level_caps=caps)
    model = J.KPFCNN(num_classes=C, architecture=architecture, first_features_dim=FDIM,
                     dl0=STEP_DL0, modulated=modulated)
    v = jax.jit(lambda r, py, f: model.init(r, py, f, train=False))(
        jax.random.PRNGKey(0), jl, jnp.asarray(feats))
    v = _randomize(v, 16)
    step = _jax_step(model)
    ref = step(v, jl, jnp.asarray(feats), jnp.asarray(labels))
    moved = feats * (1 + 1e-7 * np.random.default_rng(3).standard_normal(feats.shape)
                     ).astype(np.float32)
    own = step(v, jl, jnp.asarray(moved), jnp.asarray(labels))[2]
    tm = T.KPFCNN(num_classes=C, architecture=architecture, first_features_dim=FDIM,
                  dl0=STEP_DL0, modulated=modulated, device="cpu")
    tm.load_state_dict(kpconv_params_from_flax(v), strict=True)
    logits, regs = tm(tl, _t(feats), train=True)
    loss, acc = TR.kpconv_loss(logits, regs, _t(labels), 0.1)
    loss.backward()
    assert float(regs.detach()) > 0  # the deformable stages moved their kernel points
    return ref, kpconv_params_from_flax({"params": own}), tm, loss, acc


def _assert_loss_and_stats(ref, tm, loss, acc):
    want_loss, stats, _, want_acc = ref
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert float(acc) == pytest.approx(float(want_acc), abs=2 / STEP_N)
    want_stats = kpconv_params_from_flax({"params": {}, "batch_stats": stats})
    for name, w in want_stats.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(), w.numpy(), rtol=0,
                                   atol=STATS_ATOL * max(1.0, float(w.abs().max())),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["v1", "v2"])
def test_kpfcnn_train_step_matches_jax(arch):
    """Two levels of deformable v1, or modulated v2, blocks: the loss
    within 1e-5 relative, each gradient within 1e-4 of its max (measured:
    3e-6), the running statistics within 1e-5."""
    ref, _, tm, loss, acc = _step_pair(SHALLOW[arch], arch == "v2")
    _assert_loss_and_stats(ref, tm, loss, acc)
    _assert_grads({n: p.grad for n, p in tm.named_parameters()}, ref[2], arch)


def test_scannet_kpfcnn_train_step_matches_jax():
    """SCANNET_ARCHITECTURE with nonzero v1 offsets: the loss within 1e-5
    relative and the running statistics within 1e-5. Its gradients are
    chaotic in JAX itself: batch statistics over a few dozen rows at the
    coarse levels amplify rounding, so moving the features by 1e-7
    relative moves JAX's own gradients by up to 2e-4 of a tensor's max
    (measured 1.6e-4). The port's, whose summation orders move every
    operation by a rounding, differ from JAX's by up to 4.4e-3 of a
    tensor's max (measured); each is held within 50 times JAX's largest
    own move and must point the same way (cosine above 0.9999). The
    two-level networks above hold every gradient to 1e-4."""
    ref, own, tm, loss, acc = _step_pair(J.SCANNET_ARCHITECTURE, False)
    _assert_loss_and_stats(ref, tm, loss, acc)
    want = {k: v.numpy().ravel() for k, v in kpconv_params_from_flax({"params": ref[2]}).items()}
    spread = max(np.abs(own[k].numpy().ravel() - w).max() / np.abs(w).max()
                 for k, w in want.items())
    assert spread < 1e-3
    for name, p in tm.named_parameters():
        w, g = want[name], p.grad.numpy().ravel()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= max(GRAD_RTOL, 50 * spread), (name, err, spread)
        cos = float(np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert cos > 0.9999, (name, cos)


def test_grad_transform_and_sgd_match_optax():
    """Three steps of the JAX driver's per_var_grads + optax.sgd(ExpLR,
    momentum 0.98) against transform_grads + make_sgd on the same
    gradients, some large enough to clip, some of offset weights."""
    shapes = {"b1_kp.kernel": (15, 4, 8), "b5.kp.offset_kernel": (15, 8, 45),
              "b6.kp.offset_mlp.weight": (56, 8), "b6.kp.offset_mlp.bias": (56,),
              "b3.conv1.weight": (8, 16), "head_bn.scale": (16,)}
    rng = np.random.default_rng(17)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (rng.normal(size=s) * rng.choice([0.1, 10.0, 80.0])).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    nest = lambda flat: {k: {"v": v} for k, v in flat.items()}  # noqa: E731

    def per_var_grads(grads):
        def per_var(path, g):
            if any("offset_kernel" in str(getattr(k, "key", k))
                   or "offset_mlp" in str(getattr(k, "key", k)) for k in path):
                g = g * 0.1
            norm = jnp.sqrt(jnp.sum(jnp.square(g)) + 1e-12)
            return g * jnp.minimum(1.0, 100.0 / norm)
        return jax.tree_util.tree_map_with_path(per_var, grads)

    schedule = lambda s: 1e-2 * (0.1 ** (1 / 150000)) ** (s / 1)  # noqa: E731
    opt = optax.sgd(schedule, momentum=0.98)
    params = jax.tree.map(jnp.asarray, nest(p0))
    state = opt.init(params)
    module = torch.nn.Module()  # transform_grads reads the offset rule from the names
    tparams = {}
    for k, v in p0.items():
        *path, leaf = k.split(".")
        node = module
        for name in path:
            if not hasattr(node, name):
                node.add_module(name, torch.nn.Module())
            node = getattr(node, name)
        tparams[k] = torch.nn.Parameter(_t(v))
        node.register_parameter(leaf, tparams[k])
    assert {n for n, _ in module.named_parameters()} == set(p0)
    optimizer, scheduler = TR.make_sgd(module, 1e-2)
    clipped = 0
    for g in steps:
        jg = per_var_grads(jax.tree.map(jnp.asarray, nest(g)))
        updates, state = opt.update(jg, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
            clipped += int(np.sqrt((g[k].astype(np.float64) ** 2).sum()) * (
                0.1 if "offset" in k else 1) > 100)
        TR.transform_grads(module, 0.1, 100.0)
        optimizer.step()
        scheduler.step()
        for k, p in tparams.items():
            w = np.asarray(params[k]["v"])
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)
    assert clipped > 0 and scheduler.count == 3

