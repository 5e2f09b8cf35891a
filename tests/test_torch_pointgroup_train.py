"""Port PointGroup training (seggroup_tpu_torch.models.pointgroup with
train=True, pointgroup_loss, cli/stage2_train_pointgroup.train_step and its
Adam) against the flax PointGroup, jax.value_and_grad of
seggroup_tpu.models.pointgroup.pointgroup_loss and optax.adam, on the CPU at
shared weights: tests/test_torch_pointgroup.py's scene (2,048 points in 6
blobs over 2 batch ids, m=8, 8 classes, 32 proposals a source), its
BatchNorm parameters and statistics perturbed so that no layer is the
identity, 4 ground-truth instances, and the same jitter on both sides (the
JAX side's own draw, jax.random.uniform(key, (3,)), injected into the port).
Both modes: the heads alone (the prepare phase) and with the clustering and
the ScoreNet.

At float32 convs (the exact-parity configuration of
tests/test_torch_minkunet_train.py): the integer outputs (proposals, their
validity and count) exactly equal; the heads and the scores within 1e-5 of
their max; the running statistics within 1e-5; the loss within 1e-5
relative; every gradient within 1e-4 of its max (measured here: heads
3.2e-6, scores 4.9e-6, statistics 2.4e-7, loss equal to the last bit,
gradients 1.6e-5). One gradient is exempt from the relative bound:
`offset_dense.bias`, which the training BatchNorm right after it removes,
so that its true value is 0 and both sides give rounding noise (6.3e-8 in
JAX); it is held to 1e-6 absolute. The proposals come from an argmax of
the heads: on this scene the least gap between a valid point's two best
class scores is 2.2e-4 (the test requires 1e-4), 13 times the heads'
largest difference (1.7e-5), so no argmax is near a tie at float32. The
score voxelisation with the jitter is exact because the
port rounds the room and the shift as jitted XLA does (fused
multiply-adds, its two constants folded into one; see PointGroup.cluster).

One train step plus Adam: Adam's first step moves a weight by lr * sign(g)
(|g| far above its eps of 1e-8), so where a gradient is within its error of
0 a last-bit difference flips the step: the parameters are held to 1e-6
where |g| > 1e-4 of the tensor's max gradient, and to 2 * lr elsewhere.
The port's Adam alone, given JAX's gradients, equals optax within 1e-6
everywhere over two steps (the first in the prepare phase, where the
ScoreNet's gradients are zero on both sides).

At the default bf16 convs the two sides round the same operands and sum in
another order, and at this size (a handful of voxels at the coarsest
levels, whose BatchNorm divides by their spread) that is chaotic: the heads
differ by up to 8.5e-2, and 15 valid points take another class, each where
the reference's two best scores lie within twice that (the widest such gap
1.5e-2; the least gap on the scene is 1.2e-5). So at bf16 the step is
pinned at shared proposals: its gradients are held within JAX's own
bf16-to-float32 spread in relative L2 norm over all gradients, measured
beside them (0.41 against 0.94), the loss within 1e-3 relative (5.9e-4)."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seggroup_tpu.models import minkunet as JM
from seggroup_tpu.models import pointgroup as JP
from seggroup_tpu.ops.voxelize import voxel_gather_mean, voxelize
from seggroup_tpu.sparse.tensor import SparseTensor as JSparseTensor
from seggroup_tpu_torch.cli.stage2_train_pointgroup import make_adam, step_schedule, train_step
from seggroup_tpu_torch.models import minkunet as TM
from seggroup_tpu_torch.models import pointgroup as TP
from seggroup_tpu_torch.models.convert import pointgroup_params_from_flax
from seggroup_tpu_torch.sparse.tensor import SparseTensor

from test_torch_pointgroup import CONFIG, _scene

torch.set_num_threads(1)

LR = 1e-3
I_CAP = 16
ZERO_GRAD = "offset_dense.bias"  # removed by the training BatchNorm after it
MODES = [False, True]  # do_clustering


@contextlib.contextmanager
def f32_convs():
    """Both PointGroups with their submanifold convs at float32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "subm_conv", functools.partial(JM.subm_conv, compute_dtype=jnp.float32))
        mp.setattr(TM, "subm_conv", functools.partial(TM.subm_conv, compute_dtype=torch.float32))
        yield


def _targets(coords, rng):
    """Semantic labels (blobs 0 and 3 wall and floor, the rest objects, 5%
    unlabelled), compact instance ids of the object blobs, their centroids
    and point counts."""
    n, per = coords.shape[0], 1900 // 6
    sem = np.full(n, JP.IGNORE, np.int32)
    inst = np.full(n, JP.IGNORE, np.int32)
    next_inst = 0
    for k, cls in enumerate([0, 2, 3, 1, 4, 5]):
        sl = slice(k * per, (k + 1) * per)
        sem[sl] = cls
        if cls > 1:
            inst[sl] = next_inst
            next_inst += 1
    sem[rng.random(n) < 0.05] = JP.IGNORE
    centroid = np.zeros((n, 3), np.float32)
    pointnum = np.zeros(I_CAP, np.int32)
    for u in range(next_inst):
        sel = inst == u
        centroid[sel] = coords[sel].mean(0)
        pointnum[u] = sel.sum()
    return sem, inst, centroid, pointnum


def _jax_step(model, variables, args, targets, key, clustering):
    """Loss, parts, outputs, new statistics and gradients of the JAX
    driver's loss (cli/stage2_train_pointgroup.py:194-205)."""
    labels, inst, centroid, pointnum = (jnp.asarray(x) for x in targets)

    def loss_fn(p):
        out, mut = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, *args,
                               do_clustering=clustering, train=True, jitter_rng=key,
                               mutable=["batch_stats"])
        total, aux = JP.pointgroup_loss(out, labels, inst, centroid, pointnum, args[2],
                                        args[4], num_instances_cap=I_CAP,
                                        with_score=clustering)
        return total, (aux, mut["batch_stats"], out)

    (loss, (aux, stats, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return jax.tree.map(np.asarray, dict(loss=loss, aux=aux, stats=stats, out=out, grads=grads))


@pytest.fixture(scope="module")
def shared():
    coords, batch_ids, valid, icoords, feats = _scene()
    vm = voxelize(jnp.array(icoords), jnp.array(batch_ids), jnp.array(valid), 2048)
    st = JSparseTensor(vm.voxel_coords, voxel_gather_mean(jnp.array(feats), vm),
                       vm.voxel_valid, vm.num_voxels)
    args = (st, vm.point2voxel, jnp.array(coords), jnp.array(batch_ids), jnp.array(valid))
    model = JP.PointGroup(**CONFIG)
    variables = jax.jit(lambda r, *a: model.init(r, *a, do_clustering=True, train=False))(
        jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(1)

    def perturb(x):
        x = np.asarray(x)
        return x + 0.1 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1 else x
    variables = {"params": jax.tree.map(perturb, variables["params"]),
                 "batch_stats": jax.tree.map(lambda x: np.abs(perturb(x)) + 0.5,
                                             variables["batch_stats"])}
    targets = _targets(coords, rng)
    key = jax.random.PRNGKey(5)
    out = dict(variables=variables, targets=targets,
               jitter=np.asarray(jax.random.uniform(key, (3,))))
    with f32_convs():
        for c in MODES:
            out[c] = _jax_step(model, variables, args, targets, key, c)
    out["bf16"] = _jax_step(model, variables, args, targets, key, True)
    t_st = SparseTensor(*(torch.from_numpy(np.array(x)) for x in st))
    out["batch"] = (t_st, torch.from_numpy(np.array(vm.point2voxel)), torch.from_numpy(coords),
                    torch.from_numpy(batch_ids), torch.from_numpy(valid),
                    *(torch.from_numpy(x) for x in targets))
    return out


def _port(shared):
    port = TP.PointGroup(device="cpu", **CONFIG)
    port.load_state_dict(pointgroup_params_from_flax(shared["variables"]), strict=True)
    return port


def _forward(port, shared, clustering):
    st, p2v, coords, batch_ids, valid = shared["batch"][:5]
    return port(st, p2v, coords, batch_ids, valid, do_clustering=clustering, train=True,
                jitter=torch.from_numpy(shared["jitter"].copy()))


def _loss(out, shared, clustering):
    labels, inst, centroid, pointnum = shared["batch"][5:]
    return TP.pointgroup_loss(out, labels, inst, centroid, pointnum, shared["batch"][2],
                              shared["batch"][4], num_instances_cap=I_CAP,
                              with_score=clustering)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _flax_sd(tree, kind="params"):
    """A JAX tree of parameters (or gradients) or statistics under the
    port's state_dict names."""
    return pointgroup_params_from_flax({kind: tree} if kind == "params"
                                       else {"params": {}, kind: tree})


@pytest.mark.parametrize("clustering", MODES)
def test_train_forward_matches_flax(shared, clustering):
    want = shared[clustering]
    port = _port(shared)
    with f32_convs():
        out = _forward(port, shared, clustering)
    w = want["out"]
    for name in ("proposal_of_point", "proposal_valid", "num_proposals"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(w, name), name)
    assert _rel(out.semantic_scores.detach().numpy(), w.semantic_scores) <= 1e-5
    assert _rel(out.pt_offsets.detach().numpy(), w.pt_offsets) <= 1e-5
    assert _rel(out.scores.detach().numpy(), w.scores) <= 1e-5
    stats = _flax_sd(want["stats"], "batch_stats")
    buffers = dict(port.named_buffers())
    assert set(stats) == set(buffers)
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # every statistic the forward ran moved; the ScoreNet's only with it
    start = _flax_sd(shared["variables"]["batch_stats"], "batch_stats")
    moved = {k for k, v in stats.items() if not torch.equal(v, start[k])}
    assert moved == (set(stats) if clustering
                     else {k for k in stats if not k.startswith("score")})
    # the argmax that decides the proposals is far from a tie
    top2 = np.sort(w.semantic_scores[np.asarray(shared["batch"][4])], axis=1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-4
    if clustering:
        assert int(out.num_proposals) >= 10 and np.abs(w.scores[w.proposal_valid]).max() > 0.1


@pytest.mark.parametrize("clustering", MODES)
def test_loss_and_gradients_match_jax(shared, clustering):
    want = shared[clustering]
    port = _port(shared)
    with f32_convs():
        loss, aux = _loss(_forward(port, shared, clustering), shared, clustering)
        loss.backward()
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    assert set(aux) == set(want["aux"])
    for k, v in aux.items():
        assert abs(float(v) - float(want["aux"][k])) <= 1e-5 * max(abs(float(want["aux"][k])),
                                                                   1e-3), k
    grads = _flax_sd(want["grads"])
    reached = {k for k, p in port.named_parameters() if p.grad is not None}
    assert reached == {k for k, g in grads.items() if float(g.abs().max()) > 0}
    assert reached == (set(grads) if clustering
                       else {k for k in grads if not k.startswith("score")})
    for k, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if k == ZERO_GRAD:
            assert float(g.abs().max()) < 1e-6 and float(grads[k].abs().max()) < 1e-6
            continue
        assert _rel(g.numpy(), grads[k].numpy()) <= 1e-4, k


def test_split_program_and_plan_match_fused_and_jax(shared):
    """The split-program step over a 7-level host plan (windows on its first
    3 levels) at float32 convs: the first program (`propose`) gives the
    fused forward's proposals and leaves the running statistics as they
    were; the second (`score_plan=`) gives the fused step's loss, every
    gradient and the running statistics bit for bit, and so holds to JAX's
    fused step within this file's bounds (JAX's own tests hold its split
    program's gradients bit-identical to its fused step's)."""
    from seggroup_tpu_torch.sparse.plan import build_unet_plan, plan_to_device

    want = shared[True]
    st, p2v, coords, batch_ids, valid = shared["batch"][:5]
    jitter = torch.from_numpy(shared["jitter"].copy())
    plan = plan_to_device(build_unet_plan(st.coords.numpy(), int(st.num),
                                          [st.capacity >> i for i in range(7)],
                                          window_levels=3), "cpu")
    fused, split = _port(shared), _port(shared)
    with f32_convs():
        f_out = _forward(fused, shared, True)
        f_loss, _ = _loss(f_out, shared, True)
        f_loss.backward()
        before = {k: v.clone() for k, v in split.named_buffers()}
        out_a, score_plan = TP.propose(split, st, p2v, coords, batch_ids, valid, train=True,
                                       jitter=jitter, plan=plan)
        for k, v in split.named_buffers():
            assert torch.equal(v, before[k]), k
        out = split(st, p2v, coords, batch_ids, valid, do_clustering=True, train=True,
                    plan=plan, score_plan=score_plan)
        loss, _ = _loss(out, shared, True)
        loss.backward()
    for name in ("proposal_of_point", "proposal_valid", "num_proposals"):
        np.testing.assert_array_equal(getattr(out_a, name).numpy(), getattr(f_out, name).numpy())
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(want["out"], name))
    assert int(out.num_proposals) >= 10 and (out_a.scores == 0).all()
    assert float(loss) == float(f_loss)
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    grads = _flax_sd(want["grads"])
    for (k, p), (_, q) in zip(split.named_parameters(), fused.named_parameters()):
        assert torch.equal(p.grad, q.grad), k
        if k != ZERO_GRAD:
            assert _rel(p.grad.numpy(), grads[k].numpy()) <= 1e-4, k
    for (k, b), (_, c) in zip(split.named_buffers(), fused.named_buffers()):
        assert torch.equal(b, c), k


@pytest.mark.parametrize("clustering", MODES)
def test_train_step_and_adam_match_optax(shared, clustering):
    want = shared[clustering]
    port = _port(shared)
    optimizer, scheduler = make_adam(port, step_schedule(LR, 0.5, 120000))
    with f32_convs():
        loss, aux, props = train_step(port, optimizer, scheduler, shared["batch"], clustering,
                                      torch.from_numpy(shared["jitter"].copy()))
    assert abs(float(loss) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    assert int(props) == int(want["out"].num_proposals)
    assert scheduler.count == 1
    params = shared["variables"]["params"]
    updates, _ = jax.jit(optax.adam(LR).update)(want["grads"], optax.adam(LR).init(params),
                                                params)
    after = _flax_sd(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    grads = _flax_sd(want["grads"])
    for k, p in port.named_parameters():
        g = grads[k].abs()
        sure = (g > 1e-4 * float(g.max())) & (k != ZERO_GRAD)
        err = (p.detach() - after[k]).abs()
        assert not bool(sure.any()) or float(err[sure].max()) <= 1e-6, k
        assert float(err.max()) <= 2 * LR, k
    stats = _flax_sd(want["stats"], "batch_stats")
    for k, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[k].numpy(), rtol=1e-5, atol=1e-5)


def test_adam_alone_matches_optax(shared):
    """The port's optimizer given JAX's own gradients, two steps: the first
    of the prepare phase (the ScoreNet's gradients zero), the second with
    the clustering, at the driver's step schedule."""
    port = _port(shared)
    schedule = step_schedule(LR, 0.5, 1)  # the rate halves after the first step
    optimizer, scheduler = make_adam(port, schedule)
    params = shared["variables"]["params"]
    opt = optax.adam(lambda s: jnp.maximum(LR * 0.5 ** (s // 1), 1e-6))
    state = opt.init(params)
    for clustering in MODES:
        grads = shared[clustering]["grads"]
        updates, state = jax.jit(opt.update)(grads, state, params)
        params = optax.apply_updates(params, updates)
        flat = _flax_sd(grads)
        for k, p in port.named_parameters():
            p.grad = flat[k].clone()
        optimizer.step()
        scheduler.step()
    after = _flax_sd(jax.tree.map(np.asarray, params))
    for k, p in port.named_parameters():
        assert float((p.detach() - after[k]).abs().max()) <= 1e-6, k


def test_bf16_step_within_jax_spread(shared):
    """The default bf16 convs with the clustering. The heads agree to
    bf16's rounding, not to float32's, and a class argmax flips where the
    reference's two best scores lie closer than that; every flipped point
    is such a near-tie. The step is then pinned at shared proposals (the
    port clusters the reference's heads, which gives the reference's
    proposals exactly): proposals equal, the loss within 1e-3 relative, and
    all gradients as close to JAX's bf16 ones as JAX's bf16 gradients are to
    its float32 ones (relative L2 norm over all gradients)."""
    want, ref32 = shared["bf16"], shared[True]
    w = want["out"]
    port = _port(shared)
    with torch.no_grad():
        own = _forward(port, shared, True)
    valid = shared["batch"][4].numpy()
    sem = own.semantic_scores.numpy()
    head_err = float(np.abs(sem - w.semantic_scores).max())
    top2 = np.sort(w.semantic_scores, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    flipped = valid & (sem.argmax(1) != w.semantic_scores.argmax(1))
    print(f"bf16: heads within {head_err:.3e}; {int(flipped.sum())} flipped argmaxes, the "
          f"widest reference gap among them {float(gap[flipped].max(initial=0.0)):.3e}; the "
          f"least gap over the valid points {float(gap[valid].min()):.3e}")
    assert not flipped.any() or float(gap[flipped].max()) <= 2 * head_err

    port = _port(shared)
    cluster = port.cluster
    shared_heads = (torch.from_numpy(w.semantic_scores), torch.from_numpy(w.pt_offsets))
    port.cluster = lambda sem, off, *rest, **kw: cluster(*shared_heads, *rest, **kw)
    out = _forward(port, shared, True)
    for name in ("proposal_of_point", "proposal_valid", "num_proposals"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(w, name), name)
    loss, _ = _loss(out, shared, True)
    loss.backward()
    g_bf, g_32 = _flax_sd(want["grads"]), _flax_sd(ref32["grads"])
    norm = sum(float((g ** 2).sum()) for g in g_bf.values()) ** 0.5
    port_err = sum(float(((p.grad - g_bf[k]) ** 2).sum())
                   for k, p in port.named_parameters()) ** 0.5 / norm
    jax_spread = sum(float(((g_bf[k] - g) ** 2).sum()) for k, g in g_32.items()) ** 0.5 / norm
    print(f"bf16 at shared proposals: loss {float(loss):.6f} vs {float(want['loss']):.6f}, "
          f"gradients {port_err:.4f} from JAX's bf16 ones, JAX's own bf16-to-float32 spread "
          f"{jax_spread:.4f}")
    assert port_err <= jax_spread, (port_err, jax_spread)
    assert abs(float(loss) - float(want["loss"])) <= 1e-3 * abs(float(want["loss"]))


def test_generator_jitter_and_no_jitter():
    """The jitter drawn from a generator (3 uniforms, as the training
    driver draws it) shifts the proposals inside their grids; without one
    they sit at their grids' corner, as with a zero jitter; the jitter only
    moves the score voxelisation, never the proposals, and the forward
    passes it to the clustering."""
    coords, batch_ids, valid, icoords, feats = _scene()
    from seggroup_tpu_torch.ops.voxelize import voxel_gather_mean as t_mean
    from seggroup_tpu_torch.ops.voxelize import voxelize as t_voxelize

    vm = t_voxelize(torch.from_numpy(icoords), torch.from_numpy(batch_ids),
                    torch.from_numpy(valid), 2048)
    st = SparseTensor(vm.voxel_coords, t_mean(torch.from_numpy(feats), vm), vm.voxel_valid,
                      vm.num_voxels)
    port = TP.PointGroup(device="cpu", seed=2, **CONFIG)
    heads = port.backbone(st, vm.point2voxel, torch.from_numpy(valid))
    args = (heads[1].detach(), heads[2].detach(), torch.from_numpy(coords),
            torch.from_numpy(batch_ids), torch.from_numpy(valid))
    drawn = torch.rand(3, generator=torch.Generator().manual_seed(9))
    a = port.cluster(*args, jitter=drawn)
    b = port.cluster(*args, jitter=torch.zeros(3))
    c = port.cluster(*args)
    assert torch.equal(a.proposal_of_point, c.proposal_of_point)
    assert all(torch.equal(x, y) for x, y in zip(b.score_vox, c.score_vox))
    if int(c.num_proposals):
        assert not torch.equal(a.voxel_coords, c.voxel_coords)
        assert int(a.voxel_coords.max()) <= 13 and int(a.voxel_coords.min()) >= 0
    with torch.no_grad():
        x = port(st, vm.point2voxel, *args[2:], do_clustering=True, jitter=drawn)
        y = port.score(heads[0], a.proposal_of_point, a.score_vox)
    assert torch.equal(x.scores, y)


def test_batchnorm_momentum_per_model():
    """PointGroup's BatchNorm moves its statistics at 0.1 with epsilon
    1e-4, MinkUNet's at 0.02, in the torch convention."""
    bn = TP._bn(4)
    assert (bn.momentum, bn.epsilon) == (0.1, 1e-4)
    assert TM.SparseBatchNorm(4).momentum == 0.02
    feats = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    valid = torch.tensor([True, True, False])
    bn(feats, valid, True)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * np.array([2.0, 3.0, 4.0, 5.0]), rtol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * 4.0, rtol=1e-6)
