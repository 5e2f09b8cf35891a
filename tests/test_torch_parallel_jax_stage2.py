"""The port's MinkUNet, KPConv and PointGroup data-parallel steps on 2 gloo
ranks against the JAX package's DP builders themselves on a 2-device CPU
mesh (make_mesh(2)), two steps each, the convs at float32 on both sides,
plain SGD (optax.sgd; torch's SGD without momentum or weight decay; a
learning rate of 1e-3 for MinkUNet and PointGroup, below).
Marked slow: the JAX builders compile for over a minute each on the CPU
(Res16UNet14A's packed step 68 s, KPConv's init and step 82 s, PointGroup's
init alone 60 s). Within the fast budget, tests/test_torch_parallel_stage2.py
and tests/test_torch_parallel_kpconv.py hold the MinkUNet and KPConv steps
against the JAX DP body (the flax model's per-shard jax.value_and_grad,
the mean, optax) per tensor, and every fast file holds its steps bit for
bit against the JAX DP body on the port's single-card pieces.

  * build_minkunet_dp_step_packed on the trainer's float16 wires (rank d
    of step k: make_batch(2k + d + 1)); the port's packed and host-plan
    steps against it;
  * build_kpconv_dp_step with the JAX driver's per-variable gradient
    transform (the offset-LR scale, then each tensor's clip, as
    cli/stage2_train_kpconv.py `per_var_grads` computes it;
    tests/_torch_parallel_jax.py `kpconv_grad_transform`) on the
    trainer's sphere batches, a clip of 0.01 that binds, with two levels
    of deformable v1 blocks (tests/test_torch_kpconv_train.py `SHALLOW`:
    SCANNET_ARCHITECTURE's gradients are chaotic in JAX itself at test
    sizes);
  * build_pointgroup_dp_step_packed on the trainer's wires, the prepare
    phase's step then one with the clustering, each shard's jitter the one
    the JAX step draws (jax.random.uniform of fold_in(key, d)) injected
    into the port's ranks.

Each step is held from the same weights on both sides: the port's ranks
take step k from the JAX step's weights after step k - 1 (plain SGD keeps
no state), so that one step's error is not carried into the next. Per
step: the ranks bit-equal; the summed loss within 1e-5 relative; the
running statistics within rtol = atol = 1e-5; the change of all
parameters together within 1e-3 of JAX's in relative L2 norm (measured
here: MinkUNet 6.9e-4, KPConv 1.8e-5, PointGroup 5.0e-5). Not each
tensor at the single-card bound: a few BatchNorm parameters of the
coarsest levels, whose batch statistics span a few dozen voxels, change
by up to 7.7e-2 (MinkUNet) and 8.1e-3 (PointGroup) of their largest
change apart between the frameworks at the same weights, while the port's
DP step equals its own single-process mean of the shards bit for bit
(tests/test_torch_parallel_stage2.py); PointGroup's `offset_dense.bias`,
which the training BatchNorm after it removes, is held within 1e-6 (as
tests/test_torch_pointgroup_train.py holds it)."""

import functools
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from seggroup_tpu.models import kpconv as JK
from seggroup_tpu.models import minkunet as JM
from seggroup_tpu.models import pointgroup as JP
from seggroup_tpu.parallel.dp import (build_kpconv_dp_step, build_minkunet_dp_step_packed,
                                      build_pointgroup_dp_step_packed, make_mesh, replicate,
                                      shard_batch)
from seggroup_tpu_torch.cli.stage2_train_minkunet import make_batch
from seggroup_tpu_torch.models.convert import (kpconv_params_from_flax,
                                               minkunet_params_from_flax,
                                               pointgroup_params_from_flax)
from seggroup_tpu_torch.parallel.dp import launch

import _torch_parallel_jax as body
import _torch_parallel_ranks as ranks
import test_torch_parallel_kpconv as KPT
import test_torch_parallel_pointgroup as PGT
import test_torch_parallel_stage2 as S2T

pytestmark = pytest.mark.slow

# MinkUNet's and PointGroup's learning rate here: after a step of the
# trainers' 0.1 (0.01) from a random init, the two frameworks' float32
# gradients of these small nets at the same weights part by up to 5% of a
# tensor's largest (measured at the MinkUNet's second step, where the
# port's DP step equals its single-process mean of the shards bit for
# bit): the batch statistics of a few thousand voxels make them chaotic
LR = 1e-3
# each step's change of all parameters together, relative L2 distance from
# the JAX step's (plain SGD: the shards' mean gradients')
CHANGE_RTOL = 1e-3
# MinkUNet's voxel size here (the trainer's default; the fast file's 5 cm
# leaves a few dozen voxels at the coarsest level, whose batch statistics
# make the two frameworks' gradients part)
VOXEL = 0.02


@pytest.fixture
def f32_convs(monkeypatch):
    monkeypatch.setattr(JM, "subm_conv", functools.partial(JM.subm_conv,
                                                           compute_dtype=jnp.float32))


def _spawn(fn, tmp_path, *args):
    return [ranks.as_numpy(r) for r in launch(
        fn, 2, "cpu", *args, timeout=timedelta(seconds=600), threads=1, all_ranks=True)]


def _stacked(batches):
    """Leaf-wise stack of the two shards' batches, sharded over the mesh."""
    mesh = make_mesh(2)
    return jax.tree.map(lambda *xs: shard_batch(mesh, jnp.stack([jnp.asarray(x) for x in xs])),
                        *batches)


def _run_jax(step, variables, opt, batches, convert, extra=lambda k: ()):
    """The JAX DP step's weights after each step (under the port's names)
    and its summed losses."""
    mesh = make_mesh(2)
    params, stats = replicate(mesh, variables["params"]), replicate(mesh,
                                                                    variables["batch_stats"])
    opt_state = replicate(mesh, opt.init(variables["params"]))
    afters, losses = [], []
    for k, per_shard in enumerate(batches):
        params, stats, opt_state, loss, *_ = step(k)(params, stats, opt_state,
                                                     *_stacked(per_shard), *extra(k))
        afters.append(convert(jax.tree.map(np.asarray, {"params": params,
                                                        "batch_stats": stats})))
        losses.append(float(loss))
    return afters, losses


def worst_change_error(port, befores, afters, noise=()):
    """Over the steps, the largest relative L2 distance between the port's
    and JAX's changes of all parameters together (`noise` left out)."""
    worst = 0.0
    for got, before, after in zip(port[0]["states"], ranks.as_numpy(befores),
                                  ranks.as_numpy(afters)):
        keys = [k for k in after if not k.endswith((".mean", ".var")) and k not in noise]
        diff = np.sqrt(sum(float(np.sum((got[k] - after[k]) ** 2)) for k in keys))
        change = np.sqrt(sum(float(np.sum((after[k] - before[k]) ** 2)) for k in keys))
        worst = max(worst, diff / change)
    return worst


def _hold(port, befores, afters, losses, noise=()):
    """The ranks bit-equal, and each step of rank 0 against the JAX step's
    from the same weights."""
    for d in range(2):
        for got, want in zip(port[d]["states"], port[0]["states"]):
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert worst_change_error(port, befores, afters, noise) <= CHANGE_RTOL
    for got, after in zip(port[0]["states"], ranks.as_numpy(afters)):
        for k, want in after.items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-5, err_msg=k)
            elif k in noise:
                assert np.abs(got[k] - want).max() <= 1e-6, k
    for m, want in zip(port[0]["metrics"], losses):
        np.testing.assert_allclose(m["loss"], want, rtol=1e-5)


def test_minkunet_dp_steps_match_jax(tmp_path, f32_convs):
    from seggroup_tpu.sparse.device_plan import unpack_voxel_batch

    tuples = S2T._tuples()
    wires = [[make_batch(lambda i: tuples[i], [0, 1, 2], 2 * k + d + 1, 0, 1, S2T.CAP, VOXEL,
                         True, "device", S2T.CAPS)[0] for d in range(2)] for k in range(2)]
    model = JM.make_minkunet("Res16UNet14A", out_channels=20, level_caps=S2T.CAPS)
    st, _ = unpack_voxel_batch(*(jnp.asarray(x) for x in wires[0][0]))
    variables = jax.tree.map(np.asarray, jax.jit(lambda r: model.init(r, st, train=True))(
        jax.random.PRNGKey(0)))
    opt = optax.sgd(LR)
    step = build_minkunet_dp_step_packed(model, opt, make_mesh(2), S2T.CAPS)
    afters, losses = _run_jax(lambda k: step, variables, opt,
                              [[tuple(w) for w in ws] for ws in wires],
                              minkunet_params_from_flax)
    befores = [minkunet_params_from_flax(variables), afters[0]]
    port = _spawn(ranks.minkunet, tmp_path, befores, wires, "Res16UNet14A", S2T.CAPS, LR, True)
    for mode in ("device", "host"):
        _hold([p[mode] for p in port], befores, afters, losses)


def test_kpconv_dp_step_matches_jax(tmp_path):
    batches = KPT._batches(S2T._tuples())
    config = KPT.KP
    model = JK.KPFCNN(**config)
    pts, feats, _, bids, valid = batches[0][0]
    pyr = JK.build_pyramid(jnp.asarray(pts), jnp.asarray(bids), jnp.asarray(valid), 5,
                           KPT.KP["dl0"], level_caps=KPT.CAPS, neighbor_cap=KPT.NBR_CAPS)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r: model.init(r, pyr, jnp.asarray(feats), train=True))(jax.random.PRNGKey(0)))
    opt = optax.sgd(KPT.LR)
    step = build_kpconv_dp_step(model, opt, make_mesh(2), num_classes=20, dl0=KPT.KP["dl0"],
                                level_caps=KPT.CAPS, neighbor_caps=KPT.NBR_CAPS,
                                grad_transform=body.kpconv_grad_transform(KPT.CLIP,
                                                                          KPT.OFFSET_SCALE))
    # the JAX step's argument order: pts, feats, labels, bids, valid (as the batches)
    afters, losses = _run_jax(lambda k: step, variables, opt, batches, kpconv_params_from_flax)
    befores = [kpconv_params_from_flax(variables), afters[0]]
    port = _spawn(ranks.kpconv, tmp_path, befores, batches, config, KPT.LR, KPT.STEP_KW)
    _hold(port, befores, afters, losses)


def test_pointgroup_dp_steps_match_jax(tmp_path, f32_convs):
    from seggroup_tpu.data.pg_wire import unpack_pg_batch

    wires = PGT._wires()
    model = JP.PointGroup(**PGT.MODEL)
    caps = PGT.MODEL["level_caps"]
    w0 = jax.tree.map(jnp.asarray, wires[0][0])
    args = unpack_pg_batch(w0, PGT.VCAP, caps, window_levels=0)[:5]
    variables = jax.tree.map(np.asarray, jax.jit(lambda r: model.init(
        r, *args, do_clustering=True, train=False))(jax.random.PRNGKey(0)))
    keys = [jax.random.PRNGKey(10 + k) for k in range(2)]
    jitters = [[np.asarray(jax.random.uniform(jax.random.fold_in(keys[k], d), (3,)))
                for d in range(2)] for k in range(2)]
    opt = optax.sgd(LR)
    steps = [build_pointgroup_dp_step_packed(model, opt, make_mesh(2), JP.pointgroup_loss,
                                             voxel_cap=PGT.VCAP, level_caps=caps,
                                             do_clustering=c, instance_cap=32)
             for c in (False, True)]
    afters, losses = _run_jax(lambda k: steps[k], variables, opt,
                              [[(w,) for w in ws] for ws in wires], pointgroup_params_from_flax,
                              lambda k: (keys[k],))
    befores = [pointgroup_params_from_flax(variables), afters[0]]
    port = _spawn(ranks.pointgroup, tmp_path, befores, wires, jitters, PGT.MODEL, PGT.VCAP, LR,
                  True)
    for mode in ("device", "host"):
        _hold([p[mode] for p in port], befores, afters, losses, noise=("offset_dense.bias",))
