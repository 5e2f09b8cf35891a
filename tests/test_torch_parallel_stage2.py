"""The port's MinkUNet data-parallel steps
(seggroup_tpu_torch.parallel.dp `build_minkunet_dp_step_packed` and
`build_minkunet_dp_step`) on 2 gloo ranks, two SGD steps each, the convs
at float32, held two ways.

Against the JAX DP step's body (tests/_torch_parallel_jax.py), at the
port's own weights before each step: the flax MinkUNet's per-shard
jax.value_and_grad of the JAX step's local loss (dp.py:128-158) on the
unpacked wire, the mean of the gradients and of the moved running
statistics, then optax.sgd, at float32 convs. The JAX side builds the
rulebooks in its forward, not from the packed step's device plan (whose
trace and compile take 71 s here; tests/test_torch_minkunet_plan.py holds
planned logits equal to unplanned ones). At the single-card parity
tolerances of tests/test_torch_minkunet_train.py: the mean gradients and
the parameters after the step within 1e-4 of each tensor's max, the
running statistics within rtol = atol = 1e-5, the summed loss within 1e-5
relative (measured: gradients 4.0e-6, parameters 2.8e-6, statistics
6.1e-8, the loss equal). The confusion matrix sums to the JAX body's
count of labelled rows.

The learning rate is 0.01. At the trainer's 0.1 the second step's weights
put shard 0's batch where JAX's own gradients move by up to 3.8e-3 of a
tensor's max when the weights move by 1e-7 relative, and the port's lie
as far from JAX's (3.8e-3) as JAX's moved ones do; at 0.01 every step and
shard is within 7e-6 both ways (measured here).

Against the same body on the port's single-card pieces, in this process:
each shard's gradient and locally moved running statistics from the
trainer's own train_step, their mean, then the optimizer. Every parameter
and running statistic equals it bit for bit (the same float operations in
the same order: gloo's sum of two ranks is g0 + g1) on both ranks; the
loss and confusion matrix are the shards' sums.

One spawn of 2 ranks (one thread a rank, 60 s timeout): Res16UNet14A at
2,048 voxels, rank d's batch of step k the trainer's `make_batch(2k + d +
1)` wire (as the JAX driver's shard d), the packed step building its plan
on the rank, the host step given the host plan of the same batch."""

import functools
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.eval.semantic import confusion_matrix as jax_confusion_matrix
from seggroup_tpu.models import minkunet as JM
from seggroup_tpu.sparse.device_plan import unpack_voxel_batch
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.cli.stage2_test_semantic import level_caps
from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_on_device, make_batch, train_step
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import minkunet as TM
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.parallel.dp import launch

import _torch_parallel_jax as body
import _torch_parallel_ranks as ranks

CAP = 2048
CAPS = level_caps(CAP)
LR = 0.01
CPU = torch.device("cpu")


def _tuples():
    return [scene_to_training_tuple(make_synthetic_scene(seed=i), {}, None, f"s{i}", False)
            for i in range(3)]


def _wires(tuples):
    return [[make_batch(lambda i: tuples[i], [0, 1, 2], 2 * k + d + 1, 0, 1, CAP, 0.05, True,
                        "device", CAPS)[0] for d in range(2)] for k in range(2)]


def _shard(model, optimizer, scheduler, wire):
    st, labels, plan = batch_on_device(wire, None, CPU, CAPS)
    return train_step(model, optimizer, scheduler, st, labels, plan=plan)


def nll(logits, labels, ok):
    """The JAX steps' masked mean negative log-likelihood."""
    lp = jax.nn.log_softmax(logits, axis=-1)
    out = -jnp.take_along_axis(lp, jnp.clip(labels, 0, logits.shape[-1] - 1)[:, None],
                               axis=1)[:, 0]
    return jnp.sum(jnp.where(ok, out, 0.0)) / jnp.maximum(jnp.sum(ok), 1)


def _jax_grad():
    """The MinkUNet step's per-shard value_and_grad (dp.py:128-158) on a
    wire, at float32 convs: ((loss, (new stats, confusion)), grads)."""
    model = JM.make_minkunet("Res16UNet14A", out_channels=20, level_caps=CAPS)

    def local_loss(params, stats, wire):
        st, labels = unpack_voxel_batch(*wire)
        logits, mut = model.apply({"params": params, "batch_stats": stats}, st, train=True,
                                  mutable=["batch_stats"])
        hist = jax_confusion_matrix(jnp.argmax(logits, -1), jnp.where(st.valid, labels, 255), 20)
        return nll(logits, labels, st.valid & (labels != 255)), (mut["batch_stats"], hist)

    grad = jax.jit(jax.value_and_grad(local_loss, has_aux=True))

    def run(*args):
        with pytest.MonkeyPatch.context() as mp:  # traced at the first call
            mp.setattr(JM, "subm_conv", functools.partial(JM.subm_conv,
                                                          compute_dtype=jnp.float32))
            return grad(*args)
    return run


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    wires = _wires(_tuples())

    def make_model():
        return TM.make_minkunet("Res16UNet14A", out_channels=20, level_caps=CAPS, device="cpu")

    state = ranks._state(make_model())
    grad = _jax_grad()
    with ThreadPoolExecutor(2) as pool:  # the ranks and JAX run while this process works
        port = pool.submit(launch, ranks.minkunet, 2, "cpu", ranks._copy(state), wires,
                           "Res16UNet14A", CAPS, LR, True, timeout=timedelta(seconds=60),
                           threads=1, all_ranks=True)
        first = pool.submit(body.reference_steps, grad, [ranks._copy(state)], wires[:1], LR)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TM, "subm_conv", functools.partial(TM.subm_conv,
                                                          compute_dtype=torch.float32))
            ref = ranks.reference_steps(make_model, state, _shard, wires, LR)
        port, first = port.result(), first.result()
    jax_ref = {mode: first + body.reference_steps(grad, port[0][mode]["states"][:1], wires[1:], LR)
               for mode in ("device", "host")}
    return [ranks.as_numpy(r) for r in port], ranks.as_numpy(ref), jax_ref


@pytest.mark.parametrize("mode", ["device", "host"])
def test_minkunet_dp_step_is_the_shards_mean(runs, mode):
    port, (state, outs), _ = runs
    for d in range(2):
        got = port[d][mode]
        assert got["state"].keys() == state.keys()
        for k, v in state.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        for m, shards in zip(got["metrics"], outs):
            np.testing.assert_array_equal(m["loss"], np.float32(shards[0][0] + shards[1][0]))
            np.testing.assert_array_equal(m["hist"], shards[0][1] + shards[1][1])
            assert m["hist"].sum() > 0


@pytest.mark.parametrize("mode", ["device", "host"])
def test_minkunet_dp_step_matches_the_jax_body(runs, mode):
    port, _, jax_ref = runs
    got = port[0][mode]
    for k, ref in enumerate(jax_ref[mode]):
        body.hold_step(got["grads"][k], got["states"][k], ref, minkunet_params_from_flax)
        want = float(sum(ref["loss"]))
        assert abs(float(got["metrics"][k]["loss"]) - want) <= 1e-5 * abs(want)
        assert got["metrics"][k]["hist"].sum() == sum(int(h.sum()) for h in ref["aux"])
