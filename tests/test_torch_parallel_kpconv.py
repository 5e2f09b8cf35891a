"""The port's KPConv data-parallel step (seggroup_tpu_torch.parallel.dp
`build_kpconv_dp_step`) on 2 gloo ranks, two SGD steps, held two ways.

Against the JAX DP step's body (tests/_torch_parallel_jax.py), at the
port's own weights before each step: the flax KPFCNN's per-shard
jax.value_and_grad of the JAX step's local loss with its pyramid built in
the shard (dp.py:226-241), the JAX driver's per-variable gradient
transform on each shard's gradients (the offsets' 0.1 scale, then each
tensor's clip; dp.py:254-256 applies it before the pmean), the mean of the
gradients and of the moved running statistics, then optax.sgd. At the
single-card parity tolerances of tests/test_torch_kpconv_train.py: the
mean gradients and the parameters after the step within 1e-4 of each
tensor's max, the running statistics within rtol = atol = 1e-5, the
summed loss within 1e-5 relative, the mean accuracy within 2 / 512 (two
points of a sphere batch; measured: gradients 5.3e-6, parameters 4.1e-6,
statistics 6.0e-8, the loss and the accuracy equal).

Against the same body on the port's single-card pieces, in this process:
each shard's gradient and locally moved running statistics from the
trainer's own train_step, its transform on each shard's gradients, their
mean, then the optimizer. Every parameter and running statistic equals it
bit for bit on both ranks; the loss is the shards' sum and the accuracy
their mean.

One spawn of 2 ranks (one thread a rank, 60 s timeout): 512-point spheres
of the trainer's `sample_batch` (rank d's of step k drawn d-th of the step
from the one sampler, as the JAX driver's shard d), first_features_dim
16, two levels of deformable v1 blocks (tests/test_torch_kpconv_train.py
`SHALLOW`: SCANNET_ARCHITECTURE's gradients are chaotic in JAX itself at
test sizes), a clip of 0.01 that binds."""

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import kpconv as JK
from seggroup_tpu_torch.cli.stage2_test_semantic import kpconv_level_caps
from seggroup_tpu_torch.cli.stage2_train_kpconv import sample_batch, to_device_pyramid, train_step
from seggroup_tpu_torch.data.potentials import PotentialSampler
from seggroup_tpu_torch.models.convert import kpconv_params_from_flax
from seggroup_tpu_torch.models.kpconv import KPFCNN
from seggroup_tpu_torch.parallel.dp import launch

import _torch_parallel_jax as body
import _torch_parallel_ranks as ranks
from test_torch_kpconv_train import SHALLOW
from test_torch_parallel_stage2 import _tuples, nll

KP = dict(num_classes=20, first_features_dim=16, dl0=0.2, architecture=SHALLOW["v1"])
CAP, RADIUS, LR, CLIP, OFFSET_SCALE = 512, 5.0, 0.05, 0.01, 0.1
CAPS, NBR_CAPS = kpconv_level_caps(CAP), [24] * 5
CPU = torch.device("cpu")


def _batches(tuples):
    sampler = PotentialSampler([c for c, _, _ in tuples], in_radius=RADIUS, seed=1)
    rng = np.random.default_rng(0)
    return [[sample_batch(tuples, sampler, rng, 1, RADIUS, CAP) for _ in range(2)]
            for _ in range(2)]


def _shard(model, optimizer, scheduler, batch):
    pts, feats, labels, bids, valid = batch
    pyr = to_device_pyramid(pts, bids, valid, CPU, KP["dl0"], CAPS, NBR_CAPS)
    return train_step(model, optimizer, scheduler, pyr, torch.from_numpy(feats),
                      torch.from_numpy(labels), 0.1, CLIP, OFFSET_SCALE)


def _jax_grad():
    """The KPConv step's per-shard value_and_grad (dp.py:226-241):
    ((loss, (new stats, accuracy)), grads)."""
    model = JK.KPFCNN(**KP)

    def local_loss(params, stats, batch):
        pts, feats, labels, bids, valid = batch
        pyr = JK.build_pyramid(pts, bids, valid, num_layers=5, dl0=KP["dl0"], level_caps=CAPS,
                               neighbor_cap=NBR_CAPS)
        (logits, regs), mut = model.apply({"params": params, "batch_stats": stats}, pyr, feats,
                                          train=True, mutable=["batch_stats"])
        ok = labels != 255
        acc = jnp.sum((jnp.argmax(logits, -1) == labels) & ok) / jnp.maximum(jnp.sum(ok), 1)
        return nll(logits, labels, ok) + 0.1 * regs, (mut["batch_stats"], acc)

    return jax.jit(jax.value_and_grad(local_loss, has_aux=True))


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    batches = _batches(_tuples())

    def make_model():
        return KPFCNN(device="cpu", **KP)

    state = ranks._state(make_model())
    grad, transform = _jax_grad(), body.kpconv_grad_transform(CLIP, OFFSET_SCALE)
    with ThreadPoolExecutor(2) as pool:  # the ranks and JAX run while this process works
        port = pool.submit(launch, ranks.kpconv, 2, "cpu", ranks._copy(state), batches, KP,
                           KP["dl0"], CAPS, NBR_CAPS, LR, CLIP, OFFSET_SCALE,
                           timeout=timedelta(seconds=60), threads=1, all_ranks=True)
        first = pool.submit(body.reference_steps, grad, [ranks._copy(state)], batches[:1], LR,
                            transform)
        ref = ranks.reference_steps(make_model, state, _shard, batches, LR)
        port, first = port.result(), first.result()
    jax_ref = first + body.reference_steps(grad, port[0]["states"][:1], batches[1:], LR,
                                           transform)
    return [ranks.as_numpy(r) for r in port], ranks.as_numpy(ref), jax_ref


def test_kpconv_dp_step_clips_then_averages(runs):
    port, (state, outs), _ = runs
    for d in range(2):
        got = port[d]
        assert got["state"].keys() == state.keys()
        for k, v in state.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        for m, shards in zip(got["metrics"], outs):
            np.testing.assert_array_equal(m["loss"], np.float32(shards[0][0] + shards[1][0]))
            np.testing.assert_array_equal(m["acc"], np.float32((shards[0][1] + shards[1][1]) / 2))


def test_kpconv_dp_step_matches_the_jax_body(runs):
    port, _, jax_ref = runs
    got = port[0]
    for k, ref in enumerate(jax_ref):
        body.hold_step(got["grads"][k], got["states"][k], ref, kpconv_params_from_flax)
        want = float(sum(ref["loss"]))
        assert abs(float(got["metrics"][k]["loss"]) - want) <= 1e-5 * abs(want)
        assert abs(float(got["metrics"][k]["acc"]) - float(np.mean(ref["aux"]))) <= 2 / CAP
