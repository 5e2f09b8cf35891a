"""The port's PointGroup data-parallel steps
(seggroup_tpu_torch.parallel.dp `build_pointgroup_dp_step_packed` and
`build_pointgroup_dp_step`) on 2 gloo ranks, two SGD steps (the prepare
phase's heads alone, then with the clustering and the ScoreNet), against
the JAX DP step's body computed in this process from the port's
single-card pieces: each shard's gradient (zeros where none reaches, as
jax.grad gives) and locally moved running statistics from the trainer's
train_step (held against jax.value_and_grad at 1e-4 of each tensor's max,
both phases, by tests/test_torch_pointgroup_train.py), their mean, then
the optimizer. Every parameter and running statistic equals the reference
bit for bit on both ranks, and the loss is the shards' sum.

The flax PointGroup's own per-shard jax.value_and_grad is not this file's
reference, unlike tests/test_torch_parallel_stage2.py's and
tests/test_torch_parallel_kpconv.py's. Its prepare step takes 40 s to
trace and compile here and its clustering step 76 s, over this file's
budget. And on these wires JAX's float32 gradients are not accurate to
1e-4: on shard 0 of the first step they lie 3.6e-2 of a tensor's max
(`unet.u.u.tail0.i_branch.kernel`) from the port's float64 gradients,
while JAX's float64 ones lie within 2.2e-4 of those and the port's float32
ones within 4.9e-6 (measured here). The DP step against the JAX DP builder
itself is in tests/test_torch_parallel_jax_stage2.py, marked slow.

Rank d's batch of step k is the trainer's make_train_batch wire drawn
d-th of the step from the one generator (the JAX driver's
`[sample_batch() for _ in range(n_dev)]`), 2,048 points and voxels of the
synthetic scenes, m = 8 (a clustering step takes 4 s here, 15 s at
4,096); its jitter is its own (three uniforms a step, injected). The
packed step builds the U-Net's plan on the rank, the other is given no
plan and builds the rulebooks in its forward."""

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.cli.stage2_pointgroup_common import scene_instance_tuple
from seggroup_tpu_torch.cli.stage2_train_pointgroup import (batch_on_device, make_train_batch,
                                                            train_step)
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models.pointgroup import PointGroup
from seggroup_tpu_torch.parallel.dp import launch

import _torch_parallel_ranks as ranks

VCAP = PCAP = 2048
MODEL = dict(classes=20, m=8, score_cap=VCAP // 8, level_caps=[VCAP >> i for i in range(7)],
             cluster_radius=0.3, cluster_npoint_thre=10)
LR = 0.01
CPU = torch.device("cpu")


def _wires():
    tuples = [scene_instance_tuple(make_synthetic_scene(seed=i), {}, None, f"s{i}")
              for i in range(3)]
    rng = np.random.default_rng(0)
    return [[make_train_batch(lambda i: tuples[i], [0, 1, 2], rng, 1, PCAP, VCAP, 32, 0.02,
                              True) for _ in range(2)] for _ in range(2)]


def _jitters():
    rng = np.random.default_rng(1)
    return [[rng.random(3).astype(np.float32) for _ in range(2)] for _ in range(2)]


def _shard(model, optimizer, scheduler, wire_jitter_clustering):
    wire, jitter, clustering = wire_jitter_clustering
    batch, plan = batch_on_device(wire, VCAP, CPU)
    loss, _, proposals = train_step(model, optimizer, scheduler, batch, clustering,
                                    torch.from_numpy(jitter), plan=plan)
    return loss, proposals


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    wires, jitters = _wires(), _jitters()

    def make_model():
        return PointGroup(device="cpu", **MODEL)

    state = ranks._state(make_model())
    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process makes the reference
        port = pool.submit(launch, ranks.pointgroup, 2, "cpu", ranks._copy(state), wires,
                           jitters, MODEL, VCAP, LR, timeout=timedelta(seconds=60), threads=1,
                           all_ranks=True)
        ref = ranks.reference_steps(make_model, state, _shard,
                                    [[(w, j, k == 1) for w, j in zip(wires[k], jitters[k])]
                                     for k in range(2)], LR)
        port = port.result()
    return [ranks.as_numpy(r) for r in port], ranks.as_numpy(ref)


@pytest.mark.parametrize("mode", ["device", "host"])
def test_pointgroup_dp_step_is_the_shards_mean(runs, mode):
    port, (state, outs) = runs
    assert sum(int(p) for shards in outs for _, p in shards) > 0  # the ScoreNet has work
    for d in range(2):
        got = port[d][mode]
        assert got["state"].keys() == state.keys()
        for k, v in state.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        for m, shards in zip(got["metrics"], outs):
            np.testing.assert_array_equal(m["loss"], np.float32(shards[0][0] + shards[1][0]))
