"""Each plain reference and the benchmark's scene generator against the port
at small sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark.reference import res16unet, stage1, voxel_batch
from benchmark.tests.conftest import SMALL_SCENE


def _port_scene(sc):
    from seggroup_tpu_torch.types import Scene

    return Scene(*(sc[f] for f in scenes.FIELDS))


def test_scenes_are_the_ports_synthetic_scenes():
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene

    ours = scenes.make_scene(2 ** 32 + 3, **SMALL_SCENE)
    theirs = make_synthetic_scene(2 ** 32 + 3, **SMALL_SCENE)
    for f in scenes.FIELDS:
        np.testing.assert_array_equal(ours[f], getattr(theirs, f))


def test_batches_are_the_trainers_wire_batches():
    from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
    from seggroup_tpu_torch.cli.stage2_train_minkunet import make_batch

    pool = scenes.scene_pool(11, 3, SMALL_SCENE)
    port = [scene_to_training_tuple(_port_scene(sc), {}, None, "", False) for sc in pool]
    ref = [voxel_batch.training_tuple(sc["points"], sc["real_sem"]) for sc in pool]
    for a, b in zip(port, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for step in (1, 2):
        (c16, f16, l8, num), _ = make_batch(port.__getitem__, [0, 1, 2], step, 2 ** 40, 3,
                                            12000, 0.02, True, "device", None)
        c, f, lab, n = voxel_batch.wire_round(*voxel_batch.train_batch(ref, (2 ** 40, step), 3,
                                                                       12000, 0.02))
        assert n == int(num)
        np.testing.assert_array_equal(c, c16.astype(np.int32))
        np.testing.assert_array_equal(f, f16.astype(np.float32))
        np.testing.assert_array_equal(lab, l8.astype(np.int32))


def _stage1_pair(seed=5):
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    ref = stage1.SegGroupGNN(knn_window=2048, cluster_cap=256)
    weights = harness.make_weights(harness.param_spec(ref), seed, "cpu")
    harness.load_params(ref, weights)
    port = SegGroupGNN(knn_window=2048, cluster_cap=256, device="cpu")
    harness.load_params(port, weights)
    return ref, port


def test_stage1_reference_labels_equal_the_ports():
    ref, port = _stage1_pair()
    sc = scenes.make_scene(21, **SMALL_SCENE)
    want = port(_port_scene(sc).to("cpu"), mode="ins_infer")
    got = ref(scenes.to_tensors(sc, "cpu"))
    torch.testing.assert_close(got.layer_roots, want.layer_roots, rtol=0, atol=0)
    torch.testing.assert_close(got.layer_sem, want.layer_sem, rtol=0, atol=0)
    torch.testing.assert_close(got.layer_ins, want.layer_ins, rtol=0, atol=0)
    torch.testing.assert_close(got.final_root, want.final_root, rtol=0, atol=0)
    torch.testing.assert_close(got.final_sem, want.final_sem, rtol=0, atol=0)
    torch.testing.assert_close(got.final_ins, want.final_ins, rtol=0, atol=0)


def test_stage1_reference_train_loss_and_gradients_equal_the_ports():
    ref, port = _stage1_pair(7)
    sc = scenes.make_scene(22, **SMALL_SCENE)
    keep = torch.rand((128, 128), generator=torch.Generator().manual_seed(3)) < 0.5
    out = port(_port_scene(sc).to("cpu"), mode="train", dropout_keep=keep)
    loss = out.loss_sum / torch.clamp(out.loss_count, min=1.0)
    loss.backward()
    got = ref(scenes.to_tensors(sc, "cpu"), train=True, dropout_keep=keep).loss
    got.backward()
    want = float(loss.detach())
    assert abs(float(got.detach()) - want) <= 1e-6 * abs(want)
    theirs = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        g, w = p.grad, theirs[name].grad
        if w is None:
            assert g is None or float(g.abs().max()) == 0.0, name
            continue
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()) + 1e-12)


@pytest.fixture
def float32_subm_convs(monkeypatch):
    """The port's submanifold convs at float32 operands, as the reference's."""
    import seggroup_tpu_torch.sparse.conv as conv

    apply = conv.SubmConvFunction.apply
    monkeypatch.setattr(conv.SubmConvFunction, "apply",
                        staticmethod(lambda f, w, rb, dtype: apply(f, w, rb, torch.float32)))


def test_res16unet_reference_steps_equal_the_ports(float32_subm_convs):
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_on_device, train_step
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule

    pool = scenes.scene_pool(13, 2, SMALL_SCENE)
    tuples = [voxel_batch.training_tuple(sc["points"], sc["real_sem"]) for sc in pool]
    cap = 8192
    caps = [cap, cap // 2, cap // 4, cap // 8, cap // 8]
    spec = harness.param_spec(res16unet.Res16UNet34C())
    weights = harness.make_weights(spec, 9, "cpu")
    model = make_minkunet("Res16UNet34C", level_caps=caps, device="cpu")
    harness.load_params(model, weights)
    opt, sched = make_optimizer("SGD", model.parameters(), make_schedule("PolyLR", 0.1,
                                                                         max_iter=60000))
    batches, losses = [], []
    for step in (1, 2):
        c, f, lab, n = voxel_batch.wire_round(*voxel_batch.train_batch(tuples, (4, step), 2,
                                                                       cap, 0.02))
        batches.append(tuple(torch.from_numpy(x[:n]) for x in (c, f, lab)))
        wire = (c.astype(np.int16), f.astype(np.float16), lab.astype(np.uint8), np.int32(n))
        st, labels, plan = batch_on_device(wire, None, torch.device("cpu"), caps)
        loss, _ = train_step(model, opt, sched, st, labels, plan=plan)
        losses.append(float(loss))
    ref_losses, _, after, _ = res16unet.train(weights, batches, caps[1:])
    np.testing.assert_allclose(ref_losses, losses, rtol=2e-5)
    # float32 sums in other orders (the reference scatters where the port
    # gathers) over two steps: within a hundredth of each leaf's change
    for name, p in model.named_parameters():
        scale = float((weights[name] - after[name]).abs().max()) + 1e-12
        assert float((p.detach() - after[name]).abs().max()) <= 1e-2 * scale, name
