"""The port's MinkUNet over pyramid plans and its trainer's wire
(seggroup_tpu_torch/cli/stage2_train_minkunet.py `make_batch`,
`batch_on_device`, `--plan_mode`) against the JAX package on the CPU.

The wire: the tuple the port's `make_batch` builds at the default
`--plan_mode device` is bit-equal to JAX's pack_voxel_batch of the same
VoxelBatch (float16 features, int16 coordinates, uint8 labels), and
without augmentation to JAX's own make_voxel_batch + pack_voxel_batch.

The planned net (Res16UNet14A at 2,048 voxels): the logits with a host
plan (level 0 windowed) and with the trainer's device plan (no windows)
are bit-equal to those without one, and within the MinkUNet tolerance (atol 2e-4 + rtol 1e-3)
of JAX's `plan=` forward (JAX's plain branch: the plan without windows,
whose rulebooks JAX's own tests hold bit-equal to its device plan's). One
train step at float32 convs on the unpacked wire with the device plan
against jax.value_and_grad of the JAX driver's loss on the same unpacked
batch and plan: the loss within 1e-5, every gradient within 1e-4 of its
max (tests/test_torch_minkunet_train.py's bounds)."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.data import voxel_dataset as JV
from seggroup_tpu.models import minkunet as J
from seggroup_tpu.sparse.device_plan import pack_voxel_batch as jax_pack
from seggroup_tpu.sparse.device_plan import unpack_voxel_batch as jax_unpack
from seggroup_tpu.sparse.plan import build_unet_plan as jax_build_unet_plan
from seggroup_tpu_torch.cli import stage2_train_minkunet as S2
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import minkunet as T
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.sparse.plan import build_unet_plan, plan_to_device

torch.set_num_threads(2)

CAP = 2048
CAPS = (2048, 1024, 512, 256, 256)
C = 20
ATOL, RTOL = 2e-4, 1e-3


@contextlib.contextmanager
def f32_convs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "subm_conv", functools.partial(J.subm_conv, compute_dtype=jnp.float32))
        mp.setattr(T, "subm_conv", functools.partial(T.subm_conv, compute_dtype=torch.float32))
        yield


@functools.lru_cache(maxsize=None)
def _scene(i):
    return scene_to_training_tuple(make_synthetic_scene(seed=i, num_points=3000), {}, None,
                                   "s", False)


def _batch(augment, plan_mode="device", step=3, voxel_size=0.2):
    return S2.make_batch(_scene, [0, 1], step, 0, 2, CAP, voxel_size, augment, plan_mode,
                         CAPS)


@pytest.mark.parametrize("augment", [False, True])
def test_wire_is_jax_pack_voxel_batch(augment):
    wire, plan = _batch(augment)
    assert plan is None
    vb = S2.make_train_batch(_scene, [0, 1], 3, 0, 2, CAP, 0.2, augment)
    want = jax_pack(JV.VoxelBatch(*vb))
    assert [np.asarray(x).dtype for x in wire] == [np.int16, np.float16, np.uint8, np.int32]
    for got, ref in zip(wire, want):
        assert np.asarray(got).dtype == np.asarray(ref).dtype
        np.testing.assert_array_equal(got, ref)
    assert 1000 < int(wire[3]) < CAP
    if not augment:  # the JAX driver's own batch of this step
        rng = np.random.default_rng((0, 3))
        idx = rng.integers(0, 2, size=2)
        jvb = JV.make_voxel_batch([_scene(int(i)) for i in idx], CAP, 0.2, rng=rng,
                                  augment=False)
        for got, ref in zip(wire, jax_pack(jvb)):
            np.testing.assert_array_equal(got, ref)


def test_host_mode_batch_is_float32_with_host_plan():
    vb, plan = _batch(False, plan_mode="host")
    assert vb.feats.dtype == np.float32
    ref = jax_build_unet_plan(vb.coords, int(vb.num), list(CAPS))
    for a, b in zip(plan["rulebooks"], ref["rulebooks"]):
        np.testing.assert_array_equal(a, b)
    st, labels, tplan = S2.batch_on_device(vb, plan, torch.device("cpu"), CAPS)
    assert st.feats.dtype == torch.float32 and "windows" not in tplan
    np.testing.assert_array_equal(st.feats.numpy(), vb.feats)


@pytest.fixture(scope="module")
def shared():
    """JAX variables (statistics randomised), the unpacked wire on both
    sides with their plans, and JAX's logits and float32 train step."""
    rng = np.random.default_rng(0)
    wire, _ = _batch(False)
    js, jlab = jax_unpack(*(jnp.asarray(x) for x in wire))
    jplan = jax_build_unet_plan(np.asarray(wire[0]).astype(np.int32), int(wire[3]), list(CAPS))
    jplan = jax.tree.map(jnp.asarray, {k: v for k, v in jplan.items() if k != "windows"})
    jmodel = J.make_minkunet("Res16UNet14A", out_channels=C, level_caps=list(CAPS))
    variables = jax.tree.map(np.asarray, jax.jit(lambda r, s: jmodel.init(r, s, train=False))(
        jax.random.PRNGKey(1), js))
    variables["batch_stats"] = jax.tree.map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.min() == 1 else
                   rng.normal(0.0, 0.1, x.shape)).astype(np.float32), variables["batch_stats"])
    logits = jax.jit(lambda v, s, p: jmodel.apply(v, s, train=False, plan=p))(variables, js, jplan)

    def loss_fn(p, stats, s, labels, plan):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, s, train=True,
                              mutable=["batch_stats"], plan=plan)
        ok = s.valid & (labels != 255)
        lp = jax.nn.log_softmax(out, axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.clip(labels, 0, C - 1)[:, None], axis=1)[:, 0]
        return jnp.sum(jnp.where(ok, nll, 0.0)) / jnp.maximum(jnp.sum(ok), 1)

    with f32_convs():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], variables["batch_stats"], js, jlab, jplan)
    st, labels, dplan = S2.batch_on_device(wire, None, torch.device("cpu"), CAPS)
    return dict(variables=variables, logits=np.asarray(logits), loss=float(loss),
                grads=jax.tree.map(np.asarray, grads), st=st, labels=labels, dplan=dplan,
                wire=wire)


def _port(shared):
    port = T.make_minkunet("Res16UNet14A", out_channels=C, level_caps=list(CAPS), device="cpu")
    port.load_state_dict(minkunet_params_from_flax(shared["variables"]), strict=True)
    return port


def test_planned_logits_equal_unplanned_and_match_jax(shared):
    port, st = _port(shared), shared["st"]
    np.testing.assert_array_equal(st.feats.numpy(),
                                  shared["wire"][1].astype(np.float32))
    hplan = plan_to_device(build_unet_plan(st.coords.numpy(), int(st.num), list(CAPS)), "cpu")
    # the trainer's device plan has no windows; the host plan's select nothing
    assert "windows" not in shared["dplan"] and hplan["windows"][0] is not None
    with torch.no_grad():
        none = port(st, train=False)
        host = port(st, train=False, plan=hplan)
        dev = port(st, train=False, plan=shared["dplan"])
    np.testing.assert_array_equal(host.numpy(), none.numpy())
    np.testing.assert_array_equal(dev.numpy(), none.numpy())
    np.testing.assert_allclose(dev.numpy(), shared["logits"], atol=ATOL, rtol=RTOL)
    assert np.abs(shared["logits"]).max() > 0.5


def test_train_step_on_the_wire_matches_jax(shared):
    port = _port(shared)
    optimizer = torch.optim.SGD(port.parameters(), lr=0.0)
    with f32_convs():
        logits = port(shared["st"], train=True, plan=shared["dplan"])
        loss = S2.masked_nll(logits, shared["labels"], shared["st"].valid)
        optimizer.zero_grad()
        loss.backward()
    assert abs(float(loss) - shared["loss"]) <= 1e-5 * abs(shared["loss"])
    want = dict(minkunet_params_from_flax({"params": shared["grads"],
                                            "batch_stats": shared["variables"]["batch_stats"]}))
    checked = 0
    for name, p in port.named_parameters():
        ref = np.asarray(want[name])
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + 1e-12, (name, err)
        checked += 1
    assert checked > 30


@pytest.mark.parametrize("plan_mode", ["device", "host"])
def test_driver_runs_both_plan_modes(plan_mode, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    it, best = S2.main(["--synthetic", "2", "--val_freq", "2", "--model", "Res16UNet14A",
                        "--capacity", "4096", "--batch_size", "2", "--device", "cpu",
                        "--prefetch_workers", "1", "--exp_name", "p", "--max_iter", "2",
                        "--plan_mode", plan_mode])
    assert it == 2 and 0.0 <= best <= 1.0
    log = (tmp_path / "checkpoints/p/minkunet.log").read_text()
    assert "iter 2/2" in log and "val mIoU" in log
