"""The port's model registry (seggroup_tpu_torch.models) and standalone demo
(seggroup_tpu_torch.cli.demo_semantic) against the JAX package's on the CPU.

  * the registry's names are exactly the JAX registry's, and for one
    variant of each voxel family (Res16UNet, ST, ResUNet, ST ResUNet,
    MinkUNetHyper, sparse ResNet, ST ResNet, both CRFs) the port's model
    loads the converted JAX tree with `strict=True` (at narrow widths);
    the other names build the port's classes;
  * both demos on one PLY: the JAX demo at its PRNGKey(0) init, the port's
    at those weights converted into its checkpoint format. The written
    points are equal and their colours (the NYU40 label's palette row) equal
    on at least 99% of the points: both run the convs in bf16, and a label
    flips where two logits lie within the rounding of the order of the sums;
  * both demos refuse a CRF variant and a sparse ResNet, writing nothing."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seggroup_tpu.models as JR
from cli import demo_semantic as JD
from seggroup_tpu.data.ply import read_ply
from seggroup_tpu.data.voxel_dataset import make_voxel_batch
from seggroup_tpu.models import crf as JC
from seggroup_tpu.models import minkunet as J
from seggroup_tpu.models import resnet_sparse as JS
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch import models as TR
from seggroup_tpu_torch.cli import demo_semantic as TD
from seggroup_tpu_torch.data.ply import write_ply
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import kpconv as TK
from seggroup_tpu_torch.models import pointgroup as TP
from seggroup_tpu_torch.models import resnet_sparse as TS
from seggroup_tpu_torch.models import seggroup as TG
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

NARROW = dict(init_dim=8)
FAMILIES = {
    # name: (narrow widths, the JAX module at them)
    "Res16UNet14A": (dict(planes=(8,) * 8),
                     lambda kw: J.MinkUNet(**{**J.VARIANTS["Res16UNet14A"], **kw})),
    "STResTesseract16UNet18A": (dict(planes=(8,) * 8),
                                lambda kw: J.MinkUNet(**{**J.ST_VARIANTS[
                                    "STResTesseract16UNet18A"], **kw})),
    "ResUNet18INBN": (dict(planes=(8,) * 7),
                      lambda kw: J.ResUNet(**{**J.RESUNET_VARIANTS["ResUNet18INBN"], **kw})),
    "STResUNet14": (dict(planes=(8,) * 7),
                    lambda kw: J.ResUNet(**{**J.ST_RESUNET_VARIANTS["STResUNet14"], **kw})),
    "MinkUNetHyper14INBN": (dict(planes=(8,) * 7),
                            lambda kw: J.make_hyper("MinkUNetHyper14INBN", **kw)),
    "ResNet14": (dict(planes=(8,) * 4), lambda kw: JS.make_sparse_resnet("ResNet14", **kw)),
    "STResTesseractNet14": (dict(planes=(8,) * 4),
                            lambda kw: JS.make_sparse_resnet("STResTesseractNet14", **kw)),
    "BilateralCRF-Res16UNet14A": (dict(planes=(8,) * 8), lambda kw: JC.CRFWrapped(
        backbone=J.MinkUNet(**{**J.VARIANTS["Res16UNet14A"], **kw}))),
    "TrilateralCRF-Res16UNet14A": (dict(planes=(8,) * 8), lambda kw: JC.CRFWrapped(
        backbone=J.MinkUNet(**{**J.VARIANTS["Res16UNet14A"], **kw}), temporal=True)),
}


def test_registry_names_equal_jax():
    assert TR.model_names() == sorted(JR._REGISTRY)
    with pytest.raises(KeyError):
        TR.get_model("Res16UNet15")


def _zeros_tree(jmodel, st5: bool, crf: bool):
    """The JAX model's variables at zero, shaped by eval_shape (nothing
    compiles)."""
    m, cols = 64, 5 if st5 else 4
    coords = np.zeros((m, cols), np.int32)
    coords[:, 1:4] = np.arange(m)[:, None] % 4
    js = JST(jnp.asarray(coords), jnp.zeros((m, 3)), jnp.ones(m, bool), jnp.int32(m))
    args = (js, jnp.zeros((m, 3))) if crf else (js,)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, *args, train=False),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_registry_model_loads_jax_tree_strictly(name):
    widths, jmake = FAMILIES[name]
    kw = {**NARROW, **widths}
    variables = _zeros_tree(jmake(kw), st5=name.startswith("ST"), crf="CRF" in name)
    port = TR.get_model(name, device="cpu", **kw)
    sd = minkunet_params_from_flax(variables)
    port.load_state_dict(sd, strict=True)
    assert sum(v.numel() for v in sd.values()) == sum(
        x.size for x in jax.tree.leaves(variables))
    if "CRF" in name:
        assert port.crf.kernel.shape == ((15 if "Tri" in name else 13), 20, 20)


def test_registry_builds_the_other_models():
    for name, cls, kw in (("seggroup_gnn", TG.SegGroupGNN, {}),
                          ("pointgroup", TP.PointGroup, dict(m=8)),
                          ("kpfcnn", TK.KPFCNN, dict(first_features_dim=16)),
                          ("kpcnn", TS.KPCNN, dict(first_features_dim=16)),
                          ("kpcnn_kp", TK.KPCNN, dict(first_features_dim=16))):
        assert type(TR.get_model(name, device="cpu", **kw)) is cls, name


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """A 6,000-point synthetic room as a PLY, with colours."""
    scene = make_synthetic_scene(seed=3, num_points=6000)
    pts = scene.points[:, :3].astype(np.float32)
    rgb = np.clip((scene.points[:, 3:6] + 1.0) * 127.5, 0, 255).astype(np.uint8)
    path = tmp_path_factory.mktemp("demo") / "scene.ply"
    write_ply(str(path), {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                          "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
    return path


def _jax_demo(args, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["demo_semantic", *args])
    JD.main()


def test_port_demo_writes_the_jax_demos_labels(cloud, tmp_path, monkeypatch, capsys):
    variant, cap = "Res16UNet14A", 4096
    common = ["--ply", str(cloud), "--variant", variant, "--capacity", str(cap)]
    _jax_demo(common + ["--out", str(tmp_path / "jax.ply")], monkeypatch)

    # the JAX demo's weights: its model.init at PRNGKey(0) (the init draws
    # depend on the shapes alone)
    coords, colors = JD.load_ply_points(str(cloud))
    vb = make_voxel_batch([(coords, colors, np.full(len(coords), 255, np.int32))], cap, 0.02)
    st = JST(jnp.asarray(vb.coords), jnp.asarray(vb.feats), jnp.asarray(vb.valid),
             jnp.asarray(vb.num))
    model = JR.get_model(variant, out_channels=20,
                         level_caps=[cap, cap // 2, cap // 4, cap // 8, cap // 8])
    variables = jax.jit(lambda r, s: model.init(r, s, train=False))(jax.random.PRNGKey(0), st)
    ckpt = tmp_path / "checkpoints" / "exp" / "minkunet"
    CheckpointManager(ckpt).save(1, {"model": minkunet_params_from_flax(
        jax.tree.map(np.asarray, variables))})
    pts, lab = TD.main(common + ["--out", str(tmp_path / "port.ply"), "--checkpoint_dir",
                                 str(ckpt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {ckpt}" in out
    assert f"wrote {tmp_path / 'port.ply'}: {len(pts)} points, top classes [nyu40:" in out

    want = read_ply(str(tmp_path / "jax.ply"))["vertex"]
    got = read_ply(str(tmp_path / "port.ply"))["vertex"]
    assert len(got) == len(want) == int((vb.point2voxel[0] >= 0).sum())
    for axis in "xyz":
        np.testing.assert_array_equal(got[axis], want[axis])
    rgb = lambda v: np.stack([v["red"], v["green"], v["blue"]], 1)  # noqa: E731
    agree = (rgb(got) == rgb(want)).all(1).mean()
    assert agree >= 0.99, agree
    assert len(np.unique(lab)) > 1


@pytest.mark.parametrize("variant", ["BilateralCRF-Res16UNet14A", "ResNet14"])
def test_both_demos_refuse(cloud, tmp_path, monkeypatch, variant):
    args = ["--ply", str(cloud), "--variant", variant, "--capacity", "2048"]
    with pytest.raises(TypeError):  # CRFWrapped needs colours; SparseResNet takes no stem size
        _jax_demo(args + ["--out", str(tmp_path / "jax.ply")], monkeypatch)
    with pytest.raises(SystemExit):
        TD.main(args + ["--out", str(tmp_path / "port.ply"), "--device", "cpu"])
    assert not any(tmp_path.glob("*.ply"))
