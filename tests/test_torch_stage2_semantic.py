"""The port's stage-2 semantic evaluation CLI against the JAX CLI, on the
CPU.

First its MinkUNet scoring loop against the JAX CLI's own per-scene
computation (cli/stage2_test_semantic.py:89-117, rebuilt here from JAX
functions), on 2 small synthetic scenes with Res16UNet14A at converted JAX
weights. The capacity (3,072 voxels for about 4,060) binds, so points over
capacity are excluded on both sides. Per-point predictions must agree on
at least 99% of points (the logits agree to bf16 summation order;
measured: all points).

Then both drivers end to end, both models, on the same two prepared npz
scenes written by the JAX package, each restoring a checkpoint: the JAX
driver its flax variables (random running statistics, nonzero deformable
offsets), the port's driver the same variables converted. mIoU within
0.01, per-class AP within 1e-2 (the JAX log prints them to 1e-4), the
dumped predictions equal on at least 99% of points, and the log in
checkpoints/<exp>/<model>_test.log."""

import re
import sys

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.data.synthetic import make_synthetic_scene as jax_scene
from seggroup_tpu.data.voxel_dataset import make_voxel_batch as jax_voxel_batch
from seggroup_tpu.eval.semantic import average_precision, miou_from_confusion
from seggroup_tpu.models.minkunet import make_minkunet as jax_minkunet
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch.cli import stage2_test_semantic as S2
from seggroup_tpu_torch.cli.stage2_common import VALID_CLASS_IDS, scene_to_training_tuple
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.models.minkunet import make_minkunet

torch.set_num_threads(1)

CAPACITY, VOXEL, C = 3072, 0.02, 20


def _scenes():
    out = []
    for i in range(2):
        name = f"synthetic{i:04d}"
        out.append((name, *scene_to_training_tuple(make_synthetic_scene(seed=i), {}, None,
                                                    name, False)))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX CLI's MinkUNet loop: variables, per-scene point
    predictions (nyu40 ids, as its --dump_dir writes them), dropped counts,
    and the resulting mIoU and per-class AP."""
    model = jax_minkunet("Res16UNet14A", out_channels=C, level_caps=S2.level_caps(CAPACITY))
    fwd = jax.jit(lambda v, st: model.apply(v, st, train=False))
    nyu40_of = np.array(VALID_CLASS_IDS, np.int64)
    hist = np.zeros((C, C), np.int64)
    variables, preds, dropped, aps = None, {}, {}, []
    for i, (name, c, col, lab) in enumerate(_scenes()):
        # the JAX package's own scene conversion agrees with the port's copy
        jsc = jax_scene(seed=i, jax_arrays=False)
        np.testing.assert_array_equal(np.asarray(jsc.real_sem), make_synthetic_scene(seed=i).real_sem)
        vb = jax_voxel_batch([(c, col, lab)], CAPACITY, VOXEL)
        st = JST(jnp.asarray(vb.coords), jnp.asarray(vb.feats), jnp.asarray(vb.valid),
                 jnp.asarray(vb.num))
        if variables is None:
            variables = jax.tree.map(np.asarray, jax.jit(
                lambda r, s: model.init(r, s, train=False))(jax.random.PRNGKey(0), st))
        logits = np.asarray(fwd(variables, st))
        p2v = vb.point2voxel[0]
        lab_pts = lab[: len(p2v)]
        ok = (lab_pts != 255) & (p2v >= 0)
        pred_pts = logits.argmax(1)[np.where(p2v >= 0, p2v, 0)]
        np.add.at(hist, (lab_pts[ok], pred_pts[ok]), 1)
        sm = np.exp(logits - logits.max(1, keepdims=True))
        sm /= sm.sum(1, keepdims=True)
        probs_pts = sm[np.where(p2v >= 0, p2v, 0)]
        aps.append(average_precision(probs_pts[ok], lab_pts[ok], C))
        preds[name] = nyu40_of[probs_pts.argmax(1)]
        dropped[name] = int((p2v < 0).sum())
    with warnings.catch_warnings():  # classes absent from both scenes
        warnings.simplefilter("ignore", category=RuntimeWarning)
        ap_class = np.nanmean(np.stack(aps), 0)
    return variables, preds, dropped, miou_from_confusion(hist)[0], ap_class


def test_evaluation_matches_jax_per_point(jax_run, tmp_path):
    variables, want, dropped, miou_jax, ap_jax = jax_run
    model = make_minkunet("Res16UNet14A", out_channels=C, level_caps=S2.level_caps(CAPACITY),
                          device="cpu")
    model.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    log, phases = [], {}
    miou, per_class, ap_class = S2.test_semantic_minkunet(
        model, _scenes(), CAPACITY, VOXEL, C, dump_dir=str(tmp_path),
        phase_seconds=phases, scene_log=log)
    assert np.isfinite(miou) and abs(miou - miou_jax) < 0.01
    assert per_class.shape == ap_class.shape == (C,)
    # softmax rounds in torch, not numpy: near-tied scores may swap ranks
    np.testing.assert_allclose(ap_class, ap_jax, atol=1e-2, equal_nan=True)
    for rec in log:
        got = np.loadtxt(tmp_path / f"{rec['name']}.txt", dtype=np.int64)
        assert got.shape == want[rec["name"]].shape
        assert (got == want[rec["name"]]).mean() >= 0.99
        assert rec["dropped"] == dropped[rec["name"]] > 0
        assert rec["logits_finite"] and rec["padding_zero"]
    assert set(phases) >= {"voxelize", "forward", "score", "rulebooks", "subm_conv"}


def test_main_runs_on_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    miou, _, _ = S2.main(["--synthetic", "1", "--device", "cpu", "--variant",
                          "Res16UNet14A", "--capacity", "4096"])
    out = capsys.readouterr().out
    assert "WARNING: random weights" in out and "mIoU:" in out
    assert np.isfinite(miou) or np.isnan(miou)
    assert "mIoU:" in (tmp_path / "checkpoints/exp/minkunet_test.log").read_text()


# both drivers on prepared scenes: KPConv at a small width and sphere cap,
# with a coarser first cell and spheres as wide as the room (the synthetic
# rooms are 10 m wide and sparse; the JAX driver takes a second a sphere here)
KP_ARGS = ["--point_cap", "384", "--first_features_dim", "16", "--dl0", "0.2",
           "--in_radius", "10.0", "--votes", "1"]
MK_ARGS = ["--variant", "Res16UNet14A", "--capacity", str(CAPACITY)]


def _kpconv_variables():
    """Flax KPFCNN variables at the KP_ARGS sizes: the port's seeded init
    laid out as the flax tree (Dense kernels (in, out), the rest as they
    are; `mean`/`var` under batch_stats), offset kernels and running
    statistics randomised. The tree the JAX driver restores must have
    every variable the flax KPFCNN asks for, so it checks the layout too."""
    from seggroup_tpu_torch.models.kpconv import KPFCNN

    rng = np.random.default_rng(0)
    tree = {"params": {}, "batch_stats": {}}
    state = KPFCNN(num_classes=C, first_features_dim=16, dl0=0.2, seed=1,
                   device="cpu").state_dict()
    for key, value in state.items():
        *path, leaf = key.split(".")
        x = value.numpy()
        if leaf == "weight":
            leaf, x = "kernel", x.T
        elif leaf == "offset_kernel":
            x = (rng.normal(size=x.shape) * 0.05).astype(np.float32)
        elif leaf == "var":
            x = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif leaf == "mean":
            x = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(x)
    return tree


def _jax_scores(log: str):
    """mIoU and per-class AP (fractions) from the JAX driver's log."""
    miou = float(re.search(r"mIoU: ([\d.]+)%", log).group(1)) / 100
    ap = [float(m) / 100 if m != "nan" else np.nan
          for m in re.findall(r"^  .{16} +\S+% +(\S+)%$", log, flags=re.M)]
    return miou, np.array(ap)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory, jax_run):
    """Two npz scenes written by the JAX package; the JAX driver run on
    them for both models from JAX checkpoints; the port's checkpoints of the
    same weights. Returns (root, {model: (JAX log, JAX dump dir)}, the
    port's run directory)."""
    from cli import stage2_test_semantic as JCLI
    from seggroup_tpu.data.scannet import SCENE_KEYS, save_scene_npz
    from seggroup_tpu.utils import jit_cache
    from seggroup_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
    from seggroup_tpu_torch.models.convert import kpconv_params_from_flax
    from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("prepared_eval")
    data = root / "prepared" / "manual"
    data.mkdir(parents=True)
    for i in range(2):
        save_scene_npz(str(data / f"scene000{i}_00.npz"),
                       dict(zip(SCENE_KEYS, jax_scene(seed=i, jax_arrays=False))))
    variables = {"minkunet": jax_run[0], "kpconv": _kpconv_variables()}
    convert = {"minkunet": minkunet_params_from_flax, "kpconv": kpconv_params_from_flax}
    jax_dir, port_dir = root / "jax", root / "port"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX driver's persistent compilation cache stays off in tests
        mp.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
        for name, v in variables.items():
            JaxCkpt(str(jax_dir / "checkpoints" / "t" / name)).save(1, v)
            CheckpointManager(port_dir / "checkpoints" / "t" / name).save(
                1, {"model": convert[name](v)})
            extra = KP_ARGS if name == "kpconv" else MK_ARGS
            mp.chdir(jax_dir)
            mp.setattr(sys, "argv", ["stage2_test_semantic", "--model", name, "--exp_name", "t",
                                     "--data_root", str(root / "prepared"),
                                     "--dump_dir", f"dump_{name}", *extra])
            JCLI.main()
            out[name] = ((jax_dir / "checkpoints" / "t" / f"{name}_test.log").read_text(),
                         jax_dir / f"dump_{name}")
    return root, out, port_dir


@pytest.mark.parametrize("name", ["minkunet", "kpconv"])
def test_driver_matches_jax_on_prepared_scenes(name, prepared, monkeypatch):
    root, jax_out, port_dir = prepared
    jax_log, jax_dump = jax_out[name]
    assert "loaded checkpoint 1" in jax_log
    monkeypatch.chdir(port_dir)
    extra = KP_ARGS if name == "kpconv" else MK_ARGS
    miou, per_class, ap_class = S2.main(
        ["--model", name, "--exp_name", "t", "--data_root", str(root / "prepared"),
         "--device", "cpu", "--dump_dir", f"dump_{name}", *extra])
    log = (port_dir / "checkpoints" / "t" / f"{name}_test.log").read_text()
    assert "loaded checkpoint 1" in log and "mIoU:" in log
    # the per-scene lines (KPConv: the coverage, which the sphere cap keeps
    # under 100% here) as the JAX driver logs them
    scene_lines = [ln for ln in log.splitlines() if ln.startswith("[")]
    assert scene_lines == [ln for ln in jax_log.splitlines() if ln.startswith("[")]
    assert len(scene_lines) == 2
    miou_jax, ap_jax = _jax_scores(jax_log)
    assert np.isfinite(miou) and abs(miou - miou_jax) < 0.01
    assert ap_class.shape == ap_jax.shape == (C,)
    np.testing.assert_allclose(ap_class, ap_jax, atol=1e-2, equal_nan=True)
    for i in range(2):
        want = np.loadtxt(jax_dump / f"scene000{i}_00.txt", dtype=np.int64)
        got = np.loadtxt(port_dir / f"dump_{name}" / f"scene000{i}_00.txt", dtype=np.int64)
        assert got.shape == want.shape == (4096,)
        assert (got == want).mean() >= 0.99


def test_driver_refuses_data_parallelism(tmp_path, monkeypatch):
    """As the JAX driver, the evaluation takes `--num_devices` and runs on
    one device all the same: the same mIoU as without it."""
    monkeypatch.chdir(tmp_path)
    small = ["--synthetic", "1", "--device", "cpu", "--variant", "Res16UNet14A",
             "--capacity", "4096"]
    one, _, _ = S2.main(small)
    two, _, _ = S2.main(small + ["--num_devices", "2"])
    assert one == two or (np.isnan(one) and np.isnan(two))

