"""The port's stage-2 semantic evaluation CLI (MinkUNet branch) against
the JAX CLI's own per-scene computation (cli/stage2_test_semantic.py:
89-117, rebuilt here from JAX functions), on 2 small synthetic scenes with
Res16UNet14A at converted JAX weights, on the CPU. The capacity (3,072
voxels for about 4,060) binds, so points over capacity are excluded on both
sides. Per-point predictions must agree on at least 99% of points (the
logits agree to bf16 summation order; measured: all points)."""

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


def test_main_runs_on_cpu(capsys):
    miou, _, _ = S2.main(["--synthetic", "1", "--device", "cpu", "--variant",
                          "Res16UNet14A", "--capacity", "4096"])
    out = capsys.readouterr().out
    assert "WARNING: random weights" in out and "mIoU:" in out
    assert np.isfinite(miou) or np.isnan(miou)

