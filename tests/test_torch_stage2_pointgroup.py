"""The port's PointGroup evaluation CLI
(seggroup_tpu_torch.cli.stage2_test_pointgroup) on the CPU at a small cap:
the host batch equals the JAX package's, the CLI runs on synthetic
scenes, writes the benchmark's dump layout and restores a checkpoint, and
on a model whose heads are set by hand it keeps the right proposals."""

import os

import numpy as np
import pytest
import torch

from cli import stage2_pointgroup_common as J
from seggroup_tpu.data.synthetic import make_synthetic_scene as j_scene
from seggroup_tpu_torch.cli import stage2_pointgroup_common as T
from seggroup_tpu_torch.cli import stage2_test_pointgroup as pg_cli
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models.pointgroup import PointGroup
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

SMALL = ["--point_cap", "4096", "--voxel_cap", "4096", "--m", "8", "--device", "cpu"]


@pytest.mark.parametrize("n_cap,kwargs", [(8192, {}), (3000, {}),
                                          (4096, dict(max_points_per_scene=1500))])
def test_host_batch_equals_jax_package(n_cap, kwargs):
    """Two scenes, under and over the point budget (the spatial crop),
    through both packages' make_pg_batch: every field equal."""
    tuples_j = [J.scene_instance_tuple(j_scene(seed=s, num_points=2500), {}, None, "")
                for s in (0, 1)]
    tuples_t = [T.scene_instance_tuple(make_synthetic_scene(seed=s, num_points=2500), {}, None,
                                       "") for s in (0, 1)]
    for a, b in zip(tuples_j, tuples_t):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    want = J.make_pg_batch(tuples_j, n_cap, 16, **kwargs)
    got = T.make_pg_batch(tuples_t, n_cap, 16, **kwargs)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.valid.sum() <= n_cap and got.instance_pointnum.sum() > 0
    assert T.VALID_CLASS_IDS == J.VALID_CLASS_IDS
    np.testing.assert_array_equal(T.NYU40_TO_20, J.NYU40_TO_20)


def test_cli_runs_and_writes_the_dump_layout(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    aps, avg = pg_cli.main(["--synthetic", "2", "--dump_dir", "dump", *SMALL])
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint, random weights" in out
    assert "[2/2] synthetic0001:" in out and "AP " in out
    assert aps.shape == (18, 10) and set(avg) == {"all_ap", "all_ap_50%", "all_ap_25%",
                                                  "classes"}
    assert (tmp_path / "checkpoints" / "exp" / "pg_test.log").read_text().count("\n") >= 4
    for name in ("synthetic0000", "synthetic0001"):
        assert (tmp_path / "dump" / "instance" / f"{name}.txt").exists()
        sem = np.loadtxt(tmp_path / "dump" / "semantic" / f"{name}.txt", dtype=np.int64)
        assert sem.shape == (4096,) and np.isin(sem, T.VALID_CLASS_IDS).all()
    assert (tmp_path / "dump" / "instance" / "predicted_masks").is_dir()


def test_cli_restores_a_checkpoint(tmp_path, monkeypatch, capsys):
    """A checkpoint whose semantic head always answers class 5: the CLI
    loads it (the log says so) and every dumped prediction is that class."""
    monkeypatch.chdir(tmp_path)
    model = pg_cli.make_eval_model(8, 4096, "cpu", seed=1)
    with torch.no_grad():
        model.linear.weight.zero_()
        model.linear.bias.copy_(torch.nn.functional.one_hot(torch.tensor(5), 20).float())
    CheckpointManager(tmp_path / "checkpoints" / "run" / "pointgroup").save(
        7, {"model": model.state_dict()})
    pg_cli.main(["--synthetic", "1", "--exp_name", "run", "--dump_dir", "dump", *SMALL])
    assert "loaded checkpoint step 7" in capsys.readouterr().out
    sem = np.loadtxt(tmp_path / "dump" / "semantic" / "synthetic0000.txt", dtype=np.int64)
    assert (sem == T.VALID_CLASS_IDS[5]).all()


def _blob_scene(seed, n_blobs=4, per=400, sem=6):
    """Dense, well separated blobs of one class (nyu40 `sem`), one instance
    each."""
    rng = np.random.default_rng(seed)
    centers = np.stack(np.unravel_index(np.arange(n_blobs), (2, 2, 2)), 1) * 2.0
    coords = (centers[:, None] + rng.normal(scale=0.04, size=(n_blobs, per, 3))).reshape(-1, 3)
    ins = np.repeat(np.arange(1, n_blobs + 1), per).astype(np.int32)
    colors = rng.uniform(0, 255, size=(len(coords), 3)).astype(np.float32)
    return (f"blobs{seed}", coords.astype(np.float32), colors,
            np.full(len(coords), sem, np.int32), ins)


def test_hand_set_heads_give_perfect_instances(tmp_path):
    """Heads set by hand: every point is class 5 (nyu40 id 6, the scene's
    true class), the offsets are zero and every proposal scores 0.88. The
    clustering then finds each blob twice (original and shifted
    coordinates), NMS keeps one of each pair, and AP is 1 for that class."""
    model = PointGroup(classes=20, m=8, score_cap=2048, level_caps=[2048 >> i for i in range(7)],
                       seed=0, device="cpu")
    with torch.no_grad():
        model.linear.weight.zero_()
        model.linear.bias.copy_(torch.nn.functional.one_hot(torch.tensor(5), 20).float())
        model.offset_linear.weight.zero_()
        model.score_linear.weight.zero_()
        model.score_linear.bias.fill_(2.0)
    # one scene: the evaluator (the JAX package's too) names predictions by
    # their index within a scene, so two scenes' predictions share names
    scenes = [_blob_scene(0)]
    phases, log = {}, []
    aps, avg = pg_cli.test_instance_pointgroup(
        model, scenes, point_cap=2048, voxel_cap=2048, dump_dir=str(tmp_path),
        phase_seconds=phases, scene_log=log)
    assert [rec["proposals"] for rec in log] == [8]
    assert [rec["kept"] for rec in log] == [4]
    assert all(rec["finite"] and rec["points"] == 1600 for rec in log)
    sofa = T.VALID_CLASS_IDS.index(6) - 2  # the evaluator's classes start at cabinet
    assert np.nanmax(aps) == 1.0 and (aps[sofa] == 1.0).all()
    assert avg["all_ap"] == 1.0 and avg["classes"]["sofa"]["ap"] == 1.0
    assert {"host batch", "voxelize", "unet", "clustering", "scorenet",
            "proposals to AP"} <= set(phases)
    lines = (tmp_path / "instance" / "blobs0.txt").read_text().splitlines()
    assert len(lines) == 4 and all(line.split()[1:] == ["6", "0.8808"] for line in lines)
    masks = [np.loadtxt(tmp_path / "instance" / line.split()[0], dtype=np.int64)
             for line in lines]
    # each mask is one blob's core (its fringe lies beyond the radius)
    assert all(350 <= int(m.sum()) <= 400 for m in masks)
    assert (np.sum(masks, 0) <= 1).all()
    ins = scenes[0][4]
    assert sorted(int(np.bincount(ins[m == 1]).argmax()) for m in masks) == [1, 2, 3, 4]


def test_synthetic_only():
    with pytest.raises(NotImplementedError, match="synthetic"):
        pg_cli.main(SMALL)
