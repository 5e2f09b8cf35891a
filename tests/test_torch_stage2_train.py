"""The port's stage-2 MinkUNet training driver
(seggroup_tpu_torch.cli.stage2_train_minkunet) end to end on the CPU, at a
small size (Res16UNet14A, 4,096 voxels, 2 synthetic scenes): it writes the
log, the run configuration, the checkpoint and the best checkpoint;
`--resume` continues the iteration counter and the schedule; `--weights`
starts a new run from a checkpoint's matching tensors; the STOP file stops
it after a save; and the evaluation driver restores the trained weights
from the checkpoint."""

import json

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.cli import stage2_test_semantic as S2T
from seggroup_tpu_torch.cli import stage2_train_minkunet as S2
from seggroup_tpu_torch.cli.stage2_common import scene_to_training_tuple
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models.minkunet import make_minkunet
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

ARGS = ["--synthetic", "2", "--val_freq", "2", "--model", "Res16UNet14A",
        "--capacity", "4096", "--batch_size", "2", "--device", "cpu",
        "--prefetch_workers", "1", "--exp_name", "t"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two iterations, then two more with --resume, in one directory."""
    root = tmp_path_factory.mktemp("train")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        first = S2.main(ARGS + ["--max_iter", "2"])
        log_first = (root / "checkpoints/t/minkunet.log").read_text()
        second = S2.main(ARGS + ["--max_iter", "4", "--resume"])
    return root, first, second, log_first


def test_driver_writes_log_checkpoints_and_config(trained):
    root, (it, best), _, log = trained
    assert it == 2 and best >= 0.0
    assert "Network parameters" in log and "iter 2/2  loss" in log
    assert "==> saved iter 2  val mIoU" in log and "(new best)" in log
    cfg = json.loads((root / "checkpoints/t/stage2_minkunet.config.json").read_text())
    assert cfg["model"] == "Res16UNet14A" and cfg["device"] == "cpu"
    state = CheckpointManager(root / "checkpoints/t/minkunet").restore(2)
    assert set(state) == {"model", "optimizer", "scheduler"}
    assert state["scheduler"] == {"count": 2}
    assert 2 in CheckpointManager(root / "checkpoints/t/minkunet_best").steps()


def test_resume_continues_the_counter(trained):
    root, _, (it, _), _ = trained
    assert it == 4
    log = (root / "checkpoints/t/minkunet.log").read_text()
    assert "resumed from iter 2" in log and "iter 4/4  loss" in log
    ckpt = CheckpointManager(root / "checkpoints/t/minkunet", pow2_retention=True)
    assert ckpt.steps() == [2, 4]
    assert ckpt.restore()["scheduler"] == {"count": 4}


def test_stop_file_saves_and_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "checkpoints/t").mkdir(parents=True)
    (tmp_path / "checkpoints/t/STOP").touch()
    it, _ = S2.main(ARGS + ["--max_iter", "50"])
    assert it == 1
    assert CheckpointManager(tmp_path / "checkpoints/t/minkunet").steps() == [1]
    assert "STOP file found" in (tmp_path / "checkpoints/t/minkunet.log").read_text()


def test_weights_initialise_a_new_run(trained, monkeypatch):
    """--weights loads every tensor whose name and shape match, and keeps
    the fresh values of the rest (here: a head of another width)."""
    root, *_ = trained
    monkeypatch.chdir(root)
    src = str(root / "checkpoints/t/minkunet")
    S2.main([a if a != "t" else "w" for a in ARGS] + ["--max_iter", "1", "--weights", src])
    log = (root / "checkpoints/w/minkunet.log").read_text()
    n = len(make_minkunet("Res16UNet14A", device="cpu").state_dict())
    assert f"lenient init: {n}/{n} tensors" in log
    S2.main([a if a != "t" else "v" for a in ARGS]
            + ["--max_iter", "1", "--weights", src, "--num_classes", "13"])
    log = (root / "checkpoints/v/minkunet.log").read_text()
    assert f"lenient init: {n - 2}/{n} tensors" in log
    assert "keeping fresh init for final.weight" in log


def test_driver_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """More ranks than visible cards are refused (data parallelism itself
    runs: tests/test_torch_parallel_drivers.py); prepared npz scenes
    (--synthetic 0, data/scannet.py) are ported now and train."""
    from seggroup_tpu_torch.data.scannet import SCENE_KEYS, save_scene_npz

    monkeypatch.chdir(tmp_path)
    on_cards = [a if a != "cpu" else "cuda" for a in ARGS]
    with pytest.raises(ValueError, match="cards are visible"):
        S2.main(on_cards + ["--max_iter", "1",
                            "--num_devices", str(torch.cuda.device_count() + 1)])
    assert not (tmp_path / "checkpoints").exists()
    root = tmp_path / "prepared" / "manual"
    root.mkdir(parents=True)
    for i in range(2):
        save_scene_npz(str(root / f"scene000{i}_00.npz"),
                       dict(zip(SCENE_KEYS, make_synthetic_scene(seed=i))))
    prepared = ARGS[:1] + ["0"] + ARGS[2:]  # --synthetic 0
    it, _ = S2.main(prepared + ["--max_iter", "1", "--data_root", str(tmp_path / "prepared")])
    assert it == 1
    assert CheckpointManager(tmp_path / "checkpoints" / "t" / "minkunet").latest_step() == 1


def test_evaluation_restores_the_trained_model(trained, capsys, monkeypatch):
    """The evaluation driver scores with the checkpoint's weights: its
    predictions equal those of the model loaded from the checkpoint, and
    not those of the random-weight model it would build otherwise."""
    root, *_ = trained
    monkeypatch.chdir(root)
    S2T.main(["--synthetic", "1", "--device", "cpu", "--variant", "Res16UNet14A",
              "--capacity", "4096", "--exp_name", "t", "--dump_dir", "dump"])
    assert "loaded checkpoint 4" in capsys.readouterr().out
    got = np.loadtxt(root / "dump/synthetic0000.txt", dtype=np.int64)

    caps = S2T.level_caps(4096)
    scene = ("synthetic0000", *scene_to_training_tuple(make_synthetic_scene(seed=0), {},
                                                        None, "synthetic0000", False))
    trained_model = make_minkunet("Res16UNet14A", level_caps=caps, device="cpu")
    trained_model.load_state_dict(
        CheckpointManager(root / "checkpoints/t/minkunet").restore()["model"])
    random_model = make_minkunet("Res16UNet14A", level_caps=caps, device="cpu")
    preds = {}
    for name, model in (("trained", trained_model), ("random", random_model)):
        S2T.test_semantic_minkunet(model, [scene], 4096, 0.02, 20, dump_dir=str(root / name))
        preds[name] = np.loadtxt(root / name / "synthetic0000.txt", dtype=np.int64)
    np.testing.assert_array_equal(got, preds["trained"])
    assert (got != preds["random"]).any()
