"""The port's drivers with `--num_devices 2 --device cpu` (2 gloo ranks,
started by the drivers themselves):

  * stage1_infer writes the same files, byte for byte, at 1 and 2 ranks
    (3 prepared scenes of 1,024 points: rank 1's second scene is the
    wrapped tail, which it neither runs nor exports), also where the 2
    ranks run at a --knn_window of 16, which sends every scene to an
    auto-caps retry (rank 0 retries two scenes, rank 1 one);
  * a 2-rank stage2_train_minkunet run of 2 iterations resumed to 4 ends
    with the checkpoint of an unbroken 2-rank 4-iteration run, bit for bit
    (one thread a rank);
  * more ranks than visible cards raise."""

import filecmp
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from seggroup_tpu_torch.cli import stage1_infer as S1I
from seggroup_tpu_torch.cli import stage2_train_minkunet as TM
from seggroup_tpu_torch.data.scannet import SCENE_KEYS, save_scene_npz
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.parallel import dp
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

DIST = ["--device", "cpu", "--dist_timeout", "60"]
INFER = ["--data_root", "prepared", "--ins_infer", "--cluster_cap", "256", *DIST]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """3 prepared scenes, and the files stage1_infer exports from them at
    1 rank (under res1/exp)."""
    root = tmp_path_factory.mktemp("infer")
    scenes = root / "prepared" / "manual"
    scenes.mkdir(parents=True)
    for i in range(3):
        scene = make_synthetic_scene(seed=i, num_points=1024, num_slots=32, num_edges=128,
                                     num_instances=3, segs_per_instance=3)
        save_scene_npz(str(scenes / f"scene000{i}_00.npz"), dict(zip(SCENE_KEYS, scene)))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        S1I.main([*INFER, "--knn_window", "8192", "--num_devices", "1", "--results_root", "res1"])
    return root


@pytest.mark.parametrize("knn_window", ["8192", "16"])
def test_stage1_infer_exports_the_same_bytes(one_rank, monkeypatch, knn_window):
    """At --knn_window 16 every scene's clusters outgrow the window, so each
    is run again at 8192: what a single rank exports then is what it
    exports at 8192 directly, the files compared with here."""
    monkeypatch.chdir(one_rank)
    exp = f"w{knn_window}"
    S1I.main([*INFER, "--knn_window", knn_window, "--num_devices", "2", "--results_root", "res2",
              "--exp_name", exp])
    one, two = one_rank / "res1" / "exp", one_rank / "res2" / exp
    files = sorted(p.relative_to(one) for p in one.rglob("*.txt"))
    assert len(files) == 3 * 15  # final and 4 layers x (seg, sem, ins) a scene
    assert sorted(p.relative_to(two) for p in two.rglob("*.txt")) == files
    for f in files:
        assert filecmp.cmp(one / f, two / f, shallow=False), f
    log = (one_rank / "checkpoints" / exp / "infer.log").read_text()
    assert "all 2 ranks (0003/0003)" in log
    # rank 0, which alone logs, retries its two scenes (rank 1 its one)
    assert log.count("re-running @ 8192") == (0 if knn_window == "8192" else 2)


# StepLR: a schedule that does not depend on --max_iter, which the two legs
# of the resumed run set differently
MK = ["--synthetic", "2", "--model", "Res16UNet14A", "--capacity", "512", "--batch_size", "1",
      "--val_freq", "2", "--scheduler", "StepLR", "--num_devices", "2", *DIST]


def test_minkunet_resume_equals_an_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def resumed():
        TM.main([*MK, "--exp_name", "b", "--max_iter", "2"])
        return TM.main([*MK, "--exp_name", "b", "--max_iter", "4", "--resume"])

    with ThreadPoolExecutor(2) as pool:  # the two runs side by side
        unbroken = pool.submit(TM.main, [*MK, "--exp_name", "a", "--max_iter", "4"])
        assert resumed()[0] == 4 and unbroken.result()[0] == 4
    a = CheckpointManager(tmp_path / "checkpoints/a/minkunet").restore(4)
    b = CheckpointManager(tmp_path / "checkpoints/b/minkunet").restore(4)
    assert b["scheduler"] == a["scheduler"] == {"count": 4}
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    log = (tmp_path / "checkpoints/b/minkunet.log").read_text()
    assert "data parallel over 2 devices" in log and "resumed from iter 2" in log


def test_more_ranks_than_cards_raise():
    """More ranks than visible cards raise (the JAX make_mesh takes fewer
    devices without a word); None is every card, 1 on the CPU; without a
    coordinator initialize_multihost does nothing, as the JAX one."""
    with pytest.raises(ValueError, match="cards are visible"):
        dp.resolve_num_devices(torch.cuda.device_count() + 1, "cuda")
    assert dp.resolve_num_devices(None, "cpu") == 1
    assert dp.resolve_num_devices(3, "cpu") == 3
    assert dp.initialize_multihost() is None
    assert not torch.distributed.is_initialized()
