"""The port's stage-1 drivers and their host code against the JAX
package's, on the CPU: the prepared-scene reader (data/scannet.py) against
the JAX writer, the auto-cap buckets, the offline evaluator's eval_scene,
the label export with a prepared scene's `unmap`, and the whole chain
through the CLIs in subprocesses (train, resume, infer in both modes,
evaluate, then MinkUNet training on the exported pseudo labels), as
tests/test_e2e_two_stage.py runs the JAX drivers."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cli import stage1_common as JC
from cli.stage1_evaluate import eval_scene as jax_eval_scene
from seggroup_tpu.data import scannet as JD
from seggroup_tpu.data.synthetic import make_synthetic_scene as jax_scene
from seggroup_tpu.models.seggroup import Stage1Output as JaxStage1Output
from seggroup_tpu_torch.cli import stage1_common as TC
from seggroup_tpu_torch.cli import stage1_infer
from seggroup_tpu_torch.cli.stage1_evaluate import eval_scene
from seggroup_tpu_torch.data import scannet as TD
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.infer import export_labels_txt, export_scene
from seggroup_tpu_torch.models.seggroup import Stage1Output

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_points=1024, num_slots=32, num_edges=64, num_instances=4,
             segs_per_instance=4)


def _prepared(seed: int, n_verts: int = 1500) -> dict:
    """A scene as data/scannet.py:prepare_scene lays it out: the Scene
    fields and the host extras."""
    scene = jax_scene(seed=seed, jax_arrays=False, **SMALL)
    rng = np.random.default_rng(seed)
    n = SMALL["num_points"]
    out = {k: np.asarray(v) for k, v in zip(scene._fields, scene)}
    out.update(unmap=rng.integers(0, n, n_verts).astype(np.int32),
               mapping=rng.integers(0, n_verts, n).astype(np.int32),
               real_sem_raw=rng.integers(0, 41, n_verts).astype(np.int32),
               real_ins_raw=rng.integers(0, 9, n_verts).astype(np.int32))
    return out


def test_npz_reader_matches_jax_writer(tmp_path):
    root = tmp_path / "prepared" / "manual"
    root.mkdir(parents=True)
    for i, name in enumerate(["scene0002_00", "scene0000_01"]):
        JD.save_scene_npz(str(root / f"{name}.npz"), _prepared(i))
    want_ds, got_ds = JD.ScanNetScenes(str(root)), TD.ScanNetScenes(str(root))
    assert got_ds.scene_list == want_ds.scene_list == ["scene0000_01", "scene0002_00"]
    args = SimpleNamespace(synthetic=0, data_root=str(tmp_path / "prepared"),
                           label_style="manual")
    source = TC.SceneSource(args)
    assert source.names == JC.SceneSource(args).names and len(source) == 2
    for i in range(2):
        (want, want_x), (got, got_x) = want_ds[i], source.get(i)
        assert TD.SCENE_KEYS == tuple(want._fields)
        for name in TD.SCENE_KEYS:
            a, b = np.asarray(getattr(want, name)), getattr(got, name)
            assert b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        assert sorted(got_x) == sorted(want_x) == ["mapping", "real_ins_raw",
                                                   "real_sem_raw", "unmap"]
        for k in want_x:
            np.testing.assert_array_equal(got_x[k], want_x[k], err_msg=k)
        assert got.num_slots == SMALL["num_slots"]
    # the port's writer round-trips through the JAX reader as well
    TD.save_scene_npz(str(tmp_path / "x.npz"), _prepared(5))
    np.testing.assert_array_equal(JD.load_scene_npz(str(tmp_path / "x.npz"))[0].edges,
                                  _prepared(5)["edges"])


class _Scenes:
    """A source of synthetic scenes of the given (points, instances,
    segments per instance), made by `make`."""

    def __init__(self, make, shapes):
        self.scenes = [make(seed=i, num_points=n, num_slots=32, num_edges=64,
                            num_instances=k, segs_per_instance=m)
                       for i, (n, k, m) in enumerate(shapes)]
        self.names = [f"s{i}" for i in range(len(shapes))]

    def __len__(self):
        return len(self.scenes)

    def get(self, i):
        return self.scenes[i], {}


def test_auto_cap_buckets_match_jax():
    for minimum in (0, 64, 256, 1024, 3000, 20000):
        for size in (0, 1, 63, 64, 1000, 1024, 1025, 8192, 9000, 16384, 16385, 300000):
            for buckets in (TC.CLUSTER_CAP_BUCKETS, TC.KNN_WINDOW_BUCKETS):
                assert (TC.pick_bucket(size, buckets, minimum)
                        == JC.pick_bucket(size, buckets, minimum)), (size, minimum)
    assert TC.CLUSTER_CAP_BUCKETS == JC.CLUSTER_CAP_BUCKETS
    assert TC.KNN_WINDOW_BUCKETS == JC.KNN_WINDOW_BUCKETS
    # largest segments of about 64, 2,048, 5,000 and 20,000 points
    shapes = [(2048, 4, 8), (8192, 2, 2), (20000, 2, 2), (40000, 1, 2)]
    got_src = _Scenes(make_synthetic_scene, shapes)
    want_src = _Scenes(lambda **kw: jax_scene(jax_arrays=False, **kw), shapes)
    sizes = [TC.host_max_segment_size(sc) for sc in got_src.scenes]
    assert sizes == [JC.host_max_segment_size(sc) for sc in want_src.scenes]
    assert sizes[0] < 256 < 1024 < sizes[1] and sizes[-1] > max(TC.CLUSTER_CAP_BUCKETS)
    for minimum in (256, 1024, 4096):
        got = TC.group_scenes_by_cap(got_src, minimum)
        assert got == JC.group_scenes_by_cap(want_src, minimum), minimum
        assert sum(len(v) for v in got.values()) == len(shapes)


def test_eval_scene_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    n = 5000
    real_sem = rng.integers(0, 41, n).astype(np.int32)
    real_ins = rng.integers(0, 30, n).astype(np.int32)
    sem = np.where(rng.random(n) < 0.6, real_sem, rng.integers(-1, 41, n))
    ins = np.where(rng.random(n) < 0.6, real_ins, rng.integers(-1, 30, n))
    out_dir = str(tmp_path / "exp" / "scene0000_00" / "ins_infer")
    export_labels_txt(out_dir, "final.sem", sem)
    export_labels_txt(out_dir, "final.ins", ins)
    task = (str(tmp_path / "exp"), "scene0000_00", "ins_infer", "final", real_sem, real_ins)
    got, want = eval_scene(task), jax_eval_scene(task)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert float(np.sum(got[2])) > 0  # instances scored
    missing = task[:3] + ("layer_2",) + task[4:]
    assert eval_scene(missing) is None and jax_eval_scene(missing) is None


def _fake_output(rng, n: int) -> Stage1Output:
    def labels(*shape):
        return torch.from_numpy(rng.integers(-1, 41, shape).astype(np.int32))

    zero = torch.zeros(())
    return Stage1Output(zero, zero, torch.zeros(2, 40), torch.zeros(2, 40), torch.zeros(4),
                        labels(4, n), labels(n), labels(n), labels(n), labels(n), labels(n),
                        torch.tensor(9), torch.tensor(9), labels(4, n), labels(4, n))


@pytest.mark.parametrize("with_unmap", [True, False])
def test_export_scene_matches_jax(tmp_path, with_unmap):
    """The port's export writes the same bytes as the JAX driver's, with a
    prepared scene's `unmap` (labels at the mesh vertices) and without
    extras (a synthetic scene's labels at its points)."""
    rng = np.random.default_rng(1)
    out = _fake_output(rng, 700)
    extras = {"unmap": rng.integers(0, 700, 1100).astype(np.int32)} if with_unmap else {}
    export_scene(str(tmp_path / "port"), "scene", "ins_infer", out,
                 extras if with_unmap else None)
    batched = JaxStage1Output(*(np.asarray(t)[None] for t in out))
    JC.export_scene(str(tmp_path / "jax"), "scene", "ins_infer", batched, extras, 0)
    got_dir, want_dir = tmp_path / "port/scene/ins_infer", tmp_path / "jax/scene/ins_infer"
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 15
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    rows = np.loadtxt(got_dir / "final.sem.txt", dtype=np.int64)
    want = out.final_sem.numpy()
    np.testing.assert_array_equal(rows, want[extras["unmap"]] if with_unmap else want)


def _run(module, args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{module} {args}\nSTDOUT:{r.stdout[-2000:]}\nSTDERR:{r.stderr[-2000:]}"
    return r.stdout


def test_stage1_chain_through_the_clis(tmp_path):
    """train (1 epoch) -> resume (epoch 2) -> infer, both modes -> evaluate
    -> MinkUNet training on the layer-2 pseudo labels, each a subprocess
    on the CPU at small caps."""
    cwd = str(tmp_path)
    ns = ["--synthetic", "2", "--exp_name", "e2e", "--data_root", "unused",
          "--device", "cpu", "--cluster_cap", "256"]
    out = _run("seggroup_tpu_torch.cli.stage1_train", ns + ["--epochs", "1"], cwd)
    assert "scenes: 2" in out and "Epoch[1/1](0002/0002)  Loss: " in out
    assert "==> saved checkpoint epoch 1" in out
    assert os.listdir(tmp_path / "checkpoints/e2e/models") == ["1.pt"]

    out = _run("seggroup_tpu_torch.cli.stage1_train", ns + ["--epochs", "2", "--resume"], cwd)
    assert "resumed from epoch 1" in out and "Epoch[1/2]" not in out
    assert "Epoch[2/2](0002/0002)" in out and "==> saved checkpoint epoch 2" in out
    assert sorted(os.listdir(tmp_path / "checkpoints/e2e/models")) == ["1.pt", "2.pt"]
    log = (tmp_path / "checkpoints/e2e/run.log").read_text()
    assert log.count("==> saved checkpoint") == 2

    for mode in ("ins_infer", "sem_infer"):
        out = _run("seggroup_tpu_torch.cli.stage1_infer", ns + [f"--{mode}"], cwd)
        assert "loaded checkpoint epoch 2" in out and f"[{mode}] (0002/0002)" in out
        assert len(os.listdir(tmp_path / f"results/e2e/synthetic0001/{mode}")) == 15
    sem = np.loadtxt(tmp_path / "results/e2e/synthetic0000/ins_infer/final.sem.txt",
                     dtype=np.int64)
    assert sem.shape == (4096,) and (sem >= 1).all()  # every point labelled

    out = _run("seggroup_tpu_torch.cli.stage1_evaluate",
               ["--synthetic", "2", "--exp_name", "e2e", "--mode", "ins_infer",
                "--workers", "1"], cwd)
    assert "scenes evaluated: 2" in out and "semantic mIoU (all 40): " in out

    _run("seggroup_tpu_torch.cli.stage2_train_minkunet",
         ["--synthetic", "2", "--exp_name", "e2e", "--device", "cpu",
          "--pseudo_root", str(tmp_path / "results/e2e"), "--max_iter", "2",
          "--val_freq", "2", "--model", "Res16UNet14A", "--capacity", "4096",
          "--batch_size", "2"], cwd)
    mlog = (tmp_path / "checkpoints/e2e/minkunet.log").read_text()
    assert "val mIoU" in mlog and "saved iter 2" in mlog


def test_infer_without_checkpoint_warns_and_caps(tmp_path, monkeypatch):
    """No checkpoint: a warning and the random initialisation. Auto caps
    raise a small --cluster_cap to the covering bucket; --no-auto_caps
    keeps it and warns that the budget binds."""
    monkeypatch.chdir(tmp_path)
    ns = ["--synthetic", "1", "--exp_name", "fresh", "--device", "cpu", "--sem_infer"]
    stage1_infer.main(ns + ["--cluster_cap", "64"])
    log = (tmp_path / "checkpoints/fresh/infer.log").read_text()
    assert "WARNING: no checkpoint found, using random init" in log
    assert "auto caps: 1 scenes @ cluster_cap 1024" in log
    assert "exceeds a static budget" not in log
    stage1_infer.main(ns + ["--cluster_cap", "64", "--no-auto_caps"])
    log = (tmp_path / "checkpoints/fresh/infer.log").read_text()
    assert "vs --cluster_cap 64" in log and "1/1 scenes exceeded a static budget" in log
    assert (tmp_path / "results/fresh/synthetic0000/sem_infer/layer_2.sem.txt").exists()
