"""The pieces of the port's PointGroup training around the model, each
against the JAX package on the CPU: the sorted engine's segment max and
mean that the ScoreNet uses (values and jax.grad on hand-made ties), the
proposal x instance IoU, the IoU-binned score targets, the wire format, the
host voxelisation, and the training driver
(seggroup_tpu_torch.cli.stage2_train_pointgroup) in subprocesses: train
through the prepare phase into the clustering, resume, and the evaluation
driver restoring the checkpoint.

Integer results and the float32 values built from integer counts are held
exactly; so are the sorted engine's sums, which add in the reference's
order."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cli import stage2_pointgroup_common as JC
from seggroup_tpu.data import pg_wire as JW
from seggroup_tpu.data.synthetic import make_synthetic_scene as j_scene
from seggroup_tpu.models import pointgroup as JP
from seggroup_tpu.ops import iou as JI
from seggroup_tpu.ops import segment_ops as JS
from seggroup_tpu.ops.voxelize import VoxelMap as JVoxelMap
from seggroup_tpu.ops.voxelize import voxel_gather_mean
from seggroup_tpu_torch.cli import stage2_pointgroup_common as TC
from seggroup_tpu_torch.cli import stage2_train_pointgroup as driver
from seggroup_tpu_torch.data import pg_wire as TW
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.models import pointgroup as TP
from seggroup_tpu_torch.ops import segment_ops as TS
from seggroup_tpu_torch.ops.iou import proposal_instance_iou
from seggroup_tpu_torch.ops.voxelize import voxelize
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "2", "--device", "cpu", "--point_cap", "4096", "--voxel_cap", "4096",
         "--m", "8"]
TRAIN = [*SMALL, "--batch_size", "2", "--prepare_steps", "2"]


def _ties():
    """(data (12, 3), ids) over 5 segments: ReLU-like rows with ties at 0
    and at 2 within segments, a padding row (-1), one past the range (5)
    and an empty segment (3)."""
    data = np.array([[0, 2, 1], [0, 2, 0], [1, 0, 0], [0, 0, 0], [2, 1, 0], [2, 1, 3],
                     [0, 0, 0], [0, 0, 0], [5, 5, 5], [0, 3, 3], [2, 3, 0], [7, 7, 7]],
                    np.float32)
    ids = np.array([0, 0, 1, 0, 1, 1, 2, 2, -1, 4, 4, 5], np.int32)
    return data, ids


def _jax_value_and_grad(fn, data, ids, cot):
    return jax.jit(jax.value_and_grad(lambda d: jnp.sum(fn(d, jnp.asarray(ids)) * cot)))(
        jnp.asarray(data))


def test_sorted_max_gradient_goes_to_the_earliest_tied_row():
    """The roipool's max: the values of segment_max, each segment's
    gradient whole to its earliest row among equal maxima, as jax.grad of
    the sorted engine gives it; the scatter max (stage 1's) keeps JAX's
    scatter engine's even shares."""
    data, ids = _ties()
    cot = np.arange(1, 16, dtype=np.float32).reshape(5, 3)
    s = 5
    _, g_sorted = _jax_value_and_grad(
        lambda d, i: JS.segment_max(d, i, s, method="sorted"), data, ids, cot)
    _, g_scatter = _jax_value_and_grad(
        lambda d, i: JS.segment_max(d, i, s, method="scatter"), data, ids, cot)
    want = np.asarray(jax.jit(functools.partial(JS.segment_max, num_segments=s,
                                                method="sorted"))(data, ids))
    for fn, jg in ((TS.segment_max_sorted, g_sorted), (TS.segment_max, g_scatter)):
        x = torch.tensor(data, requires_grad=True)
        out = fn(x, torch.from_numpy(ids), s)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(), want)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)
    # segment 0: rows 0 and 1 tie at 2 in channel 1, rows 0, 1 and 3 at 0
    # in channel 0; row 0, the earliest, takes both
    g = np.asarray(g_sorted)
    assert g[0, 1] == cot[0, 1] and g[1, 1] == 0 and g[3, 0] == 0 and g[0, 0] == cot[0, 0]
    # segment 2 is all zeros: its earliest row (6) takes everything
    assert (g[6] == cot[2]).all() and (g[7] == 0).all()
    assert np.asarray(g_scatter)[1, 1] == cot[0, 1] / 2  # shared evenly
    assert (g[8] == 0).all() and (g[11] == 0).all() and (want[3] == 0).all()


def test_sorted_mean_equals_the_sorted_engine_and_its_gradient():
    """The ScoreNet's voxel mean: bit-equal to segment_sorted.segment_mean
    jitted, and its gradient jax.grad's gather of g / count."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3000, 8)).astype(np.float32)
    ids = rng.integers(-5, 300, size=3000).astype(np.int32)  # padding and empty voxels
    cot = rng.normal(size=(290, 8)).astype(np.float32)
    value, jg = _jax_value_and_grad(lambda d, i: JS.segment_mean(d, i, 290, method="sorted"),
                                    data, ids, cot)
    want = jax.jit(functools.partial(JS.segment_mean, num_segments=290, method="sorted"))(
        data, ids)
    x = torch.tensor(data, requires_grad=True)
    out = TS.segment_mean_sorted(x, torch.from_numpy(ids), 290)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    assert float(value) != 0 and (x.grad.numpy()[ids < 0] == 0).all()


@pytest.mark.parametrize("given_sizes", [True, False], ids=["sizes_given", "sizes_recounted"])
def test_proposal_instance_iou_matches_jax(given_sizes):
    rng = np.random.default_rng(3)
    n, p, i = 5000, 24, 12
    prop = rng.integers(0, p + 4, size=n).astype(np.int32)  # >= p: no proposal
    inst = rng.integers(-2, i + 2, size=n).astype(np.int32)  # < 0 or >= i: no instance
    valid = rng.random(n) < 0.9
    sizes = np.bincount(np.where((inst >= 0) & (inst < i), inst, i), minlength=i + 1)[:i]
    kw = dict(instance_sizes=sizes.astype(np.int32)) if given_sizes else {}
    want = JI.proposal_instance_iou(prop, inst, valid, p, i, **kw)
    got = proposal_instance_iou(torch.from_numpy(prop), torch.from_numpy(inst),
                                torch.from_numpy(valid), p, i,
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (p, i) and 0 < float(got.max()) <= 1


@pytest.mark.parametrize("thresh", [(0.75, 0.25), (0.7, 0.3)])
def test_score_targets_match_jax(thresh):
    """pg_score_targets at the reference's bins and at others, where the
    scale is no power of two and XLA's fused gt * k + b shows."""
    rng = np.random.default_rng(4)
    n, p_src, i_cap = 4000, 32, 16
    # 10 instances of 400 points; each source's proposal k follows instance
    # k with some points moved to other proposals or to none
    inst = (np.arange(n) // 400).astype(np.int32)
    inst[rng.random(n) < 0.1] = JP.IGNORE
    prop = np.stack([np.arange(n) // 400, np.arange(n) // 400 + p_src]).astype(np.int32)
    for src, noise in ((0, 0.15), (1, 0.45)):
        moved = rng.random(n) < noise
        prop[src, moved] = rng.integers(src * p_src, (src + 1) * p_src + 8, size=moved.sum())
    prop = np.where(prop < (np.arange(2)[:, None] + 1) * p_src, prop, 2 * p_src)
    valid = np.arange(n) < 3700
    pointnum = np.bincount(inst[valid & (inst >= 0)], minlength=i_cap).astype(np.int32)
    want = jax.jit(functools.partial(JP.pg_score_targets, p_total=2 * p_src,
                                     num_instances_cap=i_cap, fg_thresh=thresh[0],
                                     bg_thresh=thresh[1]))(
        prop, instance_labels=inst, point_valid=valid, instance_pointnum=pointnum)
    got = TP.pg_score_targets(torch.from_numpy(prop), 2 * p_src, torch.from_numpy(inst),
                              torch.from_numpy(valid), torch.from_numpy(pointnum), i_cap,
                              *thresh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.max()) == 1 and float(got.min()) == 0
    assert ((got > 0) & (got < 1)).any()


def _host_batch(pkg, n_cap=5000):
    """Two scenes of 3,000 points, the second cropped to the point budget."""
    scene = j_scene if pkg is JC else make_synthetic_scene
    tuples = [pkg.scene_instance_tuple(scene(seed=s, num_points=3000), {}, None, "")
              for s in (0, 1)]
    return pkg.make_pg_batch(tuples, n_cap, 32, rng=np.random.default_rng(0))


@pytest.mark.parametrize("voxel_cap", [8192, 1024], ids=["cap_free", "cap_binds"])
def test_host_voxelize_plan_matches_jax_and_the_device_voxelize(voxel_cap):
    """Voxel coords, counts and point2voxel exactly equal to the JAX
    package's host_voxelize_plan, and to the port's device voxelisation of
    the same cells."""
    hb_j, hb_t = _host_batch(JC), _host_batch(TC)
    np.testing.assert_array_equal(hb_t.coords, hb_j.coords)
    want = JC.host_voxelize_plan(hb_j, 0.02, voxel_cap, level_caps=None)
    got = TC.host_voxelize_plan(hb_t, 0.02, voxel_cap)
    assert want[3] is None and len(got) == 3
    for x, y, name in zip(got, want[:3], ("voxel_coords", "num", "point2voxel")):
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert x.dtype == np.asarray(y).dtype, name
    n_valid = int(hb_t.valid.sum())
    ic = np.floor(hb_t.coords[:n_valid] / 0.02).astype(np.int32)
    ic -= ic.min(0)
    cells = np.zeros((len(hb_t.coords), 3), np.int32)
    cells[:n_valid] = ic
    vm = voxelize(torch.from_numpy(cells), torch.from_numpy(hb_t.batch_ids),
                  torch.from_numpy(hb_t.valid), voxel_cap)
    np.testing.assert_array_equal(vm.voxel_coords.numpy(), got[0])
    np.testing.assert_array_equal(vm.point2voxel.numpy(), got[2])
    assert min(int(vm.num_voxels), voxel_cap) == int(got[1])
    assert (int(vm.num_voxels) > voxel_cap) == (voxel_cap == 1024)


def test_wire_format_matches_jax_and_round_trips():
    """pack_pg_batch equal to the JAX package's, array for array (the
    colours float16); unpacked on the CPU, the voxel features equal the
    JAX side's voxel_gather_mean of the float16 colours and the coords."""
    hb_j, hb_t = _host_batch(JC), _host_batch(TC)
    vox = TC.host_voxelize_plan(hb_t, 0.02, 4096)
    want = JW.pack_pg_batch(hb_j, *JC.host_voxelize_plan(hb_j, 0.02, 4096)[:3])
    got = TW.pack_pg_batch(hb_t, *vox)
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["feats"].dtype == np.float16
    st, p2v, coords, batch_ids, valid, labels, inst, centroid, pointnum = TW.unpack_pg_batch(
        got, 4096, "cpu")
    num = int(want["num"])
    vm = JVoxelMap(jnp.asarray(want["vcoords"], jnp.int32), jnp.asarray(want["p2v"]),
                   jnp.arange(4096) < num, jnp.int32(num))
    feats = jnp.concatenate([jnp.asarray(want["feats"]).astype(jnp.float32),
                             jnp.asarray(want["coords"])], axis=1)
    np.testing.assert_array_equal(st.feats.numpy(), np.asarray(jax.jit(voxel_gather_mean)(feats,
                                                                                           vm)))
    np.testing.assert_array_equal(st.coords.numpy(), vox[0])
    assert int(st.num) == num and int(st.valid.sum()) == num
    np.testing.assert_array_equal(p2v.numpy(), vox[2])
    np.testing.assert_array_equal(valid.numpy(), hb_t.valid)
    np.testing.assert_array_equal(labels.numpy(), hb_t.labels)
    np.testing.assert_array_equal(inst.numpy(), hb_t.instance_labels)
    np.testing.assert_array_equal(batch_ids.numpy(), hb_t.batch_ids)
    np.testing.assert_array_equal(centroid.numpy(), hb_t.instance_centroid)
    np.testing.assert_array_equal(pointnum.numpy(), hb_t.instance_pointnum)
    assert coords.dtype == torch.float32 and labels.dtype == torch.int32


def _run(module, args, cwd):
    """One driver in a subprocess on one CPU thread (the CPU's parallel
    scatter-adds sum in an order that changes from run to run)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{module} {args}\nSTDOUT:{r.stdout[-2000:]}\nSTDERR:{r.stderr[-2000:]}"
    return r.stdout


def test_training_chain_through_the_clis(tmp_path):
    """train 4 steps (2 of them after the prepare phase) -> resume to 6
    -> the evaluation driver restoring the checkpoint, each a subprocess on
    the CPU at small caps; a run of 6 steps without the break ends with
    the same weights, statistics and optimizer state, bit for bit (the
    checkpoint restores the batch generator at its step although the
    prefetcher had drawn 3 batches further; the jitter stream is
    replayed)."""
    train = "seggroup_tpu_torch.cli.stage2_train_pointgroup"
    first = _run(train, [*TRAIN, "--steps", "4", "--save_freq", "2"], tmp_path)
    assert "scenes: 1 train / 1 val" in first and "step 4/4" in first
    assert "score_loss" in first and first.count("==> saved step") == 2
    out = _run(train, [*TRAIN, "--steps", "6", "--save_freq", "2", "--resume"], tmp_path)
    assert "resumed from step 4" in out and "step 6/6" in out
    ckpt = CheckpointManager(tmp_path / "checkpoints" / "exp" / "pointgroup")
    assert ckpt.steps() == [2, 4, 6]
    assert (tmp_path / "checkpoints" / "exp" / "pointgroup_best").is_dir()

    whole = tmp_path / "whole"
    whole.mkdir()
    _run(train, [*TRAIN, "--steps", "6", "--save_freq", "3"], whole)
    a = ckpt.restore()
    b = CheckpointManager(whole / "checkpoints" / "exp" / "pointgroup").restore()
    assert a["scheduler"] == b["scheduler"] == {"count": 6}
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for k, v in b["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(a["optimizer"]["state"][k][name], t), (k, name)

    test = _run("seggroup_tpu_torch.cli.stage2_test_pointgroup", SMALL, tmp_path)
    assert "loaded checkpoint step 6" in test and "AP " in test


def _consumed_batches(monkeypatch, tmp_path, args):
    """The wire batches one in-process run of the training driver takes for
    its training steps, in order (the model's steps stubbed out; the
    validation's batches are left out)."""
    seen = []

    def record(batch, voxel_cap, dev):
        seen.append(batch)
        return TW.unpack_pg_batch(batch, voxel_cap, dev)

    def no_step(model, optimizer, scheduler, batch, clustering, jitter, plan=None):
        scheduler.step()
        return torch.zeros(()), {}, torch.zeros((), dtype=torch.int32)

    tmp_path.mkdir(exist_ok=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(driver, "unpack_pg_batch", record)
    monkeypatch.setattr(driver, "train_step", no_step)
    monkeypatch.setattr(driver.PointGroup, "forward", lambda *a, **k: None)
    monkeypatch.setattr(driver, "pointgroup_loss", lambda *a, **k: (torch.zeros(()), {}))
    it, _ = driver.main([*TRAIN, "--prefetch_depth", "3", *args])
    return seen[:-1], it  # the last batch is the validation's


def test_fresh_run_draws_the_jax_drivers_batch_stream(tmp_path, monkeypatch):
    """A fresh run's first batches equal those the JAX driver's
    `sample_batch` draws: one generator seeded by --seed (1), consumed in
    step order for the scene indices and make_pg_batch's augmentation."""
    got, _ = _consumed_batches(monkeypatch, tmp_path, ["--steps", "3", "--save_freq", "3"])
    assert len(got) == 3
    rng = np.random.default_rng(1)
    pool = [0]  # 2 scenes: 1 train, 1 validation
    for batch in got:
        idx = [pool[int(j)] for j in rng.integers(0, len(pool), size=2)]
        tuples = [JC.scene_instance_tuple(j_scene(seed=i), {}, None, "") for i in idx]
        hb = JC.make_pg_batch(tuples, 4096, 256, rng=rng, augment=True)
        want = JW.pack_pg_batch(hb, *JC.host_voxelize_plan(hb, 0.02, 4096, level_caps=None)[:3])
        assert set(batch) == set(want)
        for k in want:
            if np.asarray(want[k]).dtype == np.float32:
                # coordinates and centroids: the elastic field's samples are
                # vectorised numpy here and C++ on the JAX side, about 1e-6 m
                # apart (seggroup_tpu_torch/data/transforms.py)
                np.testing.assert_allclose(batch[k], want[k], rtol=0, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    assert not np.array_equal(got[0]["coords"], got[1]["coords"])  # augmentation moves on


def test_resume_draws_the_unbroken_batch_stream(tmp_path, monkeypatch):
    """A checkpoint taken while the prefetcher runs 3 batches ahead holds
    the generator's state at its own step: resuming from step 4 draws the
    batches 5 and 6 of an unbroken run."""
    first, _ = _consumed_batches(monkeypatch, tmp_path / "a",
                                 ["--steps", "4", "--save_freq", "4"])
    rest, it = _consumed_batches(monkeypatch, tmp_path / "a",
                                 ["--steps", "6", "--save_freq", "2", "--resume"])
    whole, _ = _consumed_batches(monkeypatch, tmp_path / "b",
                                 ["--steps", "6", "--save_freq", "6"])
    assert it == 6 and len(first) == 4 and len(whole) == 6
    # the resumed run validates at step 6 only: its one validation batch is cut
    for a, b in zip(first + rest, whole):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(first + rest) == 6


def test_resume_refuses_a_checkpoint_without_the_batch_generator(tmp_path, monkeypatch):
    """A checkpoint written before the trainer kept its batch generator's
    state cannot continue the batch stream: resuming it raises and names
    why instead of starting a fresh generator."""
    _consumed_batches(monkeypatch, tmp_path, ["--steps", "2", "--save_freq", "2"])
    ckpt = CheckpointManager(tmp_path / "checkpoints" / "exp" / "pointgroup")
    state = ckpt.restore()
    del state["batch_rng"]
    ckpt.save(3, state)
    with pytest.raises(ValueError, match="batch generator"):
        driver.main([*TRAIN, "--steps", "4", "--resume"])


def test_step_schedule_and_refusals(tmp_path, monkeypatch):
    """The JAX driver's schedule (step decay, floor 1e-6); data parallelism
    raises instead of running; `--plan_mode host` (once refused) runs 2
    steps, the second with the clustering, and validates."""
    sched = driver.step_schedule(1e-3, 0.5, 10)
    assert [sched(s) for s in (0, 9, 10, 25)] == [1e-3, 1e-3, 5e-4, 2.5e-4]
    assert driver.step_schedule(1e-3, 0.1, 1)(20) == 1e-6
    (tmp_path / "refused").mkdir()
    monkeypatch.chdir(tmp_path / "refused")
    with pytest.raises(NotImplementedError):
        driver.main([*TRAIN, "--steps", "1", "--num_devices", "2"])
    assert not (tmp_path / "refused" / "checkpoints").exists()
    (tmp_path / "host").mkdir()
    monkeypatch.chdir(tmp_path / "host")
    it, best = driver.main([*SMALL, "--batch_size", "2", "--prepare_steps", "1", "--steps", "2",
                            "--save_freq", "2", "--plan_mode", "host"])
    assert it == 2 and np.isfinite(best)
    log = (tmp_path / "host" / "checkpoints" / "exp" / "pointgroup.log").read_text()
    assert "step 2/2" in log and "score_loss" in log and "val loss" in log


@pytest.mark.parametrize("window_levels", [0, 3])
def test_host_voxelize_plan_with_level_caps_matches_jax(window_levels):
    """With level_caps the fourth element is the 7-level host plan, bit-equal
    to the JAX package's (rulebooks, down maps, windows)."""
    hb_j, hb_t = _host_batch(JC), _host_batch(TC)
    caps = [4096 >> i for i in range(7)]
    want = JC.host_voxelize_plan(hb_j, 0.02, 4096, level_caps=caps, window_levels=window_levels)
    got = TC.host_voxelize_plan(hb_t, 0.02, 4096, level_caps=caps, window_levels=window_levels)
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(x, y)
    plan, ref = got[3], want[3]
    for a, b in zip(plan["rulebooks"], ref["rulebooks"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plan["down"], ref["down"]):
        assert int(a["num"]) == int(b["num"])
        for k in ("coords", "out_row", "delta"):
            np.testing.assert_array_equal(a[k], b[k])
    assert [w is None for w in plan["windows"]] == [w is None for w in ref["windows"]]
    assert sum(w is not None for w in plan["windows"]) == (2 if window_levels else 0)  # 4096, 2048
    for a, b in zip(plan["windows"], ref["windows"]):
        if a is not None:
            assert bool(a["use_window"]) == bool(b["use_window"])
            np.testing.assert_array_equal(a["rb_win"], b["rb_win"])
            np.testing.assert_array_equal(a["win_base"], b["win_base"])
