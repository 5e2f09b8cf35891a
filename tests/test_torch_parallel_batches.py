"""Rank d's batches are the JAX drivers' shard d, for each of the port's
four trainers at --num_devices 2:

  * stage 1: `batch_indices` (rank d loads scene d of each step) against
    cli/stage1_common.py `batches`, the tail wrapped to the start;
  * MinkUNet: rank d's prefetched batches (the driver run in this process
    as rank d of 2, its prefetcher recording its first 3 steps) against
    the JAX driver's make_batch(s * 2 + d + 1) (cli/stage2_train_minkunet.py:
    290-291) rebuilt from the JAX package's data functions;
  * PointGroup and KPConv: what rank 0 draws each step for the 2 ranks and
    hands rank d, in order (the driver run here as rank 0), against the
    JAX PointGroup driver's `[sample_batch() for _ in range(2)]` rebuilt
    from the JAX package's functions, and against the JAX KPConv driver
    itself at --num_devices 2 (its model a stand-in, as
    tests/test_torch_stage2_train_kpconv.py does)."""

import sys

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.cli import stage2_train_kpconv as TK
from seggroup_tpu_torch.cli import stage2_train_minkunet as TM
from seggroup_tpu_torch.cli import stage2_train_pointgroup as TP
from seggroup_tpu_torch.cli.stage1_common import batch_indices, batches
from seggroup_tpu_torch.parallel import dp

torch.set_num_threads(1)

DIST = ["--device", "cpu", "--dist_timeout", "60"]


class _Drawn(Exception):
    pass


def _recording_prefetcher(out, pick):
    """A HostPrefetcher stand-in: on the first `next` it draws steps 0-2
    from the factory, keeps `pick(draw)` of each and stops the run."""

    class Recorder:
        def __init__(self, factory, depth=2, workers=1, start=0):
            self.factory, self.start = factory, start

        def __next__(self):
            out.extend(pick(self.factory(s)) for s in range(self.start, self.start + 3))
            raise _Drawn

        def close(self):
            pass
    return Recorder


class _Rank(dp.Mesh):
    """One rank of a 2-rank mesh, run in this process: nothing to share
    before the first batch."""

    def replicate(self, model, optimizer=None):
        pass


def _as_rank(monkeypatch, driver, rank):
    """driver.main runs its rank `rank` of 2 here instead of spawning."""
    monkeypatch.setattr(driver, "launch", lambda fn, n, device, *args, **kw: fn(
        _Rank(rank, n, torch.device("cpu")), *args))


def _same(got, want, atol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], atol)
        return
    got, want = np.asarray(got), np.asarray(want)
    if atol and want.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


def _stage1():
    from cli import stage1_common as JC
    from seggroup_tpu.types import Scene as JScene

    class Source:  # scene i: every field i
        names = [f"s{i}" for i in range(5)]

        def get(self, i):
            return JScene(*(np.full(2, i) for _ in JScene._fields)), {}

    order = np.random.default_rng(0).permutation(5)
    want = [(names, np.asarray(b.points)[:, 0].tolist())
            for names, b, _ in JC.batches(Source(), 2, order)]
    got = list(batch_indices(order, 2))
    assert [idx for idx, _ in got] == [w[1] for w in want]
    assert [len(w[0]) for w in want] == [real for _, real in got] == [2, 2, 1]
    ours = batches(type("S", (), {"names": Source.names, "get": lambda s, i: (i, {})})(), 2,
                   order)
    assert [names for names, _, _ in ours] == [w[0] for w in want]


def _minkunet(tmp_path, monkeypatch):
    from seggroup_tpu.data.synthetic import make_synthetic_scene as j_scene
    from seggroup_tpu.data.voxel_dataset import make_voxel_batch as j_voxel_batch
    from seggroup_tpu.sparse.device_plan import pack_voxel_batch as j_pack
    from cli.stage2_train_minkunet import scene_to_training_tuple as j_tuple

    args = ["--synthetic", "3", "--model", "Res16UNet14A", "--capacity", "2048",
            "--batch_size", "1", "--max_iter", "3",
            "--num_devices", "2", "--seed", "5", *DIST]
    monkeypatch.chdir(tmp_path)
    for d in range(2):
        got = []
        with monkeypatch.context() as mp:
            _as_rank(mp, TM, d)
            mp.setattr(TM, "HostPrefetcher", _recording_prefetcher(got, lambda b: b[0]))
            with pytest.raises(_Drawn):
                TM.main(args)
        pool = [0, 1]  # 3 scenes: 2 train, 1 validation
        for s, wire in enumerate(got):
            rng = np.random.default_rng((5, s * 2 + d + 1))  # cli/stage2_train_minkunet.py:291
            idx = rng.integers(0, len(pool), size=1)
            tuples = [j_tuple(j_scene(seed=pool[int(i)]), {}, None, "", False) for i in idx]
            want = j_pack(j_voxel_batch(tuples, 2048, 0.02, rng=rng, augment=True))
            assert len(wire) == len(want) == 4
            for x, y in zip(wire, want):
                np.testing.assert_array_equal(x, np.asarray(y))


def _pointgroup(tmp_path, monkeypatch):
    from cli import stage2_pointgroup_common as JC
    from seggroup_tpu.data import pg_wire as JW
    from seggroup_tpu.data.synthetic import make_synthetic_scene as j_scene

    got = []
    monkeypatch.chdir(tmp_path)
    _as_rank(monkeypatch, TP, 0)
    monkeypatch.setattr(TP, "HostPrefetcher", _recording_prefetcher(got, lambda b: b[0]))
    with pytest.raises(_Drawn):
        TP.main(["--synthetic", "2", "--point_cap", "4096", "--voxel_cap", "4096", "--m", "8",
                 "--batch_size", "1", "--steps", "3", "--num_devices", "2", *DIST])
    rng = np.random.default_rng(1)  # one generator, --seed
    pool = [0]
    for step in got:
        assert len(step) == 2
        for wire in step:  # shard d of the step: the step's d-th draw
            idx = [pool[int(j)] for j in rng.integers(0, len(pool), size=1)]
            tuples = [JC.scene_instance_tuple(j_scene(seed=i), {}, None, "") for i in idx]
            hb = JC.make_pg_batch(tuples, 4096, 256, rng=rng, augment=True)
            want = JW.pack_pg_batch(hb, *JC.host_voxelize_plan(hb, 0.02, 4096,
                                                               level_caps=None)[:3])
            # the elastic field's samples: numpy here, C++ on the JAX side,
            # about 1e-6 m apart (tests/test_torch_stage2_train_pointgroup.py)
            _same(wire, {k: np.asarray(v) for k, v in want.items()}, atol=1e-5)


def _kpconv(tmp_path, monkeypatch):
    from cli import stage2_train_kpconv as JT
    from seggroup_tpu.models import kpconv as JK
    from seggroup_tpu.utils import jit_cache, prefetch
    from seggroup_tpu_torch.models import kpconv as TKM

    class NoModel:  # the JAX model's init, without a network's compile
        def __init__(self, **kwargs):
            pass

        def init(self, rng, pyramid, feats, train):
            import jax.numpy as jnp
            return {"params": {"w": jnp.zeros(1)}, "batch_stats": {}}

    args = ["--synthetic", "3", "--steps", "3", "--point_cap", "1024", "--batch_size", "1",
            "--calib_batches", "1", "--num_devices", "2"]
    want, got = [], []
    monkeypatch.setattr(TKM, "kernel_point_positions", JK.kernel_point_positions)
    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["stage2_train_kpconv", *args])
    with monkeypatch.context() as mp:
        mp.setattr(prefetch, "HostPrefetcher", _recording_prefetcher(want, lambda b: b))
        mp.setattr(JK, "KPFCNN", NoModel)
        with pytest.raises(_Drawn):
            JT.main()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    _as_rank(monkeypatch, TK, 0)
    monkeypatch.setattr(TK, "HostPrefetcher", _recording_prefetcher(got, lambda b: b[0]))
    with pytest.raises(_Drawn):
        TK.main([*args, *DIST])
    assert len(got) == len(want) == 3
    for step_got, step_want in zip(got, want):
        assert len(step_got) == len(step_want) == 2
        for b_got, b_want in zip(step_got, step_want):
            for x, y in zip(b_got, b_want):
                np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("trainer", ["stage1", "minkunet", "pointgroup", "kpconv"])
def test_rank_batches_are_the_jax_shards(trainer, tmp_path, monkeypatch):
    if trainer == "stage1":
        _stage1()
    else:
        {"minkunet": _minkunet, "pointgroup": _pointgroup, "kpconv": _kpconv}[trainer](
            tmp_path, monkeypatch)
