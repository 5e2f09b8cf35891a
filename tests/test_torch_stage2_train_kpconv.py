"""The port's KPConv training driver (seggroup_tpu_torch.cli.stage2_train_kpconv)
and the drivers that read its checkpoint, against the JAX package's, on
the CPU:

  * at the JAX driver's smoke size (tests/test_e2e_two_stage.py:88-90:
    --synthetic 3 --point_cap 1024 --batch_size 1 --calib_batches 1), the
    log up to the calibration line equal letter for letter and the first 3
    training batches exactly equal, the batch drawn for the JAX model's
    init discarded on both sides (each driver's prefetcher replaced by one
    that records 3 draws and stops the run, the JAX model replaced by a
    stand-in that skips the network's compile);
  * the chain through the port's entry points at a small size: train 4
    steps; train 2, then --resume to 4, bit-equal to the unbroken run on
    one thread; stage2_test_semantic --model kpconv restoring the trained
    checkpoint; introspect_kpconv in all three modes on it, against the
    JAX driver restoring the same weights as flax variables: the same
    feature path, ERF gradients within 1e-4 of their max, deformed points
    within 1e-5."""

import sys

import jax
import numpy as np
import pytest
import torch

from seggroup_tpu.models import kpconv as J
from seggroup_tpu_torch.cli import introspect_kpconv as TI
from seggroup_tpu_torch.cli import stage2_test_semantic as TS
from seggroup_tpu_torch.cli import stage2_train_kpconv as TT
from seggroup_tpu_torch.data.ply import read_ply
from seggroup_tpu_torch.models import kpconv as T


@pytest.fixture(scope="module", autouse=True)
def shared_kernel_points():
    """The JAX function's kernel points (bit-equal to the port's,
    tests/test_torch_kpconv.py), so that the numpy optimisation runs once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "kernel_point_positions", J.kernel_point_positions)
        yield


class _Drawn(Exception):
    pass


class _NoModel:
    """Stands in for the JAX driver's flax KPFCNN, whose weights neither
    the calibration nor the batch stream reads: an init without a
    network's compile."""

    def __init__(self, **kwargs):
        pass

    def init(self, rng, pyramid, feats, train):
        import jax.numpy as jnp
        return {"params": {"w": jnp.zeros(1)}, "batch_stats": {}}


def _recording_prefetcher(batches, pick):
    """A HostPrefetcher stand-in: on the first `next` it draws 3 batches from
    the factory in step order, keeps `pick(draw)` of each and stops the run."""

    class Recorder:
        def __init__(self, factory, depth=2, workers=1, start=0):
            self.factory, self.start = factory, start

        def __next__(self):
            batches.extend(pick(self.factory(s)) for s in range(self.start, self.start + 3))
            raise _Drawn

        def close(self):
            pass
    return Recorder


SMOKE = ["--synthetic", "3", "--exp_name", "kpe2e", "--steps", "2", "--point_cap", "1024",
         "--batch_size", "1", "--save_freq", "2", "--calib_batches", "1"]


def test_calibration_line_and_batch_stream_match_jax(tmp_path, monkeypatch):
    from cli import stage2_train_kpconv as JT
    from seggroup_tpu.utils import jit_cache, prefetch

    monkeypatch.setattr(jit_cache, "enable_persistent_cache", lambda *a, **k: None)
    jax_batches, port_batches = [], []
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    # one device: the JAX driver's data-parallel stream draws a batch per device
    monkeypatch.setattr(sys, "argv", ["stage2_train_kpconv", *SMOKE, "--num_devices", "1"])
    with monkeypatch.context() as mp:
        mp.setattr(prefetch, "HostPrefetcher", _recording_prefetcher(jax_batches, lambda b: b))
        mp.setattr(J, "KPFCNN", _NoModel)
        with pytest.raises(_Drawn):
            JT.main()
    jax_log = (tmp_path / "jax" / "checkpoints" / "kpe2e" / "kpconv.log").read_text()

    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(TT, "HostPrefetcher",
                        _recording_prefetcher(port_batches, lambda b: b[0]))
    with pytest.raises(_Drawn):
        TT.main([*SMOKE, "--device", "cpu"])
    port_log = (tmp_path / "port" / "checkpoints" / "kpe2e" / "kpconv.log").read_text()

    def upto_calibration(log):
        lines = log.splitlines()
        i = next(i for i, ln in enumerate(lines) if ln.startswith("calibrated neighbor caps"))
        return lines[: i + 1]
    assert upto_calibration(port_log) == upto_calibration(jax_log)
    assert upto_calibration(port_log)[:2] == ["scenes: 3", "scenes: 2 train / 1 val"]
    assert len(port_batches) == len(jax_batches) == 3
    for b_port, b_jax in zip(port_batches, jax_batches):
        for x, y in zip(b_port, b_jax):
            np.testing.assert_array_equal(x, y)
    assert all(b[4].sum() > 0 for b in port_batches)


SMALL = ["--synthetic", "3", "--device", "cpu", "--point_cap", "512",
         "--first_features_dim", "16", "--dl0", "0.2", "--in_radius", "5.0",
         "--batch_size", "1", "--calib_batches", "1", "--val_spheres", "2"]
INTROSPECT = ["--synthetic", "1", "--point_cap", "512", "--first_features_dim", "16",
              "--dl0", "0.2", "--in_radius", "5.0"]


def _flax_tree(state: dict) -> dict:
    """The flax KPFCNN variables of a port state dict (models.convert's rule
    backwards: Linear weights transposed into Dense kernels, running
    statistics under batch_stats)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *path, leaf = key.split(".")
        x = value.numpy()
        if leaf == "weight":
            leaf, x = "kernel", x.T
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(x)
    return tree


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The training chain on one thread: an unbroken 4-step run and a
    2-step run resumed to 4 (exp `a` and `b`), saving at steps 2 and 4."""
    root = tmp_path_factory.mktemp("kpconv_chain")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(root)
            TT.main([*SMALL, "--exp_name", "a", "--steps", "4", "--save_freq", "2"])
            TT.main([*SMALL, "--exp_name", "b", "--steps", "2", "--save_freq", "2"])
            TT.main([*SMALL, "--exp_name", "b", "--steps", "4", "--save_freq", "2", "--resume"])
    finally:
        torch.set_num_threads(threads)
    return root


def test_training_and_resume_bit_exact(trained):
    from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

    a = CheckpointManager(trained / "checkpoints" / "a" / "kpconv")
    b = CheckpointManager(trained / "checkpoints" / "b" / "kpconv")
    assert a.steps() == b.steps() == [2, 4]
    sa, sb = a.restore(), b.restore()
    for key, value in sa["model"].items():
        assert torch.equal(value, sb["model"][key]), key
    assert sa["batch_rng"] == sb["batch_rng"]
    for x, y in zip(sa["sampler"]["potentials"], sb["sampler"]["potentials"]):
        assert torch.equal(x, y)
    log_b = (trained / "checkpoints" / "b" / "kpconv.log").read_text()
    assert "resumed from step 2 (lr continues at 0.01)" in log_b
    log_a = (trained / "checkpoints" / "a" / "kpconv.log").read_text()
    assert "step 4/4  loss" in log_a and "val acc" in log_a
    assert "ball-query overflow %/level" in log_a
    assert (trained / "checkpoints" / "a" / "kpconv_best").is_dir()
    # training moved the weights and the running statistics
    init = T.KPFCNN(first_features_dim=16, dl0=0.2, seed=1, device="cpu").state_dict()
    assert not torch.equal(sa["model"]["b5.kp.offset_kernel"], init["b5.kp.offset_kernel"])
    assert not torch.equal(sa["model"]["head_bn.mean"], init["head_bn.mean"])


def test_semantic_evaluation_restores_the_trained_checkpoint(trained, monkeypatch):
    monkeypatch.chdir(trained)
    miou, per_class, ap = TS.main(["--model", "kpconv", "--exp_name", "a", "--synthetic", "1",
                                   "--device", "cpu", "--point_cap", "512",
                                   "--first_features_dim", "16", "--dl0", "0.2",
                                   "--in_radius", "5.0", "--votes", "1"])
    log = (trained / "checkpoints" / "a" / "kpconv_test.log").read_text()
    assert "loaded checkpoint 4" in log and "mIoU:" in log
    assert per_class.shape == (20,)


@pytest.mark.parametrize("mode", ["features", "erf", "deformations"])
def test_introspection_matches_jax(trained, mode, monkeypatch, tmp_path):
    from cli import introspect_kpconv as JI
    from seggroup_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
    from seggroup_tpu_torch.utils.checkpoint import CheckpointManager

    state = CheckpointManager(trained / "checkpoints" / "a" / "kpconv").restore()["model"]
    jax_dir = tmp_path / "jax"
    JaxCkpt(str(jax_dir / "checkpoints" / "a" / "kpconv")).save(4, _flax_tree(state))
    grads = {}
    real_jit = jax.jit

    def spy_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "erf":
            return jitted

        def call(*args):
            out = jitted(*args)
            grads["jax"] = np.asarray(out)
            return out
        return call

    args = [*INTROSPECT, "--exp_name", "a", "--mode", mode, "--out", "out"]
    monkeypatch.chdir(jax_dir)
    monkeypatch.setattr(sys, "argv", ["introspect_kpconv", *args])
    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", spy_jit)
        JI.main()
    jax_log = (jax_dir / "checkpoints" / "a" / "introspect.log").read_text()

    real_erf = TI.erf_gradient

    def erf(*a):
        grads["port"] = real_erf(*a)
        return grads["port"]
    monkeypatch.setattr(TI, "erf_gradient", erf)
    monkeypatch.chdir(trained)
    TI.main([*args, "--device", "cpu"])
    log = (trained / "checkpoints" / "a" / "introspect.log").read_text().splitlines()
    assert log[0] == "loaded checkpoint 4"
    assert log[-1] == jax_log.splitlines()[-1]  # the feature path, the query, the count
    if mode == "erf":
        g, want = grads["port"], grads["jax"]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * np.abs(want).max())
    if mode == "deformations":
        names = sorted(p.name for p in (jax_dir / "out").glob("*_kp.ply"))
        assert names == sorted(p.name for p in (trained / "out").glob("*_kp.ply"))
        assert len(names) == 5  # the five deformable blocks
        for name in names:
            a, b = read_ply(str(trained / "out" / name)), read_ply(str(jax_dir / "out" / name))
            for c in "xyz":
                np.testing.assert_allclose(a["vertex"][c], b["vertex"][c], rtol=0, atol=1e-5)
    if mode == "features":
        assert "logits/__call__/[0]" in log[-1]
