"""The port's training utilities against the JAX package's: the learning-rate
schedules (seggroup_tpu.solvers, equal to the last bits of a float64 Python
number, since both evaluate the same formula), SGD and Adam against optax
over several steps (float32, the same operations in another order: within
rtol 1e-5 + atol 1e-6, measured at most 7.2e-7 on weights of order 1),
the checkpoint manager's
retention and round trip, lenient restore, and the host prefetcher."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seggroup_tpu import solvers as J
from seggroup_tpu_torch import solvers as T
from seggroup_tpu_torch.utils.checkpoint import CheckpointManager, lenient_restore
from seggroup_tpu_torch.utils.prefetch import HostPrefetcher

SCHEDULES = ["PolyLR", "SquaredLR", "StepLR", "ExpLR", "constant"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_equal_jax(name):
    js = J.make_schedule(name, 0.1, max_iter=60000)
    ts = T.make_schedule(name, 0.1, max_iter=60000)
    for s in (0, 1, 9, 445, 1000, 19999, 20000, 30000, 40000, 59999, 60000):
        assert float(ts(s)) == float(js(s)), (name, s)


@pytest.mark.parametrize("name,kw", [
    ("PolyLR", dict(max_iter=100, poly_power=0.5)),
    ("StepLR", dict(step_size=7, step_gamma=0.5)),
    ("ExpLR", dict(exp_gamma=0.1 ** (1 / 150000), exp_step_size=1)),  # the KPConv trainer's
    ("ExpLR", dict(exp_gamma=0.5, exp_step_size=3))])
def test_schedule_keywords_equal_jax(name, kw):
    js = J.make_schedule(name, 1e-2, **kw)
    ts = T.make_schedule(name, 1e-2, **kw)
    for s in (0, 1, 2, 3, 7, 50, 99, 1000, 150000):
        if s <= kw.get("max_iter", s):  # PolyLR is defined up to max_iter
            assert float(ts(s)) == float(js(s)), (name, kw, s)


@pytest.mark.parametrize("name", ["SGD", "Adam"])
@pytest.mark.parametrize("schedule", ["PolyLR", "StepLR"])
def test_optimizer_steps_equal_optax(name, schedule):
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    kw = dict(max_iter=10)
    opt = J.make_optimizer(name, J.make_schedule(schedule, 0.1, **kw))
    params = jax.tree.map(jnp.asarray, p0)
    state = opt.init(params)
    params_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt_t, sched = T.make_optimizer(name, list(params_t.values()),
                                    T.make_schedule(schedule, 0.1, **kw))
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for k, p in params_t.items():
            p.grad = torch.from_numpy(g[k])
        opt_t.step()
        sched.step()
        for k, p in params_t.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-6)
    assert sched.count == len(grads)


def test_scheduled_lr_state_round_trip():
    p = torch.nn.Parameter(torch.zeros(2))
    schedule = T.make_schedule("PolyLR", 0.1, max_iter=100)
    opt, sched = T.make_optimizer("SGD", [p], schedule)
    assert opt.param_groups[0]["lr"] == schedule(0)
    for _ in range(3):
        sched.step()
    opt2, sched2 = T.make_optimizer("SGD", [p], schedule)
    sched2.load_state_dict(sched.state_dict())
    assert sched2.count == 3 and opt2.param_groups[0]["lr"] == schedule(3)
    with pytest.raises(ValueError):
        T.make_optimizer("RMSprop", [p], schedule)


def _kept(directory):
    return sorted(int(f.stem) for f in directory.glob("*.pt"))


def test_pow2_or_mult16_retention(tmp_path):
    """As tests/test_checkpoint_retention.py holds the JAX manager."""
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2, pow2_retention=True)
    for step in range(1, 13):
        mgr.save(step, {"w": torch.full((3,), float(step))})
    kept = _kept(tmp_path / "ck")
    for p in (1, 2, 4, 8, 11, 12):
        assert p in kept, kept
    for gone in (3, 5, 6, 7, 9, 10):
        assert gone not in kept, kept
    assert mgr.latest_step() == 12
    assert float(mgr.restore(8)["w"][0]) == 8.0
    mgr.save(16, {"w": torch.zeros(1)})
    mgr.save(17, {"w": torch.zeros(1)})
    mgr.save(18, {"w": torch.zeros(1)})
    assert _kept(tmp_path / "ck") == [1, 2, 4, 8, 16, 17, 18]


def test_default_manager_keeps_max_to_keep_only(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore() is None
    for step in range(1, 8):
        mgr.save(step, {"w": torch.zeros(2)})
    assert _kept(tmp_path / "ck") == [5, 6, 7]
    assert not list((tmp_path / "ck").glob(".*tmp"))  # written, then renamed


def test_checkpoint_round_trip(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(5, 4)).sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "scheduler": {"count": 1}}
    CheckpointManager(tmp_path).save(1, state)
    got = CheckpointManager(tmp_path).restore()
    for k, v in model.state_dict().items():
        assert torch.equal(got["model"][k], v)
    opt2 = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt2.load_state_dict(got["optimizer"])
    assert torch.equal(opt2.state_dict()["state"][0]["momentum_buffer"],
                       opt.state_dict()["state"][0]["momentum_buffer"])
    assert got["scheduler"] == {"count": 1}


def test_lenient_restore_matches_names_and_shapes(tmp_path):
    src = {"a.weight": torch.ones(3, 2), "b.weight": torch.ones(4), "extra": torch.ones(1)}
    CheckpointManager(tmp_path).save(5, {"model": src})
    template = {"a.weight": torch.zeros(3, 2), "b.weight": torch.zeros(5),
                "c.bias": torch.zeros(2)}
    logged = []
    out, n_loaded, n_total = lenient_restore(tmp_path, template, log=logged.append)
    assert (n_loaded, n_total) == (1, 3)
    assert torch.equal(out["a.weight"], torch.ones(3, 2))
    assert torch.equal(out["b.weight"], torch.zeros(5)) and torch.equal(out["c.bias"],
                                                                        torch.zeros(2))
    assert len(logged) == 2
    with pytest.raises(FileNotFoundError):
        lenient_restore(tmp_path / "none", template)


def test_prefetcher_yields_in_step_order_and_propagates_errors():
    seen = []
    lock = threading.Lock()

    def factory(step):
        with lock:
            seen.append(step)
        if step == 7:
            raise RuntimeError("bad batch")
        return np.full(3, step)

    pf = HostPrefetcher(factory, depth=3, workers=3, start=2)
    try:
        for step in range(2, 7):
            assert int(next(pf)[0]) == step
        with pytest.raises(RuntimeError, match="bad batch"):
            next(pf)
    finally:
        pf.close()
