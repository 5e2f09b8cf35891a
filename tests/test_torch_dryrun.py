"""The port's multichip dry run (seggroup_tpu_torch.infer.dryrun_multichip,
parallel/dryrun.py) against the JAX package's (__graft_entry__.py
`dryrun_multichip`), on 2 gloo ranks on the CPU, one run for the module
(one thread a rank): the seven lines in the JAX function's order and
wording; the ranks bit-equal after every check with a model; the packed
MinkUNet loss within 0.1 of the host plan's; the inputs equal, array for
array, to the JAX run's, replayed here through the JAX package's own
make_synthetic_scene, make_voxel_batch, pack_voxel_batch, voxelize and
pack_pg_batch; the point-sharded edge conv's slabs within 1e-5 of JAX's
point_sharded_edge_conv on a 2-device CPU mesh. Check 7's clustering
takes the exact fallback in both packages, so the dry run launches no K4.
Without a card, or with fewer cards than ranks, `device="cuda"` raises
before any rank starts."""

import contextlib
import io
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.data.pg_wire import pack_pg_batch
from seggroup_tpu.data.synthetic import make_synthetic_scene
from seggroup_tpu.data.voxel_dataset import make_voxel_batch
from seggroup_tpu.ops import pallas_cc
from seggroup_tpu.ops.voxelize import voxelize
from seggroup_tpu.parallel.dp import make_mesh
from seggroup_tpu.parallel.point_sharding import point_sharded_edge_conv
from seggroup_tpu.sparse.device_plan import pack_voxel_batch
from seggroup_tpu_torch.infer import dryrun_multichip
from seggroup_tpu_torch.ops import radius_cc
from seggroup_tpu_torch.parallel import dryrun

N = 2
NUM = r"(-?\d+\.\d{4})"
# __graft_entry__.py:89-298, the f-strings at n = 2
LINES = [rf"dryrun_multichip\(2\): ok, summed loss {NUM}",
         r"dryrun_multichip\(2\): point-sharded edge conv ok \(2 shards\)",
         rf"dryrun_multichip\(2\): stage-1 point-sharded train step ok, loss {NUM}",
         rf"dryrun_multichip\(2\): minkunet dp ok, summed loss {NUM}",
         rf"dryrun_multichip\(2\): minkunet packed dp ok, summed loss {NUM}",
         rf"dryrun_multichip\(2\): kpconv dp ok, summed loss {NUM}",
         rf"dryrun_multichip\(2\): pointgroup packed dp ok, summed loss {NUM}"]


def _jax_inputs(n):
    """__graft_entry__.py's draws for n devices, in its order, through the
    JAX package, in dryrun_inputs' layout."""
    kw = dict(num_points=1024, num_slots=32, num_edges=128, num_instances=3,
              segs_per_instance=3)
    out = {"scenes": [make_synthetic_scene(seed=i, **kw) for i in range(n)]}
    rng = np.random.default_rng(0)  # :96-99
    rows = 128 * n
    out["edge_conv"] = (rng.normal(size=(rows, 9)).astype(np.float32),
                        rng.integers(0, rows, size=(rows, 8)).astype(np.int32),
                        rng.normal(size=(18, 16)).astype(np.float32))
    rng = np.random.default_rng(0)  # :134-144
    out["minkunet"] = []
    for _ in range(n):
        pts = rng.normal(size=(600, 3)).astype(np.float32)
        cols = rng.uniform(0, 255, size=(600, 3)).astype(np.float32)
        ls = rng.integers(0, 20, size=600).astype(np.int32)
        out["minkunet"].append(make_voxel_batch([(pts, cols, ls)], 512, 0.1, rng=rng))
    out["minkunet_wire"] = [pack_voxel_batch(vb) for vb in out["minkunet"]]
    out["kpconv"] = []  # :193-200
    for _ in range(n):
        pts = rng.normal(size=(512, 3)).astype(np.float32)
        feats = np.ones((512, 4), np.float32)
        labs = rng.integers(0, 20, size=512).astype(np.int32)
        out["kpconv"].append((pts, feats, labs, np.zeros(512, np.int32), np.ones(512, bool)))
    out["pointgroup"] = []  # :233-290
    npt, vcap, icap = 512, 256, 16
    for _ in range(n):
        coords = rng.uniform(0, 3, size=(npt, 3)).astype(np.float32)
        labels = rng.integers(2, 6, size=npt).astype(np.int32)
        inst = rng.integers(0, 4, size=npt).astype(np.int32)
        bids = np.zeros(npt, np.int32)
        valid = np.ones(npt, bool)
        ic = np.floor(coords / 0.1).astype(np.int32)
        ic -= ic.min(0)
        vm = voxelize(jnp.asarray(ic), jnp.asarray(bids), jnp.asarray(valid), vcap)
        rng.normal(size=(npt, 3))  # the voxel features of the JAX init
        centroid = np.zeros((npt, 3), np.float32)
        pointnum = np.zeros(icap, np.int32)
        for k in range(4):
            sel = inst == k
            if sel.any():
                centroid[sel] = coords[sel].mean(0)
                pointnum[k] = sel.sum()
        hb = SimpleNamespace(coords=coords, feats=coords * 0.1, batch_ids=bids, valid=valid,
                             labels=labels, instance_labels=inst, instance_centroid=centroid,
                             instance_pointnum=pointnum)
        out["pointgroup"].append(pack_pg_batch(hb, np.asarray(vm.voxel_coords),
                                               int(vm.num_voxels), np.asarray(vm.point2voxel)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.fixture(scope="module")
def run():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one thread a rank
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ranks = dryrun_multichip(N, "cpu")
    finally:
        torch.set_num_threads(threads)
    return out.getvalue().splitlines(), ranks


def test_prints_the_seven_jax_lines_in_order(run):
    lines, ranks = run
    assert lines == ranks[0]["lines"]
    assert len(lines) == len(LINES)
    for line, pattern in zip(lines, LINES):
        m = re.fullmatch(pattern, line)
        assert m, (line, pattern)
        assert all(np.isfinite(float(v)) for v in m.groups())


def test_ranks_bit_equal_after_every_check(run):
    _, ranks = run
    stateful = [c for c in dryrun.CHECKS if c != "edge_conv"]
    for r in ranks:
        assert list(r["digests"]) == stateful
        assert r["digests"] == ranks[0]["digests"]
        assert list(r["launches"]) == list(dryrun.CHECKS)
    # every check with a model leaves another state than the one before it
    assert len(set(ranks[0]["digests"].values())) == len(stateful)


def test_packed_minkunet_loss_near_the_host_plan_loss(run):
    _, ranks = run
    for r in ranks:
        losses = r["losses"]
        assert abs(losses["minkunet_packed_dp"] - losses["minkunet_dp"]) < 0.1
        assert losses == ranks[0]["losses"]


@pytest.mark.parametrize("key", ["scenes", "edge_conv", "minkunet", "minkunet_wire", "kpconv",
                                 "pointgroup"])
def test_inputs_equal_the_jax_dry_run(key):
    got, want = dryrun.dryrun_inputs(N)[key], _jax_inputs(N)[key]
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_edge_conv_slabs_match_jax(run):
    _, ranks = run
    x, idx, w = dryrun.dryrun_inputs(N)["edge_conv"]
    want = np.asarray(point_sharded_edge_conv(make_mesh(N), jnp.asarray(x), jnp.asarray(idx),
                                              jnp.asarray(w)))
    for d, r in enumerate(ranks):
        np.testing.assert_allclose(r["edge_conv"], want[128 * d:128 * (d + 1)], rtol=0,
                                   atol=1e-5)


def test_pointgroup_clustering_takes_the_exact_fallback_in_both():
    """PointGroup clusters the points and their shifted copies as one
    problem of 2 x 512 rows, not a multiple of 8 tiles of 256 rows, so the
    JAX package (ops/pallas_cc.py:373) runs no sweep kernel there and the
    port no K4: both take the exact fallback, with the same labels."""
    coords = dryrun.dryrun_inputs(N)["pointgroup"][0]["coords"]
    pts = np.concatenate([coords, coords + 0.05])
    bids = np.repeat(np.int32([0, 1]), len(coords))
    valid = np.ones(len(pts), bool)
    sem = np.full(len(pts), 2, np.int32)
    j_lab, j_win = pallas_cc.semantic_radius_cc(
        jnp.asarray(pts), dryrun.PG_MODEL["cluster_radius"], jnp.asarray(bids),
        jnp.asarray(valid), jnp.asarray(sem), fused_halves=True, return_use_window=True)
    t_lab, t_win = radius_cc.semantic_radius_cc(
        torch.from_numpy(pts), dryrun.PG_MODEL["cluster_radius"], torch.from_numpy(bids),
        torch.from_numpy(valid), torch.from_numpy(sem), fused_halves=True,
        return_use_window=True)
    assert not bool(j_win) and not bool(t_win)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))


@pytest.mark.parametrize("cards, error", [(0, RuntimeError), (1, ValueError)])
def test_cuda_without_enough_cards_raises(monkeypatch, cards, error):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(dryrun, "dryrun_rank", None)  # no rank may start
    with pytest.raises(error):
        dryrun_multichip(N, "cuda")
