"""The last public functions and options of the JAX package that the port
had left out, against the JAX package on the CPU:

  * ops/segment_ops: `segment_argmax` (the smallest index among a
    segment's tied maxima, per column; 0 for an empty segment) exactly,
    `csr_segment_reduce` in its four modes with padded offsets, and
    `set_default_method`'s names;
  * ops/knn `ball_query` (one set with itself, empty slots the point's own
    index) exactly, over two batch ids, padding rows and a dense cluster
    that overflows its buckets;
  * sparse/conv `sparse_batch_norm_stats` to float32 rounding;
  * PointGroup's `skip_score_unet` (the parameter tree without the
    ScoreNet's U-Net, key for key the flax tree's, read by jax.eval_shape)
    and `score_stop_gradient` (the score loss reaches the ScoreNet and not
    the backbone);
  * pointgroup_loss's `loss_weight` and `gt_scores`: the total and its
    parts within 1e-6 of JAX's on the same outputs;
  * utils/logging `format_class_iou_table` character for character, with
    and without a NaN class, and the one CLASS_NAMES_20 the CLIs read."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import pointgroup as JP
from seggroup_tpu.ops import knn as JK
from seggroup_tpu.ops import segment_ops as JS
from seggroup_tpu.sparse import conv as JC
from seggroup_tpu.sparse.tensor import SparseTensor as JSparseTensor
from seggroup_tpu.utils import logging as JL
from seggroup_tpu_torch.cli import stage2_common
from seggroup_tpu_torch.models import pointgroup as TP
from seggroup_tpu_torch.models.convert import pointgroup_params_from_flax
from seggroup_tpu_torch.ops import knn as TK
from seggroup_tpu_torch.ops import segment_ops as TS
from seggroup_tpu_torch.sparse import conv as TC
from seggroup_tpu_torch.utils import format_class_iou_table
from seggroup_tpu_torch.utils import logging as TL

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(400,), (400, 3)])
def test_segment_argmax_matches_jax(shape):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 5, size=shape).astype(np.float32)  # many ties
    ids = rng.integers(-2, 40, size=400).astype(np.int32)  # padding and empty segments
    want = np.asarray(JS.segment_argmax(jnp.asarray(data), jnp.asarray(ids), 42))
    got = TS.segment_argmax(torch.from_numpy(data), torch.from_numpy(ids), 42)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["sum", "mean", "max", "min"])
def test_csr_segment_reduce_matches_jax(mode):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(50, 4)).astype(np.float32)
    offsets = np.array([0, 3, 3, 10, 24, 41, 41, 41], np.int32)  # an empty segment, padding
    want = np.asarray(JS.csr_segment_reduce(jnp.asarray(data), jnp.asarray(offsets), 5, mode))
    got = TS.csr_segment_reduce(torch.from_numpy(data), torch.from_numpy(offsets), 5, mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        TS.csr_segment_reduce(torch.from_numpy(data), torch.from_numpy(offsets), 5, "median")


def test_set_default_method_takes_the_jax_names():
    try:
        for name in ("sorted", "scatter"):
            JS.set_default_method(name)
            TS.set_default_method(name)
        for mod in (JS, TS):
            with pytest.raises(ValueError):
                mod.set_default_method("bogus")
    finally:
        JS.set_default_method("scatter")
        TS.set_default_method("scatter")


def test_ball_query_matches_jax():
    rng = np.random.default_rng(2)
    n = 1024
    coords = rng.uniform(0, 1.5, size=(n, 3)).astype(np.float32)
    coords[:60] = coords[0] + rng.normal(scale=0.01, size=(60, 3))  # overflows its buckets
    batch_ids = (np.arange(n) >= n // 2).astype(np.int32)
    valid = rng.random(n) > 0.1
    args = (coords, 0.12, batch_ids, valid)
    want = [np.asarray(x) for x in JK.ball_query(*(jnp.asarray(a) for a in args),
                                                 max_neighbors=16, bucket_cap=8)]
    got = TK.ball_query(torch.from_numpy(coords), 0.12, torch.from_numpy(batch_ids),
                        torch.from_numpy(valid), max_neighbors=16, bucket_cap=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[2].any() and (want[1] > 1).any() and (want[1] == 0).any()


def test_sparse_batch_norm_stats_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(2.0, 3.0, size=(300, 8)).astype(np.float32)
    valid = rng.random(300) > 0.3
    want = JC.sparse_batch_norm_stats(jnp.asarray(feats), jnp.asarray(valid))
    got = TC.sparse_batch_norm_stats(torch.from_numpy(feats), torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def _pg_inputs(n=256, cap=256):
    rng = np.random.default_rng(4)
    coords = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    vc = np.zeros((cap, 4), np.int32)
    vc[:, 1:] = np.floor(coords[:cap] / 0.05).astype(np.int32)
    st = JSparseTensor(jnp.asarray(vc), jnp.zeros((cap, 6)), jnp.ones((cap,), bool),
                       jnp.int32(cap))
    return (st, jnp.arange(n, dtype=jnp.int32) % cap, jnp.asarray(coords),
            jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool))


def test_skip_score_unet_has_the_jax_parameter_tree():
    """Without the ScoreNet's U-Net, the port's parameters are the flax
    tree's key for key (with it, tests/test_torch_pointgroup.py loads the
    flax tree strictly)."""
    config = dict(classes=8, m=8, max_proposals_per_source=16, score_cap=256,
                  level_caps=[256 >> i for i in range(7)])
    jm = JP.PointGroup(skip_score_unet=True, **config)
    shapes = jax.eval_shape(lambda r: jm.init(r, *_pg_inputs(), do_clustering=True,
                                              train=False), jax.random.PRNGKey(0))
    want = pointgroup_params_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                    shapes))
    got = TP.PointGroup(skip_score_unet=True, device="cpu", **config).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    assert not any(k.startswith("score_unet.") for k in got)
    full = TP.PointGroup(device="cpu", **config).state_dict()
    assert set(full) - set(got) == {k for k in full if k.startswith("score_unet.")} != set()


def test_score_stop_gradient_keeps_the_score_loss_off_the_backbone():
    """The ScoreNet's input point features detached: the same scores, and
    their gradient reaches the ScoreNet's weights and not the point
    features the backbone made."""
    rng = np.random.default_rng(6)
    n = 256
    coords = np.concatenate([rng.normal(c, 0.02, size=(n // 2, 3))
                             for c in (0.5, 1.5)]).astype(np.float32)
    sem = torch.full((n, 8), -5.0)
    sem[:, 3] = 5.0  # every point an object of class 3: two blobs
    args = (sem, torch.zeros(n, 3), torch.from_numpy(coords), torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool))
    point_feats = rng.normal(size=(n, 8)).astype(np.float32)
    out = {}
    for stop in (False, True):
        model = TP.PointGroup(classes=8, m=8, score_cap=256, cluster_radius=0.1,
                              cluster_npoint_thre=20, score_stop_gradient=stop, seed=3,
                              device="cpu")
        props = model.cluster(*args)
        assert int(props.num_proposals) == 4  # two blobs on each of the two sources
        feats = torch.from_numpy(point_feats).requires_grad_()
        scores = model.score(feats, props.proposal_of_point, props.score_vox, train=True)
        scores.sum().backward()
        out[stop] = (scores.detach(), feats.grad,
                     model.score_linear.weight.grad.abs().sum().item())
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    assert out[False][1] is not None and out[False][1].abs().sum() > 0
    assert out[True][1] is None
    assert out[True][2] > 0 and out[False][2] > 0


def test_pointgroup_loss_weights_and_given_targets_match_jax():
    rng = np.random.default_rng(5)
    n, c, p, i_cap = 300, 8, 16, 8
    out = dict(semantic_scores=rng.normal(size=(n, c)).astype(np.float32),
               pt_offsets=rng.normal(scale=0.1, size=(n, 3)).astype(np.float32),
               scores=rng.normal(size=(p,)).astype(np.float32),
               proposal_of_point=rng.integers(0, p + 1, size=(2, n)).astype(np.int32),
               proposal_valid=rng.random(p) > 0.3,
               num_proposals=np.int32(p))
    labels = rng.integers(-1, c, size=n).astype(np.int32)
    labels[labels < 0] = JP.IGNORE
    inst = rng.integers(0, i_cap, size=n).astype(np.int32)
    inst[rng.random(n) < 0.2] = JP.IGNORE
    centroid = rng.normal(size=(n, 3)).astype(np.float32)
    pointnum = np.bincount(inst[inst != JP.IGNORE], minlength=i_cap).astype(np.int32)
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.05
    gt_scores = rng.random(p).astype(np.float32)
    rest = (labels, inst, centroid, pointnum, coords, valid)
    weights = (0.5, 2.0, 1.5, 3.0)
    for given in (None, gt_scores):
        j_total, j_aux = JP.pointgroup_loss(
            JP.PGOutput(**{k: jnp.asarray(v) for k, v in out.items()}),
            *(jnp.asarray(a) for a in rest), num_instances_cap=i_cap, with_score=True,
            loss_weight=weights, gt_scores=None if given is None else jnp.asarray(given))
        t_total, t_aux = TP.pointgroup_loss(
            TP.PGOutput(**{k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}),
            *(torch.from_numpy(a) for a in rest), num_instances_cap=i_cap, with_score=True,
            loss_weight=weights, gt_scores=None if given is None else torch.from_numpy(given))
        np.testing.assert_allclose(t_total.item(), float(j_total), rtol=1e-6)
        assert set(t_aux) == set(j_aux)
        for k in j_aux:
            np.testing.assert_allclose(t_aux[k].item(), float(j_aux[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("nan_class", [None, 7])
def test_format_class_iou_table(nan_class):
    rng = np.random.default_rng(3)
    iou_sem = rng.random(20)
    iou_ins = rng.random(18)
    if nan_class is not None:  # a class absent from the scenes: nan in both columns
        iou_sem[nan_class] = np.nan
        iou_ins[nan_class - 2] = np.nan
    acc_sem, acc_ins = float(rng.random()), float(rng.random())
    want = JL.format_class_iou_table(iou_sem, iou_ins, acc_sem, acc_ins)
    assert TL.format_class_iou_table(iou_sem, iou_ins, acc_sem, acc_ins) == want
    assert format_class_iou_table is TL.format_class_iou_table
    assert TL.CLASS_NAMES_20 == JL.CLASS_NAMES_20
    assert stage2_common.CLASS_NAMES_20 is TL.CLASS_NAMES_20
