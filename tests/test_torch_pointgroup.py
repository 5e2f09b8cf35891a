"""Port PointGroup (seggroup_tpu_torch.models.pointgroup) against the flax
model at shared weights on the CPU, at the size of tests/test_pointgroup.py
(2,048 points, m=8): parameter names and counts, the weight converter, each
stage of the forward at shared inputs, and the whole forward.

Tolerances. The heads: atol 2e-4 + rtol 1e-3, the bound the MinkUNet parity
holds (bf16 products, float32 sums in another order). Clustering and
proposals at shared heads: exactly equal. The score voxelisation at shared
proposals: exactly equal (the port sums the proposal centres in the
reference's order and rounds the scaling as jitted XLA does). Scores at a
shared voxel map: the heads' tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models.pointgroup import PointGroup as FlaxPointGroup
from seggroup_tpu.ops.voxelize import voxel_gather_mean, voxelize
from seggroup_tpu.sparse.tensor import SparseTensor as JSparseTensor
from seggroup_tpu_torch.models.convert import pointgroup_params_from_flax
from seggroup_tpu_torch.models.pointgroup import PGOutput, PointGroup
from seggroup_tpu_torch.ops.voxelize import VoxelMap
from seggroup_tpu_torch.sparse.tensor import SparseTensor

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-3
CONFIG = dict(classes=8, m=8, max_proposals_per_source=32, score_cap=2048,
              cluster_npoint_thre=20, cluster_radius=0.25)


def _scene():
    """tests/test_pointgroup.py's batch: 2 scenes of 3 blobs, 1,900 valid
    points of 2,048, voxelised at 2 cm."""
    rng = np.random.default_rng(0)
    n, per = 2048, 1900 // 6
    coords = np.zeros((n, 3), np.float32)
    batch_ids = np.zeros(n, np.int32)
    centers = rng.uniform(0, 4, size=(6, 3)).astype(np.float32)
    for k in range(6):
        sl = slice(k * per, (k + 1) * per)
        coords[sl] = centers[k] + rng.normal(scale=0.05, size=(per, 3))
        batch_ids[sl] = k // 3
    valid = np.zeros(n, bool)
    valid[: 6 * per] = True
    colors = rng.normal(size=(n, 3)).astype(np.float32)
    icoords = np.floor(coords / 0.02).astype(np.int32)
    icoords -= icoords.min(0)
    feats = np.concatenate([colors, coords], 1).astype(np.float32)
    return coords, batch_ids, valid, icoords, feats


@pytest.fixture(scope="module")
def shared():
    """The flax model with perturbed BatchNorm parameters and statistics
    and biases (so that no layer is the identity), its jitted outputs, and
    the port loaded with the same weights."""
    coords, batch_ids, valid, icoords, feats = _scene()
    vm = voxelize(jnp.array(icoords), jnp.array(batch_ids), jnp.array(valid), 2048)
    st = JSparseTensor(vm.voxel_coords, voxel_gather_mean(jnp.array(feats), vm),
                       vm.voxel_valid, vm.num_voxels)
    args = (st, vm.point2voxel, jnp.array(coords), jnp.array(batch_ids), jnp.array(valid))
    model = FlaxPointGroup(**CONFIG)
    variables = jax.jit(lambda r, *a: model.init(r, *a, do_clustering=True, train=False))(
        jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(1)

    def perturb(x):
        x = np.asarray(x)
        return x + 0.1 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1 else x
    variables = {"params": jax.tree.map(perturb, variables["params"]),
                 "batch_stats": jax.tree.map(lambda x: np.abs(perturb(x)) + 0.5,
                                             variables["batch_stats"])}
    full = jax.jit(lambda v, *a: model.apply(v, *a, do_clustering=True, train=False))(
        variables, *args)
    # the reference's own split: program A returns the score voxelisation
    _, ctx = jax.jit(lambda v, *a: model.apply(v, *a, do_clustering=True, train=False,
                                               proposals_only=True))(variables, *args)
    heads = jax.jit(lambda v, *a: model.apply(v, *a, do_clustering=False, train=False))(
        variables, *args)

    port = PointGroup(device="cpu", **CONFIG)
    port.load_state_dict(pointgroup_params_from_flax(jax.tree.map(np.asarray, variables)))
    t_args = (SparseTensor(*(torch.from_numpy(np.array(x)) for x in st)),
              torch.from_numpy(np.array(vm.point2voxel)), torch.from_numpy(coords),
              torch.from_numpy(batch_ids), torch.from_numpy(valid))
    return dict(variables=variables, full=jax.tree.map(np.array, full),
                vox=jax.tree.map(np.array, ctx["vox"]),
                heads=jax.tree.map(np.array, heads), port=port, args=t_args, valid=valid)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def test_parameter_names_and_counts_match_flax(shared):
    flax_params = dict(_flat(shared["variables"]["params"]))
    flax_stats = dict(_flat(shared["variables"]["batch_stats"]))
    port = shared["port"]
    params = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    assert len(params) == len(flax_params) and len(buffers) == len(flax_stats)
    assert sum(p.numel() for p in params.values()) == sum(v.size for v in flax_params.values())
    assert sum(b.numel() for b in buffers.values()) == sum(v.size for v in flax_stats.values())
    rename = {k: k[: -len("kernel")] + "weight" if v.ndim == 2 else k
              for k, v in flax_params.items()}
    assert set(rename.values()) == set(params)
    assert set(flax_stats) == set(buffers)
    # the recursion keeps its names down to the seventh level
    assert "unet.u.u.u.u.u.u.block1.conv2.kernel" in params
    assert "score_unet.u.block0.bn1.mean" in buffers
    # the concatenation's first tail block has the K=1 branch, no other block
    assert params["unet.tail0.i_branch.kernel"].shape == (1, 16, 8)
    assert [k for k in params if "i_branch" in k and "tail0" not in k] == []


def test_converter_carries_every_tensor(shared):
    sd = pointgroup_params_from_flax(jax.tree.map(np.asarray, shared["variables"]))
    port_sd = shared["port"].state_dict()
    assert set(sd) == set(port_sd)
    flax_all = dict(_flat(shared["variables"]["params"]))
    flax_all.update(_flat(shared["variables"]["batch_stats"]))
    assert len(sd) == len(flax_all)
    for k, v in flax_all.items():
        if v.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            np.testing.assert_array_equal(sd[k[:-6] + "weight"].numpy(), v.T)
        else:
            np.testing.assert_array_equal(sd[k].numpy(), v)
    fresh = PointGroup(device="cpu", **CONFIG)
    fresh.load_state_dict(sd)  # strict: nothing missing, nothing left over


def test_heads_match_flax(shared):
    port, args = shared["port"], shared["args"]
    with torch.no_grad():
        _, sem, off = port.backbone(args[0], args[1], args[4])
    want = shared["full"]
    np.testing.assert_allclose(sem.numpy(), want.semantic_scores, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(off.numpy(), want.pt_offsets, atol=ATOL, rtol=RTOL)
    assert np.abs(want.semantic_scores).max() > 0.5 and np.abs(want.pt_offsets).max() > 0.1
    assert (sem.numpy()[~shared["valid"]] == want.semantic_scores[~shared["valid"]]).all()
    assert (off.numpy()[~shared["valid"]] == 0).all()


def test_clustering_equal_at_shared_heads(shared):
    """Given the reference's own scores and offsets, the proposals, their
    validity and count, and the score voxelisation (every field of the
    VoxelMap) are exactly the reference's."""
    port, args, want = shared["port"], shared["args"], shared["full"]
    props = port.cluster(torch.from_numpy(want.semantic_scores),
                         torch.from_numpy(want.pt_offsets), *args[2:])
    np.testing.assert_array_equal(props.proposal_of_point.numpy(), want.proposal_of_point)
    np.testing.assert_array_equal(props.proposal_valid.numpy(), want.proposal_valid)
    assert int(props.num_proposals) == int(want.num_proposals) >= 6
    for got, ref, name in zip(props.score_vox, shared["vox"], VoxelMap._fields):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    # both clustering sources found proposals, and some points found none
    assert (props.proposal_of_point[0] < 32).any() and (props.proposal_of_point[1] < 64).any()
    assert (props.proposal_of_point[0] == 64).any()
    assert int(props.score_vox.num_voxels) > 100


def test_scores_match_flax_at_shared_voxel_map(shared):
    port, args, want = shared["port"], shared["args"], shared["full"]
    vox = VoxelMap(*(torch.from_numpy(np.array(x)) for x in shared["vox"]))
    with torch.no_grad():
        point_feats, _, _ = port.backbone(args[0], args[1], args[4])
        scores = port.score(point_feats, torch.from_numpy(want.proposal_of_point), vox)
    np.testing.assert_allclose(scores.numpy(), want.scores, atol=ATOL, rtol=RTOL)
    assert np.abs(want.scores[want.proposal_valid]).max() > 1e-3


def test_whole_forward_matches_flax(shared):
    """The chained forward on the seed's scene: the heads within tolerance,
    the predicted classes equal on every valid point, and therefore the
    proposals exactly equal and the scores within tolerance."""
    port, args, want = shared["port"], shared["args"], shared["full"]
    with torch.no_grad():
        out = port(*args, do_clustering=True)
    assert isinstance(out, PGOutput)
    valid = shared["valid"]
    agree = (out.semantic_scores.numpy().argmax(1) == want.semantic_scores.argmax(1))[valid]
    assert agree.all()
    np.testing.assert_allclose(out.pt_offsets.numpy(), want.pt_offsets, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(out.proposal_of_point.numpy(), want.proposal_of_point)
    np.testing.assert_array_equal(out.proposal_valid.numpy(), want.proposal_valid)
    assert int(out.num_proposals) == int(want.num_proposals)
    np.testing.assert_allclose(out.scores.numpy(), want.scores, atol=ATOL, rtol=RTOL)
    assert out.scores.shape == (64,) and out.proposal_of_point.dtype == torch.int32


def test_no_clustering_matches_flax(shared):
    port, args, want = shared["port"], shared["args"], shared["heads"]
    with torch.no_grad():
        out = port(*args, do_clustering=False)
    np.testing.assert_allclose(out.semantic_scores.numpy(), want.semantic_scores,
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.pt_offsets.numpy(), want.pt_offsets, atol=ATOL, rtol=RTOL)
    for name in ("scores", "proposal_of_point", "proposal_valid", "num_proposals"):
        got, ref = getattr(out, name), getattr(want, name)
        assert tuple(got.shape) == ref.shape, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)


@pytest.mark.parametrize("kwargs", [dict(train=True), dict(jitter_rng=0), dict(plan={}),
                                    dict(proposals_only=True), dict(score_plan=())])
def test_training_arguments_raise(shared, kwargs):
    with pytest.raises(NotImplementedError):
        shared["port"](*shared["args"], do_clustering=True, **kwargs)


def test_seeded_init_has_flax_scales():
    """Random weights from a seed: every kernel's standard deviation is the
    variance-scaling one (1 / fan-in), biases zero, statistics (0, 1)."""
    a = PointGroup(device="cpu", seed=3, **CONFIG)
    b = PointGroup(device="cpu", seed=3, **CONFIG)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    w = a.unet.block0.conv1.kernel  # (27, 8, 8): fan-in 216
    assert abs(float(w.detach().std()) * (27 * 8) ** 0.5 - 1.0) < 0.1
    assert float(a.linear.bias.abs().max()) == 0.0
    assert float(a.output_bn.var.min()) == 1.0 and float(a.output_bn.mean.abs().max()) == 0.0
