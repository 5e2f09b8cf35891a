"""The multichip dry run (__graft_entry__.py `dryrun_multichip`): one step of
each data-parallel and point-sharded path on tiny shapes, in every rank of
a group that parallel/dp.launch starts.

`dryrun_inputs(n)` draws what the JAX dry run draws, in its order, with the
port's own data pieces; `dryrun_rank` runs the seven checks in one rank and
returns what infer.dryrun_multichip prints. The checks, in the JAX
function's order:

1. the stage-1 DP train step (SegGroupGNN, cluster cap 128, Adam 1e-3),
   rank d on synthetic scene d;
2. point_sharded_edge_conv, rank d on rows [128 d, 128 (d + 1));
3. the stage-1 point-sharded train gradient on scene 0 from the initial
   weights;
4. the MinkUNet DP step (Res16UNet14A) on a host plan;
5. the packed MinkUNet DP step (float16 wire, plan built on the rank) from
   the initial weights and optimizer state, its loss within 0.1 of 4's;
6. the KPConv DP step at the JAX function's defaults (no gradient
   transform, one neighbour cap of 32);
7. the packed PointGroup DP step with the clustering.

Every rank draws the same initial weights from the port's seeded
initialisation and `Mesh.replicate` then hands every rank rank 0's, the
form the JAX `replicate` of one init takes here. After each check with a
model the ranks compare a digest of its parameters and floating buffers
(check 3: of the gradients too) and raise unless they are bit-equal; a
check whose values fail the JAX function's assertions raises too."""

from __future__ import annotations

import hashlib
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from seggroup_tpu_torch.parallel.dp import Mesh

STAGE1_SCENE = dict(num_points=1024, num_slots=32, num_edges=128, num_instances=3,
                    segs_per_instance=3)
CLUSTER_CAP = 128
EDGE_ROWS = 128  # rows of the edge conv a rank
MINK_CAP, MINK_POINTS, MINK_VOXEL = 512, 600, 0.1
MINK_CAPS = [MINK_CAP, MINK_CAP // 2, MINK_CAP // 4, MINK_CAP // 8, MINK_CAP // 8]
KP_POINTS, KP_DL0 = 512, 0.08
KP_CAPS = [KP_POINTS // 2, KP_POINTS // 4, KP_POINTS // 8, KP_POINTS // 16]
PG_POINTS, PG_VOXEL_CAP, PG_INSTANCE_CAP, PG_VOXEL = 512, 256, 16, 0.1
PG_MODEL = dict(classes=8, m=8, block_reps=1, max_proposals_per_source=16, score_cap=128,
                cluster_npoint_thre=10, cluster_radius=0.3)
PACKED_LOSS_TOL = 0.1  # the packed step's float16 features against the host plan's float32

CHECKS = ("stage1_dp", "edge_conv", "stage1_point_sharded", "minkunet_dp",
          "minkunet_packed_dp", "kpconv_dp", "pointgroup_packed_dp")


def dryrun_inputs(n_devices: int) -> dict:
    """The JAX dry run's inputs for `n_devices` ranks, as numpy: "scenes"
    (rank d's stage-1 scene, seed d), "edge_conv" (x, idx, w: all ranks'
    rows), and a list of rank d's batches each for "minkunet" (VoxelBatch),
    "minkunet_wire" (its pack_voxel_batch), "kpconv" (pts, feats, labels,
    bids, valid) and "pointgroup" (pack_pg_batch's wire). Checks 4, 6 and 7
    draw from one generator, in that order, as the JAX function does."""
    from seggroup_tpu_torch.data.pg_wire import pack_pg_batch
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.ops.voxelize import voxelize
    from seggroup_tpu_torch.sparse.device_plan import pack_voxel_batch

    n = n_devices
    out = {"scenes": [make_synthetic_scene(seed=d, **STAGE1_SCENE) for d in range(n)]}
    rng = np.random.default_rng(0)
    rows = EDGE_ROWS * n
    out["edge_conv"] = (rng.normal(size=(rows, 9)).astype(np.float32),
                        rng.integers(0, rows, size=(rows, 8)).astype(np.int32),
                        rng.normal(size=(18, 16)).astype(np.float32))

    rng = np.random.default_rng(0)
    out["minkunet"] = []
    for _ in range(n):
        pts = rng.normal(size=(MINK_POINTS, 3)).astype(np.float32)
        cols = rng.uniform(0, 255, size=(MINK_POINTS, 3)).astype(np.float32)
        labels = rng.integers(0, 20, size=MINK_POINTS).astype(np.int32)
        out["minkunet"].append(make_voxel_batch([(pts, cols, labels)], MINK_CAP, MINK_VOXEL,
                                                rng=rng))
    out["minkunet_wire"] = [pack_voxel_batch(vb) for vb in out["minkunet"]]

    out["kpconv"] = []
    for _ in range(n):
        pts = rng.normal(size=(KP_POINTS, 3)).astype(np.float32)
        labels = rng.integers(0, 20, size=KP_POINTS).astype(np.int32)
        out["kpconv"].append((pts, np.ones((KP_POINTS, 4), np.float32), labels,
                              np.zeros(KP_POINTS, np.int32), np.ones(KP_POINTS, bool)))

    out["pointgroup"] = []
    for _ in range(n):
        coords = rng.uniform(0, 3, size=(PG_POINTS, 3)).astype(np.float32)
        labels = rng.integers(2, 6, size=PG_POINTS).astype(np.int32)
        inst = rng.integers(0, 4, size=PG_POINTS).astype(np.int32)
        bids = np.zeros(PG_POINTS, np.int32)
        valid = np.ones(PG_POINTS, bool)
        ic = np.floor(coords / PG_VOXEL).astype(np.int32)
        ic -= ic.min(0)
        vm = voxelize(torch.from_numpy(ic), torch.from_numpy(bids), torch.from_numpy(valid),
                      PG_VOXEL_CAP)
        # the JAX run's voxel features for its init: drawn to keep the
        # stream; the wire carries coords * 0.1 as the colours, as there
        rng.normal(size=(PG_POINTS, 3))
        centroid = np.zeros((PG_POINTS, 3), np.float32)
        pointnum = np.zeros(PG_INSTANCE_CAP, np.int32)
        for k in range(4):
            sel = inst == k
            if sel.any():
                centroid[sel] = coords[sel].mean(0)
                pointnum[k] = sel.sum()
        hb = SimpleNamespace(coords=coords, feats=coords * 0.1, batch_ids=bids, valid=valid,
                             labels=labels, instance_labels=inst, instance_centroid=centroid,
                             instance_pointnum=pointnum)
        out["pointgroup"].append(pack_pg_batch(hb, vm.voxel_coords.numpy(),
                                               int(vm.num_voxels), vm.point2voxel.numpy()))
    return out


def _kernel_modules() -> dict:
    from seggroup_tpu_torch.ops import cuda_cc, cuda_fps
    from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw

    return {"masked_fps": cuda_fps, "subm_conv": cuda_subm_conv, "subm_dw": cuda_subm_dw,
            "cc_sweep": cuda_cc}


def _same_on_ranks(mesh: Mesh, check: str, tensors) -> str:
    """The sha256 of `tensors` (in order), gathered from every rank over
    the host group; raises unless every rank's is rank 0's."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    digest = h.hexdigest()
    digests = [None] * mesh.size
    dist.all_gather_object(digests, digest, group=mesh.host_group)
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"dry run {check}: the ranks' states differ ({digests})")
    return digest


def _floats(model: torch.nn.Module) -> list[torch.Tensor]:
    return [t for t in model.state_dict().values() if t.is_floating_point()]


def _finite(check: str, **values) -> None:
    for name, v in values.items():
        if not np.isfinite(v):
            raise AssertionError(f"dry run {check}: {name} is {v}")


def dryrun_rank(mesh: Mesh, inputs: dict) -> dict:
    """The seven checks in this rank (launch calls it in each rank's
    process) on its slice of `inputs` (dryrun_inputs). Returns, per check:
    the line the JAX function prints ("lines", in order), the digest of
    the ranks' common state ("digests"; not for the edge conv, which has
    no state), the wall seconds after a device synchronisation
    ("seconds") and the launches of each kernel ("launches"); the losses
    ("losses") and this rank's edge-conv slab ("edge_conv")."""
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_on_device
    from seggroup_tpu_torch.device import resolve_device
    from seggroup_tpu_torch.models.kpconv import KPFCNN
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.models.pointgroup import PointGroup
    from seggroup_tpu_torch.models.seggroup import Classifier, SegGroupGNN
    from seggroup_tpu_torch.parallel.dp import (build_kpconv_dp_step, build_minkunet_dp_step,
                                                build_minkunet_dp_step_packed,
                                                build_pointgroup_dp_step_packed,
                                                build_stage1_train_step, rank_seed)
    from seggroup_tpu_torch.parallel.point_sharding import (build_stage1_point_sharded_grad,
                                                            make_point_sharded_model,
                                                            point_sharded_edge_conv)
    from seggroup_tpu_torch.solvers import make_optimizer, make_schedule
    from seggroup_tpu_torch.sparse.plan import build_unet_plan

    dev = resolve_device(mesh.device)
    n, d = mesh.size, mesh.rank
    head = f"dryrun_multichip({n}):"
    mods = _kernel_modules()
    out = {"lines": [], "digests": {}, "seconds": {}, "launches": {}, "losses": {}}

    def optimizer(name, model, lr):
        """optax.sgd(lr, momentum=0.9) or optax.adam(lr): no weight decay."""
        return make_optimizer(name, model.parameters(), make_schedule("constant", lr),
                              momentum=0.9, weight_decay=0.0)

    def dropout_keep(seed):
        """The classifier's dropout mask, drawn on the CPU as the jitter is,
        so that the card and the CPU draw the same one."""
        gen = torch.Generator().manual_seed(seed)
        keep = torch.rand((model.max_instances, 128), generator=gen)
        return (keep < 1.0 - Classifier.rate).to(dev)

    def run(check, fn):
        """fn() -> (its line, the tensors the ranks must share or None),
        timed and counted."""
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        line, shared = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"][check] = time.perf_counter() - t0
        out["launches"][check] = {name: mod.launches for name, mod in mods.items()}
        if shared is not None:
            out["digests"][check] = _same_on_ranks(mesh, check, shared)
        out["lines"].append(f"{head} {line}")

    scene0 = inputs["scenes"][0].to(dev)
    model = SegGroupGNN(cluster_cap=CLUSTER_CAP, seed=0, device=dev)
    mesh.replicate(model)
    s1_init = {k: v.clone() for k, v in model.state_dict().items()}

    def stage1_dp():
        # weight decay 1e-4: the JAX package's make_optimizer("adam", lr=1e-3)
        opt, _ = make_optimizer("Adam", model.parameters(), make_schedule("constant", 1e-3))
        step = build_stage1_train_step(model, opt, mesh)
        loss, _ = step(inputs["scenes"][d].to(dev), dropout_keep=dropout_keep(rank_seed(3, d)))
        out["losses"]["stage1_dp"] = loss = float(loss)
        _finite("stage1_dp", loss=loss)
        return f"ok, summed loss {loss:.4f}", _floats(model)

    def edge_conv():
        x, idx, w = (torch.from_numpy(a).to(dev) for a in inputs["edge_conv"])
        rows = slice(EDGE_ROWS * d, EDGE_ROWS * (d + 1))
        slab = point_sharded_edge_conv(mesh, x[rows], idx[rows], w)
        out["edge_conv"] = slab.cpu().numpy()
        if not np.isfinite(out["edge_conv"]).all():
            raise AssertionError("dry run edge_conv: the output is not finite")
        return f"point-sharded edge conv ok ({n} shards)", None

    def stage1_point_sharded():
        sp_model = make_point_sharded_model(mesh, cluster_cap=CLUSTER_CAP, seed=0)
        sp_model.load_state_dict(s1_init)
        step = build_stage1_point_sharded_grad(sp_model, mesh)
        # the replicated work draws the same dropout on every rank
        loss, grads = step(scene0, dropout_keep=dropout_keep(5))
        out["losses"]["stage1_point_sharded"] = loss = float(loss)
        gnorm = float(sum(g.abs().sum() for g in grads.values()))
        _finite("stage1_point_sharded", loss=loss, gradient_norm=gnorm)
        if not gnorm > 0:
            raise AssertionError("dry run stage1_point_sharded: every gradient is zero")
        return (f"stage-1 point-sharded train step ok, loss {loss:.4f}",
                _floats(sp_model) + [grads[k] for k in sorted(grads)])

    mink = make_minkunet("Res16UNet14A", out_channels=20, level_caps=MINK_CAPS, seed=0,
                         device=dev)
    mesh.replicate(mink)
    mink_init = {k: v.clone() for k, v in mink.state_dict().items()}

    def minkunet_dp():
        opt, sched = optimizer("SGD", mink, 1e-2)
        vb = inputs["minkunet"][d]
        plan = build_unet_plan(vb.coords, int(vb.num), MINK_CAPS, with_windows=False)
        st, labels, plan = batch_on_device(vb, plan, dev, MINK_CAPS)
        loss, hist = build_minkunet_dp_step(mink, opt, sched, mesh)(st, labels, plan)
        out["losses"]["minkunet_dp"] = loss = float(loss)
        _finite("minkunet_dp", loss=loss)
        if int(hist.sum()) <= 0:
            raise AssertionError("dry run minkunet_dp: the confusion matrix is empty")
        return f"minkunet dp ok, summed loss {loss:.4f}", _floats(mink)

    def minkunet_packed_dp():
        mink.load_state_dict(mink_init)  # the initial weights, a fresh optimizer
        opt, sched = optimizer("SGD", mink, 1e-2)
        step = build_minkunet_dp_step_packed(mink, opt, sched, mesh, MINK_CAPS)
        loss, hist = step(inputs["minkunet_wire"][d])
        out["losses"]["minkunet_packed_dp"] = loss = float(loss)
        _finite("minkunet_packed_dp", loss=loss)
        if abs(loss - out["losses"]["minkunet_dp"]) >= PACKED_LOSS_TOL:
            raise AssertionError(f"dry run minkunet_packed_dp: loss {loss} against the host "
                                 f"plan's {out['losses']['minkunet_dp']}")
        return f"minkunet packed dp ok, summed loss {loss:.4f}", _floats(mink)

    def kpconv_dp():
        kp = KPFCNN(num_classes=20, first_features_dim=16, dl0=KP_DL0, seed=1, device=dev)
        mesh.replicate(kp)
        opt, sched = optimizer("SGD", kp, 1e-2)
        step = build_kpconv_dp_step(kp, opt, sched, mesh, dl0=KP_DL0, level_caps=KP_CAPS)
        loss, _ = step(*inputs["kpconv"][d])
        out["losses"]["kpconv_dp"] = loss = float(loss)
        _finite("kpconv_dp", loss=loss)
        return f"kpconv dp ok, summed loss {loss:.4f}", _floats(kp)

    def pointgroup_packed_dp():
        pg = PointGroup(seed=2, device=dev, **PG_MODEL)
        mesh.replicate(pg)
        opt, sched = optimizer("Adam", pg, 1e-3)
        step = build_pointgroup_dp_step_packed(pg, opt, sched, mesh, PG_VOXEL_CAP,
                                               do_clustering=True)
        jitter = torch.rand(3, generator=torch.Generator().manual_seed(rank_seed(3, d)))
        loss = float(step(inputs["pointgroup"][d], jitter.to(dev)))
        out["losses"]["pointgroup_packed_dp"] = loss
        _finite("pointgroup_packed_dp", loss=loss)
        return f"pointgroup packed dp ok, summed loss {loss:.4f}", _floats(pg)

    for check, fn in zip(CHECKS, (stage1_dp, edge_conv, stage1_point_sharded, minkunet_dp,
                                  minkunet_packed_dp, kpconv_dp, pointgroup_packed_dp)):
        run(check, fn)
    return out
