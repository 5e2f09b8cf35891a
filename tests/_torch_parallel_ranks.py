"""The rank bodies of the port's data-parallel and point-sharding tests,
started by seggroup_tpu_torch.parallel.dp.launch in processes of their
own. This module imports the port only (no JAX): each spawned rank imports
it by name. Every body returns what the test compares: the model's state
after its steps, and for each step its state, the gradients the optimizer
took (the ranks' mean) and its combined metrics."""

from __future__ import annotations

import functools

import numpy as np
import torch

from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.solvers import make_optimizer, make_schedule


def _sgd(model, lr: float, momentum: float = 0.0, weight_decay: float = 0.0):
    """optax.sgd(lr) (or the drivers' SGD with momentum and weight decay)."""
    return make_optimizer("SGD", model.parameters(), make_schedule("constant", lr),
                          momentum=momentum, weight_decay=weight_decay)


def _f32_convs():
    """The submanifold convs at float32 in this process (the train-step
    parity configuration)."""
    from seggroup_tpu_torch.models import minkunet as TM

    TM.subm_conv = functools.partial(TM.subm_conv, compute_dtype=torch.float32)


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _copy(state: dict) -> dict:
    """A copy of `state` for launch: pickling a tensor for a spawned rank
    moves its storage into shared memory, so a thread reading the same
    tensors meanwhile may see it half moved."""
    return {k: v.clone() for k, v in state.items()}


def _grads(model) -> dict:
    """The gradients a step left (after the all-reduce: the ranks' mean)."""
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _at(model, state, k):
    """Before step k: with a list of states (one a step), the model restarts
    from the k-th (a stateless optimizer: plain SGD); with one state it
    goes on from where it is."""
    if isinstance(state, list):
        model.load_state_dict(state[k], strict=True)


def stage1(mesh, state, scene_kw, seeds, keeps, model_kw, lr):
    """build_stage1_infer_step on scene seeds[rank] at the initial weights,
    then two build_stage1_train_step steps (the drivers' SGD at 100 lr,
    momentum 0.9, weight decay 1e-4) on it with its keep mask."""
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN
    from seggroup_tpu_torch.parallel.dp import build_stage1_infer_step, build_stage1_train_step

    model = SegGroupGNN(compute_dtype=torch.float32, device=mesh.device, **model_kw)
    model.load_state_dict(state, strict=True)
    scene = make_synthetic_scene(seed=seeds[mesh.rank], **scene_kw).to(mesh.device)
    out = build_stage1_infer_step(model, mesh, "ins_infer")(scene)
    infer = {k: getattr(out, k).clone() for k in ("final_sem", "final_ins", "final_root",
                                                   "layer_roots", "max_cluster_size")}
    optimizer, _ = _sgd(model, lr * 100, momentum=0.9, weight_decay=1e-4)
    mesh.replicate(model, optimizer)
    step = build_stage1_train_step(model, optimizer, mesh)
    metrics = []
    for _ in range(2):
        loss, m = step(scene, dropout_keep=torch.from_numpy(keeps[mesh.rank]))
        metrics.append({"loss": loss, **{k: m[k] for k in ("iou_sem", "iou_ins", "acc")}})
    return {"infer": infer, "state": _state(model), "metrics": metrics}


def sharded(mesh, state, scene_kw, seed, keep, model_kw, conv_inputs):
    """The point-sharded forward and gradient of scene `seed`, and
    point_sharded_edge_conv on this rank's slab of `conv_inputs`."""
    from seggroup_tpu_torch.parallel.point_sharding import (build_stage1_point_sharded_forward,
                                                            build_stage1_point_sharded_grad,
                                                            make_point_sharded_model,
                                                            point_sharded_edge_conv)

    model = make_point_sharded_model(mesh, compute_dtype=torch.float32, **model_kw)
    model.load_state_dict(state, strict=True)
    scene = make_synthetic_scene(seed=seed, **scene_kw).to(mesh.device)
    out = build_stage1_point_sharded_forward(model, mesh)(scene)
    loss, grads = build_stage1_point_sharded_grad(model, mesh)(
        scene, dropout_keep=torch.from_numpy(keep))
    x, idx, w = (torch.from_numpy(a) for a in conv_inputs)
    rows = slice(mesh.rank * x.shape[0] // mesh.size, (mesh.rank + 1) * x.shape[0] // mesh.size)
    conv = point_sharded_edge_conv(mesh, x[rows], idx[rows], w)
    return {"out": {k: getattr(out, k).clone() for k in ("final_sem", "final_ins",
                                                         "final_root", "acc")},
            "loss": loss, "grads": grads, "state_after": _state(model), "conv": conv}


def minkunet(mesh, state, wires, model_name, caps, lr, f32=False):
    """Two steps of build_minkunet_dp_step_packed on this rank's wires and,
    from the same initial state, two of build_minkunet_dp_step on the same
    batches unpacked (float32 of the float16 features) with host plans."""
    from seggroup_tpu_torch.models.minkunet import make_minkunet
    from seggroup_tpu_torch.parallel.dp import (build_minkunet_dp_step,
                                                build_minkunet_dp_step_packed)
    from seggroup_tpu_torch.sparse.device_plan import unpack_voxel_batch
    from seggroup_tpu_torch.sparse.plan import build_unet_plan, plan_to_device

    if f32:
        _f32_convs()
    out = {}
    for mode in ("device", "host"):
        model = make_minkunet(model_name, out_channels=20, level_caps=caps, device=mesh.device)
        model.load_state_dict(state[0] if isinstance(state, list) else state, strict=True)
        optimizer, scheduler = _sgd(model, lr)
        mesh.replicate(model, optimizer)
        if mode == "device":
            step = build_minkunet_dp_step_packed(model, optimizer, scheduler, mesh, caps)
        else:
            inner = build_minkunet_dp_step(model, optimizer, scheduler, mesh)

            def step(wire):
                st, labels = unpack_voxel_batch(*wire, device=mesh.device)
                plan = build_unet_plan(st.coords.cpu().numpy(), int(st.num), list(caps),
                                       with_windows=False)
                return inner(st, labels, plan_to_device(plan, mesh.device))
        metrics, states, grads = [], [], []
        for k in range(2):
            _at(model, state, k)
            loss, hist = step(wires[k][mesh.rank])
            metrics.append({"loss": loss, "hist": hist})
            states.append(_state(model))
            grads.append(_grads(model))
        out[mode] = {"state": states[-1], "states": states, "grads": grads, "metrics": metrics}
    return out


def kpconv(mesh, state, batches, model_kw, dl0, caps, nbr_caps, lr, clip, offset_scale):
    """Two build_kpconv_dp_step steps on this rank's sphere batches."""
    from seggroup_tpu_torch.models.kpconv import KPFCNN
    from seggroup_tpu_torch.parallel.dp import build_kpconv_dp_step

    model = KPFCNN(device=mesh.device, **model_kw)
    model.load_state_dict(state[0] if isinstance(state, list) else state, strict=True)
    optimizer, scheduler = _sgd(model, lr)
    mesh.replicate(model, optimizer)
    step = build_kpconv_dp_step(model, optimizer, scheduler, mesh, dl0, caps, nbr_caps,
                                grad_clip_norm=clip, offset_lr_scale=offset_scale)
    metrics, states, grads = [], [], []
    for k in range(2):
        _at(model, state, k)
        loss, acc = step(*batches[k][mesh.rank])
        metrics.append({"loss": loss, "acc": acc})
        states.append(_state(model))
        grads.append(_grads(model))
    return {"state": states[-1], "states": states, "grads": grads, "metrics": metrics}


def pointgroup(mesh, state, wires, jitters, model_kw, voxel_cap, lr, f32=False):
    """Two steps, the first of the prepare phase and the second with the
    clustering, of build_pointgroup_dp_step_packed on this rank's wires
    (the plan built on the rank) and, from the same initial state, of
    build_pointgroup_dp_step on the same batches unpacked, without a plan;
    this rank's jitter of each step injected."""
    from seggroup_tpu_torch.data.pg_wire import unpack_pg_batch
    from seggroup_tpu_torch.models.pointgroup import PointGroup
    from seggroup_tpu_torch.parallel.dp import (build_pointgroup_dp_step,
                                                build_pointgroup_dp_step_packed)

    if f32:
        _f32_convs()
    out = {}
    for mode in ("device", "host"):
        model = PointGroup(device=mesh.device, **model_kw)
        model.load_state_dict(state[0] if isinstance(state, list) else state, strict=True)
        optimizer, scheduler = _sgd(model, lr)
        mesh.replicate(model, optimizer)
        if mode == "device":
            steps = [build_pointgroup_dp_step_packed(model, optimizer, scheduler, mesh,
                                                     voxel_cap, do_clustering=c)
                     for c in (False, True)]
        else:
            inner = [build_pointgroup_dp_step(model, optimizer, scheduler, mesh,
                                              do_clustering=c) for c in (False, True)]
            steps = [lambda w, j, f=f: f(unpack_pg_batch(w, voxel_cap, mesh.device), None, j)
                     for f in inner]
        losses, states, grads = [], [], []
        for k in range(2):
            _at(model, state, k)
            losses.append(steps[k](wires[k][mesh.rank], torch.from_numpy(jitters[k][mesh.rank])))
            states.append(_state(model))
            grads.append(_grads(model))
        out[mode] = {"state": states[-1], "states": states, "grads": grads,
                     "metrics": [{"loss": x} for x in losses]}
    return out


def reference_steps(make_model, state, shard_step, batches, lr):
    """The JAX DP step's body on the port's single-card pieces, in this
    process: for each step, each shard's gradient and locally moved running
    statistics from shard_step(model, optimizer, scheduler, batch) (the
    trainer's own train_step, at learning rate 0 so that it leaves the
    weights alone) at the step's weights, their mean, then one SGD(lr)
    step. `batches[k][d]` is shard d's batch of step k. Returns (state
    after the steps, [[shard_step's return for each shard] for each step])."""
    cur = {k: v.clone() for k, v in state.items()}
    outs = []
    for per_shard in batches:
        grads, bufs, step_outs = [], [], []
        for batch in per_shard:
            model = make_model()
            model.load_state_dict(cur, strict=True)
            optimizer, scheduler = _sgd(model, 0.0)
            step_outs.append(shard_step(model, optimizer, scheduler, batch))
            grads.append([p.grad.clone() for p in model.parameters()])
            bufs.append([b.clone() for b in model.buffers()])
        model = make_model()
        model.load_state_dict(cur, strict=True)
        optimizer, _ = _sgd(model, lr)
        n = len(per_shard)
        for i, p in enumerate(model.parameters()):
            p.grad = sum(g[i] for g in grads) / n
        with torch.no_grad():
            for i, b in enumerate(model.buffers()):
                b.copy_(sum(x[i] for x in bufs) / n)
        optimizer.step()
        cur = _state(model)
        outs.append(step_outs)
    return cur, outs


def as_numpy(tree):
    """Tensors of a nested dict/list to numpy (for the comparisons)."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_numpy(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
