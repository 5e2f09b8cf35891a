"""Point-axis sharding of stage 1 (seggroup_tpu/parallel/point_sharding.py).

A scene too large for one card's memory shards its POINT axis over the
ranks of a Mesh: every rank holds the whole scene and the whole model,
runs the slot-space work (grouping, GCNs, classifier) itself, and computes
the per-point edge convs, whose (N, k, C) intermediates dominate the
memory, for its own slab of N / ranks points only; the small (N, 64)
results are all-gathered (SegGroupGNN with `shard_axis`). The kNN lists
are global indices, so no neighbourhood crosses a slab boundary.

Every rank runs the replicated work on identical inputs and must get the
same bits, or the ranks' replicated gradients part (the card's float
scatter-adds sum in a varying order unless
`torch.use_deterministic_algorithms(True)`): the gradient builder takes
the mean of the replicated subtrees' gradients over the ranks as well,
which leaves equal gradients unchanged and makes unequal ones agree, in
the same all-reduce that sums the sharded subtrees' parts."""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.distributed as dist

from seggroup_tpu_torch.parallel.dp import Mesh

# the subtrees whose gradient each rank holds a part of (its slab's); the
# rest run replicated and every rank holds their whole gradient
SHARDED_PARAM_SUBTREES = ("mlp_2", "mlp_3")


def point_sharded_edge_conv(mesh: Mesh, x: torch.Tensor, knn_idx: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """The edge conv (concat(nbr - self, self) @ W, ReLU, max over k) with
    the point axis sharded: `x` (N/D, F) and `knn_idx` (N/D, k, global
    indices) are this rank's slab, `weights` (2F, C) the whole. The rank
    all-gathers the (N, F) inputs, gathers its own neighbourhoods and
    returns its (N/D, C) slab of the output."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    nbr = torch.cat(parts)[knn_idx.long()]  # (N/D, k, F)
    self_f = x[:, None, :].expand_as(nbr)
    feat = torch.cat([nbr - self_f, self_f], dim=-1)
    return torch.relu(feat @ weights).amax(dim=1)


def make_point_sharded_model(mesh: Mesh, **kwargs):
    """A SegGroupGNN on the rank's device with its edge convs sharded over
    `mesh`; its parameters load from and into an unsharded model's."""
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    kwargs.setdefault("device", mesh.device)
    return SegGroupGNN(shard_axis=mesh, shard_count=mesh.size, **kwargs)


def build_stage1_point_sharded_forward(model, mesh: Mesh, mode: str = "ins_infer") -> Callable:
    """fwd(scene) -> the Stage1Output of the point-sharded forward, the
    same on every rank (the scene and the model replicated)."""
    if model.shard_axis is not mesh or model.shard_count != mesh.size:
        raise ValueError("the model is not sharded over this mesh")

    def fwd(scene):
        return model(scene, mode=mode)

    return fwd


def build_stage1_point_sharded_grad(model, mesh: Mesh) -> Callable:
    """step(scene, generator=None, dropout_keep=None) -> (loss, grads): the
    training loss (loss_sum / max(loss_count, 1)) and {parameter name:
    gradient} of the point-sharded train forward, the single-device
    gradient on every rank: the ranks' parts of the MLP2/MLP3 gradients
    summed, the replicated subtrees' averaged, in one all-reduce. Like the
    JAX function it leaves the model's running statistics as they were."""
    if model.shard_axis is not mesh or model.shard_count != mesh.size:
        raise ValueError("the model is not sharded over this mesh")
    names = [n for n, _ in model.named_parameters()]
    sharded = [n.split(".")[0] in SHARDED_PARAM_SUBTREES for n in names]

    def step(scene, generator=None, dropout_keep=None):
        stats = [b.clone() for b in model.buffers()]
        model.zero_grad(set_to_none=True)
        out = model(scene, mode="train", generator=generator, dropout_keep=dropout_keep)
        loss = out.loss_sum / torch.clamp(out.loss_count, min=1.0)
        loss.backward()
        with torch.no_grad():
            for b, s in zip(model.buffers(), stats):
                b.copy_(s)
        sums = mesh.all_reduce([p.grad if p.grad is not None else torch.zeros_like(p)
                                for p in model.parameters()])
        model.zero_grad(set_to_none=True)
        return loss.detach(), {name: g if part else g / mesh.size
                               for name, g, part in zip(names, sums, sharded)}

    return step
