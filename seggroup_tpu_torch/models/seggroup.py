"""Stage-1 SegGroup GNN (seggroup_tpu/models/seggroup.py).

The same forward as the JAX module over the same fixed-shape padded
tensors: DGCNN edge-conv encoders as batched Linear layers over kNN
gathers, mask-aware BatchNorm, one masked FPS over every cluster at once
(kernel K1 on the card), and the grouping engine of ops.grouping:
the sequential one by default, the parallel-rounds one with
`sequential=False`.

Three modes, as the JAX module's: `train` (the full grouping, BatchNorm
batch statistics that update the running ones, classifier dropout and the
label-smoothed loss, with autograd), `ins_infer` and `sem_infer` (running
statistics, no autograd). Gradients flow where JAX's do: through the
cluster-feature max-pools, the similarity matrix and the GCNs, not through
the distances that decide the grouping. `fast_knn=True` is accepted for
parity with the JAX module: it asks there for the approximate top-k, which
XLA computes exactly off the TPU, so here it selects the exact top-k that
`fast_knn=False` runs (ops.knn.cluster_knn).

Point sharding (`shard_axis`, a parallel.dp.Mesh of `shard_count` ranks,
parallel/point_sharding.py): every rank holds the whole scene and runs the
slot-space work (grouping, GCNs, classifier) on it; the per-point edge
convs of MLP2/MLP3, whose (N, k, C) intermediates dominate a scene's
memory, run on the rank's slab of N / shard_count points, their BatchNorm
statistics summed over the slabs, and the (N, 64) result is all-gathered.
The gradients through the two collectives are the single-device ones on
the slab: the statistics' all-reduce passes its cotangent on summed over
the ranks (each rank holds the part that reached the statistics through
its own rows), the gather passes each rank its own rows of the (replicated)
cotangent, and the ranks' MLP2/MLP3 gradients then add up to the whole
(parallel/point_sharding.build_stage1_point_sharded_grad).

Weak-label conventions: weak ins/sem are 0-based with -1 = unlabeled;
exports add +1 so 0 means unannotated."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.ops import grouping as gr
from seggroup_tpu_torch.ops.fps import masked_fps
from seggroup_tpu_torch.ops.knn import cluster_knn, knn_brute, morton3d
from seggroup_tpu_torch.ops.segment_ops import segment_max, segment_mean, segment_sum
from seggroup_tpu_torch.types import Scene

NUM_CLASSES = 40
# nyu40 ids used by the reference evaluator (model.py:27-28)
SEM_VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
INS_VALID_CLASS_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
# sentinel cluster id of padding points in cluster_knn
_PAD_CLUSTER = 0x3FFFFFFF


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) of a tensor each rank holds a part of; the
    backward sums the cotangent over the ranks too (the transpose of a
    psum whose output every rank's rows read)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


class _GatherSlabs(torch.autograd.Function):
    """The ranks' (n, C) slabs stacked into (size * n, C) in rank order
    (a tiled all_gather); the backward hands each rank its own rows of the
    cotangent, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = (mesh.rank * x.shape[0], (mesh.rank + 1) * x.shape[0])
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows[0]:ctx.rows[1]], None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the leading axes with a validity mask, in flax's
    convention (the JAX MaskedBatchNorm): `scale`/`bias` map, `mean`/`var`
    are the running statistics. In training the batch statistics are taken
    in float32 over the rows where `mask` holds (count at least 1, biased
    variance), normalize, and move the running ones as
    running = momentum * running + (1 - momentum) * batch. With `axis` (a
    parallel.dp.Mesh), the rows are one rank's slab and the count and sums
    are summed over the ranks (the JAX module's `axis_name` psums)."""

    momentum = 0.9

    def __init__(self, c: int, epsilon: float = 1e-5, axis=None):
        super().__init__()
        self.epsilon = epsilon
        self.axis = axis
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)  # statistics and normalization in f32
        if train:
            m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).to(x.dtype)
            axes = tuple(range(x.ndim - 1))
            if self.axis is None:
                cnt = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum(dim=axes) / cnt
                var = (torch.square(x - mean) * m).sum(dim=axes) / cnt
            else:
                stats = _SumOverRanks.apply(
                    torch.cat([m.sum().reshape(1), (x * m).sum(dim=axes)]), self.axis)
                cnt = torch.clamp(stats[0], min=1.0)
                mean = stats[1:] / cnt
                var = _SumOverRanks.apply(
                    (torch.square(x - mean) * m).sum(dim=axes), self.axis) / cnt
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


def _leaky(x: torch.Tensor) -> torch.Tensor:
    # flax's leaky_relu: the gradient at exactly 0 is 1 (F.leaky_relu's is
    # the slope)
    return torch.where(x >= 0, x, 0.2 * x)


class MLP1(nn.Module):
    """Per-cluster edge-conv encoder: (S, P, 6) cluster clouds -> (S, 128)
    (max || mean pooled): kNN over xyz within the cloud, neighbour xyz
    centred over k and scaled x10, 1x1 conv 6->64, LeakyReLU, max over k,
    then max/mean over points."""

    def __init__(self, k: int = 10):
        super().__init__()
        self.k = k
        self.conv1 = nn.Linear(6, 64, bias=False)
        self.bn1 = MaskedBatchNorm(64)

    def forward(self, clouds: torch.Tensor, slot_valid: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        s, p = clouds.shape[:2]
        idx = knn_brute(clouds[..., :3], self.k)  # (S, P, k) self included
        rows = torch.arange(s, device=clouds.device)[:, None, None]
        nbr = clouds[rows, idx]  # (S, P, k, 6)
        xyz = nbr[..., :3]
        xyz = (xyz - xyz.mean(dim=2, keepdim=True)) * 10.0
        feat = torch.cat([xyz, nbr[..., 3:]], dim=-1)
        mask = slot_valid[:, None, None].expand(s, p, self.k)
        h = _leaky(self.bn1(self.conv1(feat), mask, train))
        h = h.amax(dim=2)  # over k -> (S, P, 64)
        out = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)  # (S, 128)
        return torch.where(slot_valid[:, None], out, 0.0)


class EdgeConvBlock(nn.Module):
    """Shared body of MLP2/MLP3: per-point edge conv over a precomputed kNN
    graph. Input (N, 9), idx (N, k); feature concat(f_nbr - f_self, f_self)
    -> 18 dims; 1..2 conv layers; max over k. The (N, k, C) intermediates
    ride in `dtype` (bf16 by default); BN runs in f32.

    Point sharding (`axis`): x, idx and point_valid are the rank's slab of
    rows and `src` the whole (N, 9) array the (global) neighbour indices
    read; the BatchNorm statistics are summed over the slabs."""

    def __init__(self, layers: int = 1, dtype: torch.dtype = torch.bfloat16, axis=None):
        super().__init__()
        self.layers = layers
        self.dtype = dtype
        self.conv1 = nn.Linear(18, 64, bias=False)
        self.bn1 = MaskedBatchNorm(64, axis=axis)
        if layers == 2:
            self.conv2 = nn.Linear(64, 64, bias=False)
            self.bn2 = MaskedBatchNorm(64, axis=axis)

    def forward(self, x: torch.Tensor, idx: torch.Tensor, point_valid: torch.Tensor,
                train: bool = False, src: torch.Tensor | None = None) -> torch.Tensor:
        xb = x.to(self.dtype)
        nbr = (xb if src is None else src.to(self.dtype))[idx]  # (N, k, 9)
        self_f = xb[:, None, :].expand_as(nbr)
        feat = torch.cat([nbr - self_f, self_f], dim=-1)  # (N, k, 18)
        mask = point_valid[:, None].expand(idx.shape)
        h = F.linear(feat, self.conv1.weight.to(self.dtype))
        h = _leaky(self.bn1(h, mask, train)).to(self.dtype)
        if self.layers == 2:
            h = F.linear(h, self.conv2.weight.to(self.dtype))
            h = _leaky(self.bn2(h, mask, train)).to(self.dtype)
        h = h.amax(dim=1).to(torch.float32)  # over k -> (N, 64)
        return torch.where(point_valid[:, None], h, 0.0)


class GCN(nn.Module):
    """Row-normalized graph conv."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, dim, bias=False)

    def forward(self, x: torch.Tensor, edge_matrix: torch.Tensor) -> torch.Tensor:
        norm = edge_matrix / edge_matrix.sum(dim=1, keepdim=True)
        return F.relu(self.fc(norm @ x))


class Classifier(nn.Module):
    """256 -> 128 (BN over the `valid` rows, LeakyReLU, dropout .5) -> 40.

    In training, dropout keeps a unit where `dropout_keep` holds, or else
    where a uniform draw from `generator` (on x's device) falls below the
    keep probability, and scales the kept ones by its inverse, as flax's
    Dropout does."""

    rate = 0.5

    def __init__(self):
        super().__init__()
        self.linear1 = nn.Linear(256, 128, bias=False)
        self.bn1 = MaskedBatchNorm(128)
        self.linear2 = nn.Linear(128, NUM_CLASSES)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, train: bool = False,
                dropout_keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = _leaky(self.bn1(self.linear1(x), valid, train))
        if train:
            keep_prob = 1.0 - self.rate
            if dropout_keep is None:
                dropout_keep = torch.rand(h.shape, generator=generator,
                                          device=h.device) < keep_prob
            h = torch.where(dropout_keep, h / keep_prob, 0.0)
        return self.linear2(h)


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           valid: torch.Tensor, eps: float = 0.2) -> torch.Tensor:
    """Label-smoothed cross entropy summed over the valid rows (reference
    seggroup/util.py:12-29)."""
    n_class = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
    soft = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    per_row = -torch.sum(soft * F.log_softmax(logits, dim=-1), dim=-1)
    return torch.where(valid, per_row, 0.0).sum()


# ---------------------------------------------------------------------------
# cluster point-cloud construction
# ---------------------------------------------------------------------------


def cluster_pointclouds(
    points: torch.Tensor,
    point2root: torch.Tensor,
    num_slots: int,
    p_out: int = 64,
    cap: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size per-cluster point clouds: clusters smaller than p_out are
    tiled rep times plus an FPS remainder; larger clusters contribute p_out
    FPS samples, all clusters in one FPS call. Members are taken in
    (cluster, Morton) order; clusters beyond `cap` members feed FPS a strided
    subsample. Clouds are centred and scaled to the unit box in xyz.

    Returns (clouds (S, p_out, C), slot_valid (S,))."""
    n = points.shape[0]
    s = num_slots
    dev = points.device
    cid = torch.where(point2root < s, point2root, s)
    # padding rows stay out of the Morton bounding box
    m_order = torch.argsort(morton3d(points[:, :3], valid=cid < s), stable=True)
    order = m_order[torch.argsort(cid[m_order], stable=True)]
    sorted_cid = cid[order]
    slots = torch.arange(s, dtype=sorted_cid.dtype, device=dev)
    start = torch.searchsorted(sorted_cid, slots, side="left", out_int32=True)
    stop = torch.searchsorted(sorted_cid, slots, side="right", out_int32=True)
    count = stop - start
    slot_valid = count > 0

    i = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    cnt = torch.clamp(count, min=1)[:, None]
    # a device tensor divisor: division by a Python scalar multiplies by its
    # rounded reciprocal on the card
    cap_f = torch.tensor(float(cap), device=dev)
    strided = (i.to(torch.float32) * cnt / cap_f).to(torch.int32)
    pos_in = torch.where(cnt <= cap, torch.minimum(i, cnt - 1), strided)
    members = order[torch.clamp(start[:, None] + pos_in, 0, n - 1)]  # (S, cap)
    mvalid = i < torch.clamp(cnt, max=cap)

    fps_idx = masked_fps(points[members, :3], mvalid, p_out)  # (S, p_out)

    # output slot j: tiled members for j < rep*cnt, FPS picks afterwards
    rep = p_out // cnt
    j = torch.arange(p_out, dtype=torch.int32, device=dev)[None, :]
    fps_pos = torch.gather(fps_idx, 1, torch.clamp(j - rep * cnt, 0, p_out - 1).long())
    pick = torch.where(j < rep * cnt, j % cnt, fps_pos)
    clouds = points[torch.gather(members, 1, pick.long())]  # (S, p_out, C)

    xyz = clouds[..., :3]
    xyz = xyz - xyz.mean(dim=1, keepdim=True)
    denom = torch.clamp(xyz.abs().amax(dim=(1, 2), keepdim=True), min=1e-12)
    clouds = torch.cat([xyz / denom, clouds[..., 3:]], dim=-1)
    clouds = torch.where(slot_valid[:, None, None], clouds, 0.0)
    return clouds, slot_valid


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------


class Stage1Output(NamedTuple):
    loss_sum: torch.Tensor       # scalar (0 in the inference modes)
    loss_count: torch.Tensor     # scalar
    iou_sem: torch.Tensor        # (2, 40) I / U per nyu40 class
    iou_ins: torch.Tensor        # (2, 40)
    acc: torch.Tensor            # (4,) sem, ins, sem_sel, ins_sel
    layer_roots: torch.Tensor    # (4, N) per-layer point -> cluster root slot
    final_root: torch.Tensor     # (N,)
    final_sem: torch.Tensor      # (N,) exported convention: 1..40, -1 = none
    final_ins: torch.Tensor      # (N,)
    sem_layer2: torch.Tensor     # (N,) layer-2 semantic export (sem_infer output)
    ins_layer2: torch.Tensor     # (N,)
    max_segment_size: torch.Tensor  # scalar: largest layer-1 segment (binding
    # when > cluster_cap: FPS candidates are subsampled)
    max_cluster_size: torch.Tensor  # scalar: largest merged cluster entering a
    # kNN layer (binding when > knn_window)
    layer_sem: torch.Tensor      # (4, N) per-layer semantic export
    layer_ins: torch.Tensor      # (4, N) per-layer instance export


def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


class SegGroupGNN(nn.Module):
    """The stage-1 per-scene pipeline. `mode` selects 'train' (full grouping
    and the classifier loss over up to `max_instances` weak instances, with
    batch statistics and autograd), 'sem_infer' (stop after layer 2,
    structural threshold 3 instead of 6) or 'ins_infer' (full grouping, no
    classifier).

    Weights come from `seed` through a torch.Generator (flax's default
    initializers), or from a JAX checkpoint through models.convert. The
    module is built on `device`, the card unless the caller asks for the
    CPU."""

    def __init__(
        self,
        th_structural: float = 6.0,
        th_structural_sem_infer: float = 3.0,
        th_semantic: float = 2.0,
        gcn_alpha: float = 0.125,
        sequential: bool = True,
        knn_k: int = 20,
        knn_window: int = 8192,
        fast_knn: bool = False,
        knn_small_window: int | None = None,
        mlp1_points: int = 64,
        cluster_cap: int = 1024,
        max_instances: int = 128,
        compute_dtype: torch.dtype = torch.bfloat16,
        shard_axis=None,
        shard_count: int = 1,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        if shard_axis is not None and shard_axis.size != shard_count:
            raise ValueError(f"shard_count {shard_count} but the mesh has {shard_axis.size} "
                             f"ranks")
        self.shard_axis = shard_axis
        self.shard_count = shard_count
        dev = resolve_device(device)
        self.th_structural = th_structural
        self.th_structural_sem_infer = th_structural_sem_infer
        self.th_semantic = th_semantic
        self.gcn_alpha = gcn_alpha
        self.sequential = sequential
        del fast_knn  # the exact top-k either way; see the module docstring
        self.knn_k = knn_k
        self.knn_window = knn_window
        self.knn_small_window = knn_small_window
        self.mlp1_points = mlp1_points
        self.cluster_cap = cluster_cap
        self.max_instances = max_instances

        self.mlp_1 = MLP1()
        self.mlp_2 = EdgeConvBlock(layers=1, dtype=compute_dtype, axis=shard_axis)
        self.gcn_2 = GCN(192, 192)
        self.mlp_3 = EdgeConvBlock(layers=2, dtype=compute_dtype, axis=shard_axis)
        self.gcn_3 = GCN(256, 256)
        self.classifier = Classifier()
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    _lecun_normal_(m.weight, gen)
                    if m.bias is not None:
                        m.bias.zero_()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.gcn_2.fc.weight.device

    def forward(self, scene: Scene, mode: str = "ins_infer",
                phase_seconds: dict | None = None,
                dropout_keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> Stage1Output:
        """One scene's forward; in `train` mode it builds the autograd graph
        of the loss, elsewhere none. With `phase_seconds`, the card is
        synchronised around the grouping loops, the cluster kNN and the
        cluster clouds, and their wall seconds are added to the dict under
        "grouping", "cluster_knn" and "cluster_pointclouds". `dropout_keep`
        ((max_instances, 128) bool) or `generator` decide the classifier's
        dropout in `train` mode (Classifier)."""
        if mode not in ("train", "ins_infer", "sem_infer"):
            raise ValueError(f"unknown mode {mode!r}")
        if scene.points.device != self.device:
            raise ValueError(f"scene on {scene.points.device}, model on {self.device}")
        with torch.set_grad_enabled(mode == "train"):
            return self._forward(scene, mode, PhaseClock(self.device, phase_seconds),
                                 dropout_keep, generator)

    def _forward(self, scene, mode, phase, dropout_keep, generator) -> Stage1Output:
        train = mode == "train"
        s = scene.num_slots
        pts = scene.points
        pt_valid = scene.point2seg < s
        seg = torch.clamp(scene.point2seg, max=s - 1)

        def roots_of(g):
            return torch.where(pt_valid, g.root[seg], s)

        def largest(roots):
            return torch.max(segment_sum(pt_valid.to(torch.int32), roots, s))

        # --- graph initialization (reference model.py:710-733)
        g = gr.init_graph(scene.point2seg, scene.weak_ins, scene.weak_sem, s)
        edges, ev = gr.normalize_edges(g, scene.edges, scene.edge_valid)
        roots_l1 = roots_of(g)
        max_seg = largest(roots_l1)
        # layer-1 export = weak labels on the un-merged segment graph
        sem_l1, ins_l1 = self._export_labels(g, roots_l1, pt_valid, s)

        # --- structural grouping layer (model.py:745-770)
        with phase("cluster_pointclouds"):
            clouds, act1 = cluster_pointclouds(
                pts, roots_l1, s, p_out=self.mlp1_points, cap=self.cluster_cap)
        feat1 = self.mlp_1(clouds, act1, train)  # (S, 128)
        # the grouping's distances carry no gradient (JAX: stop_gradient)
        d1 = gr.edge_distances(feat1.detach(), g, edges)
        th1 = self.th_structural_sem_infer if mode == "sem_infer" else self.th_structural
        with phase("grouping"):
            g, _ = self._group(g, edges, ev, d1, th1)
        edges, ev = gr.normalize_edges(g, edges, ev)
        feat2 = gr.aggregate_cluster_feature(feat1, g, act1)  # (S, 128)
        roots_l2 = roots_of(g)
        sem_l2, ins_l2 = self._export_labels(g, roots_l2, pt_valid, s)
        cl2 = largest(roots_l2)

        if mode == "sem_infer":
            iou_sem, iou_ins, acc = evaluate_labels(
                sem_l2, ins_l2, scene.real_sem, scene.real_ins, pt_valid)
            zero = torch.zeros((), device=self.device)
            return Stage1Output(
                zero, zero, iou_sem, iou_ins, acc,
                torch.stack([roots_l1, roots_l2, roots_l2, roots_l2]),
                roots_l2, sem_l2, ins_l2, sem_l2, ins_l2, max_seg, cl2,
                torch.stack([sem_l1, sem_l2, sem_l2, sem_l2]),
                torch.stack([ins_l1, ins_l2, ins_l2, ins_l2]),
            )

        # --- semantic grouping layer 1 (model.py:786-824)
        feat2, g, edges, ev, act2 = self._semantic_layer(
            self.mlp_2, self.gcn_2, feat2, g, edges, ev, pts, roots_l2, pt_valid,
            phase, train)
        roots_l3 = roots_of(g)
        sem_l3, ins_l3 = self._export_labels(g, roots_l3, pt_valid, s)
        max_cluster = torch.maximum(cl2, largest(roots_l3))
        feat3 = gr.aggregate_cluster_feature(feat2, g, act2)

        # --- semantic grouping layer 2 (model.py:827-856)
        feat3, g, edges, ev, act3 = self._semantic_layer(
            self.mlp_3, self.gcn_3, feat3, g, edges, ev, pts, roots_l3, pt_valid,
            phase, train)
        roots_l4 = roots_of(g)
        sem_l4, ins_l4 = self._export_labels(g, roots_l4, pt_valid, s)
        feat4 = gr.aggregate_cluster_feature(feat3, g, act3)

        # --- final clustering: absorb unlabeled (model.py:868-891)
        act4 = gr.active_mask(g)
        with phase("grouping"):
            g, _, edges, ev = gr.group_unlabeled_clusters(
                g, feat4, edges, ev, pts[:, :3], scene.point2seg)
        final_root = roots_of(g)
        final_sem, final_ins = self._export_labels(g, final_root, pt_valid, s)

        iou_sem, iou_ins, acc = evaluate_labels(
            final_sem, final_ins, scene.real_sem, scene.real_ins, pt_valid)
        zero = torch.zeros((), device=self.device)
        loss_sum = loss_count = zero
        if train:
            # the final grouping's features, re-aggregated with a gradient
            # (the absorption loop reads detached ones)
            feat5 = gr.aggregate_cluster_feature(feat4, g, act4)
            loss_sum, loss_count = self._classifier_loss(feat5, g, dropout_keep, generator)
        return Stage1Output(
            loss_sum, loss_count, iou_sem, iou_ins, acc,
            torch.stack([roots_l1, roots_l2, roots_l3, roots_l4]),
            final_root, final_sem, final_ins, sem_l2, ins_l2,
            max_seg, max_cluster,
            torch.stack([sem_l1, sem_l2, sem_l3, sem_l4]),
            torch.stack([ins_l1, ins_l2, ins_l3, ins_l4]),
        )

    def _classifier_loss(self, feat5, g, dropout_keep, generator):
        """(loss_sum, loss_count) of the classifier over per-instance
        max-pooled features (model.py:900-929): the live roots' features and
        weak semantic labels pooled by weak instance id below
        max_instances."""
        i_max = self.max_instances
        act5 = gr.active_mask(g)
        ins_ids = torch.where(act5, g.ins_label, -1)
        ins_ids = torch.where((ins_ids >= 0) & (ins_ids < i_max), ins_ids, i_max)
        feat6 = segment_max(feat5, ins_ids, i_max)  # (I, 256)
        sem_gt = segment_max(torch.where(act5, g.sem_label, -1), ins_ids, i_max,
                             fill_value=-1)
        ins_present = segment_sum(act5.to(torch.int32), ins_ids, i_max) > 0
        inst_valid = ins_present & (sem_gt >= 0)
        logits = self.classifier(feat6, inst_valid, True, dropout_keep, generator)
        loss_sum = smoothed_cross_entropy(logits, torch.clamp(sem_gt, min=0), inst_valid)
        return loss_sum, inst_valid.to(torch.float32).sum()

    def _semantic_layer(self, mlp, gcn, feat_in, g, edges, ev, pts, roots,
                        pt_valid, phase, train):
        s = g.num_slots
        with phase("cluster_knn"):
            knn_idx = cluster_knn(
                pts[:, :3], torch.where(pt_valid, roots, _PAD_CLUSTER),
                k=self.knn_k, window=self.knn_window,
                valid=pt_valid, small_window=self.knn_small_window)
        center = segment_mean(pts[:, :3], roots, s)  # (S, 3)
        centered = pts[:, :3] - center[torch.clamp(roots, max=s - 1)]
        data9 = torch.cat([pts, centered], dim=-1)  # (N, 9)
        point_feat = self._point_edge_conv(mlp, data9, knn_idx, pt_valid, train)  # (N, 64)
        pooled = segment_max(point_feat, torch.where(pt_valid, roots, s), s)
        feat = torch.cat([feat_in, pooled], dim=-1)

        sims = gr.edge_similarities(feat, g, edges, alpha=self.gcn_alpha)
        feat = gcn(feat, gr.build_similarity_matrix(sims, edges, ev, s))

        d = gr.edge_distances(feat.detach(), g, edges)
        act_before = gr.active_mask(g)
        with phase("grouping"):
            g, _ = self._group(g, edges, ev, d, self.th_semantic)
        edges, ev = gr.normalize_edges(g, edges, ev)
        return feat, g, edges, ev, act_before

    def _point_edge_conv(self, mlp, data9, knn_idx, pt_valid, train):
        """The per-point edge conv; point-sharded, each rank runs its slab
        of N / shard_count rows (the neighbour indices are global, so the
        gathers read the whole data9) and the slabs are all-gathered."""
        if self.shard_axis is None:
            return mlp(data9, knn_idx, pt_valid, train)
        n = data9.shape[0]
        if n % self.shard_count:
            raise ValueError(f"{n} points do not split into {self.shard_count} slabs")
        rows = slice(self.shard_axis.rank * (n // self.shard_count),
                     (self.shard_axis.rank + 1) * (n // self.shard_count))
        pf = mlp(data9[rows], knn_idx[rows], pt_valid[rows], train, src=data9)
        return _GatherSlabs.apply(pf, self.shard_axis)

    def _group(self, g, edges, ev, dists, th):
        fn = (gr.group_nearby_clusters_sequential if self.sequential
              else gr.group_nearby_clusters)
        return fn(g, edges, ev, dists, th)

    @staticmethod
    def _export_labels(g, roots, pt_valid, s):
        """Per-point exported labels: label+1 if labeled else -1."""
        r = torch.clamp(roots, max=s - 1)
        sem = g.sem_label[r]
        ins = g.ins_label[r]
        sem = torch.where(pt_valid & (sem != -1), sem + 1, -1)
        ins = torch.where(pt_valid & (ins != -1), ins + 1, -1)
        return sem.to(torch.int32), ins.to(torch.int32)


def evaluate_labels(
    sem_pred: torch.Tensor,
    ins_pred: torch.Tensor,
    sem_true: torch.Tensor,
    ins_true: torch.Tensor,
    pt_valid: torch.Tensor,
    max_instances: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-scene I/U accumulators + accuracies (reference evaluate,
    model.py:608-655), restricted to annotated points (sem_true != 0).

    Instance I/U is binned by the semantic class of each predicted
    instance's first point; the JAX scan over instance ids 1..max_instances
    is vectorized as per-instance counts (integer-valued sums, exact in
    float32)."""
    dev = sem_pred.device
    valid = pt_valid & (sem_true != 0)

    cls = torch.arange(1, NUM_CLASSES + 1, device=dev)
    sp = sem_pred[:, None] == cls[None, :]
    st = sem_true[:, None] == cls[None, :]
    i_sem = ((sp & st) & valid[:, None]).sum(dim=0).to(torch.float32)
    u_sem = ((sp | st) & valid[:, None]).sum(dim=0).to(torch.float32)
    iou_sem = torch.stack([i_sem, u_sem])

    n_inst = max_instances

    def per_instance(mask, ids):
        return segment_sum(mask.to(torch.int32), torch.where(mask, ids - 1, n_inst),
                           n_inst)

    pred_in = valid & (ins_pred >= 1) & (ins_pred <= n_inst)
    true_in = valid & (ins_true >= 1) & (ins_true <= n_inst)
    n_pred = per_instance(pred_in, ins_pred)
    inter = per_instance(pred_in & (ins_true == ins_pred), ins_pred)
    union = n_pred + per_instance(true_in, ins_true) - inter
    # semantic class of each predicted instance = sem_pred at its first point
    first = torch.full((n_inst,), ins_pred.shape[0], dtype=torch.int64, device=dev)
    first = first.scatter_reduce_(
        0, torch.where(pred_in, ins_pred - 1, 0).long(),
        torch.where(pred_in, torch.arange(ins_pred.shape[0], device=dev),
                    ins_pred.shape[0]),
        reduce="amin")
    present = n_pred > 0
    cls_idx = torch.clamp(sem_pred[torch.where(present, first, 0)] - 1, 0,
                          NUM_CLASSES - 1).long()
    zeros = torch.zeros(NUM_CLASSES, device=dev)
    i_ins = zeros.index_add(0, cls_idx, torch.where(present, inter, 0).to(torch.float32))
    u_ins = zeros.index_add(0, cls_idx, torch.where(present, union, 0).to(torch.float32))
    iou_ins = torch.stack([i_ins, u_ins])

    def share(hit, sel):
        return (hit & sel).sum() / torch.clamp(sel.sum().to(torch.float32), min=1.0)

    sem_ok = sem_pred == sem_true
    ins_ok = ins_pred == ins_true
    sem_sel = valid & torch.isin(sem_true, torch.tensor(SEM_VALID_CLASS_IDS, device=dev))
    ins_sel = valid & torch.isin(ins_true, torch.tensor(INS_VALID_CLASS_IDS, device=dev))
    acc = torch.stack([share(sem_ok, valid), share(ins_ok, valid),
                       share(sem_ok, sem_sel), share(ins_ok, ins_sel)])
    return iou_sem, iou_ins, acc
