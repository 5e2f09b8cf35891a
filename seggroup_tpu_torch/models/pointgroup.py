"""PointGroup instance segmentation (seggroup_tpu/models/pointgroup.py):
the model, its score targets and its loss.

The same forward as the flax `PointGroup`, in both of its modes:

  * a 7-level sparse U-Net ([m..7m], pre-activation ResidualBlocks,
    kernel-2 stride-2 down and inverse up convs) over the voxels, its
    submanifold convs through kernel K2 on the card, then per-point
    semantic scores and centre offsets;
  * dual clustering on the original and the offset-shifted coordinates as
    ONE radius-graph connected-components problem over the doubled point
    set (ops/radius_cc.py, kernel K4 on the card), its sweep over ranges
    of any length (`window=None`): exact at any density, where the JAX
    model takes the fallback's nearest neighbours past 1,024 rows;
  * proposal re-voxelisation (centre by the proposal mean, fit to a
    fullscale^3 grid at up to score_scale) and the ScoreNet, a 2-level
    U-Net over the proposals' voxels, a per-proposal max and one score.

`forward` chains three plain methods, `backbone`, `cluster` and `score`, so
that each stage can be held at shared inputs. Module and attribute names
are the flax names (`unet/u/u/...`), so
`models.convert.pointgroup_params_from_flax` reads straight across.

With `train=True` every BatchNorm normalises by the batch statistics of its
valid rows and moves its running statistics at momentum 0.1 (the torch
convention; epsilon 1e-4), and autograd runs through the U-Net, the heads
and the ScoreNet. The clustering is integer work on detached heads (the
reference's `stop_gradient`). The ScoreNet's voxel mean and its roipool
max are the JAX side's sorted engine (`segment_mean_sorted`,
`segment_max_sorted`): the same sums in the same order, and the max's
gradient to one row a proposal. The proposals' jitter is injected (a
tensor of 3 uniforms, drawn by the caller): JAX's draw cannot be
reproduced. `pg_score_targets` and `pointgroup_loss` are the JAX
functions' counterparts.

`plan=`, a 7-level pyramid plan of the voxels (sparse/plan.py on the host,
sparse/device_plan.py on the card), gives the U-Net its rulebooks and down
maps, each inner UBlock the plan's tails (its window layouts, where it has
them, select nothing on the port and are not read). The
split-program mode divides a step where no gradient crosses it, at the
clustering: `proposals_only=True` returns the outputs with zero scores and
the ScoreNet's context (its voxelisation and a device plan of it), and
`score_plan=(proposal_of_point, proposal_valid, num_proposals, context)`
runs the ScoreNet on those proposals instead of clustering; `propose`
runs the first program without touching the running statistics, as the
JAX side drops its first program's."""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.minkunet import (SparseBatchNorm, SubMConv, _conv_kernel,
                                                variance_scaling_init_)
from seggroup_tpu_torch.ops.cc import compact_labels
from seggroup_tpu_torch.ops.fma import dot_fma, fma32
from seggroup_tpu_torch.ops.iou import proposal_instance_iou
from seggroup_tpu_torch.ops.radius_cc import semantic_radius_cc
from seggroup_tpu_torch.ops.segment_ops import (segment_max, segment_max_sorted,
                                                segment_mean_sorted, segment_min)
from seggroup_tpu_torch.ops.voxelize import VoxelMap, voxelize
from seggroup_tpu_torch.sparse.conv import (build_subm_rulebook, inverse_conv_up,
                                            strided_conv_down, strided_conv_down_planned)
from seggroup_tpu_torch.sparse.device_plan import build_unet_plan_device
from seggroup_tpu_torch.sparse.tensor import SparseTensor
from seggroup_tpu_torch.utils import profiling

IGNORE = -100
BN_MOMENTUM, BN_EPSILON = 0.1, 1e-4  # SparseBatchNorm(0.1, 1e-4) of the flax model


def _bn(c: int) -> SparseBatchNorm:
    return SparseBatchNorm(c, momentum=BN_MOMENTUM, epsilon=BN_EPSILON)


class ResidualBlock(nn.Module):
    """Pre-activation residual block: bn-relu-conv3-bn-relu-conv3 plus the
    identity, or a K=1 conv of the activated input where the widths differ."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = _bn(cin)
        self.conv1 = SubMConv(cin, cout)
        self.bn2 = _bn(cout)
        self.conv2 = SubMConv(cout, cout)
        if cin != cout:
            self.i_branch = SubMConv(cin, cout, kernel_size=1)

    def forward(self, st: SparseTensor, rulebook: torch.Tensor, train: bool,
                phase) -> SparseTensor:
        pre = st.with_feats(F.relu(self.bn1(st.feats, st.valid, train)))
        if hasattr(self, "i_branch"):
            own_row = torch.arange(st.capacity, dtype=torch.int32,
                                   device=st.feats.device)[:, None]
            identity = self.i_branch(pre, own_row, phase)
        else:
            identity = st.feats
        h = self.conv1(pre, rulebook, phase)
        h = F.relu(self.bn2(h, st.valid, train))
        h = self.conv2(st.with_feats(h), rulebook, phase)
        return st.with_feats(h + identity)


class UBlock(nn.Module):
    """Recursive U-Net over `n_planes` levels: `block_reps` blocks, then
    (below the last level) bn-relu-down, the inner UBlock `u`, bn-relu-up,
    the concatenation with the skip, and `block_reps` tail blocks.

    key_xy_bits: the rulebooks' key packing (sparse/hashing.pack_keys). The
    ScoreNet narrows it to (5, 5): its batch column is a proposal id < 512,
    which the default 3 batch bits would alias."""

    def __init__(self, n_planes: Sequence[int], block_reps: int = 2,
                 level_caps: Sequence[int] | None = None,
                 key_xy_bits: tuple[int, int] = (14, 14)):
        super().__init__()
        planes = list(n_planes)
        self.block_reps = block_reps
        self.level_caps = None if level_caps is None else list(level_caps)
        self.key_xy_bits = tuple(key_xy_bits)
        self.deeper = len(planes) > 1
        for i in range(block_reps):
            setattr(self, f"block{i}", ResidualBlock(planes[0], planes[0]))
        if self.deeper:
            self.conv_bn = _bn(planes[0])
            self.conv_kernel = _conv_kernel(8, planes[0], planes[1])
            self.u = UBlock(planes[1:], block_reps,
                            None if level_caps is None else self.level_caps[1:], key_xy_bits)
            self.deconv_bn = _bn(planes[1])
            self.deconv_kernel = _conv_kernel(8, planes[1], planes[0])
            for i in range(block_reps):  # the first tail block takes the concatenation
                setattr(self, f"tail{i}",
                        ResidualBlock(2 * planes[0] if i == 0 else planes[0], planes[0]))

    def forward(self, st: SparseTensor, train: bool, phase,
                plan: dict | None = None) -> SparseTensor:
        """`plan`: a pyramid plan whose first level is this UBlock's; the
        inner UBlock takes its tails (every list without its first entry)."""
        if plan is not None:
            rb = plan["rulebooks"][0]
        else:
            with phase("rulebooks"):
                rb = build_subm_rulebook(st, 3, xy_bits=self.key_xy_bits)
        for i in range(self.block_reps):
            st = getattr(self, f"block{i}")(st, rb, train, phase)
        if self.deeper:
            cap_down = self.level_caps[1] if self.level_caps else st.capacity >> 1
            h = F.relu(self.conv_bn(st.feats, st.valid, train))
            with phase("rulebooks"):
                if plan is not None:
                    st_dn, key = strided_conv_down_planned(st.with_feats(h), self.conv_kernel,
                                                           plan["down"][0])
                else:
                    st_dn, key = strided_conv_down(st.with_feats(h), self.conv_kernel,
                                                   cap_down)
            sub_plan = None if plan is None else {k: v[1:] for k, v in plan.items()}
            st_dn = self.u(st_dn, train, phase, sub_plan)
            h = F.relu(self.deconv_bn(st_dn.feats, st_dn.valid, train))
            st_up = inverse_conv_up(st_dn.with_feats(h), self.deconv_kernel, key)
            st = st.with_feats(torch.cat([st.feats, st_up.feats], dim=-1))
            for i in range(self.block_reps):
                st = getattr(self, f"tail{i}")(st, rb, train, phase)
        return st


class PGOutput(NamedTuple):
    semantic_scores: torch.Tensor    # (N, classes)
    pt_offsets: torch.Tensor         # (N, 3)
    scores: torch.Tensor             # (P,) proposal scores (pre-sigmoid)
    proposal_of_point: torch.Tensor  # (2, N) proposal id per clustering source, == P if none
    proposal_valid: torch.Tensor     # (P,)
    num_proposals: torch.Tensor      # ()


class Proposals(NamedTuple):
    """What `cluster` hands to `score`."""

    proposal_of_point: torch.Tensor  # (2, N) int32
    proposal_valid: torch.Tensor     # (P,) bool
    num_proposals: torch.Tensor      # () int32
    voxel_coords: torch.Tensor       # (2N, 3) int32 cell of each (source, point) in its
    #                                  proposal's fullscale^3 grid
    score_vox: VoxelMap              # their voxelisation, the proposal id as the batch


class PointGroup(nn.Module):
    """The full model. Built on `device`, the card unless the caller asks
    for the CPU, with weights drawn from `seed` by flax's initializers or
    loaded from a JAX tree through models.convert. `in_channels` is the
    width of the voxel features (colours + coords)."""

    def __init__(self, classes: int = 20, m: int = 16, block_reps: int = 2,
                 cluster_radius: float = 0.03, cluster_npoint_thre: int = 50,
                 cluster_neighbors: int = 32, score_scale: float = 50.0,
                 score_fullscale: float = 14.0, max_proposals_per_source: int = 128,
                 score_cap: int = 8192, level_caps: Sequence[int] | None = None,
                 in_channels: int = 6, score_stop_gradient: bool = False,
                 skip_score_unet: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.classes, self.m = classes, m
        self.cluster_radius = cluster_radius
        self.cluster_npoint_thre = cluster_npoint_thre
        self.cluster_neighbors = cluster_neighbors
        self.score_scale, self.score_fullscale = score_scale, score_fullscale
        self.max_proposals_per_source = max_proposals_per_source
        self.score_cap = score_cap
        # the JAX module's probes of the train step's backward: the point
        # features enter the ScoreNet detached; the ScoreNet's U-Net is left
        # out (and its parameters with it)
        self.score_stop_gradient = score_stop_gradient
        self.skip_score_unet = skip_score_unet

        self.input_conv = SubMConv(in_channels, m)
        self.unet = UBlock([m * (i + 1) for i in range(7)], block_reps, level_caps)
        self.output_bn = _bn(m)
        self.linear = nn.Linear(m, classes)
        self.offset_dense = nn.Linear(m, m)
        self.offset_bn = _bn(m)
        self.offset_linear = nn.Linear(m, 3)
        self.score_unet = None if skip_score_unet else UBlock(
            [m, 2 * m], 2, [score_cap, score_cap // 2], key_xy_bits=(5, 5))
        self.score_bn = _bn(m)
        self.score_linear = nn.Linear(m, 1)
        variance_scaling_init_(self, seed)
        with torch.no_grad():
            for layer in (self.linear, self.offset_dense, self.offset_linear,
                          self.score_linear):
                layer.bias.zero_()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.linear.weight.device

    # --- stage 1: backbone and heads --------------------------------------

    def backbone(self, voxels: SparseTensor, p2v: torch.Tensor, point_valid: torch.Tensor,
                 train: bool = False, phase_seconds: dict | None = None,
                 plan: dict | None = None):
        """The U-Net over the voxels (its rulebooks and down maps from
        `plan` where given), voxel -> point, and the two heads.
        Returns (point_feats (N, m), semantic_scores (N, classes),
        pt_offsets (N, 3)), zero on invalid points."""
        phase = PhaseClock(voxels.coords.device, phase_seconds)
        if plan is not None:
            rb0 = plan["rulebooks"][0]
        else:
            with phase("rulebooks"):
                rb0 = build_subm_rulebook(voxels, 3)
        st = voxels.with_feats(self.input_conv(voxels, rb0, phase))
        st = self.unet(st, train, phase, plan)
        h = F.relu(self.output_bn(st.feats, st.valid, train))

        feats_pad = torch.cat([h, h.new_zeros((1, h.shape[1]))])
        point_feats = feats_pad[torch.clamp(p2v, max=st.capacity).long()]
        point_feats = torch.where(point_valid[:, None], point_feats, 0.0)

        semantic_scores = self.linear(point_feats)
        off = F.relu(self.offset_bn(self.offset_dense(point_feats), point_valid, train))
        pt_offsets = torch.where(point_valid[:, None], self.offset_linear(off), 0.0)
        return point_feats, semantic_scores, pt_offsets

    # --- stage 2: dual clustering and proposal voxelisation ----------------

    def _to_proposals(self, lab: torch.Tensor, obj: torch.Tensor):
        """The proposals of one source: its first `max_proposals_per_source`
        components by least index, those of at least `cluster_npoint_thre`
        points. While the recorder is bound, the components of that size
        that fell past the cap are counted as
        "count.clustering.proposals_capped"."""
        p_src = self.max_proposals_per_source
        compact, num, sizes = compact_labels(lab, obj, p_src)
        keep = sizes >= self.cluster_npoint_thre
        prop = torch.where((compact < p_src) & keep[torch.clamp(compact, max=p_src - 1).long()],
                           compact, p_src)
        pvalid = keep & (torch.arange(p_src, device=lab.device) < num)
        if profiling.bound():
            n = lab.shape[0]
            all_sizes = torch.bincount(torch.where(obj, lab, n).long(), minlength=n + 1)[:n]
            big = (all_sizes >= self.cluster_npoint_thre).sum() - pvalid.sum()
            profiling.count("clustering.proposals_capped", int(profiling.to_host(big)))
        return prop.to(torch.int32), pvalid

    @staticmethod
    def clustering_problem(semantic_scores: torch.Tensor, pt_offsets: torch.Tensor,
                           coords: torch.Tensor, batch_ids: torch.Tensor,
                           point_valid: torch.Tensor):
        """Both clusterings as ONE connected-components problem over the
        doubled point set [coords; coords + offsets] with interleaved batch
        ids (2b, 2b + 1): components cannot span the halves. Returns
        (points (2N, 3), batch ids, valid, classes (2N,)); valid are the
        points predicted as objects (wall and floor, classes 0 and 1, never
        cluster)."""
        batch_ids = batch_ids.to(torch.int32)
        sem_pred = torch.argmax(semantic_scores, dim=-1).to(torch.int32)
        obj = point_valid & (sem_pred > 1)
        return (torch.cat([coords, coords + pt_offsets]),
                torch.cat([batch_ids * 2, batch_ids * 2 + 1]), torch.cat([obj, obj]),
                torch.cat([sem_pred, sem_pred]))

    @torch.no_grad()
    def cluster(self, semantic_scores: torch.Tensor, pt_offsets: torch.Tensor,
                coords: torch.Tensor, batch_ids: torch.Tensor,
                point_valid: torch.Tensor, jitter: torch.Tensor | None = None) -> Proposals:
        """Components of the radius graph among the points predicted as
        objects (classes > 1), on the original and on the offset-shifted
        coordinates at once; components of at least `cluster_npoint_thre`
        points become proposals ([0, P/2) original, [P/2, P) shifted), each
        re-voxelised into its own fullscale^3 grid, shifted inside it by
        `jitter` (3,) in [0, 1) of the room left (none without it). No
        gradient flows through it. While the recorder is bound, the
        proposals are counted as "count.clustering.proposals", their voxels
        as "count.scorenet.voxels" and those past `score_cap` as
        "count.scorenet.voxels_dropped" (one read of the card)."""
        n = coords.shape[0]
        p_src = self.max_proposals_per_source
        p_total = 2 * p_src
        pts2, batch2, obj2, sem2 = self.clustering_problem(
            semantic_scores, pt_offsets, coords, batch_ids, point_valid)
        obj = obj2[:n]
        lab2 = semantic_radius_cc(pts2, self.cluster_radius, batch2, obj2, sem2,
                                  max_neighbors_fallback=self.cluster_neighbors,
                                  window=None, fused_halves=True)
        # a first-half component's least combined index is its least index;
        # a second-half one's is (least index + n)
        prop_o, pv_o = self._to_proposals(lab2[:n], obj)
        prop_s, pv_s = self._to_proposals(torch.where(lab2[n:] < 2 * n, lab2[n:] - n, n), obj)
        prop_a = torch.where(prop_o < p_src, prop_o, p_total)
        prop_b = torch.where(prop_s < p_src, prop_s + p_src, p_total)
        proposal_valid = torch.cat([pv_o, pv_s])

        # proposal re-voxelisation; the centre is summed in the reference's
        # order (it decides integer cells), the extremes are exact
        flat_prop = torch.cat([prop_a, prop_b])  # (2N,)
        fv = flat_prop < p_total
        seg = torch.where(fv, flat_prop, -1)
        own = torch.clamp(flat_prop, max=p_total - 1).long()
        fc = torch.cat([coords, coords])
        centered = fc - segment_mean_sorted(fc, seg, p_total)[own]
        cmin = segment_min(centered, seg, p_total, fill_value=0.0)
        cmax = segment_max(centered, seg, p_total, fill_value=0.0)
        # the float steps below are rounded as jitted XLA rounds them on the
        # CPU (a division by a constant is a multiplication by its float32
        # reciprocal; scale-and-shift is one fused multiply-add, and so are
        # the extent and the jitter's shift; the two constants of the room
        # are folded into one): the cast to integer cells turns a last-bit
        # difference into another voxel
        fullscale = self.score_fullscale
        inv_fullscale = coords.new_tensor(1.0) / coords.new_tensor(fullscale)
        extent = torch.clamp((cmax - cmin).max(dim=1).values * inv_fullscale, min=1e-6)
        pscale = torch.clamp(extent.new_tensor(1.0) / extent - 0.01, max=self.score_scale)
        ps = pscale[:, None].expand_as(cmin)
        min_xyz = cmin * ps
        if jitter is None:
            offset = -min_xyz  # the proposal sits at the grid's corner
        else:
            room = torch.clamp((fullscale - 0.001) - fma32(cmax, ps, -min_xyz), min=0)
            offset = fma32(room, jitter.to(room)[None, :].expand_as(room), -min_xyz)
        scaled = fma32(centered, pscale[own][:, None].expand_as(centered), offset[own])
        icoords = torch.clamp(scaled, 0, fullscale - 1e-3).to(torch.int32)

        vmap_s = voxelize(icoords, torch.where(fv, flat_prop, p_total), fv, self.score_cap)
        if profiling.bound():
            n_prop, n_vox = (int(x) for x in profiling.to_host(torch.stack(
                [proposal_valid.sum(dtype=torch.int32), vmap_s.num_voxels])))
            profiling.count("clustering.proposals", n_prop)
            profiling.count("scorenet.voxels", min(n_vox, self.score_cap))
            profiling.count("scorenet.voxels_dropped", max(n_vox - self.score_cap, 0))
        return Proposals(torch.stack([prop_a, prop_b]), proposal_valid,
                         proposal_valid.sum(dtype=torch.int32), icoords, vmap_s)

    # --- stage 3: ScoreNet --------------------------------------------------

    def score_plan_of(self, score_vox: VoxelMap) -> dict:
        """The ScoreNet's 2-level plan of a proposal voxelisation, built on
        its device (key packing (5, 5), no windows)."""
        return build_unet_plan_device(score_vox.voxel_coords, score_vox.num_voxels,
                                      (self.score_cap, self.score_cap // 2),
                                      with_windows=False, xy_bits=(5, 5))

    def score(self, point_feats: torch.Tensor, proposal_of_point: torch.Tensor,
              score_vox: VoxelMap, train: bool = False,
              phase_seconds: dict | None = None, plan: dict | None = None) -> torch.Tensor:
        """(P,) proposal scores (pre-sigmoid): the proposals' voxels take the
        mean of their points' features, pass the 2-level U-Net (over
        `plan`, the ScoreNet's plan, where given), and each proposal takes
        the max over its points (its gradient to the earliest point among
        equal maxima)."""
        phase = PhaseClock(point_feats.device, phase_seconds)
        p_total = 2 * self.max_proposals_per_source
        flat_prop = proposal_of_point.reshape(-1)
        fv = flat_prop < p_total
        if self.score_stop_gradient:
            point_feats = point_feats.detach()
        flat_feats = torch.cat([point_feats, point_feats])
        sv_feats = segment_mean_sorted(torch.where(fv[:, None], flat_feats, 0.0),
                                       score_vox.point2voxel, self.score_cap)
        st = SparseTensor(score_vox.voxel_coords, sv_feats, score_vox.voxel_valid,
                          score_vox.num_voxels)
        if self.score_unet is not None:
            st = self.score_unet(st, train, phase, plan)
        hs = F.relu(self.score_bn(st.feats, st.valid, train))
        hs_pad = torch.cat([hs, hs.new_zeros((1, hs.shape[1]))])
        flat_score_feats = hs_pad[torch.clamp(score_vox.point2voxel, max=self.score_cap).long()]
        prop_feats = segment_max_sorted(torch.where(fv[:, None], flat_score_feats, 0.0),
                                        torch.where(fv, flat_prop, -1), p_total)
        return self.score_linear(prop_feats)[:, 0]

    def forward(self, voxels: SparseTensor, p2v: torch.Tensor, coords: torch.Tensor,
                batch_ids: torch.Tensor, point_valid: torch.Tensor,
                do_clustering: bool = False, train: bool = False,
                jitter: torch.Tensor | None = None,
                plan: dict | None = None, proposals_only: bool = False,
                score_plan: tuple | None = None, phase_seconds: dict | None = None):
        """voxels: the scene's SparseTensor; p2v (N,) point -> voxel row;
        coords (N, 3) metric; batch_ids, point_valid (N,). Without
        `do_clustering` only the heads run and there are no proposals.
        `train` uses and moves the BatchNorm statistics. `jitter`, the
        proposals' shift inside their grids: a (3,) tensor of uniforms in
        [0, 1); none without it, as the reference without `jitter_rng`.
        `plan`: the U-Net's 7-level pyramid plan (module docstring).

        Split-program mode (with `do_clustering`): `proposals_only` returns
        (PGOutput with zero scores, {"vox": the proposals' VoxelMap,
        "unet_plan": the ScoreNet's plan of it}); `score_plan`, the tuple
        (proposal_of_point, proposal_valid, num_proposals, that dict), skips
        the clustering and scores those proposals. Both see the same
        weights, so the proposals are the fused forward's, and so are the
        loss and its gradients (no gradient crosses the clustering).

        With `phase_seconds`, the card is synchronised around the stages
        ("unet", "clustering", "scorenet") and inside them around the
        rulebook builds and the submanifold convs, and their wall seconds
        are added to the dict."""
        phase = PhaseClock(coords.device, phase_seconds)
        with phase("unet"):
            point_feats, semantic_scores, pt_offsets = self.backbone(
                voxels, p2v, point_valid, train, phase_seconds, plan)
        n = coords.shape[0]
        p_total = 2 * self.max_proposals_per_source
        dev = coords.device
        if not do_clustering:
            return PGOutput(semantic_scores, pt_offsets, torch.zeros(p_total, device=dev),
                            torch.full((2, n), p_total, dtype=torch.int32, device=dev),
                            torch.zeros(p_total, dtype=torch.bool, device=dev),
                            torch.zeros((), dtype=torch.int32, device=dev))
        if score_plan is not None:
            proposal_of_point, proposal_valid, num_proposals, ctx = score_plan
            with phase("scorenet"):
                scores = self.score(point_feats, proposal_of_point, ctx["vox"], train,
                                    phase_seconds, ctx.get("unet_plan"))
            return PGOutput(semantic_scores, pt_offsets, scores, proposal_of_point,
                            proposal_valid, num_proposals)
        with phase("clustering"):
            props = self.cluster(semantic_scores, pt_offsets, coords, batch_ids, point_valid,
                                 jitter)
        if proposals_only:
            with phase("clustering"), torch.no_grad():
                ctx = {"vox": props.score_vox, "unet_plan": self.score_plan_of(props.score_vox)}
            return PGOutput(semantic_scores, pt_offsets, torch.zeros(p_total, device=dev),
                            props.proposal_of_point, props.proposal_valid,
                            props.num_proposals), ctx
        with phase("scorenet"):
            scores = self.score(point_feats, props.proposal_of_point, props.score_vox, train,
                                phase_seconds)
        return PGOutput(semantic_scores, pt_offsets, scores, props.proposal_of_point,
                        props.proposal_valid, props.num_proposals)


@torch.no_grad()
def propose(model: PointGroup, voxels: SparseTensor, p2v: torch.Tensor, coords: torch.Tensor,
            batch_ids: torch.Tensor, point_valid: torch.Tensor, train: bool = True,
            jitter: torch.Tensor | None = None, plan: dict | None = None):
    """The first program of a split step: the forward with the clustering
    (`proposals_only`), no autograd, and the BatchNorm running statistics
    put back as they were (the JAX side drops the first program's), so that
    the second program, `model(..., score_plan=...)`, moves them once, as
    the fused step does. Returns (PGOutput with zero scores, the
    `score_plan` tuple)."""
    stats = {k: v.clone() for k, v in model.named_buffers()}
    out, ctx = model(voxels, p2v, coords, batch_ids, point_valid, do_clustering=True,
                     train=train, jitter=jitter, plan=plan, proposals_only=True)
    for k, v in model.named_buffers():
        v.copy_(stats[k])
    return out, (out.proposal_of_point, out.proposal_valid, out.num_proposals, ctx)


# --- losses (seggroup_tpu/models/pointgroup.py:404-488) ----------------------


def pg_score_targets(proposal_of_point: torch.Tensor, p_total: int,
                     instance_labels: torch.Tensor, point_valid: torch.Tensor,
                     instance_pointnum: torch.Tensor, num_instances_cap: int,
                     fg_thresh: float = 0.75, bg_thresh: float = 0.25) -> torch.Tensor:
    """(P,) IoU-binned soft score targets: each proposal's best IoU with a
    ground-truth instance (the instances' sizes given, since the flat
    membership lists a point under both clustering sources), mapped
    linearly from [bg_thresh, fg_thresh] onto [0, 1] and clipped."""
    flat_prop = proposal_of_point.reshape(-1)
    flat_inst = torch.cat([instance_labels, instance_labels])
    flat_ok = (flat_prop < p_total) & torch.cat([point_valid, point_valid])
    ious = proposal_instance_iou(flat_prop, torch.where(flat_inst == IGNORE, -1, flat_inst),
                                 flat_ok, p_total, num_instances_cap,
                                 instance_sizes=instance_pointnum)
    gt_ious = ious.max(dim=1).values
    k = 1.0 / (fg_thresh - bg_thresh)
    b = bg_thresh / (bg_thresh - fg_thresh)
    # gt * k + b as XLA fuses it: one multiply-add
    return torch.clamp(fma32(gt_ious, torch.full_like(gt_ious, k), torch.full_like(gt_ious, b)),
                       0.0, 1.0)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(|x|^2 + 1e-12) per row, rounded as jitted XLA rounds it: the
    squared length a chain of fused multiply-adds over the three columns,
    the root correctly rounded (taken in float64: torch's float32 sqrt on
    the CPU is not, in about one value of 150). The 1e-12 keeps the
    gradient finite on all-zero (masked) rows."""
    return torch.sqrt((dot_fma(x, x)[:, None] + 1e-12).double()).float()


def pointgroup_loss(out: PGOutput, labels: torch.Tensor, instance_labels: torch.Tensor,
                    instance_centroids: torch.Tensor, instance_pointnum: torch.Tensor,
                    coords: torch.Tensor, point_valid: torch.Tensor, num_instances_cap: int,
                    with_score: bool, fg_thresh: float = 0.75, bg_thresh: float = 0.25,
                    loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                    gt_scores: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """(total, {"semantic_loss", "offset_norm_loss", "offset_dir_loss"[,
    "score_loss"]}): the masked mean NLL of the semantic scores (labels
    IGNORE excluded), the mean L1 distance of the offsets to the instance
    centroids and the mean negative cosine between them over the points of
    an instance, and with `with_score` the masked BCE of the valid
    proposals' scores against pg_score_targets (or the given `gt_scores`,
    which the split-program trainer computes apart), weighted by
    `loss_weight` in that order."""
    classes = out.semantic_scores.shape[-1]
    ok = point_valid & (labels != IGNORE)
    lp = F.log_softmax(out.semantic_scores, dim=-1)
    nll = -lp.gather(1, torch.clamp(labels, 0, classes - 1).long()[:, None])[:, 0]
    semantic_loss = torch.where(ok, nll, 0.0).sum() / torch.clamp(ok.sum(), min=1)

    iv = point_valid & (instance_labels != IGNORE)
    gt_off = instance_centroids - coords
    diff = out.pt_offsets - gt_off
    l1 = diff.abs().sum(-1)
    fiv = iv.to(l1.dtype)
    offset_norm_loss = (l1 * fiv).sum() / (fiv.sum() + 1e-6)
    gt_n = gt_off / (_safe_norm(gt_off) + 1e-8)
    pt_n = out.pt_offsets / (_safe_norm(out.pt_offsets) + 1e-8)
    offset_dir_loss = (-(gt_n * pt_n).sum(-1) * fiv).sum() / (fiv.sum() + 1e-6)

    total = (loss_weight[0] * semantic_loss + loss_weight[1] * offset_norm_loss
             + loss_weight[2] * offset_dir_loss)
    aux = {"semantic_loss": semantic_loss, "offset_norm_loss": offset_norm_loss,
           "offset_dir_loss": offset_dir_loss}
    if with_score:
        if gt_scores is None:
            gt_scores = pg_score_targets(out.proposal_of_point, out.proposal_valid.shape[0],
                                         instance_labels, point_valid, instance_pointnum,
                                         num_instances_cap, fg_thresh, bg_thresh)
        pred = torch.sigmoid(out.scores)
        bce = -(gt_scores * torch.log(pred + 1e-12) + (1 - gt_scores) * torch.log(1 - pred + 1e-12))
        score_loss = (torch.where(out.proposal_valid, bce, 0.0).sum()
                      / torch.clamp(out.proposal_valid.sum(), min=1))
        total = total + loss_weight[3] * score_loss
        aux["score_loss"] = score_loss
    return total, aux
