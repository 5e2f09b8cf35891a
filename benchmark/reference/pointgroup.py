"""Plain reference of PointGroup training (Jiang et al., CVPR 2020;
pointgroup/model/pointgroup/pointgroup.py and
config/pointgroup_run2_scannet.yaml of github.com/antao97/SegGroup): the
voxelisation of a batch, the 7-level sparse U-Net with pre-activation
residual blocks and its two heads, the dual clustering, the proposals'
re-voxelisation, the ScoreNet, the IoU-binned score targets, the four
losses, the backward and Adam, in plain PyTorch at float32.

Independent of the program. The submanifold convs, the neighbour tables
and the stride-2 maps are those of benchmark/reference/res16unet.py (sorted
int64 keys and binary search, a gather of 27 neighbours and one product
in row chunks); the segment sums are index_add and scatter_reduce. The
clustering is this module's own exact radius-graph components: cells of
the radius keyed by (batch, class, cell), every candidate pair of
neighbouring cells enumerated in blocks and tested at the radius, and the
least original index propagated along the pairs, with pointer jumping,
until nothing changes. Its squared distance is formed as the program forms
it, fma(dz, dz, fma(dx, dx, dy * dy)), so that a pair at the radius is
decided alike.

Conventions shared with the program: a batch's voxels are its valid
points' cells floor(coords / voxel_size) shifted so that their least is 0,
numbered in (batch, x, y, z) order, the first `caps[0]` kept; a voxel's
features are the mean of its points' [colours, coords]; a level keeps at
most its capacity of coarse voxels; BatchNorm normalises by the batch's
mean and biased variance (epsilon 1e-4) and moves its running statistics
at momentum 0.1; a proposal is one of the first `max_proposals` components
of a source (original, then shifted points) ordered by least index that
has at least `npoint_thre` points (the program's rule, which the JAX
package set: the published model keeps every component of that size);
the shifted source's proposals are numbered after the original's, and a
point in none takes 2 * max_proposals. Parameter names are the program's.

`lower=True` is the control: the operands of every conv, the K = 1 convs'
too, and their outputs' gradients rounded to float8 (e4m3, one scale a
tensor), one step below the bfloat16 the configuration states, and every
float32 product in TF32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.res16unet import _Subm, _down, _up, down_map, neighbour_table
from benchmark.reference.stage1 import _fma32, fp8_round, tf32

IGNORE = -100
BN_MOMENTUM, BN_EPSILON = 0.1, 1e-4
PAIR_BLOCK = 1 << 24  # candidate pairs tested at once


# --- the network -----------------------------------------------------------------


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = max(x.shape[0], 1)
        mean = x.sum(0) / n
        var = (x - mean).square().sum(0) / n
        with torch.no_grad():
            self.mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            self.var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
        return (x - mean) * torch.rsqrt(var + BN_EPSILON) * self.scale + self.bias


class Conv(nn.Module):
    """A submanifold conv of kernel (K, Cin, Cout), K 27 or 1."""

    def __init__(self, cin: int, cout: int, k: int = 27):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, cin, cout))

    def forward(self, x, nbr, lower):
        if self.kernel.shape[0] == 27:
            return _Subm.apply(x, self.kernel, nbr, lower)
        return _Pointwise.apply(x, self.kernel[0], lower) if lower else x @ self.kernel[0]


class _Pointwise(torch.autograd.Function):
    """x @ w with both operands, and the output's gradient, rounded to
    float8 (the control's K = 1 conv, rounded as _Subm rounds the others)."""

    @staticmethod
    def forward(ctx, x, w, lower):
        ctx.save_for_backward(x, w)
        return fp8_round(x) @ fp8_round(w)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        d = fp8_round(dout)
        return d @ fp8_round(w).T, fp8_round(x).T @ d, None


class Block(nn.Module):
    """Pre-activation residual block: bn-relu-conv-bn-relu-conv plus the
    input, or a K = 1 conv of the activated input where the widths differ."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(cin, cout)
        self.bn2 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout)
        if cin != cout:
            self.i_branch = Conv(cin, cout, 1)

    def forward(self, x, nbr, lower):
        pre = F.relu(self.bn1(x))
        identity = self.i_branch(pre, None, lower) if hasattr(self, "i_branch") else x
        h = F.relu(self.bn2(self.conv1(pre, nbr, lower)))
        return self.conv2(h, nbr, lower) + identity


class UBlock(nn.Module):
    def __init__(self, planes, reps: int = 2):
        super().__init__()
        self.reps, self.deeper = reps, len(planes) > 1
        for i in range(reps):
            setattr(self, f"block{i}", Block(planes[0], planes[0]))
        if self.deeper:
            self.conv_bn = BatchNorm(planes[0])
            self.conv_kernel = nn.Parameter(torch.empty(8, planes[0], planes[1]))
            self.u = UBlock(planes[1:], reps)
            self.deconv_bn = BatchNorm(planes[1])
            self.deconv_kernel = nn.Parameter(torch.empty(8, planes[1], planes[0]))
            for i in range(reps):
                setattr(self, f"tail{i}", Block(2 * planes[0] if i == 0 else planes[0],
                                                planes[0]))

    def forward(self, x, levels, lower, lvl: int = 0):
        nbr = levels[lvl]["nbr"]
        for i in range(self.reps):
            x = getattr(self, f"block{i}")(x, nbr, lower)
        if self.deeper:
            inv, delta, n_out = levels[lvl]["down"]
            d = _down(F.relu(self.conv_bn(x)), self.conv_kernel, inv, delta, n_out)
            d = self.u(d, levels, lower, lvl + 1)
            up = _up(F.relu(self.deconv_bn(d)), self.deconv_kernel, inv, delta)
            x = torch.cat([x, up], 1)
            for i in range(self.reps):
                x = getattr(self, f"tail{i}")(x, nbr, lower)
        return x


def pyramid(coords: torch.Tensor, caps) -> list[dict]:
    """Each level's neighbour table and the map down to the next, from the
    valid voxels `coords` (n, 4) in (batch, x, y, z) order."""
    levels, c = [], coords
    for i in range(len(caps)):
        entry = {"nbr": neighbour_table(c)}
        if i + 1 < len(caps):
            c_next, inv, delta = down_map(c, caps[i + 1])
            entry["down"] = (inv, delta, c_next.shape[0])
            c = c_next
        levels.append(entry)
    return levels


class PointGroup(nn.Module):
    def __init__(self, m: int = 16, classes: int = 20, in_channels: int = 6,
                 block_reps: int = 2, levels: int = 7):
        super().__init__()
        self.input_conv = Conv(in_channels, m)
        self.unet = UBlock([m * (i + 1) for i in range(levels)], block_reps)
        self.output_bn = BatchNorm(m)
        self.linear = nn.Linear(m, classes)
        self.offset_dense = nn.Linear(m, m)
        self.offset_bn = BatchNorm(m)
        self.offset_linear = nn.Linear(m, 3)
        self.score_unet = UBlock([m, 2 * m], 2)
        self.score_bn = BatchNorm(m)
        self.score_linear = nn.Linear(m, 1)

    def backbone(self, vox: dict, caps, lower: bool = False):
        """(point features, semantic scores, offsets) of the batch's valid
        points; a point whose voxel fell past the cap reads zero features."""
        levels = pyramid(vox["coords"], caps)
        x = self.input_conv(vox["feats"], levels[0]["nbr"], lower)
        h = F.relu(self.output_bn(self.unet(x, levels, lower)))
        pf = torch.cat([h, h.new_zeros((1, h.shape[1]))])[vox["p2v"]]
        off = self.offset_linear(F.relu(self.offset_bn(self.offset_dense(pf))))
        return pf, self.linear(pf), off

    def score(self, point_feats, svox: dict, n_props: int, caps, lower: bool = False):
        """(n_props,) scores (pre-sigmoid): the proposals' voxels take the
        mean of their entries' features, pass the 2-level U-Net, and each
        proposal takes the max over its voxels (0 where it has none)."""
        if svox["coords"].shape[0] == 0:
            return self.score_linear(point_feats.new_zeros((n_props, point_feats.shape[1])))[:, 0]
        flat = torch.cat([point_feats, point_feats])[svox["entry"]]
        feats = segment_mean(flat, svox["e2v"], svox["coords"].shape[0])
        h = self.score_unet(feats, pyramid(svox["coords"], caps), lower)
        h = F.relu(self.score_bn(h))
        prop = svox["coords"][:, 0].long()
        out = h.new_zeros((n_props, h.shape[1]))
        out = out.scatter_reduce(0, prop[:, None].expand_as(h), h, "amax", include_self=False)
        return self.score_linear(out)[:, 0]


# --- segment sums ----------------------------------------------------------------


def segment_mean(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Mean of the rows of each id in [0, n); rows of id n or more are left out."""
    ok = ids < n
    s = x.new_zeros((n + 1, x.shape[1])).index_add(0, torch.where(ok, ids, n), x)[:n]
    c = torch.zeros(n + 1, dtype=x.dtype, device=x.device).index_add(
        0, torch.where(ok, ids, n), torch.ones_like(ids, dtype=x.dtype))[:n]
    return s / torch.clamp(c, min=1)[:, None]


def _pack(c: torch.Tensor) -> torch.Tensor:
    c = c.long()
    return (c[:, 0] << 48) | (c[:, 1] << 32) | (c[:, 2] << 16) | c[:, 3]


def _unpack(k: torch.Tensor) -> torch.Tensor:
    mask = (1 << 16) - 1
    return torch.stack([k >> 48, (k >> 32) & mask, (k >> 16) & mask, k & mask], 1)


# --- the batch's voxels ----------------------------------------------------------


def voxelize(coords, colours, batch_ids, n_valid: int, voxel_size: float, cap: int) -> dict:
    """The batch's voxels from its first `n_valid` points: coords (cap', 4)
    int64 of the kept voxels, their features, each point's voxel row (the
    number of kept voxels where its voxel fell past the cap), and `total`,
    the voxels before the cap."""
    c = coords[:n_valid]
    ic = torch.floor(c / torch.tensor(voxel_size, dtype=c.dtype, device=c.device)).long()
    ic = ic - ic.min(0).values
    keys = _pack(torch.cat([batch_ids[:n_valid, None].long(), ic], 1))
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    m = min(int(uniq.shape[0]), cap)
    p2v = torch.where(inv < m, inv, m)
    feats = segment_mean(torch.cat([colours[:n_valid].float(), c], 1), p2v, m)
    return {"coords": _unpack(uniq[:m]), "feats": feats, "p2v": p2v,
            "total": int(uniq.shape[0])}


# --- the dual clustering ---------------------------------------------------------


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return _fma32(d[:, 2], d[:, 2], _fma32(d[:, 0], d[:, 0], d[:, 1] * d[:, 1]))


def components(xyz: torch.Tensor, group: torch.Tensor, valid: torch.Tensor,
               radius: float) -> torch.Tensor:
    """Connected components of the graph that joins two valid points of one
    `group` within `radius`: (N,) the least index of each valid point's
    component, N for the others."""
    n = xyz.shape[0]
    dev = xyz.device
    idx = torch.nonzero(valid)[:, 0]
    out = torch.full((n,), n, dtype=torch.long, device=dev)
    if idx.numel() == 0:
        return out
    p = xyz[idx]
    cell = torch.floor(p / torch.tensor(radius, dtype=p.dtype, device=dev)).long()
    cell = cell - cell.min(0).values + 1
    dims = cell.max(0).values + 2
    key = ((group[idx].long() * dims[0] + cell[:, 0]) * dims[1] + cell[:, 1]) * dims[2] \
        + cell[:, 2]
    order = torch.argsort(key)
    sk, sp, s_idx = key[order], p[order], idx[order]
    k = sk.shape[0]
    r2 = torch.tensor(radius, dtype=torch.float32, device=dev).square()
    # each unordered pair once: the cell itself (later rows only) and 13 of
    # its 26 neighbours
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) > (0, 0, 0)]
    src, dst = [], []
    rows = torch.arange(k, device=dev)
    for dx, dy, dz in [(0, 0, 0)] + offs:
        target = sk + (dx * dims[1] + dy) * dims[2] + dz
        lo = torch.searchsorted(sk, target)
        hi = torch.searchsorted(sk, target, right=True)
        if (dx, dy, dz) == (0, 0, 0):
            lo = rows + 1
        cnt = torch.clamp(hi - lo, min=0)
        ends = torch.cumsum(cnt, 0)
        total = int(ends[-1])
        start_row = 0
        while start_row < k and total:
            base = int(ends[start_row - 1]) if start_row else 0
            stop = int(torch.searchsorted(ends, base + PAIR_BLOCK, right=True))
            stop = max(stop, start_row + 1)
            c = cnt[start_row:stop]
            i = torch.repeat_interleave(rows[start_row:stop], c)
            first = torch.cumsum(c, 0) - c
            j = lo[i] + torch.arange(i.shape[0], device=dev) - torch.repeat_interleave(first, c)
            hit = _sqdist(sp[i], sp[j]) <= r2
            src.append(i[hit])
            dst.append(j[hit])
            start_row = stop
    src, dst = torch.cat(src), torch.cat(dst)
    lab = s_idx.clone()  # labels: original indices; rank of each original index
    pos = torch.full((n,), -1, dtype=torch.long, device=dev)
    pos[s_idx] = rows
    while True:
        new = lab.scatter_reduce(0, src, lab[dst], "amin")
        new = new.scatter_reduce(0, dst, lab[src], "amin")
        while True:  # pointer jumping: a label's own label
            jumped = new[pos[new]]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    out[s_idx] = lab
    return out


def _source_proposals(lab: torch.Tensor, n: int, max_props: int, npoint_thre: int):
    """One source's proposal of each point (max_props where none) and the
    proposals' validity."""
    ok = lab < n
    uniq, inv, counts = torch.unique(lab[ok], sorted=True, return_inverse=True,
                                     return_counts=True)
    keep = torch.zeros(max_props, dtype=torch.bool, device=lab.device)
    first = min(int(uniq.shape[0]), max_props)
    keep[:first] = counts[:first] >= npoint_thre
    prop = torch.full_like(lab, max_props)
    rank = torch.where((inv < max_props) & keep[torch.clamp(inv, max=max_props - 1)], inv,
                       max_props)
    prop[ok] = rank
    return prop, keep


def cluster(semantic_scores, offsets, coords, batch_ids, valid, radius: float = 0.03,
            npoint_thre: int = 50, max_proposals: int = 128):
    """The dual clustering of the points predicted as objects (classes above
    1), on the original and on the shifted coordinates: (proposal of each
    (source, point) (2, N), proposals' validity (2 * max_proposals,))."""
    n = coords.shape[0]
    sem = torch.argmax(semantic_scores, dim=-1)
    obj = valid & (sem > 1)
    group = batch_ids.long() * semantic_scores.shape[1] + sem
    props, keeps = [], []
    for k, xyz in enumerate((coords, coords + offsets)):
        prop, keep = _source_proposals(components(xyz, group, obj, radius), n, max_proposals,
                                       npoint_thre)
        props.append(torch.where(prop < max_proposals, prop + k * max_proposals,
                                 2 * max_proposals))
        keeps.append(keep)
    return torch.stack(props), torch.cat(keeps)


def score_voxels(proposal_of_point, coords, jitter, n_props: int, fullscale: float = 14.0,
                 scale: float = 50.0) -> dict:
    """The proposals' re-voxelisation: each proposal's points centred by
    their mean, scaled to fit a fullscale^3 grid (at most `scale`) and
    shifted inside it by `jitter` of the room left. Returns its voxels
    (coords (v, 4) with the proposal as the batch, in order), each entry's
    voxel (`e2v`) for the (source, point) entries `entry`, and `total`."""
    flat = proposal_of_point.reshape(-1)
    entry = torch.nonzero(flat < n_props)[:, 0]
    prop = flat[entry].long()
    fc = torch.cat([coords, coords])[entry]
    centered = fc - segment_mean(fc, prop, n_props)[prop]
    big = torch.finfo(torch.float32).max
    cmin = centered.new_full((n_props, 3), big).scatter_reduce(
        0, prop[:, None].expand(-1, 3), centered, "amin")
    cmax = centered.new_full((n_props, 3), -big).scatter_reduce(
        0, prop[:, None].expand(-1, 3), centered, "amax")
    has = torch.zeros(n_props, dtype=torch.bool, device=coords.device)
    has[prop] = True
    cmin = torch.where(has[:, None], cmin, 0.0)
    cmax = torch.where(has[:, None], cmax, 0.0)
    inv_fullscale = coords.new_tensor(1.0) / coords.new_tensor(fullscale)
    extent = torch.clamp((cmax - cmin).max(dim=1).values * inv_fullscale, min=1e-6)
    pscale = torch.clamp(extent.new_tensor(1.0) / extent - 0.01, max=scale)
    ps = pscale[:, None].expand_as(cmin)
    min_xyz = cmin * ps
    room = torch.clamp((fullscale - 0.001) - _fma32(cmax, ps, -min_xyz), min=0)
    offset = _fma32(room, jitter.to(room)[None, :].expand_as(room), -min_xyz)
    scaled = _fma32(centered, pscale[prop][:, None].expand_as(centered), offset[prop])
    icoords = torch.clamp(scaled, 0, fullscale - 1e-3).to(torch.int32).long()
    keys = _pack(torch.cat([prop[:, None], icoords], 1))
    uniq, e2v = torch.unique(keys, sorted=True, return_inverse=True)
    return {"coords": _unpack(uniq), "e2v": e2v, "entry": entry, "total": int(uniq.shape[0])}


# --- targets and losses ----------------------------------------------------------


def score_targets(proposal_of_point, instance_labels, pointnum, n_props: int):
    """Each proposal's best IoU with an instance (the instances' sizes
    given), mapped from [0.25, 0.75] onto [0, 1] and clipped."""
    flat = proposal_of_point.reshape(-1).long()
    inst = torch.cat([instance_labels, instance_labels]).long()
    n_inst = pointnum.shape[0]
    ok = flat < n_props
    sizes_p = torch.bincount(flat[ok], minlength=n_props).float()
    both = ok & (inst >= 0) & (inst < n_inst)
    inter = torch.bincount(flat[both] * n_inst + inst[both],
                           minlength=n_props * n_inst).float().reshape(n_props, n_inst)
    union = sizes_p[:, None] + pointnum.float()[None, :] - inter
    iou = (inter / torch.clamp(union, min=1.0)).max(dim=1).values
    return torch.clamp(iou * 2.0 - 0.5, 0.0, 1.0)


def _unit(x):
    return x / (torch.sqrt(x.square().sum(-1, keepdim=True) + 1e-12) + 1e-8)


def losses(sem, off, scores, pvalid, batch: dict, proposal_of_point) -> dict:
    """The four losses of the batch's valid points (weights 1, 1, 1, 1)."""
    labels, inst = batch["labels"], batch["inst"]
    ok = labels != IGNORE
    nll = -F.log_softmax(sem, -1).gather(1, torch.clamp(labels, 0, sem.shape[1] - 1)
                                         .long()[:, None])[:, 0]
    out = {"semantic_loss": torch.where(ok, nll, 0.0).sum() / max(int(ok.sum()), 1)}
    iv = (inst != IGNORE).float()
    gt_off = batch["centroid"] - batch["coords"]
    out["offset_norm_loss"] = ((off - gt_off).abs().sum(-1) * iv).sum() / (iv.sum() + 1e-6)
    out["offset_dir_loss"] = (-(_unit(gt_off) * _unit(off)).sum(-1) * iv).sum() \
        / (iv.sum() + 1e-6)
    target = score_targets(proposal_of_point, inst, batch["pointnum"], pvalid.shape[0])
    pred = torch.sigmoid(scores)
    bce = -(target * torch.log(pred + 1e-12) + (1 - target) * torch.log(1 - pred + 1e-12))
    out["score_loss"] = torch.where(pvalid, bce, 0.0).sum() / max(int(pvalid.sum()), 1)
    return out


# --- the train step --------------------------------------------------------------


def valid_batch(wire: dict, dev) -> dict:
    """The batch's valid points on `dev` from the wire the program was fed
    (its float16 colours as the program reads them)."""
    n = int(wire["nvalid"])

    def t(x):
        return torch.as_tensor(x[:n]).to(dev)

    return {"coords": t(wire["coords"]).float(), "colours": t(wire["feats"]).float(),
            "batch_ids": t(wire["batch_ids"]).long(), "labels": t(wire["labels"]).long(),
            "inst": t(wire["inst"]).long(), "centroid": t(wire["centroid"]).float(),
            "pointnum": torch.as_tensor(wire["pointnum"]).to(dev).long(), "n": n}


def forward(net: PointGroup, batch: dict, proposal_of_point, pvalid, jitter, cfg: dict,
            lower: bool = False):
    """One train forward over `batch` at the given proposals: (losses, the
    scores, the score voxels, the point voxels)."""
    vox = voxelize(batch["coords"], batch["colours"], batch["batch_ids"], batch["n"],
                   cfg["voxel_size"], cfg["caps"][0])
    pf, sem, off = net.backbone(vox, cfg["caps"], lower)
    n_props = pvalid.shape[0]
    svox = score_voxels(proposal_of_point, batch["coords"], jitter, n_props,
                        cfg["score_fullscale"], cfg["score_scale"])
    scores = net.score(pf, svox, n_props, (cfg["score_cap"], cfg["score_cap"] // 2), lower)
    return losses(sem, off, scores, pvalid, batch, proposal_of_point), scores, svox, vox


def adam_step(params: dict, grads: dict, state: dict, lr: float, betas=(0.9, 0.999),
              eps: float = 1e-8) -> None:
    """torch.optim.Adam's update (no weight decay), in place: `state` maps
    each name to {"step", "exp_avg", "exp_avg_sq"}."""
    b1, b2 = betas
    with torch.no_grad():
        for k, p in params.items():
            s = state[k]
            s["step"] += 1
            g = grads[k]
            s["exp_avg"].lerp_(g, 1 - b1)
            s["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1 = 1 - b1 ** s["step"]
            bc2 = math.sqrt(1 - b2 ** s["step"])
            denom = (s["exp_avg_sq"].sqrt() / bc2).add_(eps)
            p.addcdiv_(s["exp_avg"], denom, value=-lr / bc1)


def train(start: dict, steps: list[dict], cfg: dict, lower: bool = False) -> dict:
    """Train steps from the program's state `start` ({"params", "buffers",
    "adam"}: name -> tensor, and name -> Adam state) over `steps`, each
    {"wire", "proposal_of_point" (2, N_valid), "proposal_valid", "jitter",
    "lr"}. Returns each step's loss, its four parts and the ScoreNet's
    scores, the first step's gradients, the parameters after the last step,
    and the voxels and score voxels before the caps of each step."""
    dev = start["params"][next(iter(start["params"]))].device
    net = PointGroup(cfg["m"], cfg["classes"], cfg["in_channels"], cfg["block_reps"],
                     cfg["levels"]).to(dev)
    net.load_state_dict({**start["params"], **start["buffers"]}, strict=True)
    params = dict(net.named_parameters())
    state = {k: {"step": int(v["step"]), "exp_avg": v["exp_avg"].clone(),
                 "exp_avg_sq": v["exp_avg_sq"].clone()} for k, v in start["adam"].items()}
    out = {"losses": [], "parts": [], "scores": [], "score_voxels": [], "voxels": []}
    with tf32(lower):
        for s in steps:
            batch = valid_batch(s["wire"], dev)
            net.zero_grad(set_to_none=True)
            parts, scores, svox, vox = forward(net, batch, s["proposal_of_point"],
                                               s["proposal_valid"], s["jitter"], cfg, lower)
            loss = sum(parts.values())
            loss.backward()
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if "grads" not in out:
                out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
            adam_step(params, grads, state, s["lr"])
            out["losses"].append(float(loss.detach()))
            out["parts"].append({k: float(v.detach()) for k, v in parts.items()})
            out["scores"].append(scores.detach())
            out["score_voxels"].append(svox["total"])
            out["voxels"].append(vox["total"])
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out
