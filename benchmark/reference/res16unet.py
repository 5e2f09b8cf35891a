"""Plain reference of Res16UNet34C training (Choy et al. 2019, MinkowskiNet
`models/res16unet.py`): the network over a sparse voxel batch, the masked
mean NLL, and SGD with momentum 0.9, weight decay 1e-4 and PolyLR, in plain
PyTorch at float32.

Independent of the program: its own coordinate hashing (sorted int64 keys
and binary search) builds each level's 3^3 neighbour table and stride-2
maps over the valid voxels alone; a submanifold conv is a gather of each
voxel's 27 neighbours and one product, with a custom backward that
scatters the data gradient and recomputes the gathers, in row chunks so
that it fits. Conventions the weights share with the program: a (27, Cin,
Cout) kernel's offset k is (dx, dy, dz) = (k // 9 - 1, k // 3 % 3 - 1,
k % 3 - 1), read at voxel + offset; a stride-2 kernel's index is
(x % 2) * 4 + (y % 2) * 2 + z % 2 of the fine voxel; a level keeps at most
its capacity of coarse voxels in (batch, x, y, z) order, as the program's
caps do. Parameter names are the program's.

`lower=True` is the control: the submanifold convs' operands rounded to
float8 (e4m3, one scale a tensor), one step below the bfloat16 the
configuration states, and every float32 product in TF32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.stage1 import fp8_round, tf32

IGNORE_LABEL = 255
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
INIT_DIM = 32
CHUNK_ELEMS = 1 << 26  # gathered elements per chunk


def _keys(coords: torch.Tensor) -> torch.Tensor:
    """(batch, x, y, z), each in [0, 2^15), packed into one int64 whose order
    is the lexicographic order."""
    c = coords.long()
    return (c[:, 0] << 48) | (c[:, 1] << 32) | (c[:, 2] << 16) | c[:, 3]


def neighbour_table(coords: torch.Tensor) -> torch.Tensor:
    """(n, 27) row of the voxel at coords + offset k, n where absent."""
    n = coords.shape[0]
    keys = _keys(coords)
    order = torch.argsort(keys)
    sk = keys[order]
    r = torch.arange(-1, 2, device=coords.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    q = coords.long()[:, None, 1:] + offs[None]  # (n, 27, 3)
    ok = (q >= 0).all(-1)
    qk = torch.cat([coords.long()[:, None, :1].expand(n, 27, 1), q.clamp(min=0)], -1)
    qk = _keys(qk.reshape(-1, 4)).reshape(n, 27)
    pos = torch.searchsorted(sk, qk).clamp(max=n - 1)
    hit = ok & (sk[pos] == qk)
    return torch.where(hit, order[pos], n)


def down_map(coords: torch.Tensor, cap: int):
    """Stride-2 map: (coarse coords, coarse row of each fine voxel or -1
    past the cap, kernel index of each fine voxel)."""
    half = torch.cat([coords[:, :1], coords[:, 1:] >> 1], 1)
    uniq, inv = torch.unique(_keys(half), sorted=True, return_inverse=True)
    m = min(len(uniq), cap)
    c = uniq[:m]
    mask = (1 << 16) - 1
    coarse = torch.stack([c >> 48, (c >> 32) & mask, (c >> 16) & mask, c & mask], 1)
    delta = (coords[:, 1] % 2) * 4 + (coords[:, 2] % 2) * 2 + coords[:, 3] % 2
    return coarse, torch.where(inv < m, inv, -1), delta


class _Subm(torch.autograd.Function):
    """out[i] = sum_k feats[nbr[i, k]] @ W[k], absent neighbours zero."""

    @staticmethod
    def forward(ctx, feats, w, nbr, lower):
        ctx.save_for_backward(feats, w, nbr)
        ctx.lower = lower
        f, wq = _operands(feats, w, lower)
        n, cin = f.shape
        pad = torch.cat([f, f.new_zeros(1, cin)])
        wf = wq.reshape(-1, wq.shape[2])
        out = torch.empty((n, w.shape[2]), dtype=f.dtype, device=f.device)
        step = max(1, CHUNK_ELEMS // (27 * cin))
        for s in range(0, n, step):
            out[s:s + step] = pad[nbr[s:s + step]].reshape(-1, 27 * cin) @ wf
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, w, nbr = ctx.saved_tensors
        f, wq = _operands(feats, w, ctx.lower)
        d = fp8_round(dout) if ctx.lower else dout
        n, cin = f.shape
        pad = torch.cat([f, f.new_zeros(1, cin)])
        dpad = torch.zeros((n + 1, cin), dtype=f.dtype, device=f.device)
        dw = torch.zeros((27 * cin, w.shape[2]), dtype=f.dtype, device=f.device)
        wt = wq.permute(0, 2, 1)  # (27, Cout, Cin)
        step = max(1, CHUNK_ELEMS // (27 * max(cin, w.shape[2])))
        for s in range(0, n, step):
            rb, dc = nbr[s:s + step], d[s:s + step]
            dw += pad[rb].reshape(-1, 27 * cin).T @ dc
            contrib = torch.einsum("co,koi->cki", dc, wt)
            dpad.index_add_(0, rb.reshape(-1), contrib.reshape(-1, cin))
        return dpad[:n], dw.reshape(w.shape), None, None


def _operands(feats, w, lower):
    if lower:
        return fp8_round(feats), fp8_round(w)
    return feats, w


class SubMConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(27, cin, cout))

    def forward(self, x, nbr, lower):
        return _Subm.apply(x, self.kernel, nbr, lower)


class BatchNorm(nn.Module):
    """Batch statistics over the voxels (biased variance), eps 1e-5."""

    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias


class BasicBlock(nn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        self.conv1 = SubMConv(cin, planes)
        self.norm1 = BatchNorm(planes)
        self.conv2 = SubMConv(planes, planes)
        self.norm2 = BatchNorm(planes)
        if cin != planes:
            self.downsample = nn.Linear(cin, planes, bias=False)
            self.downsample_norm = BatchNorm(planes)

    def forward(self, x, nbr, lower):
        h = F.relu(self.norm1(self.conv1(x, nbr, lower)))
        h = self.norm2(self.conv2(h, nbr, lower))
        if hasattr(self, "downsample"):
            x = self.downsample_norm(self.downsample(x))
        return F.relu(h + x)


def _down(x, w, inv, delta, n_out):
    out = x.new_zeros((n_out, w.shape[2]))
    for k in range(8):
        sel = torch.nonzero((delta == k) & (inv >= 0))[:, 0]
        out = out.index_add(0, inv[sel], x[sel] @ w[k])
    return out


def _up(x, w, inv, delta):
    """Each fine voxel reads its coarse voxel; zero where that fell past the
    cap."""
    out = x.new_zeros((inv.shape[0], w.shape[2]))
    for k in range(8):
        sel = torch.nonzero((delta == k) & (inv >= 0))[:, 0]
        out = out.index_put((sel,), x[inv[sel]] @ w[k])
    return out


class Res16UNet34C(nn.Module):
    def __init__(self, in_channels=3, out_channels=20):
        super().__init__()
        self.conv0 = SubMConv(in_channels, INIT_DIM)
        self.bn0 = BatchNorm(INIT_DIM)
        cur, skip_ch = INIT_DIM, [INIT_DIM]
        for lvl in range(4):
            setattr(self, f"conv{lvl + 1}s2_kernel", nn.Parameter(torch.empty(8, cur, cur)))
            setattr(self, f"bn{lvl + 1}", BatchNorm(cur))
            for i in range(LAYERS[lvl]):
                setattr(self, f"block{lvl + 1}_{i}", BasicBlock(cur, PLANES[lvl]))
                cur = PLANES[lvl]
            skip_ch.append(cur)
        for lvl in range(4):
            up = PLANES[4 + lvl]
            setattr(self, f"convtr{lvl + 4}s2_kernel", nn.Parameter(torch.empty(8, cur, up)))
            setattr(self, f"bntr{lvl + 4}", BatchNorm(up))
            cur = up + skip_ch[3 - lvl]
            for i in range(LAYERS[4 + lvl]):
                setattr(self, f"block{lvl + 5}_{i}", BasicBlock(cur, up))
                cur = up
        self.final = nn.Linear(cur, out_channels, bias=True)

    def forward(self, coords, feats, caps, lower=False):
        """Logits of the voxels `coords` (n, 4) with features `feats`;
        `caps` the capacities of levels 1-4."""
        nbrs, maps = [neighbour_table(coords)], []
        c = coords
        for cap in caps:
            c, inv, delta = down_map(c, cap)
            maps.append((inv, delta, c.shape[0]))
            nbrs.append(neighbour_table(c))

        def blocks(x, name, n, nbr):
            for i in range(n):
                x = getattr(self, f"{name}_{i}")(x, nbr, lower)
            return x

        out_p1 = F.relu(self.bn0(self.conv0(feats, nbrs[0], lower)))
        x, skips = out_p1, []
        for lvl in range(4):
            inv, delta, n_out = maps[lvl]
            x = F.relu(getattr(self, f"bn{lvl + 1}")(
                _down(x, getattr(self, f"conv{lvl + 1}s2_kernel"), inv, delta, n_out)))
            x = blocks(x, f"block{lvl + 1}", LAYERS[lvl], nbrs[lvl + 1])
            skips.append(x)
        for lvl in range(4):
            inv, delta, _ = maps[3 - lvl]
            skip = skips[2 - lvl] if lvl < 3 else out_p1
            up = _up(x, getattr(self, f"convtr{lvl + 4}s2_kernel"), inv, delta)
            up = F.relu(getattr(self, f"bntr{lvl + 4}")(up))
            x = blocks(torch.cat([up, skip], 1), f"block{lvl + 5}", LAYERS[4 + lvl],
                       nbrs[3 - lvl])
        return self.final(x)


def masked_nll(logits, labels):
    ok = labels != IGNORE_LABEL
    lp = F.log_softmax(logits, dim=-1)
    nll = -lp.gather(1, torch.clamp(labels, 0, logits.shape[1] - 1).long()[:, None])[:, 0]
    return torch.where(ok, nll, 0.0).sum() / torch.clamp(ok.sum(), min=1)


def poly_lr(step, base=0.1, max_iter=60000, power=0.9):
    return base * (1 - step / (max_iter + 1)) ** power


def confusion(logits, labels, num_classes):
    """(C, C) counts of the labelled voxels: rows the label, columns the
    argmax."""
    ok = labels != IGNORE_LABEL
    idx = labels[ok].long() * num_classes + logits[ok].argmax(-1)
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, -1)


def train(weights: dict, batches, caps, lower=False, momentum=0.9, weight_decay=1e-4):
    """Three (or len(batches)) SGD steps from `weights` over `batches`, each
    (coords (n, 4), feats (n, 3), labels (n,)) of valid voxels on the
    device. Returns (losses, first gradients {name: tensor}, parameters
    after the last step {name: tensor}, each step's confusion matrix)."""
    dev = batches[0][0].device
    net = Res16UNet34C().to(dev)
    net.load_state_dict({k: v for k, v in weights.items()
                         if k in dict(net.named_parameters())}, strict=True)
    params = dict(net.named_parameters())
    bufs, losses, first, hists = {}, [], None, []
    with tf32(lower):
        for step, (coords, feats, labels) in enumerate(batches):
            net.zero_grad(set_to_none=True)
            logits = net(coords, feats, caps, lower)
            loss = masked_nll(logits, labels)
            loss.backward()
            losses.append(float(loss.detach()))
            hists.append(confusion(logits.detach(), labels, logits.shape[1]))
            if first is None:
                first = {k: p.grad.detach().clone() for k, p in params.items()}
            lr = poly_lr(step)
            with torch.no_grad():
                for k, p in params.items():
                    d = p.grad + weight_decay * p
                    bufs[k] = d.clone() if k not in bufs else bufs[k].mul_(momentum).add_(d)
                    p.sub_(lr * bufs[k])
    return losses, first, {k: p.detach() for k, p in params.items()}, hists
