"""The mean-field CRF over a bilateral grid and its wrapper
(seggroup_tpu/models/crf.py).

A backbone's per-voxel logits are refined by `iterations` mean-field steps
whose pairwise term is a learned (K, C, C) kernel over the 6-D bilateral
grid (batch, floor(xyz / spatial_sigma), floor(rgb / chromatic_sigma)), or
the 7-D trilateral grid with the frame index: out = unary, then
`iterations` times out = pairwise(softmax(out)) + unary. The kernel region
is the hypercross, the centre and the 2 * ndim face neighbours (13 offsets
in 6-D, 15 in 7-D).

The cells are keyed as on the JAX side: a triple int32 key per cell, one
stable lexsort, and a bisection over the sorted triples (`bit_length(M)`
steps) for each voxel's own cell (`cell_id`) and each offset's neighbour
cell (`tgt_rows`, `tgt_ok`), so the integer rows equal JAX's. The floors
multiply by the float32 reciprocal of the sigma, as jitted XLA divides by
a constant. The pairwise term sums the features per cell (a scatter-add),
gathers each offset's neighbour cell and takes one (M, K, C) x (K, C, C)
product; JAX computes it outside any Pallas kernel, and so does this."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from seggroup_tpu_torch.models.minkunet import variance_scaling_init_
from seggroup_tpu_torch.ops.segment_ops import lexsort
from seggroup_tpu_torch.sparse.tensor import SparseTensor

__all__ = ["MeanFieldCRF", "CRFWrapped", "hypercross_offsets"]

INT32_MAX = 2 ** 31 - 1


def hypercross_offsets(ndim: int) -> np.ndarray:
    """(2 ndim + 1, ndim) int32: the centre, then -1 and +1 along each axis."""
    offs = np.zeros((2 * ndim + 1, ndim), np.int32)
    for d in range(ndim):
        offs[1 + 2 * d, d], offs[2 + 2 * d, d] = -1, 1
    return offs


def _floor_div(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """floor(x / sigma) as int32, the division a product with the float32
    reciprocal of sigma (jitted XLA's division by a constant)."""
    recip = np.float32(1.0) / np.float32(sigma)
    return torch.floor(x.to(torch.float32) * torch.tensor(recip, device=x.device)).to(torch.int32)


class MeanFieldCRF(nn.Module):
    """`iterations` mean-field steps over the bilateral (or, with
    `temporal`, trilateral) grid; `kernel` (K, C, C).

    channels:        logit width (num classes).
    spatial_sigma:   xyz quantization of the grid, in voxel units.
    chromatic_sigma: rgb quantization.
    iterations:      mean-field iterations."""

    def __init__(self, channels: int, spatial_sigma: float = 1.0,
                 chromatic_sigma: float = 12.0, iterations: int = 10, temporal: bool = False):
        super().__init__()
        self.channels, self.iterations, self.temporal = channels, iterations, temporal
        self.spatial_sigma, self.chromatic_sigma = spatial_sigma, chromatic_sigma
        self.offsets = hypercross_offsets(7 if temporal else 6)
        self.kernel = nn.Parameter(torch.empty(len(self.offsets), channels, channels))

    def cells(self, st: SparseTensor, colors: torch.Tensor,
              times: torch.Tensor | None = None):
        """(cell_id (M,), tgt_rows (M, K), tgt_ok (M, K)): each voxel's cell
        as its first position among the sorted keys (M for an invalid row),
        and each offset's neighbour cell likewise (M and False where absent)."""
        m = st.capacity
        dev = st.coords.device
        parts = [_floor_div(st.coords[:, 1:4], self.spatial_sigma),
                 _floor_div(colors, self.chromatic_sigma)]
        if self.temporal:  # temporal sigma 1: the frame index itself
            parts.append((torch.zeros(m, dtype=torch.int32, device=dev) if times is None
                          else times.to(torch.int32))[:, None])
        cell = torch.cat(parts, dim=1)  # (M, ndim)
        valid = st.valid[:, None]
        cell = cell - torch.where(valid, cell, 2 ** 20).amin(0) + 1  # a halo for the -1s
        dims = torch.where(valid, cell, 0).amax(0) + 2
        batch = st.coords[:, 0].to(torch.int32)

        def keys_of(c, b):
            k0 = b
            if self.temporal:
                k0 = k0 * dims[6] + c[..., 6]
            k0 = k0 * dims[0] + c[..., 0]
            k1 = c[..., 1] * dims[2] + c[..., 2]
            k2 = (c[..., 3] * dims[4] + c[..., 4]) * dims[5] + c[..., 5]
            return k0, k1, k2

        k0, k1, k2 = (torch.where(st.valid, k, INT32_MAX) for k in keys_of(cell, batch))
        order = lexsort([k2, k1, k0])
        s0, s1, s2 = k0[order], k1[order], k2[order]

        def lower_bound(q0, q1, q2):
            """First sorted position >= each query triple, and whether it
            holds that triple: JAX's bisection, step for step."""
            lo = torch.zeros(q0.shape, dtype=torch.int64, device=dev)
            hi = torch.full(q0.shape, m, dtype=torch.int64, device=dev)
            for _ in range(max(1, m.bit_length())):
                mid = (lo + hi) // 2
                p = torch.clamp(mid, max=m - 1)
                m0, m1, m2 = s0[p], s1[p], s2[p]
                less = (m0 < q0) | ((m0 == q0) & ((m1 < q1) | ((m1 == q1) & (m2 < q2))))
                lo = torch.where(less, mid + 1, lo)
                hi = torch.where(less, hi, mid)
            p = torch.clamp(lo, max=m - 1)
            return lo, (s0[p] == q0) & (s1[p] == q1) & (s2[p] == q2)

        first, _ = lower_bound(k0, k1, k2)
        cell_id = torch.where(st.valid, first, m)
        offs = torch.as_tensor(self.offsets, device=dev)
        rows, hit = lower_bound(*keys_of(cell[:, None, :] + offs[None], batch[:, None]))
        tgt_ok = hit & valid
        return cell_id, torch.where(tgt_ok, rows, m), tgt_ok

    def forward(self, logits: torch.Tensor, st: SparseTensor, colors: torch.Tensor,
                times: torch.Tensor | None = None) -> torch.Tensor:
        """(M, C) refined logits, zero on invalid rows. `times` (M,) is each
        voxel's frame index for the trilateral grid (all 0 without it); only
        read when `temporal`."""
        m, c = st.capacity, self.channels
        cell_id, tgt_rows, tgt_ok = self.cells(st, colors, times)
        valid = st.valid[:, None]
        unary = torch.where(valid, logits, 0.0)

        def pairwise(x):
            cell_sum = x.new_zeros((m + 1, c)).index_add(0, cell_id, torch.where(valid, x, 0.0))
            msgs = torch.where(tgt_ok[..., None], cell_sum[tgt_rows], 0.0)  # (M, K, C)
            return torch.einsum("mkc,kcd->md", msgs, self.kernel)

        out = unary
        for _ in range(self.iterations):
            out = pairwise(torch.softmax(out, dim=-1)) + unary
        return torch.where(valid, out, 0.0)


class CRFWrapped(nn.Module):
    """A backbone and the CRF filter on its logits (reference Wrapper,
    wrapper.py:7-30), flax names `backbone` and `crf`. In training the
    reference applies the filter with probability 0.5; the caller passes
    `apply_filter` from its own coin flip. The CRF's kernel is drawn from
    `seed` as flax draws it; the module lives on the backbone's device."""

    def __init__(self, backbone: nn.Module, num_classes: int = 20, spatial_sigma: float = 1.0,
                 chromatic_sigma: float = 12.0, iterations: int = 10, temporal: bool = False,
                 seed: int = 0):
        super().__init__()
        self.backbone = backbone
        self.crf = MeanFieldCRF(num_classes, spatial_sigma, chromatic_sigma, iterations,
                                temporal)
        variance_scaling_init_(self.crf, seed)
        self.crf.to(backbone.device)

    def forward(self, st: SparseTensor, colors: torch.Tensor, train: bool = False,
                apply_filter: bool = True, times: torch.Tensor | None = None) -> torch.Tensor:
        logits = self.backbone(st, train=train)
        if not apply_filter:
            return logits
        return self.crf(logits, st, colors, times)
