"""Kernel K3, the submanifold conv's weight gradient, as a hand-written CUDA
kernel for Hopper: the counterpart of the weight-gradient kernels of
seggroup_tpu/sparse/pallas_conv.py (K3a `_dw_kernel`, K3b
`_dw_kernel_packed`).

The source is `csrc/subm_dw.cu` (its header states the design and the
bound). It is compiled at first use with nvcc for sm_90a into `_build/`
(`cuda_build`), loaded with ctypes and launched on the current stream.
A call of `subm_dw_cuda` runs three passes: the compaction of the present
(row, neighbour) pairs per (row slab, offset), the product over them, and,
with more than one slab, the in-order sum of the slabs. `launches` counts
the calls of `subm_dw_cuda` that launched them.

`compact_pairs_plain` is the compaction pass's plain version (the tests
hold the kernel's pass against it); `compact_pairs_cuda` and
`sum_slabs_cuda` launch the first and the last pass alone, for tests and
timing."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from seggroup_tpu_torch import cuda_build
from seggroup_tpu_torch.sparse.cuda_subm_conv import pad8

SOURCE = cuda_build.CSRC / "subm_dw.cu"
# the C entry point of each channel regime, named after the Pallas variant
# it replaces
K3B_SHIFT2 = "subm_dw_k3b_shift2"  # Cin <= 32
K3B_SHIFT1 = "subm_dw_k3b_shift1"  # Cin <= 64
K3A = "subm_dw_k3a"  # Cin > 64
# each regime's (Cin tile, Cout tile): the narrow Cout tile where Cout fits
# it, else the wide one (csrc/subm_dw.cu picks the same)
TILES = {K3B_SHIFT2: (32, (32, 64)), K3B_SHIFT1: (64, (64, 128)), K3A: (128, (128, 256))}

# Row slabs: enough for CTAS_PER_SM CTAs on every SM, and none over
# MAX_SLAB_ROWS rows (a CTA's float32 sum runs in order over its slab's
# pairs, so the slab bounds the length of the sum, as the plain version's
# 16,384-row tiles do); but no slab under MIN_SLAB_ROWS rows and no float32
# workspace of slab partials over WORKSPACE_BYTES.
CTAS_PER_SM = 4
MIN_SLAB_ROWS = 2048
MAX_SLAB_ROWS = 16384
WORKSPACE_BYTES = 128 << 20

launches = 0
_lib = None


def build() -> tuple[Path, str]:
    """Compile csrc/subm_dw.cu (once per source content) and return the
    shared library's path and the compiler's output ('' when it was built
    before)."""
    return cuda_build.build(SOURCE, "libseggroup_subm_dw")


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, "libseggroup_subm_dw")
        for name in TILES:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.subm_dw_compact.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.subm_dw_compact.restype = ctypes.c_int
        lib.subm_dw_sum_slabs.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                                  ctypes.c_size_t,
                                                                  ctypes.c_void_p]
        lib.subm_dw_sum_slabs.restype = ctypes.c_int
        _lib = lib
    return _lib


def regime(cin: int) -> str:
    """The instantiation that serves `cin` input channels, as the Pallas
    engine picks its variant (pallas_conv._pack_shift)."""
    if cin <= 32:
        return K3B_SHIFT2
    if cin <= 64:
        return K3B_SHIFT1
    return K3A


def tile(cin: int, cout: int) -> tuple[int, int]:
    """The (Cin tile, Cout tile) of the product's CTAs for (cin, cout)."""
    tm, (narrow, wide) = TILES[regime(cin)]
    return tm, narrow if cout <= narrow else wide


def slabs_for(m: int, kvol: int, cin: int, cout: int, sms: int) -> tuple[int, int]:
    """(slabs, rows per slab) for an (m, cin) x (m, cout) product over kvol
    offsets on a card with `sms` SMs."""
    tm, tn = tile(cin, cout)
    ctas = kvol * math.ceil(cin / tm) * math.ceil(cout / tn)
    slabs = min(max(math.ceil(CTAS_PER_SM * sms / ctas), math.ceil(m / MAX_SLAB_ROWS)),
                math.ceil(m / MIN_SLAB_ROWS), WORKSPACE_BYTES // (kvol * cin * cout * 4))
    slabs = max(1, slabs)
    rows = math.ceil(m / slabs)
    return math.ceil(m / rows), rows


def compact_pairs_plain(rulebook: torch.Tensor, slabs: int,
                        slab_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The compaction pass's plain version. rulebook (M, K) int32, any value
    outside [0, M) absent -> pairs (slabs, K, slab_rows, 2) int32 and counts
    (slabs, K) int32: segment (s, k) holds the present pairs (row i,
    neighbour rulebook[i, k]) of the rows of slab s in ascending i, its
    first counts[s, k] entries; the rest are -1."""
    m, kvol = rulebook.shape
    dev = rulebook.device
    pairs = torch.full((slabs, kvol, slab_rows, 2), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((slabs, kvol), dtype=torch.int32, device=dev)
    for s in range(slabs):
        rb = rulebook[s * slab_rows:(s + 1) * slab_rows].T  # (K, rows)
        present = (rb >= 0) & (rb < m)
        # present rows first, each group in ascending row order
        order = torch.sort((~present).to(torch.int8), dim=1, stable=True).indices
        n = present.sum(1)
        keep = torch.arange(rb.shape[1], device=dev)[None, :] < n[:, None]
        rows = (order + s * slab_rows).to(torch.int32)
        nbrs = torch.gather(rb, 1, order)
        pairs[s, :, :rb.shape[1], 0] = torch.where(keep, rows, -1)
        pairs[s, :, :rb.shape[1], 1] = torch.where(keep, nbrs, -1)
        counts[s] = n.to(torch.int32)
    return pairs, counts


def _compact(lib, rb: torch.Tensor, slabs: int, slab_rows: int):
    m, kvol = rb.shape
    dev = rb.device
    pairs = torch.empty((slabs, kvol, slab_rows, 2), dtype=torch.int32, device=dev)
    counts = torch.empty((slabs, kvol), dtype=torch.int32, device=dev)
    err = lib.subm_dw_compact(rb.data_ptr(), pairs.data_ptr(), counts.data_ptr(), m, kvol,
                              slabs, slab_rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_dw compaction launch failed with cudaError {err}")
    return pairs, counts


def compact_pairs_cuda(rulebook: torch.Tensor, slabs: int,
                       slab_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The compaction pass alone on the card: what `compact_pairs_plain`
    returns, but the entries past each segment's count are left unwritten."""
    if not (rulebook.is_cuda and rulebook.dtype == torch.int32 and rulebook.ndim == 2):
        raise ValueError("compact_pairs_cuda takes an (M, K) int32 CUDA rulebook")
    m = rulebook.shape[0]
    if m == 0 or slabs < 1 or slab_rows < 1 or (slabs - 1) * slab_rows >= m \
            or slabs * slab_rows < m:
        raise ValueError(f"{slabs} slabs of {slab_rows} rows do not cover {m} rows")
    return _compact(_load(), rulebook.contiguous(), slabs, slab_rows)


def sum_slabs_cuda(ws: torch.Tensor) -> torch.Tensor:
    """The slab-sum pass alone on the card: ws (slabs, ...) float32 -> the
    sum over the first axis, added in the order 0, 1, ..."""
    if not (ws.is_cuda and ws.dtype == torch.float32 and ws.ndim >= 1 and ws.is_contiguous()):
        raise ValueError("sum_slabs_cuda takes a contiguous float32 CUDA tensor")
    out = torch.empty(ws.shape[1:], dtype=torch.float32, device=ws.device)
    err = _load().subm_dw_sum_slabs(ws.data_ptr(), out.data_ptr(), ws.shape[0], out.numel(),
                                    torch.cuda.current_stream(ws.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_dw slab sum launch failed with cudaError {err}")
    return out


def subm_dw_cuda(feats: torch.Tensor, dout: torch.Tensor,
                 rulebook: torch.Tensor) -> torch.Tensor:
    """feats (M, Cin) bfloat16, dout (M, Cout) bfloat16, rulebook (M, K)
    int32 with M for an absent neighbour -> (K, Cin, Cout) float32,
    dW[k] = sum_i feats[rulebook[i, k]] (x) dout[i] accumulated in float32,
    by the CUDA kernel on the tensors' card; the same inputs give the same
    bits on every run. Cin and Cout are padded to multiples of 8 with zeros
    here (the stem's Cin=3 among them)."""
    global launches
    dev = feats.device
    if not (feats.is_cuda and dout.device == dev and rulebook.device == dev):
        raise ValueError("subm_dw_cuda takes CUDA tensors on one device")
    if feats.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16:
        raise ValueError(f"feats and dout must be bfloat16, got {feats.dtype}, {dout.dtype}")
    if rulebook.dtype != torch.int32:
        raise ValueError(f"rulebook must be int32, got {rulebook.dtype}")
    if feats.ndim != 2 or dout.ndim != 2 or rulebook.ndim != 2:
        raise ValueError("shapes must be feats (M, Cin), dout (M, Cout), rulebook (M, K)")
    m, cin = feats.shape
    cout = dout.shape[1]
    kvol = rulebook.shape[1]
    if dout.shape[0] != m or rulebook.shape[0] != m:
        raise ValueError(f"feats {tuple(feats.shape)}, dout {tuple(dout.shape)} and "
                         f"rulebook {tuple(rulebook.shape)} disagree")
    if m == 0 or cin == 0 or cout == 0 or kvol == 0:
        return torch.zeros((kvol, cin, cout), dtype=torch.float32, device=dev)
    lib = _load()
    # the kernel copies 16-byte pieces of rows: the bases must be aligned
    f, d = (x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (pad8(feats, 1).contiguous(), pad8(dout, 1).contiguous()))
    cin_p, cout_p = f.shape[1], d.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slabs, slab_rows = slabs_for(m, kvol, cin_p, cout_p, sms)
    pairs, counts = _compact(lib, rulebook.contiguous(), slabs, slab_rows)
    out = torch.empty((kvol, cin_p, cout_p), dtype=torch.float32, device=dev)
    ws = (torch.empty((slabs, kvol, cin_p, cout_p), dtype=torch.float32, device=dev)
          if slabs > 1 else out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, regime(cin))(f.data_ptr(), d.data_ptr(), pairs.data_ptr(),
                                    counts.data_ptr(), ws.data_ptr(), out.data_ptr(), cin_p,
                                    cout_p, kvol, slabs, slab_rows, stream)
    if err != 0:
        raise RuntimeError(f"subm_dw kernel launch failed with cudaError {err}")
    launches += 1
    if (cin_p, cout_p) != (cin, cout):
        out = out[:, :cin, :cout].contiguous()
    return out
