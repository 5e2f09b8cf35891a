"""Kernel K3, the submanifold conv's weight gradient, as a hand-written CUDA
kernel for Hopper: the counterpart of the weight-gradient kernels of
seggroup_tpu/sparse/pallas_conv.py (K3a `_dw_kernel`, K3b
`_dw_kernel_packed`).

The source is `csrc/subm_dw.cu` (its header states the design and the
bound). It is compiled at first use with nvcc for sm_90a into `_build/`
(`cuda_build`), loaded with ctypes and launched on the current stream.
`launches` counts the calls of `subm_dw_cuda` that launched it (each is one
product pass and, with more than one slab, one pass that adds the slabs)."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from seggroup_tpu_torch import cuda_build
from seggroup_tpu_torch.sparse.cuda_subm_conv import pad8

SOURCE = cuda_build.CSRC / "subm_dw.cu"
# the C entry point of each channel regime, named after the Pallas variant
# it replaces, and its (Cin tile, Cout tile) (csrc/subm_dw.cu)
K3B_SHIFT2 = "subm_dw_k3b_shift2"  # Cin <= 32
K3B_SHIFT1 = "subm_dw_k3b_shift1"  # Cin <= 64
K3A = "subm_dw_k3a"  # Cin > 64
TILES = {K3B_SHIFT2: (32, 32), K3B_SHIFT1: (64, 64), K3A: (64, 128)}

CHUNK_ROWS = 64  # rows per product step of a CTA
# Row slabs: enough for CTAS_PER_SM CTAs on every SM, and none over
# MAX_SLAB_ROWS rows (a CTA's float32 sum runs in order over its slab, so
# the slab bounds the length of the sum, as the plain version's 16,384-row
# tiles do); but no slab under MIN_SLAB_ROWS rows and no workspace over
# WORKSPACE_BYTES.
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
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
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


def slabs_for(m: int, kvol: int, cin: int, cout: int, sms: int) -> tuple[int, int]:
    """(slabs, rows per slab) for an (m, cin) x (m, cout) product over kvol
    offsets on a card with `sms` SMs; rows per slab is a multiple of the
    chunk."""
    tm, tn = TILES[regime(cin)]
    ctas = kvol * math.ceil(cin / tm) * math.ceil(cout / tn)
    slabs = min(max(math.ceil(CTAS_PER_SM * sms / ctas), math.ceil(m / MAX_SLAB_ROWS)),
                math.ceil(m / MIN_SLAB_ROWS), WORKSPACE_BYTES // (kvol * cin * cout * 4))
    slabs = max(1, slabs)
    rows = math.ceil(math.ceil(m / slabs) / CHUNK_ROWS) * CHUNK_ROWS
    return math.ceil(m / rows), rows


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
    f = pad8(feats, 1).contiguous()
    d = pad8(dout, 1).contiguous()
    rb = rulebook.contiguous()
    cin_p, cout_p = f.shape[1], d.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slabs, slab_rows = slabs_for(m, kvol, cin_p, cout_p, sms)
    out = torch.empty((kvol, cin_p, cout_p), dtype=torch.float32, device=dev)
    ws = (torch.empty((slabs, kvol, cin_p, cout_p), dtype=torch.float32, device=dev)
          if slabs > 1 else out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, regime(cin))(f.data_ptr(), d.data_ptr(), rb.data_ptr(), ws.data_ptr(),
                                    out.data_ptr(), m, cin_p, cout_p, kvol, slabs, slab_rows,
                                    stream)
    if err != 0:
        raise RuntimeError(f"subm_dw kernel launch failed with cudaError {err}")
    launches += 1
    if (cin_p, cout_p) != (cin, cout):
        out = out[:, :cin, :cout].contiguous()
    return out
