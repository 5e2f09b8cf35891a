"""Kernel K2, the submanifold gather-GEMM forward, as a hand-written CUDA
kernel for Hopper: the counterpart of the forward kernels of
seggroup_tpu/sparse/pallas_conv.py (K2a `_fwd_kernel`, K2b
`_fwd_kernel_chunked`, K2c `_fwd_kernel_packed`).

The source is `csrc/subm_conv.cu` (its header states the design and the
bound). It is compiled at first use with nvcc for sm_90a into `_build/`
(`cuda_build`), loaded with ctypes and launched on the current stream.
`launches` counts the launches made through `subm_conv_cuda`."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from seggroup_tpu_torch import cuda_build

SOURCE = cuda_build.CSRC / "subm_conv.cu"
# the C entry point of each channel regime, named after the Pallas variant
# it replaces (csrc/subm_conv.cu)
K2C_SHIFT2 = "subm_conv_k2c_shift2"  # Cin <= 32
K2C_SHIFT1 = "subm_conv_k2c_shift1"  # Cin <= 64
K2AB_CHUNKED = "subm_conv_k2ab_chunked"  # Cin > 64

launches = 0
_lib = None


def build() -> tuple[Path, str]:
    """Compile csrc/subm_conv.cu (once per source content) and return the
    shared library's path and the compiler's output ('' when it was built
    before)."""
    return cuda_build.build(SOURCE, "libseggroup_subm_conv")


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, "libseggroup_subm_conv")
        for name in (K2C_SHIFT2, K2C_SHIFT1, K2AB_CHUNKED):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def regime(cin: int) -> str:
    """The instantiation that serves `cin` input channels, as the Pallas
    engine picks its variant (pallas_conv._pack_shift)."""
    if cin <= 32:
        return K2C_SHIFT2
    if cin <= 64:
        return K2C_SHIFT1
    return K2AB_CHUNKED


def pad8(x: torch.Tensor, dim: int) -> torch.Tensor:
    extra = -x.shape[dim] % 8
    if extra == 0:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, extra]
    return torch.nn.functional.pad(x, pad)


def subm_conv_cuda(feats: torch.Tensor, weights: torch.Tensor,
                   rulebook: torch.Tensor) -> torch.Tensor:
    """feats (M, Cin) bfloat16, weights (K, Cin, Cout) bfloat16, rulebook
    (M, K) int32 with M for an absent neighbour -> (M, Cout) float32,
    out[i] = sum_k W[k]^T feats[rulebook[i, k]] accumulated in float32, by
    the CUDA kernel on the tensors' card. Cin and Cout are padded to
    multiples of 8 with zeros here (the stem's Cin=3 among them)."""
    global launches
    dev = feats.device
    if not (feats.is_cuda and weights.device == dev and rulebook.device == dev):
        raise ValueError("subm_conv_cuda takes CUDA tensors on one device")
    if feats.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise ValueError(f"feats and weights must be bfloat16, got {feats.dtype}, "
                         f"{weights.dtype}")
    if rulebook.dtype != torch.int32:
        raise ValueError(f"rulebook must be int32, got {rulebook.dtype}")
    if feats.ndim != 2 or weights.ndim != 3 or rulebook.ndim != 2:
        raise ValueError("shapes must be feats (M, Cin), weights (K, Cin, Cout), "
                         "rulebook (M, K)")
    m, cin = feats.shape
    kvol, _, cout = weights.shape
    if weights.shape[1] != cin or tuple(rulebook.shape) != (m, kvol):
        raise ValueError(f"feats {tuple(feats.shape)}, weights {tuple(weights.shape)} "
                         f"and rulebook {tuple(rulebook.shape)} disagree")
    if m == 0 or cout == 0:
        return torch.zeros((m, cout), dtype=torch.float32, device=dev)
    lib = _load()
    f = pad8(feats, 1).contiguous()
    w = pad8(pad8(weights, 1), 2).contiguous()
    rb = rulebook.contiguous()
    cin_p, cout_p = f.shape[1], w.shape[2]
    out = torch.empty((m, cout_p), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, regime(cin))(f.data_ptr(), w.data_ptr(), rb.data_ptr(),
                                    out.data_ptr(), m, cin_p, cout_p, kvol, stream)
    if err != 0:
        raise RuntimeError(f"subm_conv kernel launch failed with cudaError {err}")
    launches += 1
    return out if cout_p == cout else out[:, :cout].contiguous()
