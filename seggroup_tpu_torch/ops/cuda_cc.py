"""Kernel K4, one label-min sweep of the windowed radius-graph connected
components, as a hand-written CUDA kernel for Hopper: the counterpart of
seggroup_tpu/ops/pallas_cc.py:_sweep_kernel.

The source is `csrc/cc_sweep.cu` (its header states the design, the
arithmetic order of the distance and the bound). It is compiled at first
use with nvcc for sm_90a into `_build/` (`cuda_build`), loaded with ctypes
and launched on the current stream. `launches` counts the launches made
through `cc_sweep_cuda`: one per sweep."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from seggroup_tpu_torch import cuda_build

SOURCE = cuda_build.CSRC / "cc_sweep.cu"

launches = 0
_lib = None


def build() -> tuple[Path, str]:
    """Compile csrc/cc_sweep.cu (once per source content) and return the
    shared library's path and the compiler's output ('' when it was built
    before)."""
    return cuda_build.build(SOURCE, "libseggroup_cc_sweep")


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, "libseggroup_cc_sweep")
        lib.seggroup_cc_sweep.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.seggroup_cc_sweep.restype = ctypes.c_int
        _lib = lib
    return _lib


def cc_sweep_cuda(labels: torch.Tensor, xyz: torch.Tensor, sem: torch.Tensor,
                  key: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  offs: torch.Tensor, r2: torch.Tensor, tile: int) -> torch.Tensor:
    """One sweep by the CUDA kernel on the tensors' card. Rows are in key
    order: labels, sem, key (N,) int32, xyz (N, 3) float32; lo, hi
    (N / tile, 9) int32 row ranges; offs (9,) int32; r2 a float32 tensor of
    one element. Returns (N,) int32: for each row the least of its label
    and the labels of the rows in its tile's ranges that pass the distance,
    class and key-delta tests."""
    global launches
    dev = labels.device
    ints = (labels, sem, key, lo, hi, offs)
    if not (labels.is_cuda and all(t.device == dev for t in (xyz, r2, *ints))):
        raise ValueError("cc_sweep_cuda takes CUDA tensors on one device")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("labels, sem, key, lo, hi and offs must be int32")
    if xyz.dtype != torch.float32 or r2.dtype != torch.float32 or r2.numel() != 1:
        raise ValueError("xyz must be float32 and r2 one float32")
    n = labels.shape[0]
    if n == 0 or tile % 32 or n % tile or tile > 1024:
        raise ValueError(f"N={n} must be a positive multiple of tile={tile}, tile of 32 "
                         f"and at most 1024 (one thread per row of a tile)")
    shapes = ((xyz, (n, 3)), (sem, (n,)), (key, (n,)), (lo, (n // tile, 9)),
              (hi, (n // tile, 9)), (offs, (9,)))
    if labels.ndim != 1 or any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError("shapes must be labels, sem, key (N,), xyz (N, 3), "
                         "lo, hi (N / tile, 9), offs (9,)")
    lib = _load()
    args = [t.contiguous() for t in (xyz, sem, key, labels, lo, hi, offs, r2)]
    out = torch.empty_like(args[3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.seggroup_cc_sweep(*(t.data_ptr() for t in args), out.data_ptr(), n, tile,
                                dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"cc_sweep kernel launch failed with cudaError {err}")
    launches += 1
    return out
