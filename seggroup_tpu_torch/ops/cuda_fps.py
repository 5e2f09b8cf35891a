"""Kernel K1, masked farthest-point sampling, as a hand-written CUDA kernel
for Hopper: the counterpart of seggroup_tpu/ops/pallas_fps.py.

The source is `csrc/fps.cu` (its header states the two designs and the
bound); `variant` chooses the design by the row length P.
It is compiled at first use with nvcc for sm_90a into `_build/`
(`cuda_build`), loaded with ctypes and launched on the current stream.
`launches` counts the launches made through `masked_fps_cuda`."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from seggroup_tpu_torch import cuda_build

SOURCE = cuda_build.CSRC / "fps.cu"

launches = 0
_lib = None

# Largest P served by the warps design (a CTA of 4 warps per row, the
# candidates in registers, 32 a lane at P = 4,096); a longer row goes to the
# block design (a CTA of 256 threads, the row in shared memory). On an H100
# the warps design took a quarter to a half of the block design's time on
# full rows of 1,024, 2,048 and 4,096 candidates.
WARPS_MAX_P = 4096


def variant(p: int) -> str:
    """Which design serves rows of P candidates: "warps" or "block"."""
    return "warps" if p <= WARPS_MAX_P else "block"


def build() -> tuple[Path, str]:
    """Compile csrc/fps.cu (once per source content) and return the shared
    library's path and the compiler's output ('' when it was built before)."""
    return cuda_build.build(SOURCE, "libseggroup_fps")


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, "libseggroup_fps")
        lib.seggroup_masked_fps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.seggroup_masked_fps.restype = ctypes.c_int
        lib.seggroup_fps_max_points.argtypes = []
        lib.seggroup_fps_max_points.restype = ctypes.c_int
        _lib = lib
    return _lib


def masked_fps_cuda(points: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """(B, P, D>=3) points + (B, P) bool valid -> (B, k) int32 indices into
    P, computed by the CUDA kernel on the tensors' card. xyz are the first
    three columns, as masked_fps_pallas takes them."""
    global launches
    if not (points.is_cuda and valid.is_cuda and points.device == valid.device):
        raise ValueError("masked_fps_cuda takes CUDA tensors on one device")
    if points.ndim != 3 or points.shape[-1] < 3:
        raise ValueError(f"points must be (B, P, D>=3), got {tuple(points.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(points.shape[:2]):
        raise ValueError("valid must be a bool (B, P) mask")
    b, p, _ = points.shape
    if k < 1 or p < 1:
        raise ValueError(f"need k >= 1 and P >= 1, got k={k}, P={p}")
    lib = _load()
    if p > lib.seggroup_fps_max_points():
        raise ValueError(f"P={p} exceeds the kernel's "
                         f"{lib.seggroup_fps_max_points()} candidates per row")
    xyz = points[..., :3].to(torch.float32).contiguous()
    vmask = valid.contiguous()
    out = torch.empty((b, k), dtype=torch.int32, device=points.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.seggroup_masked_fps(xyz.data_ptr(), vmask.data_ptr(), out.data_ptr(), b, p, k,
                                  int(variant(p) == "warps"), points.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"FPS kernel launch failed with cudaError {err}")
    launches += 1
    return out
