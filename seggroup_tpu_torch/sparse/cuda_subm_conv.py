"""Kernel K2, the submanifold gather-GEMM (the forward and the data
gradient), as a hand-written CUDA kernel for Hopper: the counterpart of the
forward kernels of seggroup_tpu/sparse/pallas_conv.py (K2a `_fwd_kernel`,
K2b `_fwd_kernel_chunked`, K2c `_fwd_kernel_packed`).

The source is `csrc/subm_conv.cu` (its header states the design, the bound
and the measured times). It is compiled at first use with nvcc for sm_90a
into `_build/` (`cuda_build`), loaded with ctypes and launched on the current
stream. A call of `subm_conv_cuda` runs two passes: the weights into the
K-major (Cout_p, K * Cin_p) matrix (`subm_conv_weights_k_major`; not where
the plan is `direct`, K = 1 with N <= 64: there the second pass reads the
few weights itself), then the gather-GEMM, launched to start under the
first: a CTA owns 128 output rows and the whole Cout up to 256 (equal N
tiles above, half of it where the rows alone would not fill the card),
reads its rulebook block once, lists its
present offsets, and streams the flattened (present offset, 8-channel
piece) axis in stages of 64 values through a cp.async ring into wgmma
(`subm_gather_gemm`, or `subm_gather_gemm_ws` with a copying warpgroup
beside two multiplying ones at N = 192 and 256). `plan` picks the entry
point, the N tile, the ring's depth, the kernel and the direct form from
the shapes alone (no host sync); `launches` counts the calls of
`subm_conv_cuda` that launched the kernels (each call one launch of the
gather-GEMM, after one of the weights pass unless the plan is direct).

`present_offsets_plain` lists each 128-row tile's present offsets and
`weights_k_major_plain` is the first pass's plain version; the tests hold
the kernel's tile order and its first pass against them."""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from seggroup_tpu_torch import cuda_build

SOURCE = cuda_build.CSRC / "subm_conv.cu"
# the C entry point of each channel regime, named after the Pallas variant
# it replaces (csrc/subm_conv.cu)
K2C_SHIFT2 = "subm_conv_k2c_shift2"  # Cin <= 32
K2C_SHIFT1 = "subm_conv_k2c_shift1"  # Cin <= 64
K2AB_CHUNKED = "subm_conv_k2ab_chunked"  # Cin > 64

# the CTA's tile and ring (csrc/subm_conv.cu)
ROW_TILE = 128  # output rows per CTA
STAGE_VALUES = 64  # reduction values per stage: 8 pieces of 8 channels
N_TILES = (16, 32, 48, 64, 80, 96, 112, 128, 192, 256)  # the instantiated widths
STAGES = 4  # the ring's depth, 3 where a large K's rulebook block leaves no room
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a CTA may take
WS_N = (192, 256)  # the widths that run on the warp-specialised kernel
PAIR_N = (80, 128)  # N tiles that take a 3-stage ring on a large grid: two CTAs share an SM

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
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.subm_conv_weights.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                          + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        lib.subm_conv_weights.restype = ctypes.c_int
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


def stage_bytes(n: int) -> int:
    """Bytes of one ring stage: A (128 rows x 64 values) and B (n rows x 64
    values), bf16."""
    return (ROW_TILE + n) * STAGE_VALUES * 2


def smem_bytes(n: int, kvol: int, stages: int) -> int:
    """Dynamic shared memory of a CTA (csrc/subm_conv.cu:smem_bytes): room
    to align the ring, the ring, its barriers, the int32 rulebook block, the
    present-offset list and flags."""
    return 1024 + stages * stage_bytes(n) + 64 + (ROW_TILE * kvol + 2 * kvol + 4) * 4


def n_tile(cout_p: int) -> tuple[int, int]:
    """(N tile width, number of N tiles) for cout_p output channels: the
    whole Cout in one tile up to 256, else equal tiles; each width the
    narrowest instantiation that holds its share."""
    tiles = math.ceil(cout_p / N_TILES[-1])
    share = math.ceil(cout_p / tiles)
    return next(w for w in N_TILES if w >= share), tiles


class Plan(NamedTuple):
    entry: str  # the C entry point (regime)
    n: int  # N tile width
    n_tiles: int
    stages: int  # ring depth
    ws: int  # 1: the warp-specialised kernel (a copying warpgroup beside two multiplying)
    smem: int  # dynamic shared memory of a CTA, bytes
    direct: bool  # no weights pass: the gather-GEMM reads W itself (K = 1, N <= 64)


@functools.lru_cache(maxsize=None)
def plan(cin: int, cout: int, kvol: int, m: int, sms: int = 132) -> Plan:
    """The launch of `subm_conv_cuda` for (Cin, Cout, K) over m rows on a
    card with `sms` SMs, from the shapes alone:
    - N: the whole Cout up to 256, else equal tiles; where the row tiles
      and N tiles together would not fill the card once, N is halved (down
      to 64) for more CTAs;
    - the kernel: the warp-specialised one for N in WS_N;
    - the ring: as many stages as a tile can have where that is under 4
      (K = 1: the stages are all copied up front); else 4 stages, but 3 for
      N in PAIR_N when the grid fills the card more than twice over (two
      CTAs then share an SM), and 3 where a large K's rulebook block leaves
      no room for 4. Raises where it leaves no room for 3;
    - direct: at K = 1 with N <= 64 the gather-GEMM reads the few weights
      itself and no weights pass runs (one launch a call, not two: the
      host's time, not the card's, sets such a call's time)."""
    cout_p = -(-cout // 8) * 8
    n, tiles = n_tile(cout_p)
    row_tiles = -(-m // ROW_TILE)
    while n > 64 and row_tiles * tiles < sms:
        n = next(w for w in N_TILES if w >= -(-cout_p // (2 * tiles)))
        tiles = -(-cout_p // n)
    ws = n in WS_N
    most = -(-kvol * -(-cin // 8) // 8)  # stages of a tile where every offset is present
    pair = PAIR_N[0] <= n <= PAIR_N[1] and row_tiles * tiles > 2 * sms
    if most < STAGES:  # a ring that holds every stage
        depths = (max(most, 2 if ws else 1),)
    else:
        depths = (STAGES - 1,) if pair else (STAGES, STAGES - 1)
    for stages in depths:
        smem = smem_bytes(n, kvol, stages)
        if smem <= SMEM_LIMIT:
            direct = kvol == 1 and n <= 64
            return Plan(regime(cin), n, tiles, stages, int(ws), smem, direct)
    raise ValueError(f"subm_conv_cuda: K={kvol} with an N tile of {n} needs "
                     f"{smem} bytes of shared memory, over {SMEM_LIMIT}")


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def present_offsets_plain(rulebook: torch.Tensor) -> torch.Tensor:
    """(ceil(M / 128), K) bool: the offsets of each 128-row tile that some
    row of the tile has (a value in [0, M)), the ones the kernel streams."""
    m, kvol = rulebook.shape
    on = (rulebook >= 0) & (rulebook < m)
    tiles = -(-m // ROW_TILE)
    pad = on.new_zeros((tiles * ROW_TILE - m, kvol))
    return torch.cat([on, pad]).reshape(tiles, ROW_TILE, kvol).any(1)


def weights_k_major_plain(weights: torch.Tensor, cin_p: int, cout_p: int) -> torch.Tensor:
    """The first pass's plain version: weights (K, Cin, Cout) -> (Cout_p,
    K * Cin_p), Wt[n, k * Cin_p + c] = W[k, c, n], zero in the padding."""
    kvol, cin, cout = weights.shape
    w = torch.zeros((kvol, cin_p, cout_p), dtype=weights.dtype, device=weights.device)
    w[:, :cin, :cout] = weights
    return w.permute(2, 0, 1).reshape(cout_p, kvol * cin_p).contiguous()


def subm_conv_cuda(feats: torch.Tensor, weights: torch.Tensor,
                   rulebook: torch.Tensor) -> torch.Tensor:
    """feats (M, Cin) bfloat16, weights (K, Cin, Cout) bfloat16 (any
    strides), rulebook (M, K) int32 with any value outside [0, M) for an
    absent neighbour -> (M, Cout) float32, out[i] = sum_k W[k]^T
    feats[rulebook[i, k]] accumulated in float32, by the CUDA kernels on the
    tensors' card. The features' Cin is padded to a multiple of 8 with zeros
    here (the stem's Cin=3 among them), the weights' by the first pass."""
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
    p = plan(cin, cout, kvol, m, _sms(dev))
    lib = _load()
    f = pad8(feats, 1).contiguous()
    rb = rulebook.contiguous()
    cin_p, cout_p = f.shape[1], -(-cout // 8) * 8
    # no Wt (NULL) where the plan is direct: the gather-GEMM reads W itself
    wt = None if p.direct else torch.empty((cout_p, kvol * cin_p), dtype=torch.bfloat16,
                                           device=dev)
    out = torch.empty((m, cout_p), dtype=torch.float32, device=dev)
    err = getattr(lib, p.entry)(f.data_ptr(), weights.data_ptr(),
                                None if wt is None else wt.data_ptr(), rb.data_ptr(),
                                out.data_ptr(), m, cin, cin_p, cout, cout_p, kvol,
                                *weights.stride(), p.n, p.n_tiles, p.stages, p.ws,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_conv kernel launch failed with cudaError {err}")
    launches += 1
    return out if cout_p == cout else out[:, :cout].contiguous()
