"""Build and load the port's native code: the CUDA kernels (csrc/*.cu) and
the host library (csrc/seggroup_native.cpp).

Each CUDA source is compiled with nvcc for sm_90a, the host source with the
host's C++ compiler, into a shared library with a plain C interface, named
by a hash of the source and the flags, under the gitignored `_build/`
directory, and loaded with ctypes. A library built before is reused.
Nothing here runs when a module is imported."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the host library: no -march=native and no floating-point contraction, so
# that its floats are the same on every host and equal its numpy fallbacks
# (the JAX package's Makefile builds with -march=native, where GCC fuses
# multiply-adds into FMA on a host that has them)
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path is not None:
            return path
    raise RuntimeError("no C++ compiler (c++ or g++) found: the host library cannot be built")


def _compile(source: Path, stem: str, compiler, flags: list[str]) -> tuple[Path, str]:
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    exe = compiler()
    proc = subprocess.run([exe, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(exe)} failed on {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def build(source: Path, stem: str) -> tuple[Path, str]:
    """Compile the CUDA `source` (once per source content) into
    `_build/<stem>_<hash>.so`; return the library's path and the compiler's
    output ('' when it was built before)."""
    return _compile(source, stem, nvcc, NVCC_FLAGS)


def build_host(source: Path, stem: str) -> tuple[Path, str]:
    """`build` for a C++ source with the host's compiler (CXX_FLAGS)."""
    return _compile(source, stem, cxx, CXX_FLAGS)


def load(source: Path, stem: str) -> ctypes.CDLL:
    """Build the CUDA `source` if needed and load it."""
    path, _ = build(source, stem)
    return ctypes.CDLL(str(path))
