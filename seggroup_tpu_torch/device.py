"""Device selection shared by the port's entry points."""

from __future__ import annotations

import subprocess
import time
from contextlib import contextmanager

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. CUDA is the default; a
    missing card raises instead of falling back to the CPU.

    On the card, float32 matrix products and convolutions run in full
    float32 (TF32 off): the JAX reference runs its products at
    Precision.HIGHEST."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def card_description() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class PhaseClock:
    """Adds the wall seconds of named phases to a dict, synchronising the
    device around each; does nothing without a dict."""

    def __init__(self, device: torch.device, sink: dict | None):
        self.device = device
        self.sink = sink

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name: str):
        if self.sink is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.sink[name] = self.sink.get(name, 0.0) + time.perf_counter() - t0
