"""Device selection shared by the port's entry points."""

from __future__ import annotations

import subprocess

import torch

from seggroup_tpu_torch.utils import profiling


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
    """The phases of a call handed `phase_seconds`: `clock(name)` is the
    recorder's span `name` fenced by a synchronisation of `device` on both
    sides (utils/profiling.py; `device` None fences nothing). Handed a dict,
    the clock binds the process's recorder to it, and each phase adds its
    wall seconds to it under `name` and its entries under "count.<name>".
    Handed None, the call asked for no phases: the clock records nothing and
    only names its phases' regions while torch.profiler records."""

    def __init__(self, device: torch.device | None, sink: dict | None):
        self.device = device
        self.sink = sink
        if sink is not None:
            profiling.bind(sink)

    def __call__(self, name: str):
        if self.sink is None:
            return profiling.region(name)
        return profiling.span(name, fence=self.device)
