"""Profiling and timing utilities (seggroup_tpu/utils/profiling.py).

Host-side `AverageMeter` and `Timer` for loop bookkeeping, as in the JAX
package; `device_trace` records a `torch.profiler` trace of the CPU and,
where a card is present, of CUDA, written as a Chrome trace under
`logdir` (viewable in chrome://tracing or Perfetto); `annotate` names a
region in that trace (`torch.profiler.record_function`)."""

from __future__ import annotations

import contextlib
import os
import time

import torch


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def tic(self):
        self.t0 = time.time()

    def toc(self) -> float:
        return time.time() - self.t0


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record the work inside the block with torch.profiler (CUDA activity
    too where a card is present) and write `logdir/trace.json`. Yields the
    profiler (its `key_averages()` tabulates the kernels)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the device trace."""
    with torch.profiler.record_function(name):
        yield
