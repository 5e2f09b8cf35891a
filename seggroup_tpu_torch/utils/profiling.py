"""The port's one span-and-counter recorder.

An entry point that takes `phase_seconds` hands the recorder a dict, its
sink. The first call handed a dict binds this process's recorder to it (a
rank under parallel.dp.launch is a process of its own, so the binding is
per rank); it stays bound until a call hands another dict or `stop()`,
not only while the call that bound it runs. So what a training loop calls
outside such a call is recorded too: the plan of a batch, the prefetch
threads, the ranks' gradient exchange. While bound:

  * `span(name)` adds the wall seconds of its block to sink[name] and 1 to
    sink["count." + name]; `span(name, fence=device)` first synchronises
    the device on both sides of the block, so that the block's device work
    falls inside its seconds (device.PhaseClock's phases);
  * `count(name, n)` adds n to sink["count." + name];
  * `to_host(t)` and `nonzero(t)`, the port's reads of the card on the
    stage-1 path, are spans "host.read": the seconds the host blocked on
    the card, unfenced, and their number under "count.host.read", to
    which `implicit_reads(n, t)` adds the reads that library ops make by
    themselves inside a block, untimed.

A key without a dot is the wall seconds of a disjoint phase on the calling
thread ("forward", "grouping", "export", "plan", "prefetch_wait", ...); a
dotted key nests inside one ("export.format", "all-reduce.wait") or runs
on another thread ("prefetch.make"), so a sum over the phases adds the
undotted keys alone. Updates to the sink take a lock: the prefetch threads
write to it too. A reader divides a span's seconds by its own count where
the binding may start partway through the first unit of work.

Unbound, `span` returns the shared null context and `count` returns at
once, with no device synchronisation and no allocation; but while
torch.profiler records, every span, phases included, opens a
`torch.profiler.record_function` region of its name, bound or not, so the
port's layers sit on the profiler's host timeline, nested as they run,
beside the operators and kernels."""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext

import torch
from torch.autograd import _profiler_enabled

_sink: dict | None = None
_lock = threading.Lock()
_NULL = nullcontext()


def bind(sink: dict) -> None:
    """Record into `sink` from now on, in every thread of this process."""
    global _sink
    _sink = sink


def stop() -> None:
    """Record nothing from now on."""
    global _sink
    _sink = None


def bound() -> bool:
    return _sink is not None


def _add(sink: dict, name: str, seconds: float | None, n: int = 1) -> None:
    key = "count." + name
    with _lock:
        if seconds is not None:
            sink[name] = sink.get(name, 0.0) + seconds
        sink[key] = sink.get(key, 0) + n


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the bound sink's "count.<name>"."""
    sink = _sink
    if sink is not None:
        _add(sink, name, None, n)


def _sync(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    __slots__ = ("name", "fence", "sink", "region", "t0")

    def __init__(self, name: str, fence: torch.device | None, sink: dict | None):
        self.name, self.fence, self.sink = name, fence, sink
        self.region = None

    def __enter__(self):
        if _profiler_enabled():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        if self.sink is not None:
            _sync(self.fence)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.sink is not None:
                _sync(self.fence)
                _add(self.sink, self.name, time.perf_counter() - self.t0)
        finally:
            if self.region is not None:
                self.region.__exit__(*exc)
        return False


def span(name: str, fence: torch.device | None = None):
    """A block timed into the bound sink under `name` (fenced on `fence`, a
    device, where given); a region of the profiler's trace while it
    records; else the shared null context."""
    sink = _sink
    if sink is None and not _profiler_enabled():
        return _NULL
    return _Span(name, fence, sink)


def region(name: str):
    """A region of the profiler's trace while it records, timed into no
    sink (a phase of a call that asked for none)."""
    return _Span(name, None, None) if _profiler_enabled() else _NULL


class _Read:
    """A read of the card inside `block` (the span "host.read" by default),
    with the card's sync debug mode (torch.cuda.set_sync_debug_mode) lifted
    inside it: a read through here is a deliberate one."""

    __slots__ = ("span", "mode")

    def __init__(self, t: torch.Tensor, block=None):
        self.span = span("host.read") if block is None else block
        self.mode = torch.cuda.get_sync_debug_mode() if t.is_cuda else 0

    def __enter__(self):
        if self.mode:
            torch.cuda.set_sync_debug_mode(0)
        self.span.__enter__()

    def __exit__(self, *exc):
        try:
            self.span.__exit__(*exc)
        finally:
            if self.mode:
                torch.cuda.set_sync_debug_mode(self.mode)
        return False


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`, a read of the card: the host blocks until the card has
    computed `t`. `bool(x)`, `int(x)` and `.numpy()` of a card tensor read
    through here as `bool(to_host(x))` and so on."""
    with _Read(t):
        return t.cpu()


def nonzero(t: torch.Tensor) -> torch.Tensor:
    """`torch.nonzero(t)`, which reads its result's length from the card
    before it returns: a read of the card, counted at its call."""
    with _Read(t):
        return torch.nonzero(t)


def implicit_reads(n: int, like: torch.Tensor):
    """A block whose library ops read the card `n` times by themselves, on
    the device of `like`: indexing by a 0-d integer tensor of the card
    (`x[r]`) makes Tensor.__getitem__ call `r.item()`. Such reads are
    counted here, where the caller knows their number before the block, as
    `n` under "count.host.read"; their seconds go untimed, as a span for
    each would sit inside the caller's loop."""
    count("host.read", n)
    return _Read(like, _NULL)
