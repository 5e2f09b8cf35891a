"""Background host-side batch pipeline.

The reference overlaps input work with device compute via DataLoader worker
processes / tf.data threads (SURVEY.md §2.5 host-parallelism row). The JAX
analog: a daemon thread runs the (numpy) batch factory — augmentation,
voxelization, C++ rulebook plans — and a small queue hands results to the
train loop, so the TPU never waits for the host once the pipeline is warm.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

from seggroup_tpu_torch.utils import profiling


class HostPrefetcher:
    """Runs `factory(step) -> batch` on `workers` daemon threads, `depth`
    batches ahead. Batches are yielded in step order. Exceptions in the
    factory propagate to the consumer on the next __next__. The recorder
    (utils/profiling.py), while bound, times each batch a thread makes as
    "prefetch.make" and each wait of the consumer for its next batch as
    "prefetch_wait"."""

    def __init__(self, factory: Callable[[int], object], depth: int = 2,
                 workers: int = 1, start: int = 0):
        self._factory = factory
        self._depth = max(1, depth)
        self._workers = max(1, workers)
        self._tickets: queue.Queue = queue.Queue()
        self._done: dict = {}
        self._lock = threading.Condition()
        self._next_out = start
        self._next_in = start
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(self._workers)
        ]
        for _ in range(self._depth + self._workers - 1):
            self._tickets.put(self._next_in)
            self._next_in += 1
        for t in self._threads:
            t.start()

    def _run(self):
        while True:
            step = self._tickets.get()
            if step is None or self._stop:
                return
            try:
                with profiling.span("prefetch.make"):
                    result = (None, self._factory(step))
            except BaseException as e:  # propagate to consumer
                result = (e, None)
            with self._lock:
                self._done[step] = result
                self._lock.notify_all()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with profiling.span("prefetch_wait"), self._lock:
            while self._next_out not in self._done:
                self._lock.wait()
            err, batch = self._done.pop(self._next_out)
            self._next_out += 1
        self._tickets.put(self._next_in)
        self._next_in += 1
        if err is not None:
            raise err
        return batch

    def close(self):
        self._stop = True
        for _ in self._threads:
            self._tickets.put(None)
