"""Tensorboard scalar writer behind a flag.

The reference logs scalars via tensorboardX in two stacks
(pointgroup/train.py:29-30,91-93 and minkowski/lib/train.py:35,137-139);
this is the unified equivalent. No-op when disabled or when no tensorboard
backend is importable, so training CLIs never hard-depend on it.
"""

from __future__ import annotations

__all__ = ["ScalarWriter"]


class ScalarWriter:
    def __init__(self, logdir: str, enabled: bool = True):
        self._w = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._w = SummaryWriter(logdir)
            except Exception:
                self._w = None

    @property
    def active(self) -> bool:
        return self._w is not None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
