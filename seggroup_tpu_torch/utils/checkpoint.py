"""Checkpoints of state dicts (seggroup_tpu/utils/checkpoint.py).

One file per step, `<directory>/<step>.pt`, written with `torch.save` to a
temporary name and renamed into place, so a reader never sees half a file.
Retention is the JAX package's: the `max_to_keep` newest steps, and with
`pow2_retention` every step that is a power of two or a multiple of 16
besides. `restore` loads with `weights_only=True`: a checkpoint holds
tensors, numbers, strings and containers of them only."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


def _pow2_or_mult16(step: int) -> bool:
    """The reference's retention predicate (pointgroup util/utils.py:85-98):
    keep checkpoints whose step is a power of two or a multiple of 16."""
    return step % 16 == 0 or (step & (step - 1)) == 0


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 5,
                 pow2_retention: bool = False):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep
        self.pow2_retention = pow2_retention

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path(step)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        steps = self.steps()
        for old in steps[:-self.max_to_keep] if self.max_to_keep > 0 else steps:
            if not (self.pow2_retention and _pow2_or_mult16(old)):
                self._path(old).unlink()

    def restore(self, step: int | None = None, map_location="cpu") -> Any:
        """The state saved at `step` (default the latest), or None when
        there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location, weights_only=True)


def lenient_restore(directory: str | os.PathLike, template: dict[str, torch.Tensor],
                    step: int | None = None, log=print
                    ) -> tuple[dict[str, torch.Tensor], int, int]:
    """Name-filtered partial weight loading (reference
    `lenient_weight_loading`, minkowski/main.py:129-146): every entry of the
    checkpoint's model state dict whose name is in `template` (a state dict)
    and whose shape matches replaces the template's; the rest keep their
    values. Returns (state dict, entries loaded, entries in the template)."""
    raw = CheckpointManager(directory).restore(step)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    src = raw.get("model", raw)
    out = dict(template)
    n_loaded = 0
    for name, value in template.items():
        if name in src and tuple(src[name].shape) == tuple(value.shape):
            out[name] = src[name].to(value.dtype)
            n_loaded += 1
        else:
            log(f"lenient_restore: keeping fresh init for {name}")
    return out, n_loaded, len(out)
