"""Learning-rate schedules and optimizers (seggroup_tpu/solvers.py).

The five schedules are the JAX package's formulas, with its keywords and
defaults. `make_optimizer` gives
torch.optim's SGD (momentum 0.9) or Adam with an L2 weight decay of 1e-4
added to the gradient, which is optax's `add_decayed_weights` followed by
`sgd` or `adam`; with `weight_decay=0`, Adam is optax's plain `adam` (the
PointGroup trainer's). `ScheduledLR` sets the learning rate of step s to
schedule(s), s counted from 0 as optax counts its updates."""

from __future__ import annotations

from collections.abc import Callable, Iterable

import torch

Schedule = Callable[[int], float]

# the JAX package's optimizer constants
SGD_MOMENTUM = 0.9
ADAM_BETAS = (0.9, 0.999)
WEIGHT_DECAY = 1e-4


def make_schedule(name: str, base_lr: float, *, max_iter: int = 60000,
                  poly_power: float = 0.9, step_size: int = 20000,
                  step_gamma: float = 0.1, exp_gamma: float = 0.9,
                  exp_step_size: int = 445) -> Schedule:
    if name == "PolyLR":
        return lambda s: base_lr * (1 - s / (max_iter + 1)) ** poly_power
    if name == "SquaredLR":
        return lambda s: base_lr * (1 - s / (max_iter + 1)) ** 2
    if name == "StepLR":
        return lambda s: base_lr * step_gamma ** (s // step_size)
    if name == "ExpLR":
        return lambda s: base_lr * exp_gamma ** (s / exp_step_size)
    if name == "constant":
        return lambda s: base_lr
    raise ValueError(name)


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                   momentum: float = SGD_MOMENTUM, weight_decay: float = WEIGHT_DECAY
                   ) -> tuple[torch.optim.Optimizer, "ScheduledLR"]:
    """(optimizer, its ScheduledLR); the optimizer starts at schedule(0)."""
    lr = float(schedule(0))
    if name == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)
    elif name == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, weight_decay=weight_decay)
    else:
        raise ValueError(name)
    return opt, ScheduledLR(opt, schedule)


class ScheduledLR:
    """Sets every parameter group's learning rate to schedule(step); `step()`
    advances after each optimizer step. Its state is the step count."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule, start: int = 0):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = start
        self._apply()

    def _apply(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.schedule(self.count))

    def step(self) -> None:
        self.count += 1
        self._apply()

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self._apply()
