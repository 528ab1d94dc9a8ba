"""Train state and optimizer: the reference's SGD recipe (counterpart of
``can_tpu/train/state.py:29-55``).

SGD with momentum 0.95 and no weight decay, the base lr scaled linearly
by the world size, optionally cosine-decayed to ``lr * lrf`` over the run
(optax ``cosine_decay_schedule(alpha=lrf)``; ``lrf = 1`` keeps the
reference's constant lr).  ``torch.optim.SGD`` with dampening 0 and
nesterov off computes optax's ``sgd(momentum)``: the momentum buffer
starts at the first gradient (optax: a zero trace plus the gradient) and
the update is ``-lr * buffer`` (tests/test_torch_train.py holds the two
against each other).  As in optax, the step's lr is the schedule at the
count before the step is taken.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch


def make_lr_schedule(base_lr: float, *, world_size: int = 1,
                     total_steps: Optional[int] = None,
                     lrf: float = 1.0) -> Callable[[int], float]:
    """lr(step): base_lr x world_size, optionally cosine-decayed to x lrf
    over ``total_steps`` (constant afterwards)."""
    peak = float(base_lr) * world_size  # linear scaling rule
    if lrf == 1.0 or total_steps is None:
        return lambda step: peak
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")

    def schedule(step: int) -> float:
        frac = min(int(step), total_steps) / total_steps
        return peak * ((1.0 - lrf) * 0.5 * (1.0 + math.cos(math.pi * frac)) + lrf)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], *,
                   momentum: float = 0.95) -> torch.optim.SGD:
    """SGD with momentum and no weight decay; the lr is set from the
    schedule at every step (``TrainState.apply_update``)."""
    return torch.optim.SGD(list(params), lr=0.0, momentum=momentum,
                           dampening=0.0, weight_decay=0.0, nesterov=False)


@dataclasses.dataclass
class TrainState:
    """What one run trains: the model (parameters and BN running
    statistics), its optimizer, the lr schedule and the step count.  The
    train step updates it in place."""

    model: torch.nn.Module
    optimizer: torch.optim.SGD
    lr_schedule: Callable[[int], float]
    step: int = 0

    def lr(self) -> float:
        """The lr of the next step (schedule at the pre-increment count)."""
        return float(self.lr_schedule(self.step))

    def apply_update(self) -> float:
        """One optimizer step at ``lr()``; returns the lr used."""
        lr = self.lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr


def create_train_state(model: torch.nn.Module, lr_schedule, *,
                       momentum: float = 0.95) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               momentum=momentum),
                      lr_schedule=lr_schedule)
