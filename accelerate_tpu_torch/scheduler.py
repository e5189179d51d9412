"""Learning-rate schedule wrapper.

Port of :mod:`accelerate_tpu.scheduler`.  In the JAX package the schedule
lives inside the optax transformation, which evaluates it at its own update
count; here the train step calls :meth:`AcceleratedScheduler.apply` just
before each *applied* optimizer step, so the schedule advances only on
applied steps (accumulation micro-steps and fp16-overflow skips never move
it), with ``step_multiplier`` scaling the count as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


class AcceleratedScheduler:
    def __init__(self, schedule: Union[Callable[[int], float], float],
                 step_multiplier: int = 1, split_batches: bool = False):
        if isinstance(schedule, (int, float)):
            value = float(schedule)
            schedule = lambda count: value  # noqa: E731
        self.schedule = schedule
        self.split_batches = split_batches
        self.step_multiplier = 1 if split_batches else max(1, step_multiplier)

    def __call__(self, count):
        return self.schedule(count * self.step_multiplier)

    def get_last_lr(self, step: int):
        return [float(self(step))]

    def apply(self, optimizer: torch.optim.Optimizer, step: int) -> float:
        """Set every param group's learning rate to the schedule's value for
        the update that follows ``step`` applied ones; returns it."""
        lr = float(self(step))
        for group in optimizer.param_groups:
            group["lr"] = lr
        return lr

    def state_dict(self):
        return {"step_multiplier": self.step_multiplier, "split_batches": self.split_batches}

    def load_state_dict(self, state):
        self.step_multiplier = state.get("step_multiplier", self.step_multiplier)
        self.split_batches = state.get("split_batches", self.split_batches)
