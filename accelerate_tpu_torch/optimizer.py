"""Optimizer wrapper.

Port of :mod:`accelerate_tpu.optimizer`.  Accumulation, clipping, loss
scaling and the overflow skip all happen inside the train step
(``Accelerator.compile_train_step``); this wrapper is the user-facing shell
around the bound ``torch.optim.Optimizer``: ``step_was_skipped``,
``zero_grad``, and a ``state_dict`` that carries the training counters and
the accumulation buffer (the parameters' ``.grad``) with the optimizer's own
state, so a restore mid-window resumes the same average.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .state import GradientState


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class AcceleratedOptimizer:
    def __init__(self, optimizer, _accelerator=None):
        if isinstance(optimizer, AcceleratedOptimizer):
            optimizer = optimizer.optimizer
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"expected a torch.optim.Optimizer, got {type(optimizer)}")
        self.optimizer = optimizer
        self.gradient_state = GradientState()
        self._step_was_skipped = False
        self._accelerator = _accelerator  # finds the TrainState bound to this optimizer

    @property
    def param_groups(self):
        """The optimizer's groups; for an offloaded (chunked) optimizer,
        every chunk's, the same dicts its optimizers step with."""
        return self.optimizer.param_groups

    @property
    def step_was_skipped(self) -> bool:
        """True when the last sync step overflowed under fp16 and was skipped."""
        return self._step_was_skipped

    def _resolve_state(self):
        state = None
        if self._accelerator is not None:
            state = self._accelerator._states.get(id(self.optimizer))
        if state is None:
            raise RuntimeError(
                "No TrainState is linked to this optimizer yet: create one with "
                "accelerator.create_train_state(params=model, tx=...) first.")
        return state

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Empty the accumulation buffer and restart the linked state's
        accumulation window (a micro-step count without its gradient sum
        would mis-scale the next update)."""
        self.optimizer.zero_grad(set_to_none=set_to_none)
        if self._accelerator is not None:
            state = self._accelerator._states.get(id(self.optimizer))
            if state is not None:
                state.micro_step = 0

    def state_dict(self) -> Dict[str, Any]:
        """Host copy of the linked TrainState's :meth:`~TrainState.state_dict`:
        the optimizer state, the step counters, the accumulation buffer and
        the loss scale."""
        return _to_host(self._resolve_state().state_dict())

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` snapshot into the optimizer and its
        linked TrainState, in place."""
        self._resolve_state().load_state_dict(state_dict)
