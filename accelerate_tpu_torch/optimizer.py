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

import dataclasses
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
        return self.optimizer.param_groups

    @property
    def step_was_skipped(self) -> bool:
        """True when the last sync step overflowed under fp16 and was skipped."""
        return self._step_was_skipped

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

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
        """Host copy of the optimizer state, the step counters, the
        accumulation buffer and the loss scale."""
        state = self._resolve_state()
        sd = {
            "optimizer": _to_host(self.optimizer.state_dict()),
            "step": state.step,
            "micro_step": state.micro_step,
            "grad_accum": [None if p.grad is None else _to_host(p.grad) for p in self._params()],
        }
        if state.loss_scale is not None:
            sd["loss_scale"] = {"scale": state.loss_scale.scale,
                                "growth_tracker": state.loss_scale.growth_tracker}
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` snapshot into the optimizer and its
        linked TrainState, in place."""
        state = self._resolve_state()
        self.optimizer.load_state_dict(state_dict["optimizer"])
        state.step = int(state_dict.get("step", 0))
        accum = state_dict.get("grad_accum")
        params = self._params()
        if accum is None:
            # no buffer in the snapshot: restart the window from zero
            self.optimizer.zero_grad(set_to_none=True)
            state.micro_step = 0
        else:
            if len(accum) != len(params):
                raise ValueError(f"snapshot holds {len(accum)} gradient buffers for "
                                 f"{len(params)} parameters")
            for p, g in zip(params, accum):
                p.grad = None if g is None else g.to(device=p.device, dtype=p.dtype, copy=True)
            state.micro_step = int(state_dict.get("micro_step", 0))
        ls = state_dict.get("loss_scale")
        if ls is not None and state.loss_scale is not None:
            state.loss_scale = dataclasses.replace(
                state.loss_scale, scale=float(ls["scale"]),
                growth_tracker=int(ls["growth_tracker"]))
