"""Training state of the compiled-step path.

Port of :mod:`accelerate_tpu.train_state`.  The JAX package threads one
immutable pytree through a jitted step; here the state is a mutable
:class:`TrainState` that the train step **updates in place**:

  - ``model``       the ``nn.Module`` holding the master weights
                    (``PrecisionPolicy.param_dtype``)
  - ``optimizer``   the ``torch.optim.Optimizer`` bound to those weights
  - ``step``        count of *applied* optimizer steps
  - ``micro_step``  micro-steps accumulated since the last sync
  - ``loss_scale``  the fp16 :class:`DynamicLossScale` (``None`` otherwise)

The gradient-accumulation buffer is the parameters' own ``.grad``: each
micro-step's backward adds into it, and a sync step averages, clips,
applies and clears it.  ``step`` and ``micro_step`` are host integers — the
step decides on the host whether a call syncs, so it never reads them back
from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """fp16 loss scale: grows by ``growth_factor`` after ``growth_interval``
    consecutive finite sync steps, backs off by ``backoff_factor`` (not below
    1) on overflow; an overflowing step is skipped."""

    scale: float = 2.0**16
    growth_tracker: int = 0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000

    @classmethod
    def create(cls, init_scale: float = 2.0**16, **kwargs) -> "DynamicLossScale":
        return cls(scale=float(init_scale), **kwargs)

    def update(self, grads_finite: bool) -> "DynamicLossScale":
        tracker = self.growth_tracker + 1 if grads_finite else 0
        grow = tracker >= self.growth_interval
        if grads_finite:
            scale = self.scale * self.growth_factor if grow else self.scale
        else:
            scale = max(self.scale * self.backoff_factor, 1.0)
        return dataclasses.replace(self, scale=scale, growth_tracker=0 if grow else tracker)


def _leaves(tensors) -> list:
    if isinstance(tensors, dict):
        tensors = tensors.values()
    return [t for t in tensors if t is not None]


def tree_finite(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """Device bool: every element of every tensor is finite."""
    leaves = _leaves(tensors)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """L2 norm over all tensors, accumulated in f32 whatever their dtype, as
    a device scalar (no host read)."""
    leaves = _leaves(tensors)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in leaves]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass(eq=False)
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    micro_step: int = 0
    loss_scale: Optional[DynamicLossScale] = None

    @classmethod
    def create(cls, *, model: nn.Module, tx: Callable, use_loss_scaling: bool = False,
               init_loss_scale: float = 2.0**16,
               loss_scale_kwargs: Optional[dict] = None) -> "TrainState":
        """Bind ``tx(parameters) -> Optimizer`` (e.g.
        ``functools.partial(torch.optim.AdamW, lr=...)``) to ``model``."""
        optimizer = tx(list(model.parameters()))
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"tx must build a torch.optim.Optimizer, got {type(optimizer)}")
        loss_scale = (DynamicLossScale.create(init_loss_scale, **(loss_scale_kwargs or {}))
                      if use_loss_scaling else None)
        return cls(model=model, optimizer=optimizer, loss_scale=loss_scale)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Name -> master weight."""
        return dict(self.model.named_parameters())

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``; advances
        ``step``.  In place; returns ``self``."""
        self.optimizer.step()
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, Any]:
        """What resuming needs besides the weights: the counters, the
        optimizer's state, the loss scale and — whenever ``micro_step > 0`` —
        the accumulation buffer by parameter name (without it a window
        restored mid-way would lose its earlier micro-steps).  Tensors stay
        where they are."""
        tree = {"step": self.step, "micro_step": self.micro_step,
                "optimizer": self.optimizer.state_dict()}
        if self.micro_step > 0:
            tree["grad"] = {name: p.grad for name, p in self.model.named_parameters()
                            if p.grad is not None}
        if self.loss_scale is not None:
            tree["loss_scale"] = {"scale": self.loss_scale.scale,
                                  "growth_tracker": self.loss_scale.growth_tracker}
        return tree

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` in place, the buffer onto the
        parameters' device.  torch keeps an optimizer's step counts on the
        host unless it is ``capturable`` or ``fused``: they go back there, and
        ``optimizer.load_state_dict`` places them (and the moments, on the
        parameters' device) as the optimizer itself would."""
        opt = tree["optimizer"]
        for param_state in opt["state"].values():
            if isinstance(param_state.get("step"), torch.Tensor):
                param_state["step"] = param_state["step"].cpu()
        self.optimizer.load_state_dict(opt)
        self.step = int(tree["step"])
        self.micro_step = int(tree["micro_step"])
        grads = tree.get("grad", {})
        for name, p in self.model.named_parameters():
            g = grads.get(name)
            p.grad = None if g is None else g.to(device=p.device, dtype=p.dtype)
        if self.loss_scale is not None and "loss_scale" in tree:
            self.loss_scale = dataclasses.replace(
                self.loss_scale, scale=float(tree["loss_scale"]["scale"]),
                growth_tracker=int(tree["loss_scale"]["growth_tracker"]))
