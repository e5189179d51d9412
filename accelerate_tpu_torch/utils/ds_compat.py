"""DeepSpeed ``optimizer``/``scheduler`` JSON sections -> a torch optimizer and schedule.

Port of :mod:`accelerate_tpu.utils.ds_compat` (its ``optax_from_ds_config``
becomes :func:`torch_tx_from_ds_config`).  It completes the migration shim:
:meth:`~accelerate_tpu_torch.utils.dataclasses.ZeroPlugin.
from_deepspeed_config` maps the ZeRO, precision and accumulation keys, and
this module builds the optimizer the same file describes::

    plugin = ZeroPlugin.from_deepspeed_config("ds.json")
    tx, schedule = torch_tx_from_ds_config("ds.json", lr=2e-4, total_num_steps=10_000)
    accelerator = Accelerator(deepspeed_plugin=plugin)
    state = accelerator.create_train_state(params=model, tx=tx)
    if schedule is not None:
        accelerator.prepare(schedule)      # step -> learning rate

``tx`` is a factory ``parameters -> torch.optim.Optimizer`` (what
``create_train_state`` takes); ``schedule`` the learning rate by applied
step, ``None`` for a constant rate.  Optimizer ``type``: ``AdamW``
(``torch.optim.AdamW``, decoupled decay), ``Adam`` (decoupled by default,
as DeepSpeed's FusedAdam runs with ``adam_w_mode=True``;
``adam_w_mode: false`` / ``torch_adam: true`` select ``torch.optim.Adam``'s
coupled L2), ``SGD``.  ``Lamb`` has no ``torch.optim`` counterpart and
raises.  Scheduler ``type``: ``WarmupLR``, ``WarmupDecayLR``,
``WarmupCosineLR``, the same formulas as the optax schedules the JAX
package builds.  ``"auto"`` values resolve from the keyword arguments.
"""

from __future__ import annotations

import functools
import json
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

__all__ = ["torch_tx_from_ds_config"]

_MISSING = object()  # an absent JSON key, as opposed to an explicit "auto"


def _resolved(value, fallback, name: str):
    if value in ("auto", None):
        if fallback is None:
            what = 'sets it to "auto"' if value == "auto" else "omits it"
            raise ValueError(
                f"DeepSpeed config needs a value for {name} (the config {what}) — "
                f"pass {name}=... to torch_tx_from_ds_config (the reference fills "
                "these from the Trainer at prepare() time; here the call site is "
                "that moment).")
        return fallback
    return value


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``."""
    steps = max(int(steps), 1)
    return lambda count: init + (end - init) * min(max(count, 0) / steps, 1.0)


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``."""
    decay_steps = max(int(decay_steps), 1)

    def sched(count):
        frac = min(max(count, 0), decay_steps) / decay_steps
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    return sched


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """``optax.join_schedules`` over two schedules."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def _schedule(sched: Dict[str, Any], lr: float, total_num_steps: Optional[int],
              warmup_num_steps: Optional[int]) -> Union[float, Callable[[int], float]]:
    stype = sched.get("type", "WarmupLR")
    p = sched.get("params", {}) or {}
    raw_warmup = p.get("warmup_num_steps", _MISSING)
    if raw_warmup is _MISSING:
        warmup_steps = int(warmup_num_steps if warmup_num_steps is not None else 1000)
    else:
        warmup_steps = int(_resolved(raw_warmup, warmup_num_steps, "warmup_num_steps"))
    if stype == "WarmupCosineLR":
        total = int(_resolved(p.get("total_num_steps"), total_num_steps, "total_num_steps"))
        min_ratio = float(_resolved(p.get("warmup_min_ratio", 0.0), 0.0, "warmup_min_ratio"))
        cos_min = float(_resolved(p.get("cos_min_ratio", 0.0), 0.0, "cos_min_ratio"))
        return _join(_linear(min_ratio * lr, lr, max(warmup_steps, 1)),
                     _cosine(lr, max(total - warmup_steps, 1), cos_min), warmup_steps)
    min_lr = float(_resolved(p.get("warmup_min_lr", 0.0), 0.0, "warmup_min_lr"))
    max_lr = float(_resolved(p.get("warmup_max_lr"), lr, "warmup_max_lr"))
    if stype == "WarmupLR":
        if warmup_steps == 0:
            return max_lr
        return _linear(min_lr, max_lr, warmup_steps)
    if stype == "WarmupDecayLR":
        total = int(_resolved(p.get("total_num_steps"), total_num_steps, "total_num_steps"))
        return _join(_linear(min_lr, max_lr, max(warmup_steps, 1)),
                     _linear(max_lr, 0.0, max(total - warmup_steps, 1)), warmup_steps)
    raise ValueError(
        f"Unsupported DeepSpeed scheduler type {stype!r}; supported: WarmupLR, "
        "WarmupDecayLR, WarmupCosineLR. Build the schedule directly for anything else.")


def torch_tx_from_ds_config(config: Union[str, Dict[str, Any]], *, lr: Optional[float] = None,
                            weight_decay: Optional[float] = None,
                            total_num_steps: Optional[int] = None,
                            warmup_num_steps: Optional[int] = None
                            ) -> Tuple[Callable, Optional[Callable[[int], float]]]:
    """``(tx, schedule)`` for a DeepSpeed JSON's optimizer and scheduler
    (``config``: the path or the parsed dict): see the module docstring."""
    if isinstance(config, str):
        with open(config) as f:
            ds = json.load(f)
    else:
        ds = config
    opt = ds.get("optimizer") or {}
    otype = str(opt.get("type", "AdamW"))
    p = opt.get("params", {}) or {}
    lr_val = float(_resolved(p.get("lr"), lr, "lr"))
    sched = ds.get("scheduler")
    schedule = _schedule(sched, lr_val, total_num_steps, warmup_num_steps) if sched else lr_val
    wd_val = float(_resolved(p.get("weight_decay", 0.0),
                             weight_decay if weight_decay is not None else 0.0, "weight_decay"))
    betas = _resolved(p.get("betas", (0.9, 0.999)), (0.9, 0.999), "betas")
    betas = (float(betas[0]), float(betas[1]))
    eps = float(_resolved(p.get("eps", 1e-8), 1e-8, "eps"))
    # the optimizer starts at the schedule's first value; the accelerator's
    # prepared schedule sets each applied step's
    first_lr = schedule(0) if callable(schedule) else float(schedule)
    schedule = schedule if callable(schedule) else None

    lowered = otype.lower()
    if lowered == "adamw":
        tx = functools.partial(torch.optim.AdamW, lr=first_lr, betas=betas, eps=eps,
                               weight_decay=wd_val)
    elif lowered == "adam":
        coupled = bool(_resolved(p.get("torch_adam", False), False, "torch_adam")) or not bool(
            _resolved(p.get("adam_w_mode", True), True, "adam_w_mode"))
        cls = torch.optim.Adam if coupled else torch.optim.AdamW
        tx = functools.partial(cls, lr=first_lr, betas=betas, eps=eps, weight_decay=wd_val)
    elif lowered == "sgd":
        momentum = float(_resolved(p.get("momentum", 0.0), 0.0, "momentum") or 0.0)
        tx = functools.partial(torch.optim.SGD, lr=first_lr, momentum=momentum,
                               weight_decay=wd_val)
    elif lowered == "lamb":
        raise ValueError(
            "DeepSpeed optimizer type 'Lamb' has no torch.optim counterpart; pass a LAMB "
            "optimizer factory to create_train_state directly.")
    else:
        raise ValueError(
            f"Unsupported DeepSpeed optimizer type {otype!r}; supported: Adam, AdamW, SGD. "
            "Pass a torch.optim factory directly for anything else (DeepSpeed's fused/CPU "
            "variants are execution details of its CUDA engine — the math maps onto these).")
    return tx, schedule
