"""The ``Accelerator`` of the training path: one process, one device.

Port of :mod:`accelerate_tpu.accelerator` for a single card.  The JAX
package compiles the whole training step into one jitted program; here the
same step runs eagerly, with the same semantics and the same metrics::

    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    loader = accelerator.prepare(SimpleDataLoader(dataset, batch_size=2))
    state = accelerator.create_train_state(
        params=model, tx=functools.partial(torch.optim.AdamW, lr=3e-4))
    step = accelerator.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    for batch in loader:
        state, metrics = step(state, batch)

Every call of ``step`` casts the f32 masters to the policy's compute dtype
(a differentiable ``.to`` inside the loss, so gradients land in f32 on the
masters), runs the loss forward and backward — adding into the parameters'
``.grad``, the accumulation buffer — and on a sync call (every
``gradient_accumulation_steps``-th, the dataloader's last batch, or every
call under ``sync_each_batch``) averages, clips by global norm and value,
checks finiteness under fp16, applies the optimizer and clears the buffer.
The state is updated in place.  ``metrics`` holds device tensors (``loss``,
``grad_norm``, ``applied``, ``overflow`` and ``aux``): the step reads nothing
back from the device, except one finiteness flag per sync step under fp16.

The reference's unfused loop shape is here too, with the JAX package's
semantics::

    for batch in loader:
        with accelerator.accumulate():
            grads, m = accelerator.compute_gradients(loss_fn, state, batch)
            state = accelerator.apply_gradients(state, grads, max_grad_norm=1.0)

``compute_gradients`` returns fresh f32 gradients (unscaled under fp16)
and leaves the state alone; ``apply_gradients`` adds them into the
accumulation buffer, or on a sync call averages, clips, applies and clears
it.  ``save_state``/``load_state`` (``checkpointing.py``) resume a run,
mid-window too; ``save_model`` exports safetensors.

Arguments for what is not ported — sharding plugins, meshes, RNG
synchronization across processes (``rng_types``), offload,
PowerSGD, fp8, remat, trackers, the metrics endpoint — raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.utils.data
from torch import nn

from . import checkpointing
from .data_loader import DataLoaderShard, SimpleDataLoader, prepare_data_loader
from .data_loader import skip_first_batches as _skip_first_batches
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .train_state import TrainState, global_norm, tree_finite
from .utils import operations as ops
from .utils.dataclasses import (
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    PrecisionPolicy,
    ProjectConfiguration,
)

_PARALLEL = "ROADMAP Queue 1 item 9 (parallel/)"
#: constructor argument -> where its port stands in the ROADMAP
_UNPORTED_ARGS = {
    "deepspeed_plugin": f"ZeRO sharding and offload: {_PARALLEL}",
    "fsdp_plugin": f"FSDP sharding and offload: {_PARALLEL}",
    "megatron_lm_plugin": f"tensor/pipeline/sequence parallelism: {_PARALLEL}",
    "mesh": f"device meshes: {_PARALLEL}",
    "rng_types": f"RNG synchronization across processes: {_PARALLEL}",
    "compilation_config": "remat and compile options: ROADMAP Queue 1 item 9 (remat)",
    "dynamo_backend": "torch.compile of the step: ROADMAP Queue 1 item 9 (remat)",
    "log_with": "trackers: ROADMAP Queue 1 item 10 (tracking.py)",
    "metrics_port": "the metrics endpoint: ROADMAP Queue 1 item 8 (telemetry/)",
}


def _is_tensor(t) -> bool:
    return isinstance(t, torch.Tensor)


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor leaf of a tree, in order."""
    leaves: List[torch.Tensor] = []
    ops.recursively_apply(leaves.append, tree, _is_tensor)
    return leaves


def _is_dataloader_like(obj) -> bool:
    if isinstance(obj, (DataLoaderShard, SimpleDataLoader)):
        return True
    return isinstance(obj, torch.utils.data.DataLoader)


class Accelerator:
    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        deepspeed_plugin=None,
        fsdp_plugin=None,
        megatron_lm_plugin=None,
        mesh=None,
        rng_types=None,
        log_with=None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        step_scheduler_with_optimizer: bool = True,
        kwargs_handlers: Optional[List[Any]] = None,
        compilation_config=None,
        dynamo_backend: Optional[str] = None,
        metrics_port: Optional[int] = None,
    ):
        given = dict(deepspeed_plugin=deepspeed_plugin, fsdp_plugin=fsdp_plugin,
                     megatron_lm_plugin=megatron_lm_plugin, mesh=mesh, rng_types=rng_types,
                     compilation_config=compilation_config, dynamo_backend=dynamo_backend,
                     log_with=log_with, metrics_port=metrics_port)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"Accelerator({name}=...) is not ported: {_UNPORTED_ARGS[name]}")
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.scaler_handler: Optional[GradScalerKwargs] = None
        for handler in kwargs_handlers or []:
            if not isinstance(handler, GradScalerKwargs):
                raise NotImplementedError(
                    f"kwargs handler {type(handler).__name__} is not ported (collective "
                    f"options and PowerSGD: {_PARALLEL}); only GradScalerKwargs is")
            self.scaler_handler = handler

        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        elif gradient_accumulation_steps != 1:
            raise ValueError("Pass either gradient_accumulation_steps or "
                             "gradient_accumulation_plugin, not both")

        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu,
                                      _from_accelerator=True)
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        if split_batches:
            self.dataloader_config.split_batches = True
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer

        self.trackers: List[Any] = []  # stays empty: log_with is not ported

        self.step = 0  # host micro-step counter (the GradientState mirror)
        self.flag_tensor: Optional[int] = None
        self._models: List[nn.Module] = []
        self._optimizers: List[AcceleratedOptimizer] = []
        self._schedulers: List[AcceleratedScheduler] = []
        self._dataloaders: List[DataLoaderShard] = []
        #: id(torch optimizer) -> the TrainState it is bound to
        self._states: Dict[int, TrainState] = {}
        self._custom_objects: List[Any] = []
        self._save_model_state_pre_hooks: Dict[Any, Callable] = {}
        self._load_model_state_pre_hooks: Dict[Any, Callable] = {}

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def distributed_type(self) -> str:
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def policy(self) -> PrecisionPolicy:
        return self.state.policy

    @property
    def _use_loss_scaling(self) -> bool:
        """fp16 dynamic loss scaling, honouring ``GradScalerKwargs(enabled=False)``."""
        return self.policy.use_loss_scaling and (
            self.scaler_handler.enabled if self.scaler_handler else True)

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int):
        self.gradient_state.plugin_kwargs.update({"num_steps": value})

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @property
    def use_seedable_sampler(self) -> bool:
        return self.dataloader_config.use_seedable_sampler

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    # ------------------------------------------------------------ process ctl
    def wait_for_everyone(self):
        self.state.partial_state.wait_for_everyone()

    def print(self, *args, **kwargs):
        self.state.partial_state.print(*args, **kwargs)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.partial_state.split_between_processes(inputs,
                                                                apply_padding=apply_padding)

    def on_main_process(self, function):
        return self.state.partial_state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.partial_state.on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.partial_state.on_process(function, process_index=process_index)

    def on_last_process(self, function):
        return self.state.partial_state.on_last_process(function)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.partial_state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.partial_state.local_main_process_first():
            yield

    # ----------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Wrap dataloaders, optimizers and schedules for this accelerator;
        return them in the same order (one object alone, else a tuple)."""
        result = [self._prepare_one(obj) for obj in args]
        return result[0] if len(result) == 1 else tuple(result)

    def _prepare_one(self, obj):
        if _is_dataloader_like(obj):
            prepared = self.prepare_data_loader(obj)
            self._dataloaders.append(prepared)
            return prepared
        if isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
            prepared = AcceleratedOptimizer(obj, _accelerator=self)
            self._optimizers.append(prepared)
            return prepared
        if isinstance(obj, TrainState):
            return obj
        if isinstance(obj, AcceleratedScheduler):
            self._schedulers.append(obj)
            return obj
        if isinstance(obj, nn.Module):
            self._models.append(obj)
            return obj
        if callable(obj):
            # a bare schedule: step -> learning rate
            sched = AcceleratedScheduler(
                obj, step_multiplier=self.num_processes if self.step_scheduler_with_optimizer else 1,
                split_batches=self.split_batches)
            self._schedulers.append(sched)
            return sched
        return obj

    def prepare_data_loader(self, data_loader, device_placement: Optional[bool] = None):
        cfg = self.dataloader_config
        return prepare_data_loader(
            data_loader, device=self.device, split_batches=cfg.split_batches,
            put_on_device=self.device_placement if device_placement is None else device_placement,
            dispatch_batches=cfg.dispatch_batches, even_batches=cfg.even_batches,
            use_seedable_sampler=cfg.use_seedable_sampler, non_blocking=cfg.non_blocking,
            prefetch_size=cfg.prefetch_size)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return _skip_first_batches(dataloader, num_batches=num_batches)

    # ------------------------------------------------------------ train state
    def create_train_state(self, *, params: nn.Module, tx: Callable) -> TrainState:
        """Cast the module's masters to the policy's ``param_dtype`` (in
        place), then bind ``tx(parameters) -> torch.optim.Optimizer`` to them.
        The optimizer is registered, wrapped, with this accelerator."""
        if not isinstance(params, nn.Module):
            raise TypeError(f"params must be the nn.Module holding the masters, got "
                            f"{type(params)}")
        params.to(dtype=self.policy.param_dtype)
        scaler = self.scaler_handler
        state = TrainState.create(
            model=params, tx=tx, use_loss_scaling=self._use_loss_scaling,
            init_loss_scale=scaler.init_scale if scaler else 2.0**16,
            loss_scale_kwargs=(dict(growth_factor=scaler.growth_factor,
                                    backoff_factor=scaler.backoff_factor,
                                    growth_interval=scaler.growth_interval)
                               if scaler else None),
        )
        self._states[id(state.optimizer)] = state
        self._optimizers.append(AcceleratedOptimizer(state.optimizer, _accelerator=self))
        if params not in self._models:
            self._models.append(params)
        return state

    def _compute_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """Name -> master cast to the compute dtype (differentiable)."""
        return self.policy.cast_to_compute(dict(model.named_parameters()))

    # ------------------------------------------------------------- train step
    def compile_train_step(self, loss_fn: Callable, *, has_aux: bool = False,
                           max_grad_norm: Optional[float] = None,
                           max_grad_value: Optional[float] = None) -> Callable:
        """Build ``step(state, batch) -> (state, metrics)`` for
        ``loss_fn(params, batch) -> loss`` (``(loss, aux)`` with ``has_aux``),
        where ``params`` maps parameter names to the compute-dtype weights.

        Gradient accumulation is built in: the optimizer applies on every
        ``gradient_accumulation_steps``-th call and on the dataloader's last
        batch (``GradientState.sync_with_dataloader``); other calls only add
        to the buffer.  ``grad_norm`` is the norm of the running average on
        every call; the clip factor is ``min(1, max_grad_norm / (norm + 1e-6))``."""
        accum = self.gradient_accumulation_steps
        fp16 = self._use_loss_scaling

        def step(state: TrainState, batch):
            gs = self.gradient_state
            force = bool((gs.sync_with_dataloader and gs.end_of_dataloader)
                         or gs.sync_each_batch)
            scale = state.loss_scale.scale if fp16 else 1.0
            out = loss_fn(self._compute_params(state.model), batch)
            loss, aux = out if has_aux else (out, None)
            loss = loss.float()
            (loss * scale if fp16 else loss).backward()

            count = state.micro_step + 1
            do_sync = force or count >= accum
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            # the buffer holds scale * (sum of the micro-steps' gradients)
            inv = 1.0 / (count * scale)
            gnorm = global_norm(grads) * inv
            applied = overflow = False
            if do_sync:
                factor = torch.full((), inv, dtype=torch.float32, device=gnorm.device)
                if max_grad_norm is not None:
                    factor = factor * torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, factor)
                if max_grad_value is not None:
                    for g in grads:
                        g.clamp_(-max_grad_value, max_grad_value)
                finite = bool(tree_finite(grads)) if fp16 else True
                applied, overflow = finite, not finite
                if applied:
                    for sched in self._schedulers:
                        sched.apply(state.optimizer, state.step)
                    state.apply_gradients()
                state.optimizer.zero_grad(set_to_none=True)
                state.micro_step = 0
                if fp16:
                    state.loss_scale = state.loss_scale.update(finite)
                for wrapper in self._optimizers:
                    if wrapper.optimizer is state.optimizer:
                        wrapper._step_was_skipped = overflow
            else:
                state.micro_step = count
            self.step = 0 if do_sync else self.step + 1
            gs._set_sync_gradients(do_sync)

            # flags as device fills: a host-to-device copy would wait for the stream
            flag = lambda value: torch.full((), value, dtype=torch.bool,  # noqa: E731
                                            device=loss.device)
            metrics = {
                "loss": loss.detach(),
                "grad_norm": gnorm.detach(),
                "applied": flag(applied),
                "overflow": flag(overflow),
            }
            if has_aux:
                metrics["aux"] = ops.recursively_apply(torch.Tensor.detach, aux,
                                                       lambda t: isinstance(t, torch.Tensor))
            return state, metrics

        return step

    def compile_eval_step(self, eval_fn: Callable) -> Callable:
        """Build ``eval_step(state_or_params, batch)``: ``eval_fn(params,
        batch)`` under ``torch.no_grad`` with the compute-dtype weights, its
        floating outputs cast to the policy's output dtype.  Takes a
        :class:`TrainState`, the model, or a name -> tensor dict."""

        def eval_step(state_or_params, batch):
            with torch.no_grad():
                if isinstance(state_or_params, TrainState):
                    params = self._compute_params(state_or_params.model)
                elif isinstance(state_or_params, nn.Module):
                    params = self._compute_params(state_or_params)
                else:
                    params = self.policy.cast_to_compute(state_or_params)
                return self.policy.cast_to_output(eval_fn(params, batch))

        return eval_step

    # ----------------------------------------------------- accumulation flags
    @contextlib.contextmanager
    def accumulate(self, *models):
        """Set ``sync_gradients`` for the next micro-step, as the JAX
        package's imperative mirror does."""
        self._do_sync()
        yield

    def _do_sync(self):
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            gs._set_sync_gradients((self.step % self.gradient_accumulation_steps) == 0)
        if gs.sync_each_batch:
            gs._set_sync_gradients(True)

    @contextlib.contextmanager
    def no_sync(self, model=None):
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)

    # ------------------------------------------------- the reference's loop
    def compute_gradients(self, loss_fn: Callable, state: TrainState, batch,
                          has_aux: bool = False):
        """Gradients of ``loss_fn(params, batch)`` (the loss
        ``compile_train_step`` takes, run under the same policy cast) with
        respect to the state's masters: ``(grads, {"loss", "aux"})``, where
        ``grads`` maps each parameter name to a fresh f32 tensor, divided
        by the fp16 loss scale.  The state, and its accumulation buffer,
        are left as they are."""
        named = list(state.model.named_parameters())
        scale = state.loss_scale.scale if state.loss_scale is not None else 1.0
        out = loss_fn(self._compute_params(state.model), batch)
        loss, aux = out if has_aux else (out, ())
        loss = loss.float()
        grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                    [p for _, p in named], allow_unused=True)
        result = {}
        for (name, p), g in zip(named, grads):
            g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
            result[name] = g.div_(scale) if scale != 1.0 else g
        aux = ops.recursively_apply(torch.Tensor.detach, aux, _is_tensor)
        return result, {"loss": loss.detach(), "aux": aux}

    def backward(self, *args, **kwargs):
        """Not supported, as in the JAX package: gradients are computed
        functionally (:meth:`compute_gradients`)."""
        raise RuntimeError(
            "accelerator.backward(loss) is not supported: gradients are computed "
            "functionally. Use `grads, m = accelerator.compute_gradients(loss_fn, state, batch)` "
            "then `state = accelerator.apply_gradients(state, grads)`, or the fused "
            "`accelerator.compile_train_step(loss_fn)`.")

    def apply_gradients(self, state: TrainState, grads: Dict[str, torch.Tensor],
                        max_grad_norm: Optional[float] = None) -> TrainState:
        """Add ``grads`` (name -> tensor, as :meth:`compute_gradients`
        returns them) into the accumulation buffer — the parameters'
        ``.grad`` — and, when ``sync_gradients`` is set (by
        :meth:`accumulate`), average the buffer over the window's
        ``micro_step + 1`` calls, clip it by global norm to
        ``max_grad_norm`` (factor ``min(1, max / (norm + 1e-6))``), apply
        the optimizer unless fp16 finds it non-finite, update the loss
        scale, clear the buffer and restart the window.  ``grads`` is not
        modified.  In place; returns ``state``."""
        params = dict(state.model.named_parameters())
        if grads.keys() != params.keys():
            raise ValueError(f"grads hold {sorted(set(grads) ^ set(params))[:5]} that the "
                             "state's parameters do not (or the other way round)")
        with torch.no_grad():
            for name, p in params.items():
                if p.grad is None:
                    p.grad = grads[name].to(p.dtype, copy=True)
                else:
                    p.grad.add_(grads[name])
        if not self.sync_gradients:
            state.micro_step += 1
            return state
        bufs = [p.grad for p in params.values()]
        torch._foreach_div_(bufs, float(state.micro_step + 1))
        if max_grad_norm is not None:
            clip = torch.clamp(max_grad_norm / (global_norm(bufs) + 1e-6), max=1.0)
            torch._foreach_mul_(bufs, clip)
        finite = bool(tree_finite(bufs)) if state.loss_scale is not None else True
        if finite:
            for sched in self._schedulers:
                sched.apply(state.optimizer, state.step)
            state.apply_gradients()
        state.optimizer.zero_grad(set_to_none=True)
        state.micro_step = 0
        if state.loss_scale is not None:
            state.loss_scale = state.loss_scale.update(finite)
        for wrapper in self._optimizers:
            if wrapper.optimizer is state.optimizer:
                wrapper._step_was_skipped = not finite
        return state

    def clip_grad_norm_(self, grads, max_norm: float, norm_type: float = 2.0):
        """``(grads scaled by min(1, max_norm / (norm + 1e-6)), norm)`` for
        the global L2 norm of a tree of gradients; ``grads`` is not
        modified."""
        if norm_type != 2.0:
            raise NotImplementedError("Only L2 global-norm clipping is supported")
        norm = global_norm(_tensors(grads))
        factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return ops.recursively_apply(lambda g: g * factor, grads, _is_tensor), norm

    def clip_grad_value_(self, grads, clip_value: float):
        """Every gradient clamped to ``[-clip_value, clip_value]`` (new tensors)."""
        return ops.recursively_apply(lambda g: g.clamp(-clip_value, clip_value), grads,
                                     _is_tensor)

    # ------------------------------------------------------------ collectives
    def gather(self, tensor):
        return ops.gather(tensor)

    def gather_for_metrics(self, input_data):
        """Gather over processes and drop the end-of-epoch remainder padding
        (with one process the gather is the identity)."""
        data = ops.gather(input_data)
        gs = self.gradient_state
        if gs.end_of_dataloader and gs.remainder > 0:
            data = ops.recursively_apply(lambda t: t[: gs.remainder], data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                        pad_first=pad_first)

    # ------------------------------------------------------------- utilities
    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A no-op scope: the precision policy is applied inside the step."""
        yield

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """A no-op scope: one process has no uneven inputs to join."""
        yield

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """The module itself: the port wraps nothing."""
        return model

    def free_memory(self, *objects):
        """Drop every registered model, optimizer, schedule, dataloader and
        train state, collect garbage and return the card's cached blocks."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._states.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects):
        return self.free_memory(*objects)

    def set_trigger(self):
        """Flag this process for :meth:`check_trigger`."""
        self.flag_tensor = 1

    def check_trigger(self) -> bool:
        """True (once) if any process called :meth:`set_trigger`."""
        triggered = any(bool(f) for f in ops.gather_object([self.flag_tensor or 0]))
        if triggered:
            self.flag_tensor = 0
        return triggered

    def get_state_dict(self, state_or_params, unwrap: bool = True) -> Dict[str, torch.Tensor]:
        """A host copy of the weights of a :class:`TrainState`, a module or a
        name -> tensor dict, by the port's state-dict names."""
        return checkpointing.host_state_dict(state_or_params)

    def register_for_checkpointing(self, *objects):
        """Objects with ``state_dict``/``load_state_dict`` that
        :meth:`save_state`/:meth:`load_state` carry along."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(
                f"All objects must have state_dict/load_state_dict methods; got {invalid}")
        self._custom_objects.extend(objects)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return _skip_first_batches(dataloader, num_batches=num_batches)

    # ------------------------------------------------------------ checkpoints
    def save_state(self, output_dir: Optional[str] = None, state: Optional[TrainState] = None,
                   **save_kwargs) -> str:
        return checkpointing.save_accelerator_state(self, output_dir, state, **save_kwargs)

    def load_state(self, input_dir: Optional[str] = None, state: Optional[TrainState] = None,
                   **load_kwargs) -> Optional[TrainState]:
        return checkpointing.load_accelerator_state(self, input_dir, state, **load_kwargs)

    def save_model(self, state_or_params, save_directory: str,
                   max_shard_size: Union[int, str] = "10GB", safe_serialization: bool = True,
                   save_dtype: Optional[torch.dtype] = None) -> List[str]:
        return checkpointing.save_model(
            self, state_or_params, save_directory, max_shard_size=max_shard_size,
            safe_serialization=safe_serialization, save_dtype=save_dtype)

    def register_save_state_pre_hook(self, hook: Callable):
        """``hook(models, weights, output_dir)`` runs before each save."""
        handle = object()
        self._save_model_state_pre_hooks[handle] = hook
        return handle

    def register_load_state_pre_hook(self, hook: Callable):
        """``hook(models, input_dir)`` runs before each load."""
        handle = object()
        self._load_model_state_pre_hooks[handle] = hook
        return handle

    def end_training(self):
        for tracker in self.trackers:
            tracker.finish()

    # ---------------------------------------------------------------- profile
    @contextlib.contextmanager
    def profile(self, log_dir: Optional[str] = None):
        """Capture a ``torch.profiler`` trace of the block (host activity,
        and the card's on ``cuda``) and write it as a Chrome trace under
        ``log_dir`` (default ``<project_dir or .>/profile``); yields the
        profiler."""
        log_dir = log_dir or os.path.join(self.project_dir or ".", "profile")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"worker{self.process_index}.{time.time_ns()}.pt.trace.json"))
