"""Process, device and gradient-sync state: the Borg singletons of the training path.

Port of :mod:`accelerate_tpu.state` for one process on one device:
:class:`PartialState` (the device — the card unless ``cpu=True``),
:class:`AcceleratorState` (adds the precision policy) and
:class:`GradientState` (gradient-accumulation sync flags and the active
dataloader's ``end_of_dataloader`` / ``remainder``).  Every instance of a
class shares one ``__dict__``; ``_reset_state`` clears it, as in the JAX
package.  Several processes (``torch.distributed``) are ROADMAP Queue 1
item 9 (``parallel/``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .utils.dataclasses import GradientAccumulationPlugin, PrecisionPolicy


class PartialState:
    """The device and the (single) process.  ``cpu=True`` runs on the host;
    otherwise the card, and no visible card raises."""

    _shared_state: Dict[str, Any] = {}
    _lock = threading.Lock()

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        with PartialState._lock:
            if self.initialized:
                return
            if kwargs:
                raise NotImplementedError(
                    f"PartialState({', '.join(kwargs)}): process-group options are not "
                    "ported: ROADMAP Queue 1 item 9 (parallel/)")
            self.device = resolve_device("cpu" if cpu else None)
            self.num_processes = 1
            self.process_index = 0
            self.local_process_index = 0
            self.num_devices = 1
            self.distributed_type = "NO"
            self._shared_state["_initialized"] = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @property
    def use_distributed(self) -> bool:
        return False

    @property
    def is_main_process(self) -> bool:
        return True

    @property
    def is_local_main_process(self) -> bool:
        return True

    @property
    def is_last_process(self) -> bool:
        return True

    def wait_for_everyone(self):
        """Barrier across processes; with one process, a no-op."""

    def print(self, *args, **kwargs):
        if self.is_local_main_process:
            print(*args, **kwargs)

    def _goes_first(self, is_main: bool):
        if not is_main:
            self.wait_for_everyone()
        yield
        if is_main:
            self.wait_for_everyone()

    @contextlib.contextmanager
    def main_process_first(self):
        """The main process runs the block before the others."""
        yield from self._goes_first(self.is_main_process)

    @contextlib.contextmanager
    def local_main_process_first(self):
        yield from self._goes_first(self.is_local_main_process)

    @contextlib.contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's share of a list, tuple, array, tensor or dict of
        them (equal lengths), in contiguous slices, the first
        ``len % num_processes`` one longer.  ``apply_padding`` pads a short
        share to the longest by repeating the input's last element."""
        if self.num_processes == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            lengths = {len(v) for v in inputs.values()}
            if len(lengths) != 1:
                raise ValueError("All values in a dict passed to split_between_processes "
                                 "must have equal length")
            length = lengths.pop()
        else:
            length = len(inputs)
        sizes = [length // self.num_processes] * self.num_processes
        for i in range(length % self.num_processes):
            sizes[i] += 1
        start = sum(sizes[: self.process_index])
        end = start + sizes[self.process_index]

        def _slice(obj):
            chunk = obj[start:end]
            pad = sizes[0] - len(chunk)
            if not apply_padding or pad <= 0:
                return chunk
            # the input's last element, so that an empty share pads too
            if isinstance(chunk, torch.Tensor):
                return torch.cat([chunk] + [obj[-1:]] * pad)
            if isinstance(chunk, np.ndarray):
                return np.concatenate([chunk] + [obj[-1:]] * pad)
            return list(chunk) + [obj[-1]] * pad

        if isinstance(inputs, dict):
            yield {k: _slice(v) for k, v in inputs.items()}
        else:
            yield _slice(inputs)

    def _run_if(self, flag: Callable[[], bool], function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            if flag():
                return function(*args, **kwargs)

        return wrapper

    def on_main_process(self, function: Callable) -> Callable:
        """Decorator: run ``function`` on the main process only."""
        return self._run_if(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self._run_if(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable) -> Callable:
        return self._run_if(lambda: self.is_last_process, function)

    def on_process(self, function: Optional[Callable] = None,
                   process_index: Optional[int] = None) -> Callable:
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return self._run_if(lambda: self.process_index == process_index, function)

    def __repr__(self):
        return (f"Distributed environment: {self.distributed_type}\n"
                f"Num processes: {self.num_processes}\n"
                f"Process index: {self.process_index}\n"
                f"Device: {self.device}\n")

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()


class AcceleratorState:
    """:class:`PartialState` plus the mixed-precision policy."""

    _shared_state: Dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False,
                 _from_accelerator: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            if mixed_precision is not None and mixed_precision != self._mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with "
                    f"mixed_precision={self._mixed_precision!r}; create the Accelerator "
                    "once or call AcceleratorState._reset_state() first.")
            return
        policy = PrecisionPolicy.from_mixed_precision(mixed_precision)
        self.partial_state = PartialState(cpu=cpu, **kwargs)
        self._mixed_precision = str(mixed_precision or "no").lower()
        self.policy = policy
        self.distributed_type = self.partial_state.distributed_type
        self._shared_state["_initialized"] = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    def __getattr__(self, name):
        # topology attributes come from PartialState, as in the JAX package
        if name in ("_shared_state", "partial_state") or name.startswith("__"):
            raise AttributeError(name)
        ps = self.__dict__.get("partial_state")
        if ps is not None and hasattr(ps, name):
            return getattr(ps, name)
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    def __repr__(self):
        return repr(self.partial_state) + f"Mixed precision type: {self.mixed_precision}\n"

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False):
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation sync across the loop: ``sync_gradients``, the
    active dataloader and its ``end_of_dataloader`` / ``remainder``."""

    _shared_state: Dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references: List[Any] = [None]
            self.plugin_kwargs = (gradient_accumulation_plugin.to_dict()
                                  if gradient_accumulation_plugin is not None else {})
            self._shared_state["_initialized"] = True
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_dict()

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps") or 1

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", False)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader):
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader):
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    def __repr__(self):
        return (f"Sync gradients: {self.sync_gradients}\n"
                f"At end of current dataloader: {self.end_of_dataloader}\n"
                f"Extra samples added: {self.remainder}\n")

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()
