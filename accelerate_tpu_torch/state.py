"""Process, device and gradient-sync state: the Borg singletons of the training path.

Port of :mod:`accelerate_tpu.state`: :class:`PartialState` (the process
group and this process's device — the card unless ``cpu=True``),
:class:`AcceleratorState` (adds the precision policy and the plugins) and
:class:`GradientState` (gradient-accumulation sync flags and the active
dataloader's ``end_of_dataloader`` / ``remainder``).  Every instance of a
class shares one ``__dict__``; ``_reset_state`` clears it, as in the JAX
package.

Processes: the JAX package drives every local device from one process
and joins hosts through ``jax.distributed``; here each process owns one
device, PyTorch's model.  The rendezvous reads the reference's environment
(``accelerate_tpu/state.py:74-125``)::

    ACCELERATE_COORDINATOR_ADDRESS=host:port  ACCELERATE_NUM_PROCESSES=N
    ACCELERATE_PROCESS_ID=rank                ACCELERATE_LOCAL_PROCESS_ID=i

and with it calls ``torch.distributed.init_process_group`` (``nccl`` on
the card, ``gloo`` under ``cpu=True``; ``InitProcessGroupKwargs``'
``backend``, ``init_method`` and ``timeout`` pass through as
``PartialState`` keyword arguments).  ``num_processes`` and
``process_index`` are then the group's, and the device is
``cuda:{local_process_index}``.  A group initialized before (``torchrun``)
is taken as it is; the local index is then torchrun's ``LOCAL_RANK`` where
the reference's variable is unset, else the rank modulo the node's cards.
``distributed_type`` is the reference's for the same topology: ``NO`` for
one process, ``MULTI_CPU`` for several on the host; several on cards are
``MULTI_GPU`` (the JAX package's ``TPU``/``MULTI_TPU`` count chips, which
have no process each).
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ._device import resolve_device
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MeshConfig,
    PrecisionPolicy,
    parse_flag_from_env,
)

# the reference's rendezvous environment (accelerate_tpu/state.py:43-47)
ENV_COORDINATOR = "ACCELERATE_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "ACCELERATE_NUM_PROCESSES"
ENV_PROCESS_ID = "ACCELERATE_PROCESS_ID"
ENV_LOCAL_PROCESS_ID = "ACCELERATE_LOCAL_PROCESS_ID"


def _local_index(rank: int, cpu: bool) -> int:
    """This process's index on its node: ``ACCELERATE_LOCAL_PROCESS_ID``,
    else ``LOCAL_RANK`` (torchrun's), else ``rank`` modulo the node's cards
    (``rank`` itself on the host)."""
    for key in (ENV_LOCAL_PROCESS_ID, "LOCAL_RANK"):
        if os.environ.get(key):
            return int(os.environ[key])
    cards = 0 if cpu or not torch.cuda.is_available() else torch.cuda.device_count()
    return rank % cards if cards else rank


def is_initialized() -> bool:
    return PartialState._shared_state != {}


class PartialState:
    """The process group and this process's device.  ``cpu=True`` runs on
    the host; otherwise the card, and no visible card raises.  Keyword
    arguments: ``backend``, ``init_method``, ``timeout`` (a ``timedelta`` or
    seconds) for the rendezvous."""

    _shared_state: Dict[str, Any] = {}
    _lock = threading.Lock()

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        with PartialState._lock:
            if self.initialized:
                return
            self._initialize(cpu=cpu, **kwargs)

    def _initialize(self, cpu: bool = False, backend: Optional[str] = None,
                    init_method: Optional[str] = None, timeout=None):
        from .utils.environment import override_numa_affinity

        self.debug = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        cpu = cpu or parse_flag_from_env("ACCELERATE_USE_CPU")
        rank = int(os.environ.get(ENV_PROCESS_ID) or os.environ.get("RANK") or 0)
        override_numa_affinity(_local_index(rank, cpu))
        coordinator = os.environ.get(ENV_COORDINATOR)
        want = int(os.environ.get(ENV_NUM_PROCESSES, "0") or 0)
        if backend in (None, "jax"):
            backend = "gloo" if cpu else "nccl"
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: use 'gloo', 'nccl' or None (the default)")
        if (dist.is_available() and not dist.is_initialized()
                and (coordinator or init_method) and want >= 1):
            if not cpu:
                resolve_device(None)  # no card raises before the rendezvous
                torch.cuda.set_device(_local_index(rank, cpu))
            if timeout is not None and not isinstance(timeout, datetime.timedelta):
                timeout = datetime.timedelta(seconds=float(timeout))
            kw = {"timeout": timeout} if timeout is not None else {}
            dist.init_process_group(backend=backend,
                                    init_method=init_method or f"tcp://{coordinator}",
                                    world_size=want, rank=rank, **kw)
        grouped = dist.is_available() and dist.is_initialized()
        self.num_processes = dist.get_world_size() if grouped else 1
        self.process_index = dist.get_rank() if grouped else 0
        self.local_process_index = _local_index(self.process_index, cpu)
        self.backend = dist.get_backend() if grouped else None
        if cpu:
            self.device = torch.device("cpu")
        elif grouped:
            resolve_device(None)
            self.device = torch.device("cuda", self.local_process_index)
        else:
            self.device = resolve_device(None)
        self.num_devices = self.num_processes
        if self.num_processes == 1:
            self.distributed_type = DistributedType.NO
        else:
            self.distributed_type = (DistributedType.MULTI_CPU if self.device.type == "cpu"
                                     else DistributedType.MULTI_GPU)
        self.fork_launched = parse_flag_from_env("FORK_LAUNCHED", False)
        self._mesh = None
        self._shared_state["_initialized"] = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    # ------------------------------------------------------------------ mesh
    @property
    def mesh(self):
        """The active :class:`~accelerate_tpu_torch.parallel.mesh.Mesh`;
        every process on a ``dp`` axis until one is set."""
        if self._mesh is None:
            from .parallel import mesh as mesh_lib

            self._mesh = mesh_lib.build_mesh()
        return self._mesh

    def set_mesh(self, mesh_or_config):
        """Set the mesh from a :class:`~accelerate_tpu_torch.parallel.mesh.
        Mesh`, a :class:`MeshConfig` or an axes dict (built over every
        process; all of them must call this together)."""
        from .parallel import mesh as mesh_lib

        if isinstance(mesh_or_config, mesh_lib.Mesh):
            self._mesh = mesh_or_config
        elif isinstance(mesh_or_config, MeshConfig):
            self._mesh = mesh_lib.build_mesh(
                mesh_or_config.axes, dcn_axes=mesh_or_config.dcn_axes or None,
                allow_split_physical_axes=mesh_or_config.allow_split_physical_axes)
        elif isinstance(mesh_or_config, dict):
            self._mesh = mesh_lib.build_mesh(mesh_or_config)
        else:
            raise TypeError(f"Cannot build a mesh from {type(mesh_or_config)}")
        return self._mesh

    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self):
        """Barrier across processes (``torch.distributed.barrier``); with
        one process, a no-op."""
        if self.num_processes > 1:
            dist.barrier()

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
                f"Local process index: {self.local_process_index}\n"
                f"Num devices: {self.num_devices}\n"
                f"Device: {self.device}\n")

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()

    def destroy_process_group(self):
        """Leave the process group (if one was joined) and reset the state."""
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        self._reset_state()


class AcceleratorState:
    """:class:`PartialState` plus the mixed-precision policy and the
    plugins, with the JAX package's promotion of ``distributed_type``
    (``accelerate_tpu/state.py:338-350``): ``ZERO`` with a ZeRO plugin,
    else ``FSDP`` with an FSDP plugin, else ``MODEL_PARALLEL`` with a
    model-parallel one."""

    _shared_state: Dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False,
                 fsdp_plugin=None, zero_plugin=None, model_parallel_plugin=None,
                 mesh_config: Optional[MeshConfig] = None,
                 _from_accelerator: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            if mixed_precision is not None and mixed_precision != self._mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with "
                    f"mixed_precision={self._mixed_precision!r}; create the Accelerator "
                    "once or call AcceleratorState._reset_state() first.")
            return
        if mixed_precision is None:
            mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION") or None
        policy = PrecisionPolicy.from_mixed_precision(mixed_precision)
        self.partial_state = PartialState(cpu=cpu, **kwargs)
        self._mixed_precision = str(mixed_precision or "no").lower()
        self.policy = policy
        self.fsdp_plugin = fsdp_plugin
        self.zero_plugin = zero_plugin
        self.model_parallel_plugin = model_parallel_plugin
        if zero_plugin is not None or parse_flag_from_env("ACCELERATE_USE_DEEPSPEED"):
            self.distributed_type = DistributedType.ZERO
        elif fsdp_plugin is not None or parse_flag_from_env("ACCELERATE_USE_FSDP"):
            self.distributed_type = DistributedType.FSDP
        elif (model_parallel_plugin is not None
              or parse_flag_from_env("ACCELERATE_USE_MEGATRON_LM")):
            self.distributed_type = DistributedType.MODEL_PARALLEL
        else:
            self.distributed_type = self.partial_state.distributed_type
        if mesh_config is not None:
            self.partial_state.set_mesh(mesh_config)
        self._shared_state["_initialized"] = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    @property
    def mesh(self):
        return self.partial_state.mesh

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
