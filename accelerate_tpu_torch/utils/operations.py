"""Tree helpers and collectives across processes.

Port of :mod:`accelerate_tpu.utils.operations`.  A "tree" is a tensor,
numpy array, number, or a dict / list / tuple (namedtuples too) of them.
The collectives run over the process group (``torch.distributed``): a
per-rank ``[b, ...]`` tensor gathers to ``[world * b, ...]`` on every rank,
as in the reference; a DTensor gives its full value.  With one process
each is the identity or a scale.  Tensors come back on their own device
(the JAX package returns numpy).

Under ``ACCELERATE_DEBUG_MODE`` the tensor collectives first compare their
inputs' shapes across processes (:func:`verify_operation`) and raise
:class:`DistributedOperationException` on every rank when they differ,
instead of deadlocking in the collective.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


def PartialState():
    """Lazy accessor (the state module imports this one)."""
    from ..state import PartialState as _PartialState

    return _PartialState()


def process_topology():
    """``(num_processes, process_index)``: the state's, else the process
    group's, else one process (making no state: that would claim the card)."""
    from ..state import PartialState as _PartialState

    if _PartialState._shared_state.get("_initialized"):
        state = _PartialState()
        return state.num_processes, state.process_index
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _num_processes() -> int:
    return process_topology()[0]


class DistributedOperationException(Exception):
    """A collective's inputs differ in shape across processes
    (``accelerate_tpu/utils/operations.py:50``)."""


def is_tensor(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def honor_type(obj, generator):
    """``obj``'s container type rebuilt from ``generator`` (namedtuples too)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def recursively_apply(func: Callable, data, *args, test_type: Callable = is_tensor,
                      error_on_other_type: bool = False, **kwargs):
    """Apply ``func`` to every leaf of ``data`` that passes ``test_type``
    (list/tuple/namedtuple/dict, order kept); other leaves stay as they
    are unless ``error_on_other_type``."""
    if isinstance(data, (tuple, list)):
        return honor_type(data, (recursively_apply(func, o, *args, test_type=test_type,
                                                   error_on_other_type=error_on_other_type,
                                                   **kwargs) for o in data))
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type,
                                                **kwargs) for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to "
                        f"{getattr(func, '__name__', func)}: only nested list/tuple/dict of "
                        "tensors are supported.")
    return data


def send_to_device(tensor, device=None, non_blocking: bool = False, skip_keys=None):
    """Move every array leaf of a tree onto ``device`` as a torch tensor
    (numpy arrays through :func:`torch.from_numpy`, no copy on the host)."""
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]

    def _send(t):
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        return t.to(device, non_blocking=non_blocking) if device is not None else t

    if isinstance(tensor, Mapping) and skip_keys:
        return type(tensor)(
            (k, v if k in skip_keys else send_to_device(v, device, non_blocking))
            for k, v in tensor.items())
    return recursively_apply(_send, tensor)


# ------------------------------------------------------------------ inspection
def _leaves(data) -> List[Any]:
    out: List[Any] = []
    recursively_apply(out.append, data)
    return out


def find_device(data) -> Optional[torch.device]:
    """The device of the first tensor leaf (``None`` if there is none)."""
    for leaf in _leaves(data):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def find_batch_size(data) -> int:
    """Dim 0 of the first tensor leaf with a dim."""
    for leaf in _leaves(data):
        if getattr(leaf, "ndim", 0) >= 1:
            return int(leaf.shape[0])
    raise ValueError("Cannot find the batch size from empty data.")


def ignorant_find_batch_size(data) -> Optional[int]:
    try:
        return find_batch_size(data)
    except (ValueError, TypeError):
        return None


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def listify(data):
    """Tensor leaves as nested Python lists."""
    return recursively_apply(lambda t: _to_numpy(t).tolist(), data)


def slice_tensors(data, tensor_slice, process_index=None, num_processes=None):
    """Every tensor leaf sliced by ``tensor_slice``."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def concatenate(data, dim: int = 0):
    """A list of same-structured trees, concatenated leaf by leaf."""
    first = data[0]
    if isinstance(first, (tuple, list)):
        return honor_type(first, (concatenate([d[i] for d in data], dim=dim)
                                  for i in range(len(first))))
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first})
    if not is_tensor(first):
        raise TypeError(f"Can only concatenate tensors but got {type(first)}")
    if isinstance(first, np.ndarray):
        return np.concatenate([_to_numpy(d) for d in data], axis=dim)
    return torch.cat(list(data), dim=dim)


# ---------------------------------------------------------------- debug checks
def _shape_signature(data):
    return [list(leaf.shape) for leaf in _leaves(data) if hasattr(leaf, "shape")]


def verify_operation(function):
    """With ``ACCELERATE_DEBUG_MODE`` set, gather the tensor argument's leaf
    shapes from every process first, and raise
    :class:`DistributedOperationException` on every rank when they differ."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        if _num_processes() == 1 or not PartialState().debug:
            return function(*args, **kwargs)
        operation = f"{function.__module__}.{function.__name__}"
        tensor = kwargs.get("tensor", args[0] if args else None)
        all_shapes = gather_object([_shape_signature(tensor)])
        if not all(s == all_shapes[0] for s in all_shapes):
            raise DistributedOperationException(
                "Cannot apply desired operation due to shape mismatches. All shapes across "
                f"devices must be valid.\n\nOperation: `{operation}`\nInput shapes:\n"
                + "\n".join(f"  - Process {i}: {s}" for i, s in enumerate(all_shapes)))
        return function(*args, **kwargs)

    return wrapper


def chained_operation(function):
    """Re-raise a :class:`DistributedOperationException` naming the outer
    operation."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        try:
            return function(*args, **kwargs)
        except DistributedOperationException as e:
            operation = f"{function.__module__}.{function.__name__}"
            raise DistributedOperationException(
                f"Error found while calling `{operation}`. Please see the earlier error for "
                "more details.") from e

    return wrapper


# ----------------------------------------------------------------- collectives
def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(x)
    full = getattr(x, "full_tensor", None)
    return full() if full is not None else x


def _gather_one(x):
    """Every rank's ``[b, ...]`` concatenated on dim 0 (a 0-d tensor as a
    ``[world]`` vector); a DTensor's full value; a numpy leaf stays numpy."""
    was_numpy = isinstance(x, np.ndarray)
    t = _as_tensor(x).detach()
    if _num_processes() > 1:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        t = torch.cat([p.reshape(-1, *t.shape[1:]) if t.ndim else p.reshape(1)
                       for p in parts])
    return t.cpu().numpy() if was_numpy else t


@verify_operation
def gather(tensor):
    """Every tensor leaf gathered from all processes: per-rank ``[b, ...]``
    becomes ``[world * b, ...]`` on every rank."""
    return recursively_apply(_gather_one, tensor)


def gather_object(object: Any) -> List[Any]:
    """A picklable object from each process, in a list (a list's items are
    spliced in)."""
    n = _num_processes()
    if n == 1:
        return list(object) if isinstance(object, list) else [object]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, object)
    if isinstance(object, list):
        return [item for part in out for item in part]
    return out


def _broadcast_one(x, from_process: int = 0):
    was_numpy = isinstance(x, np.ndarray)
    t = _as_tensor(x)
    if _num_processes() > 1:
        t = t.contiguous().clone()
        dist.broadcast(t, src=from_process)
    return t.cpu().numpy() if was_numpy else t


@verify_operation
def broadcast(tensor, from_process: int = 0):
    """Every tensor leaf as ``from_process`` holds it, on every process."""
    return recursively_apply(functools.partial(_broadcast_one, from_process=from_process),
                             tensor)


def broadcast_object_list(object_list: List[Any], from_process: int = 0) -> List[Any]:
    """``from_process``'s picklable objects, written into ``object_list`` in
    place on every process; returns it."""
    if _num_processes() > 1:
        dist.broadcast_object_list(object_list, src=from_process)
    return object_list


def _num_shards_of(x) -> int:
    """How many data-axis shards a DTensor's dim 0 has (1 for anything else):
    ``reduce`` folds them, as the reference folds a sharded global array."""
    spec = getattr(x, "placements", None)
    mesh = getattr(x, "device_mesh", None)
    if spec is None or mesh is None:
        return 1
    from ..parallel.mesh import DATA_AXES

    names = mesh.mesh_dim_names or ()
    return math.prod(mesh.size(i) for i, p in enumerate(spec)
                     if getattr(p, "dim", None) == 0 and i < len(names)
                     and names[i] in DATA_AXES) or 1


@verify_operation
def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """Sum or mean every tensor leaf across processes, times ``scale``; a
    DTensor split on dim 0 over the data axes folds its shards instead
    (``[n * b, ...] -> [b, ...]``), as the reference folds a sharded array."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")

    def _reduce_one(x):
        was_numpy = isinstance(x, np.ndarray)
        n = _num_shards_of(x)
        if n > 1:
            full = _as_tensor(x)
            if full.ndim and full.shape[0] % n == 0:
                out = full.reshape(n, full.shape[0] // n, *full.shape[1:]).sum(0) * scale
                return out / n if reduction == "mean" else out
            return full * scale
        t = _as_tensor(x)
        world = _num_processes()
        if world > 1:
            t = t.detach().clone()
            dist.all_reduce(t)
        t = t * scale
        if reduction == "mean" and world > 1:
            t = t / world
        return t.cpu().numpy() if was_numpy else t

    return recursively_apply(_reduce_one, tensor)


@chained_operation
@verify_operation
def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Pad every tensor leaf along ``dim`` to the largest size any process
    holds there, with ``pad_index`` (at the front with ``pad_first``)."""

    def _pad_one(x):
        if x.ndim == 0 or dim >= x.ndim:
            return x
        sizes = gather_object([int(x.shape[dim])])
        max_size = max(sizes)
        if max_size == x.shape[dim]:
            return x
        n_pad = max_size - x.shape[dim]
        if isinstance(x, np.ndarray):
            width = [(0, 0)] * x.ndim
            width[dim] = (n_pad, 0) if pad_first else (0, n_pad)
            return np.pad(x, width, constant_values=pad_index)
        shape = list(x.shape)
        shape[dim] = n_pad
        filler = x.new_full(shape, pad_index)
        return torch.cat([filler, x] if pad_first else [x, filler], dim=dim)

    return recursively_apply(_pad_one, tensor)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Pad ``dim`` with copies of its last entry until ``num_processes``
    divides it."""

    def _pad_one(x):
        remainder = x.shape[dim] % num_processes
        if remainder == 0:
            return x
        n_pad = num_processes - remainder
        last = x.narrow(dim, x.shape[dim] - 1, 1) if isinstance(x, torch.Tensor) else \
            np.take(x, [x.shape[dim] - 1], axis=dim)
        if isinstance(x, np.ndarray):
            return np.concatenate([x] + [last] * n_pad, axis=dim)
        return torch.cat([x] + [last] * n_pad, dim=dim)

    return recursively_apply(_pad_one, tensor)


# --------------------------------------------------------------- dtype casting
def convert_to_fp32(tensor):
    """float16 / bfloat16 leaves upcast to float32."""

    def _is_half(t):
        return isinstance(t, torch.Tensor) and t.dtype in (torch.float16, torch.bfloat16) or (
            isinstance(t, np.ndarray) and t.dtype == np.float16)

    def _convert(t):
        return t.float() if isinstance(t, torch.Tensor) else t.astype(np.float32)

    return recursively_apply(_convert, tensor, test_type=_is_half)


class ConvertOutputsToFp32:
    """A function whose outputs come back in f32 (a class, so it pickles)."""

    def __init__(self, model_forward):
        self.model_forward = model_forward
        functools.update_wrapper(self, model_forward)

    def __call__(self, *args, **kwargs):
        return convert_to_fp32(self.model_forward(*args, **kwargs))


def convert_outputs_to_fp32(model_forward):
    return ConvertOutputsToFp32(model_forward)
