"""Tree helpers of the training path: device placement and single-process gathers.

Port of the parts of :mod:`accelerate_tpu.utils.operations` the train step,
the data loader and the ``Accelerator``'s collectives use.  A "tree" is a
tensor, numpy array, number, or a dict / list / tuple of them.  With one
process every collective is the identity or a scale; each returns its
tensors on their own device (the JAX package returns numpy).
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping

import numpy as np
import torch


def is_tensor(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def recursively_apply(fn: Callable, data, test_type: Callable = is_tensor):
    """Apply ``fn`` to every leaf of ``data`` that passes ``test_type``."""
    if isinstance(data, Mapping):
        return type(data)((k, recursively_apply(fn, v, test_type)) for k, v in data.items())
    if isinstance(data, (list, tuple)):
        return type(data)(recursively_apply(fn, v, test_type) for v in data)
    return fn(data) if test_type(data) else data


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
            for k, v in tensor.items()
        )
    return recursively_apply(_send, tensor)


def gather(tensor: Any):
    """Concatenate a tree over processes; with one process, the tree itself."""
    return tensor


def gather_object(object: Any) -> List[Any]:
    """A picklable object from each process, in a list (a list's items
    are spliced in)."""
    return list(object) if isinstance(object, list) else [object]


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """Sum or mean every array leaf across processes, times ``scale``; with
    one process both are the leaf times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    return recursively_apply(lambda t: t * scale, tensor)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Pad every array leaf along ``dim`` to the largest size any process
    holds there; with one process each leaf is that size already."""
    return tensor
