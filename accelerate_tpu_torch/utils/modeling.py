"""Model-size math and device-map inference for big-model inference.

Port of :mod:`accelerate_tpu.utils.modeling`.  A "module" is a key prefix of
the port's flat state dicts (``"layers.3.attn.q_proj.weight"``): the
top-level modules are ``embed_tokens``, ``pos_embed``, ``embed_norm``,
``layers.{i}``, ``final_norm`` and ``lm_head`` (where the reference's Flax
tree has ``layers_{i}``).  Sizes come from anything with a shape and a dtype
(real or ``meta`` tensors, numpy arrays) or from a bare shape tuple, so no
weight bytes are needed.  Nested dicts are flattened with ``.`` first, as
in the reference.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

PathTree = Any
DeviceId = Union[int, str]  # device index | "cpu" | "disk"

SEP = "."  # the state-dict / safetensors key separator


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype, device="meta").element_size()
    return int(np.dtype(dtype).itemsize)


def _leaf_nbytes(leaf, dtype=None) -> int:
    shape = leaf if isinstance(leaf, tuple) else getattr(leaf, "shape", None)
    if shape is None:
        return 0
    if dtype is None:
        dtype = getattr(leaf, "dtype", torch.float32)
    return int(math.prod(shape)) * _itemsize(dtype)


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"layers.0.attn.q_proj.weight": leaf}``: a nested dict to flat
    ``.``-joined paths (a flat state dict comes back as it is)."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            path = f"{prefix}{SEP}{key}" if prefix else str(key)
            flat.update(flatten_tree(value, path))
    else:
        flat[prefix] = tree
    return flat


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(SEP)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def module_of(path: str) -> str:
    """The top-level module a flat key belongs to: its first part, with the
    index of a module list (``layers.3``)."""
    parts = path.split(SEP)
    if len(parts) > 2 and parts[1].isdigit():
        return SEP.join(parts[:2])
    return parts[0]


def compute_module_sizes(tree: PathTree, dtype=None) -> Dict[str, int]:
    """Size in bytes of every path prefix, ``""`` being the whole model
    (``accelerate_tpu/utils/modeling.py:63``).  ``dtype`` overrides every
    leaf's."""
    sizes: Dict[str, int] = defaultdict(int)
    for path, leaf in flatten_tree(tree).items():
        nbytes = _leaf_nbytes(leaf, dtype)
        sizes[""] += nbytes
        parts = path.split(SEP)
        for i in range(1, len(parts) + 1):
            sizes[SEP.join(parts[:i])] += nbytes
    return dict(sizes)


def get_max_layer_size(tree: PathTree, dtype=None) -> Tuple[int, List[str]]:
    """The largest top-level module and its names: the most that must fit on
    one device at once while streaming (``:76``)."""
    sizes = compute_module_sizes(tree, dtype)
    best, names = 0, []
    for mod in top_level_modules(tree):
        s = sizes.get(mod, 0)
        if s > best:
            best, names = s, [mod]
        elif s == best:
            names.append(mod)
    return best, names


def _natkey(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def top_level_modules(tree: PathTree) -> List[str]:
    """The top-level modules, natural-sorted so that ``layers.2`` comes before
    ``layers.10`` (greedy packing follows execution order; ``:92``)."""
    if not isinstance(tree, dict):
        return []
    mods = dict.fromkeys(module_of(p) for p in flatten_tree(tree))
    return sorted(mods, key=_natkey)


def get_max_memory(num_devices: Optional[int] = None, reserve_fraction: float = 0.1
                   ) -> Optional[Dict[DeviceId, int]]:
    """Each card's free memory (``torch.cuda.mem_get_info``) less
    ``reserve_fraction`` of it for activations and caches (``:104``, which
    reads XLA's ``memory_stats``).  ``None`` without a card, or when asked
    for more cards than there are: callers then split synthetically."""
    if not torch.cuda.is_available():
        return None
    n = num_devices if num_devices is not None else torch.cuda.device_count()
    if n > torch.cuda.device_count():
        return None
    budgets: Dict[DeviceId, int] = {}
    for i in range(n):
        free, _ = torch.cuda.mem_get_info(i)
        budgets[i] = max(int(free * (1.0 - reserve_fraction)), 0)
    return budgets


def _num_devices(num_devices: Optional[int]) -> int:
    if num_devices is not None:
        return num_devices
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def get_balanced_memory(tree: PathTree, max_memory: Optional[Dict[DeviceId, int]] = None,
                        num_devices: Optional[int] = None, dtype=None,
                        low_zero: bool = False) -> Dict[DeviceId, int]:
    """Even per-device budgets (``:134``): the model's size over the devices
    plus its largest module, clamped to each card's free memory where there
    is a card.  ``low_zero`` leaves device 0 room for the largest module
    only (``"balanced_low_0"``).  The budgets have no term for a streaming
    executor's two transfer buffers: pass ``max_memory`` to leave room."""
    if max_memory is not None:
        return dict(max_memory)
    n = _num_devices(num_devices)
    total = compute_module_sizes(tree, dtype)[""]
    max_layer, _ = get_max_layer_size(tree, dtype=dtype)
    active = n - 1 if (low_zero and n > 1) else n
    per_device = total // max(active, 1) + max_layer
    real = get_max_memory(n)
    budgets: Dict[DeviceId, int] = {
        i: per_device if real is None else min(per_device, real[i]) for i in range(n)
    }
    if low_zero and n > 1:
        budgets[0] = max_layer if real is None else min(max_layer, real[0])
    budgets["cpu"] = 10**15
    budgets["disk"] = 10**18
    return budgets


def infer_auto_device_map(tree: PathTree, max_memory: Optional[Dict[DeviceId, int]] = None,
                          dtype=None, num_devices: Optional[int] = None
                          ) -> Dict[str, DeviceId]:
    """Greedy packing of the top-level modules over the devices, then
    ``"cpu"``, then ``"disk"``, in execution order and never backtracking,
    so neighbouring layers share a device (``:171``).  Returns ``{module:
    device}``."""
    n = _num_devices(num_devices)
    budgets = (get_balanced_memory(tree, None, n, dtype) if max_memory is None
               else dict(max_memory))
    sizes = compute_module_sizes(tree, dtype)
    order: List[DeviceId] = [i for i in range(n) if budgets.get(i, 0) > 0]
    order += [d for d in ("cpu", "disk") if budgets.get(d, 0) > 0]
    if not order:
        raise ValueError("All device budgets are zero; cannot place the model.")
    device_map: Dict[str, DeviceId] = {}
    used: Dict[DeviceId, int] = defaultdict(int)
    cursor = 0
    for mod in top_level_modules(tree):
        size = sizes.get(mod, 0)
        while cursor < len(order):
            dev = order[cursor]
            if used[dev] + size <= budgets[dev]:
                device_map[mod] = dev
                used[dev] += size
                break
            cursor += 1  # device full: move on, never back
        else:
            raise ValueError(
                f"Module {mod!r} ({size} bytes) does not fit anywhere. "
                f"Budgets: { {d: budgets[d] for d in order} }, used: {dict(used)}.")
    return device_map


def named_module_tensors(tree: PathTree, prefix: str = "") -> Dict[str, Any]:
    """:func:`flatten_tree` under the reference's name (``:213``)."""
    return flatten_tree(tree, prefix)
