"""Tensor parallelism as name-based placement rules over the ``tp`` mesh axis.

Port of :mod:`accelerate_tpu.parallel.tensor_parallel`: the Megatron
convention as regexes over the JAX package's ``/``-joined parameter paths
(attention q/k/v, the MLP's gate/up and ``lm_head`` column-parallel —
``"out"``; ``o_proj``/``down_proj`` row-parallel — ``"in"``; the embedding
vocab-parallel — ``"vocab"``), composed with ``fsdp`` on the other dim.
:func:`path_to_str` turns a torch state-dict name into that path
(``layers.0.attn.q_proj.weight`` -> ``layers_0/attn/q_proj/kernel``), and
the specs are computed on the JAX package's logical shapes and mapped
onto the torch layout (``parallel/sharding.py``), so an ``"out"``
projection splits dim 0 of its ``[out, in]`` weight and an ``"in"`` one
dim 1.

How the step computes under these layouts is the Accelerator's (Megatron's
column/row-parallel products on the rank's heads, ``models/transformer.py``'s
``_dense``); :func:`tp_kind` tells it which kind a parameter got.
:data:`SERVING_TP_RULES` is kept for the engine's ``tp_axis=`` (ROADMAP
Queue 1 item 9e-ii).  ``wrap_with_pp_rule``'s role, each pipeline stage
owning its layers, is the ``ShardedLayout``'s stage ownership
(``parallel/sharding.py``, ``parallel/pipeline.py``'s ``layer_stage``).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Optional, Sequence, Tuple

from ..utils.dataclasses import FullyShardedDataParallelPlugin
from . import mesh as mesh_lib
from .mesh import Mesh, NamedSharding, PartitionSpec
from .sharding import logical_shape, make_opt_sharding_fn, make_param_sharding_fn, to_torch_spec

DEFAULT_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)/kernel$", "out"),
    (r"(o_proj|down_proj)/kernel$", "in"),
    (r"embed_tokens/embedding$", "vocab"),
)

# serving: column-parallel projections only, so that every reduction a
# sharded serve runs is its tp=1 twin's (the JAX package's rationale)
SERVING_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)/kernel$", "out"),
)


def path_to_str(path) -> str:
    """The JAX package's ``/``-joined path of a parameter: from a torch
    state-dict name (``layers.{i}`` -> ``layers_{i}``, a linear's
    ``weight`` -> ``kernel``, an embedding's -> ``embedding``), or from a
    sequence of keys as the reference joins them."""
    if not isinstance(path, str):
        parts = []
        for p in path:
            name = getattr(p, "name", None)
            if name is None:
                name = getattr(p, "key", None)
            if name is None:
                name = getattr(p, "idx", p)
            parts.append(str(name))
        return "/".join(parts)
    parts = path.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
            continue
        out.append(parts[i])
        i += 1
    if out and out[-1] == "weight":
        out[-1] = "embedding" if len(out) > 1 and "embed" in out[-2] else "kernel"
    return "/".join(out)


def tp_kind(name: str, shape: Sequence[int], tp: int,
            rules: Optional[Sequence[Tuple[str, str]]] = None) -> Optional[str]:
    """``"out"``, ``"in"`` or ``"vocab"`` when a rule matches ``name`` and
    ``tp`` divides the dim it splits; else ``None`` (the parameter falls
    back to the shape rule, as in the reference)."""
    if tp <= 1 or len(shape) < 2:
        return None
    path = path_to_str(name)
    lshape = logical_shape(name, shape)
    for pat, kind in rules or DEFAULT_TP_RULES:
        if re.search(pat, path):
            tp_dim = len(lshape) - 1 if kind == "out" else len(lshape) - 2
            return kind if lshape[tp_dim] % tp == 0 else None
    return None


def make_tp_sharding_fn(mesh: Mesh, plugin: Optional[FullyShardedDataParallelPlugin] = None, *,
                        for_opt_state: bool = False,
                        rules: Optional[Sequence[Tuple[str, str]]] = None,
                        axis_name: str = "tp") -> Callable[..., NamedSharding]:
    """``rule(name, x) -> NamedSharding`` (torch dims) with TP + FSDP
    composition: a matching matrix splits its tp dim over ``axis_name`` and,
    when the plugin shards this kind of state, the other dim over ``fsdp``
    (``"vocab"``: both on the vocab dim, tp major); everything else takes
    the shape rule."""
    tp = mesh_lib.mesh_axis_size(mesh, axis_name)
    fsdp = mesh_lib.mesh_axis_size(mesh, "fsdp")
    rules = rules or DEFAULT_TP_RULES
    if for_opt_state:
        base = make_opt_sharding_fn(mesh, plugin)
        shards_other = plugin is not None and plugin.shards_opt_state and fsdp > 1
        memory_kind = ("pinned_host" if plugin is not None and plugin.offload_optimizer
                       and not plugin.offload_optimizer_nvme_path else None)
    else:
        base = make_param_sharding_fn(mesh, plugin)
        shards_other = plugin is not None and plugin.shards_params and fsdp > 1
        memory_kind = "pinned_host" if plugin is not None and plugin.cpu_offload else None
    min_size = plugin.min_weight_size if plugin is not None else 2**12

    def rule(name, x) -> NamedSharding:
        shape = tuple(getattr(x, "shape", ()))
        kind = tp_kind(name, shape, tp, rules)
        if kind is None:
            return base(x, name)
        lshape = logical_shape(name, shape)
        tp_dim = len(lshape) - 1 if kind == "out" else len(lshape) - 2
        spec: list = [None] * len(lshape)
        if kind == "vocab":
            if (shards_other and lshape[tp_dim] % (tp * fsdp) == 0
                    and math.prod(lshape) >= min_size):
                spec[tp_dim] = (axis_name, "fsdp")
            else:
                spec[tp_dim] = axis_name
        else:
            other_dim = len(lshape) - 2 if kind == "out" else len(lshape) - 1
            spec[tp_dim] = axis_name
            if shards_other and lshape[other_dim] % fsdp == 0 and math.prod(lshape) >= min_size:
                spec[other_dim] = "fsdp"
        return NamedSharding(mesh, to_torch_spec(name, PartitionSpec(*spec), len(shape)),
                             memory_kind)

    return rule


__all__ = ["DEFAULT_TP_RULES", "SERVING_TP_RULES", "make_tp_sharding_fn", "path_to_str",
           "tp_kind"]
