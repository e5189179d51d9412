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
:data:`SERVING_TP_RULES` place a served model (``ServingEngine(mesh=,
tp_axis=)``): :func:`serving_tp` is the engine's group over the ``tp``
axis, and :func:`shard_serving_model` keeps this rank's column block of
q/k/v/gate/up/``lm_head`` (their biases with them) and marks where the
serving forward gathers the columns back: the attention output before the
replicated ``o_proj``, the MLP's product before the replicated
``down_proj``, and the logits.  No contraction is split, so a sharded
serve computes what one card computes.  ``wrap_with_pp_rule``'s role, each pipeline stage
owning its layers, is the ``ShardedLayout``'s stage ownership
(``parallel/sharding.py``, ``parallel/pipeline.py``'s ``layer_stage``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.dataclasses import FullyShardedDataParallelPlugin
from . import mesh as mesh_lib
from .mesh import Mesh, NamedSharding, PartitionSpec
from .sharding import (
    all_gather_along,
    logical_shape,
    make_opt_sharding_fn,
    make_param_sharding_fn,
    to_torch_spec,
)

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


# ------------------------------------------------------------------- serving
@dataclasses.dataclass(frozen=True)
class ServeTP:
    """A serving engine's tensor-parallel group: ``size`` ranks, this one
    ``rank``; ``group`` ``None`` is the default group (a world of one,
    where every gather runs over a group of one)."""

    group: Any
    size: int
    rank: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s last dim gathered from every rank, in rank order, with
        no autograd (a CUDA graph captures it over NCCL)."""
        return all_gather_along(x, -1, self.group)

    def block(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``y``'s last dim (a projection kept whole
        whose output the rank's heads take)."""
        return y if self.size == 1 else y.chunk(self.size, -1)[self.rank]


def serving_tp(mesh: Mesh, tp_axis: str = "tp") -> Optional[ServeTP]:
    """The group a ``ServingEngine(mesh=, tp_axis=)`` serves over.  The
    engine runs one process a rank, every rank of the mesh calling it
    alike.  The mesh holds the ``tp_axis`` only and this rank: the whole
    world (:func:`~.mesh.build_mesh`) or one replica's ranks
    (:func:`~.mesh.replica_meshes`, whose groups were made with the
    meshes).  A mesh of one rank without a process group returns ``None``:
    the engine serves as the mesh-less one does.  A mesh of several ranks
    without a process group would be several cards in one process, which
    the port does not run: one process a card (``launchers.py``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    tp = mesh_lib.mesh_axis_size(mesh, tp_axis)
    if tp != mesh.size:
        raise ValueError(
            f"mesh {mesh.shape}: a serving engine's mesh holds the {tp_axis!r} axis only; "
            "replicas over other axes are meshes of their own (replica_meshes) behind a "
            "ReplicaRouter")
    if not (dist.is_available() and dist.is_initialized()):
        if mesh.size == 1:
            return None
        raise ValueError(
            f"a mesh of {mesh.size} cards in one process: the port runs one process a card; "
            "start one process a rank with launchers.py (notebook_launcher on cards, "
            "debug_launcher on the CPU) and build the engine on every rank")
    me = dist.get_rank()
    if me not in mesh:
        raise ValueError(f"rank {me} is not in the mesh's ranks {list(mesh.ranks)}: build a "
                         "replica's engine on its own ranks only")
    group = mesh.span_group()
    if group is None and mesh.size != dist.get_world_size():
        raise ValueError(f"mesh {mesh.shape} on ranks {list(mesh.ranks)} has no process "
                         "group: make replicas' meshes with replica_meshes, on every rank")
    rank = mesh.coordinate()[tp_axis] if tp > 1 else 0
    return ServeTP(group, tp, rank)


def _serving_split(name: str, shape: Sequence[int], size: int) -> bool:
    """Whether :data:`SERVING_TP_RULES` split this matrix by its output
    features over ``size`` ranks (its dim dividing; a group of one splits
    every one into one block)."""
    return (len(shape) == 2 and shape[0] % size == 0
            and re.search(SERVING_TP_RULES[0][0], path_to_str(name)) is not None)


def shard_serving_model(model: nn.Module, tp: ServeTP) -> Dict[str, slice]:
    """Keep this rank's column block of every ``nn.Linear`` that
    :data:`SERVING_TP_RULES` splits (rows of the ``[out, in]`` weight, and
    the bias's block), and mark the serving forward's gathers
    (``models/transformer.py``'s ``_dense``): ``o_proj`` and ``down_proj``
    gather their input when the projections before them were split,
    ``lm_head`` its output.  Each attention layer learns the global index of
    its first head (alibi's slopes are the global heads').  Weight-quantized
    and fp8 q/k/v projections stay whole (the reference's rules do not
    match their leaves), marked to hand the rank its heads' block of their
    product; an MoE block's experts and router stay whole.  The blocks are
    copies (at a group of one the tensors stay the caller's).  Returns the
    state-dict name -> row block of every split tensor, which
    :func:`serving_block` applies to full tensors.  A model already sharded
    for ``tp`` is returned as it is; head counts that do not divide
    ``tp.size`` raise ``ValueError``."""
    cfg = model.config
    done = getattr(model, "_atpu_serve_tp", None)
    if done is not None:
        if done != tp:
            raise ValueError("the model is already sharded for another tensor-parallel group")
        return model._atpu_serve_blocks
    if cfg.num_heads % tp.size or cfg.num_kv_heads % tp.size:
        raise ValueError(f"num_heads {cfg.num_heads} / num_kv_heads {cfg.num_kv_heads} must "
                         f"divide evenly over tp={tp.size}")
    blocks: Dict[str, slice] = {}
    split = set()
    with torch.no_grad():
        for name, module in model.named_modules():
            if type(module) is not nn.Linear:
                if re.search(r"attn\.(q_proj|k_proj|v_proj)$", name):
                    # int8/int4 codes and fp8 weights stay whole, as the
                    # reference's rules leave those leaves replicated: the
                    # product is the mesh-less one's, the heads its block
                    module._atpu_serve = ("block", tp)
                    split.add(name)
                continue
            w = module.weight
            if not _serving_split(name + ".weight", w.shape, tp.size):
                continue
            n = w.shape[0] // tp.size
            rows = slice(tp.rank * n, (tp.rank + 1) * n)
            split.add(name)
            blocks[name + ".weight"] = rows
            if module.bias is not None:
                blocks[name + ".bias"] = rows
            if tp.size > 1:
                module.weight = nn.Parameter(w.detach()[rows].clone(),
                                             requires_grad=w.requires_grad)
                if module.bias is not None:
                    b = module.bias
                    module.bias = nn.Parameter(b.detach()[rows].clone(),
                                               requires_grad=b.requires_grad)
            module._atpu_serve = ("out", tp) if name == "lm_head" else ("col", tp)
    heads = cfg.num_heads // tp.size
    for i, layer in enumerate(model.layers):
        attn = layer.attn
        if f"layers.{i}.attn.q_proj" in split:
            attn.o_proj._atpu_serve = ("in", tp)
            attn._atpu_head_offset = tp.rank * heads
        mlp = getattr(layer, "mlp", None)
        if mlp is not None and f"layers.{i}.mlp.up_proj" in split:
            mlp.down_proj._atpu_serve = ("in", tp)
    model._atpu_serve_tp = tp
    model._atpu_serve_blocks = blocks
    return blocks


def serving_block(blocks: Dict[str, slice], name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of the full tensor ``full`` named ``name``
    (:func:`shard_serving_model`'s ``blocks``; unsplit names whole)."""
    rows = blocks.get(name)
    return full if rows is None else full[rows]


__all__ = ["DEFAULT_TP_RULES", "SERVING_TP_RULES", "ServeTP", "make_tp_sharding_fn",
           "path_to_str", "serving_block", "serving_tp", "shard_serving_model", "tp_kind"]
