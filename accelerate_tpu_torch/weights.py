"""Weights for the port's :class:`~.models.transformer.Transformer`.

* :func:`params_from_jax` turns the JAX package's Flax params (a nested dict
  of numpy arrays) into the port's state dict, for every family: Flax
  ``Dense`` kernels are ``[in, out]``, ``nn.Linear`` weights ``[out, in]``,
  so every projection is transposed; names map
  ``layers_{i}/attn/q_proj/kernel`` -> ``layers.{i}.attn.q_proj.weight``,
  ``.../bias`` -> ``....bias``, ``embed_tokens``/``pos_embed``
  ``embedding`` -> ``.weight``, and norm ``scale``/``bias`` keep their names.
  An MoE layer's router kernel becomes its ``Linear`` weight (transposed,
  f32); the stacked expert kernels ``[E, in, out]`` keep their layout
  (``moe_mlp/experts/gate_proj/kernel`` -> ``....weight``), and a quantized
  tree's ``qweight``/``scales`` carry across untransposed, bit for bit.  A
  ``scan_layers=True`` tree (one ``layers/layer/...`` module whose leaves
  carry a leading depth axis) is unstacked into ``layers.{i}`` first, each
  layer's kernels transposed on their own; the port has no scanned layout.
* :func:`init_params` makes random full-width weights from a seed, the way
  the Flax model initialises them (normal(0.02) matrices and embeddings,
  zero biases, unit norm scales, zero scales for Gemma's unit-offset
  RMSNorm).  Matrices and projection biases may be stored in bf16: Flax
  casts f32 params to the bf16 compute dtype before every product, so the
  math is the same; norm parameters and routers stay f32.  Under
  ``quantization`` each projection is quantized as it is drawn, so the
  dense weights never exist at once (Mixtral-8x7B: 93 GB in bf16, 47 GB in
  int8).  With a ``device_map`` every tensor is still drawn on the card, in
  the same order from the same generator, and each module the map puts on
  ``"cpu"`` is copied into one pinned host block as it is drawn: the values
  are the whole draw's, and neither side ever holds more than its share
  (Mixtral-8x7B in bf16, 93 GB, exists on a machine with an 80 GB card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .models.transformer import TransformerConfig, state_dict_shapes
from .ops.quantization import QuantizationConfig, quantize_flat_tree
from .utils.modeling import module_of
from .utils.offload import pinned_host_views


def is_norm_param(name: str) -> bool:
    """Whether a state-dict entry is a norm's scale or bias, which the model
    keeps in f32 whatever the storage dtype of the rest."""
    return name.rsplit(".", 2)[-2].endswith("norm")


def is_f32_param(name: str) -> bool:
    """Norm parameters and MoE routers: the entries the model keeps in f32."""
    return is_norm_param(name) or name.rsplit(".", 2)[-2:] == ["router", "weight"]


def params_from_jax(tree: Mapping, device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Flax ``Transformer`` params -> the port's state dict, on ``device``
    (the card unless ``device="cpu"``).  Matrices, embeddings and projection
    biases take ``dtype`` when given (else their own), norm parameters stay
    f32."""
    device = resolve_device(device)
    sd = {}
    tree = unstack_layers(tree)

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            parts = list(path)
            if parts and parts[0].startswith("layers_"):
                parts[0:1] = ["layers", parts[0][len("layers_"):]]
            a = np.asarray(val)
            if key in ("qweight", "scales"):
                # the reference's layout, codes and f32 scales as they are
                sd[".".join(parts + [key])] = torch.from_numpy(np.array(a)).to(device)
                continue
            if key == "kernel":
                # Dense [in, out] -> Linear [out, in]; stacked experts
                # [E, in, out] keep their layout
                a, key = (a.T if a.ndim == 2 else a), "weight"
            elif key == "embedding":
                key = "weight"
            name = ".".join(parts + [key])
            if is_f32_param(name):
                sd[name] = torch.from_numpy(a.astype(np.float32, copy=True)).to(device)
                continue
            t = torch.from_numpy(np.array(a))
            sd[name] = t.to(device=device, dtype=dtype or t.dtype)

    walk(tree, ())
    return sd


def unstack_layers(tree: Mapping) -> Mapping:
    """A ``scan_layers=True`` Flax tree -> the per-layer ``layers_{i}`` tree:
    the stacked ``layers/layer`` module's leaves sliced along their leading
    depth axis.  Any other tree comes back as it is."""
    stack = tree.get("layers")
    if not (isinstance(stack, Mapping) and "layer" in stack):
        return tree

    def leaves(node):
        for val in node.values():
            yield from (leaves(val) if isinstance(val, Mapping) else (val,))

    def take(node, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in node.items()}

    depth = np.shape(next(leaves(stack["layer"])))[0]
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers_{i}": take(stack["layer"], i) for i in range(depth)})
    return out


def _draw_plan(cfg: TransformerConfig, dtype: torch.dtype):
    """``(dense config, quantization config or None, {name: (shape, dtype)})``
    of every tensor :func:`init_params` returns, in draw order."""
    qcfg = None
    if cfg.quantization is not None:
        # the dense model's draws, each projection quantized as drawn
        qcfg = QuantizationConfig(bits=cfg.quantization, block_size=cfg.quantization_block_size)
        cfg = dataclasses.replace(cfg, quantization=None)
    out = {}
    for name, shape in state_dict_shapes(cfg).items():
        if name.endswith(".scale") or (name.endswith(".bias") and is_norm_param(name)):
            dt = torch.float32
        elif name.endswith(".bias"):
            dt = dtype
        else:
            dt = torch.float32 if is_f32_param(name) else dtype
        meta = {name: torch.empty(shape, dtype=dt, device="meta")}
        for k, t in (quantize_flat_tree(meta, qcfg) if qcfg is not None else meta).items():
            out[k] = (tuple(t.shape), t.dtype)
    return cfg, qcfg, out


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16,
                device_map: Optional[Dict[str, Union[int, str]]] = None
                ) -> Dict[str, torch.Tensor]:
    """Random weights for ``cfg`` from ``seed``: normal(0.02) matrices and
    embeddings in ``dtype``, zero projection biases in ``dtype``, f32 norm
    parameters (unit scales, or zero under ``norm_unit_offset``; zero
    biases), made on ``device`` (the card unless ``device="cpu"``) with an
    explicit generator.

    ``device_map`` (``{top-level module: 0 or "cpu"}``, every module
    covered) keeps the ``"cpu"`` modules' tensors in one pinned host block,
    each copied there right after its draw on ``device``; the values are
    those of the draw without a map."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    cfg, qcfg, plan = _draw_plan(cfg, dtype)
    host = {}
    if device_map is not None:
        from .big_modeling import _validate_device_map

        _validate_device_map(device_map, dict.fromkeys(module_of(n) for n in plan))
        if "disk" in device_map.values():
            raise ValueError("init_params draws to the card and the host only; write "
                             "disk modules with big_modeling.disk_offload")
        host = pinned_host_views({n: plan[n] for n in plan if device_map[module_of(n)] == "cpu"},
                                 pin=device.type == "cuda")
    sd = {}
    for name, shape in state_dict_shapes(cfg).items():
        if name.endswith(".scale"):
            fill = 0.0 if cfg.norm_type == "rmsnorm" and cfg.norm_unit_offset else 1.0
            drawn = {name: torch.full(shape, fill, dtype=torch.float32, device=device)}
        elif name.endswith(".bias"):
            drawn = {name: torch.zeros(shape, dtype=plan[name][1], device=device)}
        else:
            w = torch.empty(shape, dtype=torch.float32 if is_f32_param(name) else dtype,
                            device=device).normal_(0.0, 0.02, generator=gen)
            drawn = quantize_flat_tree({name: w}, qcfg) if qcfg is not None else {name: w}
            del w
        for k, t in drawn.items():
            if k in host:
                host[k].copy_(t)
                t = host[k]
            sd[k] = t
        del drawn
    return sd
