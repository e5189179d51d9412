"""Weights for the port's :class:`~.models.transformer.Transformer`.

* :func:`params_from_jax` turns the JAX package's Flax params (a nested dict
  of numpy arrays) into the port's state dict, for every family: Flax
  ``Dense`` kernels are ``[in, out]``, ``nn.Linear`` weights ``[out, in]``,
  so every projection is transposed; names map
  ``layers_{i}/attn/q_proj/kernel`` -> ``layers.{i}.attn.q_proj.weight``,
  ``.../bias`` -> ``....bias``, ``embed_tokens``/``pos_embed``
  ``embedding`` -> ``.weight``, and norm ``scale``/``bias`` keep their names.
* :func:`init_params` makes random full-width weights from a seed, the way
  the Flax model initialises them (normal(0.02) matrices and embeddings,
  zero biases, unit norm scales, zero scales for Gemma's unit-offset
  RMSNorm).  Matrices and projection biases may be stored in bf16: Flax
  casts f32 params to the bf16 compute dtype before every product, so the
  math is the same; norm parameters stay f32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .models.transformer import TransformerConfig, state_dict_shapes


def is_norm_param(name: str) -> bool:
    """Whether a state-dict entry is a norm's scale or bias, which the model
    keeps in f32 whatever the storage dtype of the rest."""
    return name.rsplit(".", 2)[-2].endswith("norm")


def params_from_jax(tree: Mapping, device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Flax ``Transformer`` params -> the port's state dict, on ``device``
    (the card unless ``device="cpu"``).  Matrices, embeddings and projection
    biases take ``dtype`` when given (else their own), norm parameters stay
    f32."""
    device = resolve_device(device)
    sd = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            parts = list(path)
            if parts and parts[0].startswith("layers_"):
                parts[0:1] = ["layers", parts[0][len("layers_"):]]
            a = np.asarray(val)
            if is_norm_param(".".join(parts + [key])):
                sd[".".join(parts + [key])] = torch.from_numpy(
                    a.astype(np.float32, copy=True)).to(device)
                continue
            if key == "kernel":
                a, key = a.T, "weight"
            elif key == "embedding":
                key = "weight"
            t = torch.from_numpy(np.array(a))
            sd[".".join(parts + [key])] = t.to(device=device, dtype=dtype or t.dtype)

    walk(tree, ())
    return sd


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights for ``cfg`` from ``seed``: normal(0.02) matrices and
    embeddings in ``dtype``, zero projection biases in ``dtype``, f32 norm
    parameters (unit scales, or zero under ``norm_unit_offset``; zero
    biases), made on ``device`` (the card unless ``device="cpu"``) with an
    explicit generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sd = {}
    for name, shape in state_dict_shapes(cfg).items():
        if name.endswith(".scale"):
            fill = 0.0 if cfg.norm_type == "rmsnorm" and cfg.norm_unit_offset else 1.0
            sd[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
        elif name.endswith(".bias"):
            sd[name] = torch.zeros(shape, dtype=torch.float32 if is_norm_param(name) else dtype,
                                   device=device)
        else:
            sd[name] = torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, 0.02, generator=gen)
    return sd
