"""Weights for the port's :class:`~.models.transformer.Transformer`.

* :func:`params_from_jax` turns the JAX package's Flax params (a nested dict
  of numpy arrays) into the port's state dict.  Flax ``Dense`` kernels are
  ``[in, out]``, ``nn.Linear`` weights ``[out, in]``, so every projection is
  transposed; names map ``layers_{i}/attn/q_proj/kernel`` ->
  ``layers.{i}.attn.q_proj.weight`` and so on.
* :func:`init_params` makes random full-width weights from a seed, the way
  the Flax model initialises them (normal(0.02) matrices and embedding, unit
  norm scales).  Matrices may be stored in bf16: Flax casts f32 params to the
  bf16 compute dtype before every product, so the math is the same; norm
  scales stay f32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .models.transformer import TransformerConfig, state_dict_shapes

_PROJ = {
    "attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "up_proj", "down_proj"),
}


def params_from_jax(tree: Mapping, device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Flax ``Transformer`` params -> the port's state dict, on ``device``
    (the card unless ``device="cpu"``).  Matrices take ``dtype`` when given
    (else their own), norm scales stay f32."""
    device = resolve_device(device)

    def mat(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    def vec(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    sd = {"embed_tokens.weight": mat(tree["embed_tokens"]["embedding"])}
    i = 0
    while f"layers_{i}" in tree:
        layer = tree[f"layers_{i}"]
        p = f"layers.{i}."
        sd[p + "input_norm.scale"] = vec(layer["input_norm"]["scale"])
        sd[p + "post_attn_norm.scale"] = vec(layer["post_attn_norm"]["scale"])
        for block, names in _PROJ.items():
            for name in names:
                kernel = np.asarray(layer[block][name]["kernel"])
                sd[p + f"{block}.{name}.weight"] = mat(kernel.T)
        i += 1
    sd["final_norm.scale"] = vec(tree["final_norm"]["scale"])
    sd["lm_head.weight"] = mat(np.asarray(tree["lm_head"]["kernel"]).T)
    return sd


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights for ``cfg`` from ``seed``: normal(0.02) matrices in
    ``dtype``, unit f32 norm scales, made on ``device`` (the card unless
    ``device="cpu"``) with an explicit generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sd = {}
    for name, shape in state_dict_shapes(cfg).items():
        if name.endswith(".scale"):
            sd[name] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            sd[name] = torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, 0.02, generator=gen)
    return sd
