"""FLOPs and bytes of one call of each serving program, for the cost table.

The reference asks XLA's ``cost_analysis`` about each compiled window and
chunk (``ServingEngine.analyze_costs``,
``accelerate_tpu/serving/engine.py:3094-3115``); PyTorch has no
counterpart, so the port states each program's cost as a formula over the
shapes the :class:`~accelerate_tpu_torch.telemetry.CostTable` recorded,
with the model's geometry bound in.  They are the bound columns of
``chip_smoke.py`` (:func:`chunk` is the chunk's; the decode step's weight
bound): each forward reads every weight it uses once, and K1/K2 read each
visible key's K and V once.
The shapes say how wide a lane's block table (or slab) is, not how many of
its keys are live, so attention is counted at that width: an upper bound.

FLOPs are the model's: 2 per matrix weight per token, the MoE layers at
``num_experts_per_tok`` experts (plus the router), and 4 * head_dim per
visible (query head, key) pair a layer.  Every formula returns
``(flops, bytes)``.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

Shapes = List[Tuple[Tuple[int, ...], str]]
Formula = Callable[[Shapes], Tuple[float, float]]

#: bytes of the lane vectors one lane install writes: pending, eos,
#: top_k (int32), temperature, top_p (f32), active, sampled (bool) and the
#: ``(seed, counter)`` int64 pair
LANE_INSTALL_BYTES = 4 * 5 + 1 * 2 + 8 * 2


def matrix_params(cfg) -> Tuple[int, int]:
    """``(per layer, head)``: the matrix weights one token multiplies
    through (an MoE layer's active experts and its router)."""
    hd, h = cfg.resolved_head_dim, cfg.hidden_size
    attn = h * hd * 2 * (cfg.num_heads + cfg.num_kv_heads)
    mlp = (3 if cfg.mlp_variant in ("swiglu", "geglu") else 2) * h * cfg.intermediate_size
    if cfg.num_experts:
        mlp = mlp * cfg.num_experts_per_tok + h * cfg.num_experts
    return attn + mlp, h * cfg.vocab_size


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors``, each distinct tensor once (tied weights once)."""
    seen, total = set(), 0
    for t in tensors:
        key = (t.data_ptr(), tuple(t.shape), t.dtype, t.device)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def _kv_bytes(cfg, lanes: int, keys: int, kv_elem: int, page: int, quantized: bool) -> int:
    """K and V of ``keys`` keys on ``lanes`` lanes, every layer, with each
    page's two f32 scales for quantized pages."""
    nbytes = 2 * cfg.num_layers * lanes * keys * cfg.num_kv_heads * cfg.resolved_head_dim * kv_elem
    if quantized:
        nbytes += 2 * 4 * cfg.num_layers * cfg.num_kv_heads * lanes * -(-keys // page)
    return nbytes


def forward(cfg, weight_bytes: int, lanes: int, queries: int, keys: int, kv_elem: int,
            page: int = 1, quantized: bool = False, head: bool = True,
            pairs_per_lane: int = None) -> Tuple[float, float]:
    """One forward of ``queries`` tokens on each of ``lanes`` lanes against
    ``keys`` keys a lane (``pairs_per_lane`` visible (query, key) pairs a
    lane, default every query against every key)."""
    layer, head_params = matrix_params(cfg)
    tokens = lanes * queries
    if pairs_per_lane is None:
        pairs_per_lane = queries * keys
    flops = (2 * (cfg.num_layers * layer + (head_params if head else 0)) * tokens
             + 4 * cfg.resolved_head_dim * cfg.num_heads * cfg.num_layers * lanes * pairs_per_lane)
    return float(flops), float(weight_bytes + _kv_bytes(cfg, lanes, keys, kv_elem, page, quantized))


def decode_window(cfg, weight_bytes: int, steps: int, kv_elem: int, page: int,
                  quantized: bool, keys_of: Callable[[Shapes], Tuple[int, int]]) -> Formula:
    """A decode window of ``steps`` steps: each step one token a lane
    against the lane's full width.  ``keys_of(shapes) -> (lanes, keys)``."""
    def formula(shapes):
        lanes, keys = keys_of(shapes)
        flops, nbytes = forward(cfg, weight_bytes, lanes, 1, keys, kv_elem, page, quantized)
        return steps * flops, steps * nbytes
    return formula


def verify_window(cfg, weight_bytes: int, span: int, kv_elem: int, page: int,
                  quantized: bool, keys_of: Callable[[Shapes], Tuple[int, int]]) -> Formula:
    """One verify forward of ``span`` positions a lane (K + 1, or the tree's
    nodes)."""
    def formula(shapes):
        lanes, keys = keys_of(shapes)
        return forward(cfg, weight_bytes, lanes, span, keys, kv_elem, page, quantized)
    return formula


def chunk(cfg, layer_bytes: int, embed_elem: int, bucket: int, base: int, kv_elem: int,
          page: int = 1, quantized: bool = False) -> Tuple[float, float]:
    """One prefill chunk of ``bucket`` tokens at positions ``base ..``
    through the layer stack (the chunk program stops before the LM head):
    the layers' weights (``layer_bytes``), the chunk's embedding rows and
    the ``base`` prior tokens' K/V read once, the chunk's K/V written once;
    each query attends the prior keys and the chunk's causally."""
    pairs = base * bucket + bucket * (bucket + 1) // 2
    return forward(cfg, layer_bytes + bucket * cfg.hidden_size * embed_elem, 1, bucket,
                   base + bucket, kv_elem, page, quantized, head=False, pairs_per_lane=pairs)


def prefill_chunk(cfg, layer_bytes: int, embed_elem: int, bucket: int, kv_elem: int,
                  page: int, quantized: bool, keys_of: Callable[[Shapes], int]) -> Formula:
    """:func:`chunk` placed at the end of the lane's width: ``base = width
    - bucket`` prior keys."""
    def formula(shapes):
        base = max(keys_of(shapes) - bucket, 0)
        return chunk(cfg, layer_bytes, embed_elem, bucket, base, kv_elem, page, quantized)
    return formula


def write(nbytes: int) -> Formula:
    """A write of ``nbytes`` from the host's launch arguments, no FLOPs."""
    return lambda shapes: (0.0, float(nbytes))


def copy(nbytes: int) -> Formula:
    """A pure copy of ``nbytes``: read once and written once, no FLOPs."""
    return lambda shapes: (0.0, float(2 * nbytes))


def elem(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()
