"""Decoder-only transformer in PyTorch, every family of the JAX config.

Port of :mod:`accelerate_tpu.models.transformer`.  The default is the Llama
recipe: pre-norm RMSNorm (f32 statistics), rotary embeddings (rotate-half in
f32), grouped-query attention and a SwiGLU MLP.  The family switches of the
JAX config select the other families ``hf_compat`` maps: LayerNorm with or
without bias, biases on the projections (per site), learned (with an offset)
or alibi positions, the gelu / exact-gelu / relu / geglu MLPs, a parallel
residual with one or two norms, partial and interleaved rotary, a sliding
window, Gemma's unit-offset norm and embedding scale, BLOOM's embedding norm,
a tied head and a head bias.  The numerics follow the Flax model: every
projection casts its input, weight and bias to ``config.dtype`` (Flax
``nn.Dense(dtype=...)``), norm parameters stay f32, and logits come out in
f32.

Three attention branches, as in the JAX ``Attention``:

* with a :class:`PagedKVCache` — the serving path: the new K/V are scattered
  into the page pool in place (int8 and fp8 pages requantized per touched
  page), then attention reads the pages through the block tables with the
  decode kernel (K1) or the prefill kernel (K2).  A ``tree_mask`` (a
  speculative tree verify) takes K1's tree-mask arm.  Sliding-window and
  alibi models take the kernels' plain versions (``PagedKVCache.plain``), as
  the reference sends them to its XLA path: the kernels have neither arm;
* with a slab :class:`KVCache` (per-lane index) — the slab serving pool
  (``ServingEngine(paged=False)``), its batch-1 prefill scratch and the
  stateless draft forward of tree speculation: the new K/V are written at
  each lane's own index and :func:`cached_attention` (plain PyTorch, as
  XLA code is in the reference) reads the slab;
* without a cache — the training path and the independent forward the
  serving path is checked against:
  :func:`~accelerate_tpu_torch.ops.attention.dot_product_attention` with
  ``config.attention_impl``, ``"xla"`` (plain math, no kernel), ``"blocked"``
  (plain, causal query chunks) or ``"pallas"`` (the flash kernels K3–K5,
  differentiable).

:func:`lm_loss_fn` is the next-token loss the ``Accelerator`` train step
differentiates, with the JAX signature ``loss_fn(params, batch)``.

Still refused, each naming its ROADMAP item: MoE (``num_experts > 0``),
``use_fp8``, ``quantization`` and ``attention_impl="ring"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.attention import check_implementation, dot_product_attention
from ..ops.paged_attention import (
    as_tree_mask,
    kv_qmax,
    paged_attention,
    paged_attention_reference,
    paged_flash_prefill,
    paged_flash_prefill_reference,
    paged_insert,
    paged_quantized_insert,
)

#: the JAX config's options the port refuses -> (is it set?, its ROADMAP item)
_NOT_PORTED = {
    "num_experts": (lambda v: v > 0, "9e (parallel/moe.py)"),
    "use_fp8": (bool, "9d (ops/fp8.py)"),
    "quantization": (lambda v: v is not None, "9d (ops/quantization.py)"),
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # the family switches (accelerate_tpu/models/transformer.py:103-150);
    # models/hf_compat.py maps real checkpoints onto them
    norm_type: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    norm_bias: bool = True             # LayerNorm bias (MPT: False)
    use_bias: bool = False             # biases on attention/MLP projections
    positional: str = "rope"           # "rope" | "learned" | "alibi"
    mlp_variant: str = "swiglu"        # "swiglu" | "gelu" | "gelu_exact" | "relu" | "geglu"
    pos_offset: int = 0                # learned table row of position 0 (OPT: 2)
    parallel_residual: bool = False    # x + attn(norm(x)) + mlp(norm'(x))
    shared_norm: bool = False          # parallel residual with one norm (GPT-J)
    rope_dim: Optional[int] = None     # rotary over the first rope_dim dims
    rope_interleaved: bool = False     # GPT-J's rotate-every-two pairing
    attn_bias: Optional[bool] = None   # per-site overrides of use_bias
    mlp_bias: Optional[bool] = None
    lm_head_bias: bool = False
    qkv_bias: Optional[bool] = None    # Qwen2: bias on q/k/v only
    sliding_window: Optional[int] = None  # each token sees this many positions
    norm_unit_offset: bool = False     # Gemma: RMSNorm scales by (1 + scale)
    embed_scale: bool = False          # Gemma: embeddings times sqrt(hidden)
    embed_norm: bool = False           # BLOOM: a norm right after the embedding
    attention_impl: str = "xla"        # no-cache attention: "xla" | "blocked" | "pallas"
    use_fp8: bool = False
    quantization: Optional[int] = None
    num_experts: int = 0
    dtype: torch.dtype = torch.bfloat16        # activation / compute dtype
    param_dtype: torch.dtype = torch.float32   # default weight storage dtype

    def __post_init__(self):
        for name, (is_set, item) in _NOT_PORTED.items():
            if is_set(getattr(self, name)):
                raise NotImplementedError(
                    f"TransformerConfig({name}={getattr(self, name)!r}) is not ported: "
                    f"ROADMAP Queue 1 item {item}")
        check_implementation(self.attention_impl)
        # the JAX config's validation (accelerate_tpu/models/transformer.py:216-231)
        if self.norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError(f"Unknown norm_type {self.norm_type!r}; choose 'rmsnorm' or "
                             "'layernorm'")
        if self.positional not in ("rope", "learned", "alibi"):
            raise ValueError(f"Unknown positional {self.positional!r}; choose 'rope', "
                             "'learned' or 'alibi'")
        if self.mlp_variant not in ("swiglu", "gelu", "gelu_exact", "relu", "geglu"):
            raise ValueError(f"Unknown mlp_variant {self.mlp_variant!r}; choose 'swiglu', "
                             "'gelu', 'gelu_exact', 'relu' or 'geglu'")
        if self.sliding_window is not None and self.sliding_window <= 0:
            raise ValueError(f"sliding_window must be positive, got {self.sliding_window}")
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"num_heads {self.num_heads} must be a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def full_causal(self) -> bool:
        """No sliding window and no alibi: the paged kernels' models (the
        reference's ``paged_kernel != "xla"`` rule, ``:237-244``)."""
        return self.sliding_window is None and self.positional != "alibi"

    def site_bias(self, site: str) -> bool:
        """Whether the ``"qkv"``, ``"o"`` or ``"mlp"`` projections carry a
        bias: the per-site override, else ``use_bias`` (qkv falls back to
        the attention site's)."""
        attn = self.use_bias if self.attn_bias is None else self.attn_bias
        if site == "o":
            return attn
        if site == "qkv":
            return attn if self.qkv_bias is None else self.qkv_bias
        return self.use_bias if self.mlp_bias is None else self.mlp_bias

    @property
    def gated_mlp(self) -> bool:
        return self.mlp_variant in ("swiglu", "geglu")

    @property
    def post_attn_norm(self) -> bool:
        """Whether a layer holds a second norm (all but GPT-J's shared one)."""
        return not (self.parallel_residual and self.shared_norm)

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**{**dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                             num_layers=32, num_heads=32, num_kv_heads=32), **kw})

    @classmethod
    def gpt2_xl_equiv(cls, **kw):
        """GPT-2-XL-sized decoder (1.5B), Llama recipe."""
        return cls(**{**dict(vocab_size=50257, hidden_size=1600, intermediate_size=6400,
                             num_layers=48, num_heads=25, num_kv_heads=25,
                             max_seq_len=1024), **kw})

    @classmethod
    def gpt2(cls, **kw):
        """GPT-2 (124M): LayerNorm with bias, learned positions, tanh-gelu
        MLP, biases everywhere, tied embeddings."""
        return cls(**{**dict(
            vocab_size=50257, hidden_size=768, intermediate_size=3072,
            num_layers=12, num_heads=12, num_kv_heads=12, max_seq_len=1024,
            norm_type="layernorm", use_bias=True, positional="learned",
            mlp_variant="gelu", tie_word_embeddings=True,
        ), **kw})

    @classmethod
    def tiny(cls, **kw):
        """Test-sized config (unit tests)."""
        return cls(**{**dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2,
                             max_seq_len=128), **kw})


@dataclasses.dataclass
class PagedKVCache:
    """The serving page pool threaded through the model.

    ``pages_k``/``pages_v [L, num_pages, page, Hkv, D]`` and the f32 scales
    ``[L, num_pages, Hkv]`` (ones for native pages) are written IN PLACE by
    the forward; ``tables [N, P]`` int32 block tables, ``index [N]`` int32
    next write position per lane, ``active [N]`` bool write gate (inactive
    lanes' writes go to the null page).  ``kernel`` picks the attention
    kernel: ``"decode"`` (K1, :func:`paged_attention`) or ``"prefill"`` (K2,
    :func:`paged_flash_prefill`); ``plain`` routes either to its kernel's
    plain version instead (the engine's ``decode_kernel="xla"``, an A/B of
    the kernels inside the engine).  ``quant_err`` is the running max of the
    round-trip error of every value a quantized-page forward wrote, an f32
    device scalar (``None`` until one writes; the reference's
    ``PagedKVCache.quant_err``, ``accelerate_tpu/models/transformer.py:349``)."""

    pages_k: torch.Tensor
    pages_v: torch.Tensor
    k_scales: torch.Tensor
    v_scales: torch.Tensor
    tables: torch.Tensor
    index: torch.Tensor
    active: torch.Tensor
    kernel: str = "decode"
    quant_err: Optional[torch.Tensor] = None
    plain: bool = False

    def __post_init__(self):
        if self.kernel not in ("decode", "prefill"):
            raise ValueError(f"kernel must be 'decode' or 'prefill', got {self.kernel!r}")


@dataclasses.dataclass
class KVCache:
    """A slab KV cache with a per-lane write index: ``k``/``v [L, B, M, Hkv,
    D]``, ``index [B]`` int32, the next write position of each lane.  The
    port's counterpart of ``KVCache.create(..., per_lane_index=True)``
    (``accelerate_tpu/models/transformer.py:309-317``): the slab serving
    pool (``KVCache.create(cfg, num_slots, max_len)``), its batch-1 prefill
    scratch (``KVCache.create(cfg, 1, max_prompt_len)``, whose one-lane
    index stands for the reference's scalar one) and the draft forward of
    tree speculation.  The forward writes ``k``/``v`` in place, so a CUDA
    graph that holds them stays valid.  A write of ``S`` rows starts at
    ``clamp(index, 0, M - S)``, as ``lax.dynamic_update_slice`` clamps in
    the reference: a lane past its slab's end (a finished lane one
    pipelined window late) overwrites its own last rows instead of indexing
    out of bounds."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor

    @classmethod
    def create(cls, config: "TransformerConfig", batch_size: int, max_len: int,
               device=None, dtype: Optional[torch.dtype] = None) -> "KVCache":
        shape = (config.num_layers, batch_size, max_len, config.num_kv_heads,
                 config.resolved_head_dim)
        dtype = dtype or config.dtype
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros(batch_size, dtype=torch.int32, device=device))


def cached_attention(q, k, v, q_positions, window=None, alibi: bool = False,
                     tree_mask=None):
    """Attention of ``q [B,S,Hq,D]`` against a full cache ``k``/``v [B,M,Hkv,D]``.

    Causal arm: key slot ``j`` is visible to query ``i`` iff ``j <=
    q_positions[b, i]``; ``window`` adds the band ``j > q_positions[b, i] -
    window`` (Mistral), and ``alibi`` adds ``slope_h * (j - q_positions[b,
    i])`` to the f32 logits (BLOOM, MPT).  Tree arm (``tree_mask``, an
    ``[S, S]`` ancestor-or-self mask or a
    :class:`~accelerate_tpu_torch.ops.paged_attention.TreeMask`): the ``S``
    tree nodes sit at the slots from each lane's frontier ``q_positions[:,
    0]`` on, and node ``i`` sees the history ``j < frontier`` plus the tree
    nodes of its row of the mask (``accelerate_tpu/models/transformer.py:
    356-421``); it refuses ``window`` and ``alibi``.  GQA groups fold into
    the query tensor so the cache is contracted unexpanded; logits are
    formed in ``q.dtype``, then softmax in f32, and the probabilities are
    cast back to ``q.dtype`` for the PV product."""
    b, s, n_q, d = q.shape
    n_kv = k.shape[2]
    rep = n_q // n_kv
    qg = q.reshape(b, s, n_kv, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * d ** -0.5
    j = torch.arange(k.shape[1], device=q.device)
    tree = as_tree_mask(tree_mask)
    if tree is not None:
        if window is not None or alibi:
            raise ValueError("tree_mask needs a full-causal model: sliding_window and "
                             "alibi are not supported under tree verification")
        anc_mask = tree.dense(q.device)                         # [S, S]
        base = q_positions[:, 0].long()                         # [B] lane frontier
        rel = j[None, :] - base[:, None]                        # [B, M] slot -> node
        within = (rel >= 0) & (rel < s)
        anc = anc_mask[:, rel.clamp(0, s - 1)].permute(1, 0, 2)  # [B, S, M]
        allowed = (j[None, None, :] < base[:, None, None]) | (within[:, None, :] & anc)
        mask = allowed[:, None, None, :, :]
    else:
        key = j[None, None, None, None, :]
        query = q_positions[:, None, None, :, None]
        if alibi:
            slopes = alibi_slopes(n_q, q.device).reshape(n_kv, rep)
            logits = logits + slopes[None, :, :, None, None] * (key - query).float()
        mask = key <= query
        if window is not None:
            mask = mask & (key > query - window)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, s, n_q, d)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """Per-head alibi slopes, f32 ``[n_heads]``: the Press et al. geometric
    sequence with the HF non-power-of-2 correction (the closest power of 2
    takes the standard sequence, extra heads interleave from the
    double-resolution one), powers taken in f64 as the reference's Python
    floats are, then rounded to f32.  Made on ``device`` by device ops, so a
    CUDA graph can capture it."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    powers = torch.pow(base, torch.arange(1, closest + 1, dtype=torch.float64, device=device))
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        odd = torch.arange(n_heads - closest, dtype=torch.float64, device=device) * 2 + 1
        powers = torch.cat([powers, torch.pow(extra_base, odd)])
    return powers.float()


def _alibi_bias(n_heads: int, k_len: int, device=None) -> torch.Tensor:
    """``[1, H, 1, K]`` additive bias ``slope_h * j`` (key position) of the
    no-cache forward: softmax-equal to the relative ``slope_h * (j - i)``
    form the caches use, not bitwise (``:439-445``)."""
    j = torch.arange(k_len, dtype=torch.float32, device=device)
    return (alibi_slopes(n_heads, device)[:, None, None] * j[None, None, :])[None]


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of ``[B, S, H, D]`` — rotate-half
    convention (Llama/NeoX), computed in f32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs                  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope_interleaved(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """GPT-J's rotate-every-two pairing: dims (0, 1), (2, 3), ... form the
    rotation pairs, computed in f32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs                  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)


def _apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The config's rotary: full or over the first ``rope_dim`` dims (the
    rest pass through), rotate-half or interleaved."""
    fn = _rope_interleaved if cfg.rope_interleaved else _rope
    rd = cfg.rope_dim
    if rd is None or rd >= x.shape[-1]:
        return fn(x, positions, cfg.rope_theta)
    return torch.cat([fn(x[..., :rd], positions, cfg.rope_theta), x[..., rd:]], dim=-1)


def scale_embed(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """Gemma's ``sqrt(hidden)`` embedding scale (identity unless
    ``cfg.embed_scale``); the constant is rounded to ``x.dtype`` first, as
    the reference's ``jnp.asarray(..., x.dtype)``."""
    if cfg.embed_scale:
        return x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=...)`` numerics: input, weight and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class RMSNorm(nn.Module):
    """RMSNorm with f32 statistics; ``unit_offset`` (Gemma) scales by ``1 +
    scale``."""

    def __init__(self, dim: int, eps: float = 1e-5, unit_offset: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.unit_offset = unit_offset
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        normed = xf * torch.rsqrt(var + self.eps)
        scale = 1.0 + self.scale if self.unit_offset else self.scale
        return (normed * scale).to(x.dtype)


class LayerNorm(nn.Module):
    """Centred LayerNorm with f32 statistics, with a bias or (MPT) without."""

    def __init__(self, dim: int, eps: float = 1e-5, bias: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
                     if bias else None)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        normed = (xf - mean) * torch.rsqrt(var + self.eps) * self.scale
        if self.bias is not None:
            normed = normed + self.bias
        return normed.to(x.dtype)


def make_norm(cfg: TransformerConfig) -> nn.Module:
    """The config's norm (``accelerate_tpu/models/transformer.py:540-546``)."""
    if cfg.norm_type == "layernorm":
        return LayerNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.norm_bias)
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.norm_unit_offset)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        hd = cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype)
        qkv = cfg.site_bias("qkv")
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd, bias=qkv, **kw)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, bias=qkv, **kw)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, bias=qkv, **kw)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, bias=cfg.site_bias("o"),
                                **kw)

    def forward(self, x, positions, cache=None, layer: int = 0, tree_mask=None):
        cfg = self.config
        dt = cfg.dtype
        hd = cfg.resolved_head_dim
        b, s = x.shape[:2]
        q = _dense(self.q_proj, x, dt).reshape(b, s, cfg.num_heads, hd)
        k = _dense(self.k_proj, x, dt).reshape(b, s, cfg.num_kv_heads, hd)
        v = _dense(self.v_proj, x, dt).reshape(b, s, cfg.num_kv_heads, hd)
        if cfg.positional == "rope":
            q = _apply_rope(q, positions, cfg)
            k = _apply_rope(k, positions, cfg)
        window, alibi = cfg.sliding_window, cfg.positional == "alibi"
        if isinstance(cache, KVCache):
            # slab: write each lane at its own index (clamped as the
            # reference's dynamic_update_slice clamps), attend over the slab
            k_cache, v_cache = cache.k[layer], cache.v[layer]
            start = cache.index.long().clamp(0, k_cache.shape[1] - s)
            slots = start[:, None] + torch.arange(s, device=x.device)[None, :]
            lanes = torch.arange(b, device=x.device)[:, None]
            k_cache[lanes, slots] = k.to(k_cache.dtype)
            v_cache[lanes, slots] = v.to(v_cache.dtype)
            out = cached_attention(q, k_cache, v_cache, positions, window=window, alibi=alibi,
                                   tree_mask=tree_mask)
        elif cache is not None:
            # scatter the new KV through the block tables, then attend over the
            # pages in place; ``index`` doubles as each lane's pre-write length
            pages_k, pages_v = cache.pages_k[layer], cache.pages_v[layer]
            k_scales, v_scales = cache.k_scales[layer], cache.v_scales[layer]
            if kv_qmax(pages_k.dtype) is not None:
                # quantized pages: each touched page requantized, its scales
                # rewritten in place; the larger error of K and V carried
                # (accelerate_tpu/models/transformer.py:596-604)
                _, _, err_k = paged_quantized_insert(pages_k, k_scales, k, cache.tables,
                                                     cache.index, cache.active)
                _, _, err_v = paged_quantized_insert(pages_v, v_scales, v, cache.tables,
                                                     cache.index, cache.active)
                err = torch.maximum(err_k, err_v)
                cache.quant_err = err if cache.quant_err is None \
                    else torch.maximum(cache.quant_err, err)
            else:
                paged_insert(pages_k, k, cache.tables, cache.index, cache.active)
                paged_insert(pages_v, v, cache.tables, cache.index, cache.active)
            if not (cache.plain or cfg.full_causal):
                # the kernels have no window or alibi arm (nor the reference's)
                raise ValueError("the paged kernels support full-causal rope/learned models; "
                                 "sliding_window and alibi need their plain versions "
                                 "(PagedKVCache(plain=True), the engine's decode_kernel='xla')")
            if cache.kernel == "prefill":
                if tree_mask is not None:
                    raise ValueError("tree verification is a decode-side program: the "
                                     "prefill kernel cannot carry a tree_mask")
                if cache.plain:
                    out = paged_flash_prefill_reference(
                        q, pages_k, pages_v, cache.tables, cache.index, k_scales=k_scales,
                        v_scales=v_scales, window=window, alibi=alibi)
                else:
                    out = paged_flash_prefill(q, pages_k, pages_v, cache.tables, cache.index,
                                              k_scales=k_scales, v_scales=v_scales)
            elif cache.plain:
                out = paged_attention_reference(
                    q, pages_k, pages_v, cache.tables, cache.index, k_scales=k_scales,
                    v_scales=v_scales, window=window, alibi=alibi, tree_mask=tree_mask)
            else:
                out = paged_attention(q, pages_k, pages_v, cache.tables, cache.index,
                                      k_scales=k_scales, v_scales=v_scales, tree_mask=tree_mask)
        else:
            if tree_mask is not None:
                raise ValueError("tree_mask requires a KV cache (verify window)")
            bias = _alibi_bias(cfg.num_heads, s, x.device) if alibi else None
            out = dot_product_attention(q, k, v, causal=True,
                                        implementation=cfg.attention_impl,
                                        window=window, bias=bias)
        return _dense(self.o_proj, out.reshape(b, s, cfg.num_heads * hd), dt)


#: the non-gated MLPs' activations: GPT-2/GPT-J's tanh gelu, NeoX's exact
#: (erf) gelu, OPT's relu
_ACT = {
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
}


class MLP(nn.Module):
    """``down(act(up(x)))`` for the gelu / gelu_exact / relu variants;
    ``down(gate_act(gate(x)) * up(x))`` for swiglu (silu gate) and geglu
    (tanh-gelu gate)."""

    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        kw = dict(bias=cfg.site_bias("mlp"), device=device, dtype=dtype)
        if cfg.gated_mlp:
            self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        cfg = self.config
        dt = cfg.dtype
        up = _dense(self.up_proj, x, dt)
        if not cfg.gated_mlp:
            return _dense(self.down_proj, _ACT[cfg.mlp_variant](up), dt)
        gate = _dense(self.gate_proj, x, dt)
        gated = F.gelu(gate, approximate="tanh") if cfg.mlp_variant == "geglu" else F.silu(gate)
        return _dense(self.down_proj, gated * up, dt)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.input_norm = make_norm(cfg)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        if cfg.post_attn_norm:
            self.post_attn_norm = make_norm(cfg)
        self.mlp = MLP(cfg, device=device, dtype=dtype)

    def forward(self, x, positions, cache=None, layer: int = 0, tree_mask=None):
        normed = self.input_norm(x)
        attn_out = self.attn(normed, positions, cache=cache, layer=layer, tree_mask=tree_mask)
        if self.config.parallel_residual:
            # GPT-J / NeoX block: both branches read the same input; GPT-J
            # (shared_norm) reuses the attention branch's norm
            mlp_in = normed if self.config.shared_norm else self.post_attn_norm(x)
            return x + attn_out + self.mlp(mlp_in)
        x = x + attn_out
        return x + self.mlp(self.post_attn_norm(x))


class Transformer(nn.Module):
    """Decoder-only LM.  ``forward(input_ids [B,S]) -> logits [B,S,V]`` (f32).

    With ``cache=``\\ :class:`PagedKVCache` (or a slab :class:`KVCache`) the
    call is an incremental forward: positions default to ``cache.index +
    arange(S)``, each layer writes its K/V into the cache in place at
    ``cache.index + arange(S)``, and the result is ``(logits, cache)`` with
    the cache's ``index`` advanced by ``S``.  ``tree_mask`` (``[S, S]`` or a
    :class:`~accelerate_tpu_torch.ops.paged_attention.TreeMask`) makes it a
    tree verify: the ``S`` inputs are tree nodes, attention takes the
    ancestor mask, and ``positions`` must be given (frontier + node depth:
    sibling branches share positions).

    The constructor allocates the weights uninitialised on ``device`` (the
    card unless ``device="cpu"``), matrices, embeddings and projection
    biases in ``dtype`` (default ``config.param_dtype``), norm parameters in
    f32; load values with
    ``load_state_dict`` from :func:`~accelerate_tpu_torch.weights.init_params`
    or :func:`~accelerate_tpu_torch.weights.params_from_jax`.
    """

    def __init__(self, config: TransformerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or config.param_dtype
        self.config = config
        cfg = config
        # build on the meta device, then allocate without running any init:
        # the weights come from a state dict
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
            if cfg.positional == "learned":
                self.pos_embed = nn.Embedding(cfg.max_seq_len + cfg.pos_offset,
                                              cfg.hidden_size, dtype=dtype)
            if cfg.embed_norm:
                self.embed_norm = make_norm(cfg)
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dtype=dtype) for _ in range(cfg.num_layers)
            )
            self.final_norm = make_norm(cfg)
            if not cfg.tie_word_embeddings:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                         bias=cfg.lm_head_bias, dtype=dtype)
        self.to_empty(device=device)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """The layer stack's input: token embeddings in the compute dtype
        (Flax ``nn.Embed(dtype=...)``), Gemma's scale, BLOOM's norm, and the
        learned position rows ``positions + pos_offset``."""
        cfg = self.config
        x = scale_embed(cfg, self.embed_tokens.weight[input_ids].to(cfg.dtype))
        if cfg.embed_norm:
            x = self.embed_norm(x)
        if cfg.positional == "learned":
            # a lane one pipelined window past its end reads rows past the
            # table, whose outputs are never emitted: clamped to the last row
            # (the reference's gather returns NaN there, which a later lane
            # of the same pages could read through a masked 0 x NaN)
            rows = (positions + cfg.pos_offset).clamp(max=self.pos_embed.num_embeddings - 1)
            x = x + self.pos_embed.weight[rows].to(cfg.dtype)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head (the embedding table when tied), f32 logits."""
        cfg = self.config
        x = self.final_norm(x)
        if cfg.tie_word_embeddings:
            return F.linear(x.to(cfg.dtype), self.embed_tokens.weight.to(cfg.dtype)).float()
        return _dense(self.lm_head, x, cfg.dtype).float()

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache=None, tree_mask=None):
        cfg = self.config
        if tree_mask is not None and positions is None:
            raise ValueError("tree_mask requires explicit positions "
                             "(lane frontier + per-node tree depth)")
        tree_mask = as_tree_mask(tree_mask)
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
            positions = positions.expand(input_ids.shape[0], -1)
            if cache is not None:
                positions = positions + cache.index.long()[:, None]
        x = self.embed(input_ids, positions)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, cache=cache, layer=i, tree_mask=tree_mask)
        logits = self.head(x)
        if cache is None:
            return logits
        return logits, dataclasses.replace(cache, index=cache.index + input_ids.shape[1])


def state_dict_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Name -> shape of every weight :class:`Transformer` holds for ``cfg``."""
    hd = cfg.resolved_head_dim
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embed_tokens.weight": (cfg.vocab_size, h)}

    def norm(name):
        shapes[name + ".scale"] = (h,)
        if cfg.norm_type == "layernorm" and cfg.norm_bias:
            shapes[name + ".bias"] = (h,)

    def linear(name, out, inp, bias):
        shapes[name + ".weight"] = (out, inp)
        if bias:
            shapes[name + ".bias"] = (out,)

    if cfg.positional == "learned":
        shapes["pos_embed.weight"] = (cfg.max_seq_len + cfg.pos_offset, h)
    if cfg.embed_norm:
        norm("embed_norm")
    qkv, o, mlp = cfg.site_bias("qkv"), cfg.site_bias("o"), cfg.site_bias("mlp")
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        norm(p + "input_norm")
        linear(p + "attn.q_proj", cfg.num_heads * hd, h, qkv)
        linear(p + "attn.k_proj", cfg.num_kv_heads * hd, h, qkv)
        linear(p + "attn.v_proj", cfg.num_kv_heads * hd, h, qkv)
        linear(p + "attn.o_proj", h, cfg.num_heads * hd, o)
        if cfg.post_attn_norm:
            norm(p + "post_attn_norm")
        if cfg.gated_mlp:
            linear(p + "mlp.gate_proj", f, h, mlp)
        linear(p + "mlp.up_proj", f, h, mlp)
        linear(p + "mlp.down_proj", h, f, mlp)
    norm("final_norm")
    if not cfg.tie_word_embeddings:
        linear("lm_head", cfg.vocab_size, h, cfg.lm_head_bias)
    return shapes


# ------------------------------------------------------------------ training
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy over the positions whose label is not
    ``ignore_index``, with the optional z-loss ``z_loss * logsumexp**2``."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = logz - label_logits
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp(min=1)


def shift_labels(batch) -> torch.Tensor:
    """Next-token labels: ``batch["labels"]`` if given, else ``input_ids``
    shifted left with ``-100`` (ignored) at the final position."""
    labels = batch.get("labels")
    if labels is None:
        ids = batch["input_ids"]
        pad = torch.full((ids.shape[0], 1), -100, dtype=ids.dtype, device=ids.device)
        labels = torch.cat([ids[:, 1:], pad], dim=1)
    return labels


def lm_loss_fn(model: Transformer):
    """Next-token loss for ``Accelerator.compile_train_step``:
    ``loss_fn(params, batch)``, where ``params`` maps every parameter name
    of ``model`` to the tensor to run it with (the train step passes the
    masters cast to the compute dtype) and ``batch["input_ids"]`` is
    ``[B, S]``.  The model is run through :func:`torch.func.functional_call`,
    so gradients flow to whatever tensors ``params`` holds."""

    def loss_fn(params, batch):
        logits = torch.func.functional_call(model, params, (batch["input_ids"],))
        return cross_entropy_loss(logits, shift_labels(batch))

    return loss_fn
