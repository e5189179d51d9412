"""Llama-recipe decoder-only transformer in PyTorch.

Port of :mod:`accelerate_tpu.models.transformer`, Llama recipe only:
pre-norm RMSNorm (f32 statistics), rotary embeddings (rotate-half in f32),
grouped-query attention and a SwiGLU MLP.  The numerics follow the Flax
model: every projection casts its input and weight to ``config.dtype``
before the product (Flax ``nn.Dense(dtype=...)``), norm scales stay f32, and
logits come out in f32.

Three attention branches, as in the JAX ``Attention``:

* with a :class:`PagedKVCache` — the serving path: the new K/V are scattered
  into the page pool in place (int8 and fp8 pages requantized per touched
  page), then attention reads the pages through the block tables with the
  decode kernel (K1) or the prefill kernel (K2).  A ``tree_mask`` (a
  speculative tree verify) takes K1's tree-mask arm;
* with a slab :class:`KVCache` (per-lane index) — the slab serving pool
  (``ServingEngine(paged=False)``), its batch-1 prefill scratch and the
  stateless draft forward of tree speculation: the new K/V are written at
  each lane's own index and :func:`cached_attention` (plain PyTorch, as
  XLA code is in the reference) reads the slab;
* without a cache — the training path and the independent forward the
  serving path is checked against: causal
  :func:`~accelerate_tpu_torch.ops.attention.dot_product_attention` with
  ``config.attention_impl``, ``"xla"`` (plain math, no kernel) or
  ``"pallas"`` (the flash kernels K3–K5, differentiable).

:func:`lm_loss_fn` is the next-token loss the ``Accelerator`` train step
differentiates, with the JAX signature ``loss_fn(params, batch)``.

Family switches the JAX config also carries (layernorm, learned or alibi
positions, gelu MLPs, parallel residual, partial or interleaved rope, sliding
window, MoE) raise ``NotImplementedError``: they are later slices.
"""

from __future__ import annotations

import dataclasses
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

#: Llama-recipe values of the JAX config's family switches; any other value
#: is a family this slice has not ported
_LLAMA_SWITCHES = {
    "tie_word_embeddings": False,
    "norm_type": "rmsnorm",
    "use_bias": False,
    "positional": "rope",
    "mlp_variant": "swiglu",
    "parallel_residual": False,
    "rope_dim": None,
    "rope_interleaved": False,
    "sliding_window": None,
    "num_experts": 0,
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
    norm_type: str = "rmsnorm"
    use_bias: bool = False
    positional: str = "rope"
    mlp_variant: str = "swiglu"
    parallel_residual: bool = False
    rope_dim: Optional[int] = None
    rope_interleaved: bool = False
    sliding_window: Optional[int] = None
    num_experts: int = 0
    attention_impl: str = "xla"                # no-cache attention: "xla" | "pallas"
    dtype: torch.dtype = torch.bfloat16        # activation / compute dtype
    param_dtype: torch.dtype = torch.float32   # default weight storage dtype

    def __post_init__(self):
        for name, llama in _LLAMA_SWITCHES.items():
            if getattr(self, name) != llama:
                raise NotImplementedError(
                    f"TransformerConfig({name}={getattr(self, name)!r}): only the "
                    f"Llama recipe is ported ({name}={llama!r}); other families "
                    "are ROADMAP Queue 1 item 2"
                )
        check_implementation(self.attention_impl)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"num_heads {self.num_heads} must be a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**{**dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                             num_layers=32, num_heads=32, num_kv_heads=32), **kw})

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


def cached_attention(q, k, v, q_positions, tree_mask=None):
    """Attention of ``q [B,S,Hq,D]`` against a full cache ``k``/``v [B,M,Hkv,D]``.

    Causal arm: key slot ``j`` is visible to query ``i`` iff ``j <=
    q_positions[b, i]``.  Tree arm (``tree_mask``, an ``[S, S]``
    ancestor-or-self mask or a
    :class:`~accelerate_tpu_torch.ops.paged_attention.TreeMask`): the ``S``
    tree nodes sit at the slots from each lane's frontier ``q_positions[:,
    0]`` on, and node ``i`` sees the history ``j < frontier`` plus the tree
    nodes of its row of the mask (``accelerate_tpu/models/transformer.py:
    386-405``).  GQA groups fold into the query tensor so the cache is
    contracted unexpanded; logits are formed in ``q.dtype``, then softmax in
    f32, and the probabilities are cast back to ``q.dtype`` for the PV
    product."""
    b, s, n_q, d = q.shape
    n_kv = k.shape[2]
    rep = n_q // n_kv
    qg = q.reshape(b, s, n_kv, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * d ** -0.5
    j = torch.arange(k.shape[1], device=q.device)
    tree = as_tree_mask(tree_mask)
    if tree is not None:
        anc_mask = tree.dense(q.device)                         # [S, S]
        base = q_positions[:, 0].long()                         # [B] lane frontier
        rel = j[None, :] - base[:, None]                        # [B, M] slot -> node
        within = (rel >= 0) & (rel < s)
        anc = anc_mask[:, rel.clamp(0, s - 1)].permute(1, 0, 2)  # [B, S, M]
        allowed = (j[None, None, :] < base[:, None, None]) | (within[:, None, :] & anc)
        mask = allowed[:, None, None, :, :]
    else:
        mask = j[None, None, None, None, :] <= q_positions[:, None, None, :, None]
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, s, n_q, d)


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


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=...)`` numerics: input and weight in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        normed = xf * torch.rsqrt(var + self.eps)
        return (normed * self.scale).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        hd = cfg.resolved_head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd, **kw)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, **kw)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, **kw)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, **kw)

    def forward(self, x, positions, cache=None, layer: int = 0, tree_mask=None):
        cfg = self.config
        dt = cfg.dtype
        hd = cfg.resolved_head_dim
        b, s = x.shape[:2]
        q = _dense(self.q_proj, x, dt).reshape(b, s, cfg.num_heads, hd)
        k = _dense(self.k_proj, x, dt).reshape(b, s, cfg.num_kv_heads, hd)
        v = _dense(self.v_proj, x, dt).reshape(b, s, cfg.num_kv_heads, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        if isinstance(cache, KVCache):
            # slab: write each lane at its own index (clamped as the
            # reference's dynamic_update_slice clamps), attend over the slab
            k_cache, v_cache = cache.k[layer], cache.v[layer]
            start = cache.index.long().clamp(0, k_cache.shape[1] - s)
            slots = start[:, None] + torch.arange(s, device=x.device)[None, :]
            lanes = torch.arange(b, device=x.device)[:, None]
            k_cache[lanes, slots] = k.to(k_cache.dtype)
            v_cache[lanes, slots] = v.to(v_cache.dtype)
            out = cached_attention(q, k_cache, v_cache, positions, tree_mask=tree_mask)
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
            if cache.kernel == "prefill":
                if tree_mask is not None:
                    raise ValueError("tree verification is a decode-side program: the "
                                     "prefill kernel cannot carry a tree_mask")
                prefill = paged_flash_prefill_reference if cache.plain else paged_flash_prefill
                out = prefill(q, pages_k, pages_v, cache.tables, cache.index,
                              k_scales=k_scales, v_scales=v_scales)
            else:
                decode = paged_attention_reference if cache.plain else paged_attention
                out = decode(q, pages_k, pages_v, cache.tables, cache.index,
                             k_scales=k_scales, v_scales=v_scales, tree_mask=tree_mask)
        else:
            if tree_mask is not None:
                raise ValueError("tree_mask requires a KV cache (verify window)")
            out = dot_product_attention(q, k, v, causal=True,
                                        implementation=cfg.attention_impl)
        return _dense(self.o_proj, out.reshape(b, s, cfg.num_heads * hd), dt)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        dt = self.config.dtype
        gate = _dense(self.gate_proj, x, dt)
        up = _dense(self.up_proj, x, dt)
        return _dense(self.down_proj, F.silu(gate) * up, dt)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)
        self.mlp = MLP(cfg, device=device, dtype=dtype)

    def forward(self, x, positions, cache=None, layer: int = 0, tree_mask=None):
        x = x + self.attn(self.input_norm(x), positions, cache=cache, layer=layer,
                          tree_mask=tree_mask)
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
    card unless ``device="cpu"``), matrices in ``dtype`` (default
    ``config.param_dtype``), norm scales in f32; load values with
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
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dtype=dtype) for _ in range(cfg.num_layers)
            )
            self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                     dtype=dtype)
        self.to_empty(device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

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
        # Flax nn.Embed(dtype=...): the table is cast to the compute dtype
        x = self.embed_tokens.weight[input_ids].to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, cache=cache, layer=i, tree_mask=tree_mask)
        x = self.final_norm(x)
        logits = _dense(self.lm_head, x, cfg.dtype).float()
        if cache is None:
            return logits
        return logits, dataclasses.replace(cache, index=cache.index + input_ids.shape[1])


def state_dict_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Name -> shape of every weight :class:`Transformer` holds."""
    hd = cfg.resolved_head_dim
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        shapes.update({
            p + "input_norm.scale": (h,),
            p + "attn.q_proj.weight": (cfg.num_heads * hd, h),
            p + "attn.k_proj.weight": (cfg.num_kv_heads * hd, h),
            p + "attn.v_proj.weight": (cfg.num_kv_heads * hd, h),
            p + "attn.o_proj.weight": (h, cfg.num_heads * hd),
            p + "post_attn_norm.scale": (h,),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f),
        })
    shapes["final_norm.scale"] = (h,)
    shapes["lm_head.weight"] = (cfg.vocab_size, h)
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
