"""Autoregressive generation: the static decode loop, and per-lane token
selection for the serving engine.

Port of :mod:`accelerate_tpu.models.generation`, both halves.

The static half: :func:`sample_tokens` (greedy ``argmax``, or temperature,
top-k and top-p filters then one draw from an explicit
``torch.Generator``), :func:`make_sampler`, :func:`make_prefill_step`,
:func:`make_decode_step` and :func:`generate` over the port's
:class:`~.transformer.Transformer` and its slab
:class:`~.transformer.KVCache`.  The reference's one fused ``lax.scan``
program (``accelerate_tpu/models/generation.py:204``) is a Python loop over
one decode step here, the cache written in place; on the card the step is
one CUDA graph, replayed a token, and nothing in the loop waits for the
card.  Lanes that emitted
``eos_token_id`` emit ``pad_token_id`` from then on (static shapes).  This
is the reference's one published benchmark workload: seconds per token,
resident here and streamed by :class:`~accelerate_tpu_torch.big_modeling.
StreamingTransformer` when the weights do not fit.

The batched half: :class:`GenerationConfig`, :func:`filter_logits_batched`
(temperature, then top-k, then top-p, per lane) and
:func:`sample_tokens_batched`.  Greedy lanes take ``argmax`` — exact.
Sampled lanes draw by inverse CDF
from uniforms that a counter-based hash makes of each lane's key, a device
row ``(seed, counter)`` (:func:`uniforms`), as the reference carries a
device key per lane through its windows
(``accelerate_tpu/serving/pool.py:137-172``).  The engine seeds a lane
from ``(rng_seed, request id)`` (:func:`lane_key`) and each window advances
its counter by a fixed number of draws, so a request's sampled tokens
depend neither on the slot it lands in nor on its neighbours; no host state
takes part, so a CUDA graph of a window replays the draws.  The hash works
on 32-bit halves held in int64 tensors, whose products stay below 2^49: it
gives the same bits on the CPU and the card.  JAX's threefry stream differs
(and Philox, the static half's generator, too), so sampled tokens match the
JAX package in distribution only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from .transformer import KVCache, Transformer


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-loop knobs (the transformers ``GenerationConfig`` analog)."""

    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def lane_key(rng_seed: int, rid: int) -> int:
    """A request's sampling seed, from ``(rng_seed, rid)`` only: a
    non-negative int below 2^63 (the first column of a lane's key)."""
    state = np.random.SeedSequence([int(rng_seed), int(rid)]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for ``a`` in ``[0, 2^32)`` (int64) and a 32-bit
    constant ``b``, by 16-bit limbs of ``a``: no product reaches 2^63."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer bijection with low bias (the ``lowbias32`` finalizer)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` uniforms in ``[0, 1)`` per lane, f32 ``[N, n]``: draw ``j`` of
    lane ``i`` hashes its seed ``keys[i, 0]`` with the counter ``keys[i, 1]
    + j``.  Reads the keys only; the caller advances the counters."""
    seed, counter = keys[:, 0:1], keys[:, 1:2]
    c = (counter + torch.arange(n, device=keys.device)[None, :]) & _M32
    h = _mix32(_mix32(_mix32(c) ^ (seed & _M32)) ^ (seed >> 32))
    return (h >> 8).to(torch.float32) * 2.0**-24


def filter_logits_batched(logits: torch.Tensor, *, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-lane sampling filters: ``[N, V]`` raw logits + knob vectors ->
    filtered f32 logits (suppressed entries at ``finfo.min``): temperature,
    then top-k, then top-p.  ``top_k <= 0`` and ``top_p >= 1`` disable their
    filters per lane."""
    v = logits.shape[-1]
    neg_inf = torch.finfo(torch.float32).min
    lf = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: kth-largest per lane via one sort; lanes with top_k <= 0 keep all
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    kidx = torch.clamp(top_k.long(), 1, v) - 1
    kth = torch.gather(sorted_desc, 1, kidx[:, None])
    lf = torch.where((top_k > 0)[:, None] & (lf < kth), neg_inf, lf)
    # top-p on the (possibly top-k-filtered) logits; second sort because the
    # k-filter changed the tail
    sorted_p = torch.sort(lf, dim=-1, descending=True).values
    probs = torch.softmax(sorted_p, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    outside = (cum - probs) >= top_p[:, None]
    min_kept = torch.where(outside, torch.inf, sorted_p).min(dim=-1, keepdim=True).values
    return torch.where((top_p < 1.0)[:, None] & (lf < min_kept), neg_inf, lf)


def sample_filtered(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One inverse-CDF draw per row of filtered logits ``[..., V]`` with the
    uniform ``u [...]``: the first token of nonzero probability whose
    cumulative probability exceeds ``u`` times the total.  Always a token
    of the support, even where a parallel cumulative sum rounds unevenly
    (then the last token of the support).  Returns int32 ``[...]``."""
    shape = logits.shape[:-1]
    v = logits.shape[-1]
    probs = torch.softmax(logits.reshape(-1, v), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    support = probs > 0
    hit = support & (cdf > (u.reshape(-1, 1) * cdf[:, -1:]))
    first = torch.argmax(hit.to(torch.int32), dim=-1)
    last = v - 1 - torch.argmax(support.flip(-1).to(torch.int32), dim=-1)
    return torch.where(hit.any(dim=-1), first, last).to(torch.int32).reshape(shape)


def sample_tokens_batched(logits: torch.Tensor, u: torch.Tensor, sampled: torch.Tensor, *,
                          temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """Per-lane token choice: ``[N, V]`` logits -> ``[N]`` int32 tokens.

    Lanes with ``sampled[n]`` false take ``argmax``; the others draw from
    their filtered distribution with the uniform ``u[n]``.  Every lane's
    vocabulary is sorted: an engine whose lanes are all greedy takes the
    ``argmax`` alone and never calls this."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    lf = filter_logits_batched(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    return torch.where(sampled, sample_filtered(lf, u), tokens)


# ------------------------------------------------------------- static loop
def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None
                  ) -> torch.Tensor:
    """``[B, V]`` logits -> ``[B]`` int32 tokens (``accelerate_tpu/models/
    generation.py:51``).  Greedy unless ``do_sample`` (and a temperature
    above 0); sampling applies temperature, then top-k, then top-p, and
    draws once a row from ``generator``."""
    if not do_sample or temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("do_sample=True needs an rng: pass a torch.Generator")
    logits = logits.float() / max(temperature, 1e-6)
    neg_inf = torch.finfo(torch.float32).min
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # a slot is outside the nucleus when the mass before it already
        # reaches top_p; the first slot is always kept
        outside = (cum - probs) >= top_p
        min_kept = torch.where(outside, torch.inf, sorted_desc).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < min_kept, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@functools.lru_cache(maxsize=32)
def make_sampler(do_sample: bool = False, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None):
    """``(logits [B, V], generator) -> tokens [B]`` for fixed knobs
    (``:160``)."""
    return functools.partial(sample_tokens, do_sample=do_sample, temperature=temperature,
                             top_k=top_k, top_p=top_p)


def _apply(model: Transformer, params, input_ids: torch.Tensor, cache: KVCache):
    """``model`` over ``input_ids`` with ``cache``, holding its own weights
    (``params`` None) or the state dict ``params``."""
    with torch.no_grad():
        if params is None:
            return model(input_ids, cache=cache)
        return torch.func.functional_call(model, params, (input_ids,), {"cache": cache})


def make_prefill_step(model: Transformer):
    """``(params, input_ids [B, S], cache) -> (logits [B, S, V], cache)``: the
    prompt written into the cache at each lane's index (``:178``).
    ``params`` None runs the model's own weights."""

    def prefill(params, input_ids, cache):
        return _apply(model, params, input_ids, cache)

    return prefill


def make_decode_step(model: Transformer):
    """``(params, tokens [B], cache) -> (logits [B, V], cache)``: one token a
    lane (``:188``).  The cache is written in place, so a step costs the
    weight reads and one row of the cache, not a copy of it."""

    def decode(params, tokens, cache):
        logits, cache = _apply(model, params, tokens[:, None], cache)
        return logits[:, -1], cache

    return decode


def check_cache_room(used: int, prompt: int, max_new_tokens: int, max_len: int) -> None:
    """Refuse a generation that would overrun the cache: a slab write past
    its end is clamped onto the last rows, which would corrupt them."""
    if used + prompt + max_new_tokens > max_len:
        raise ValueError(
            f"cache max_len {max_len} < {used} already written + prompt {prompt} "
            f"+ max_new_tokens {max_new_tokens}; create the cache with "
            f"max_len >= {used + prompt + max_new_tokens}")


def make_graphed_decode_step(model: Transformer, params, tokens: torch.Tensor,
                             cache: KVCache):
    """The decode step on the card as one CUDA graph: ``step(tokens [B]) ->
    logits [B, V]``, captured as the serving engine captures its windows
    (:class:`~accelerate_tpu_torch.serving.graphs.WindowGraphs`) over
    ``tokens``' copy and ``cache``: each replay writes the cache's K/V in
    place and advances its index in place.  The warm-up before the capture
    writes the rows the first replay writes again, and its index is put
    back.  The logits are a static buffer, rewritten by the next replay."""
    from ..serving.graphs import WindowGraphs

    static, start = tokens.clone(), cache.index.clone()

    def decode():
        logits, new = _apply(model, params, static[:, None], cache)
        cache.index.copy_(new.index)
        return logits[:, -1]

    graphs = WindowGraphs(tokens.device)
    graphs.capture("decode", decode, reset=lambda: cache.index.copy_(start))

    def step(tok: torch.Tensor) -> torch.Tensor:
        static.copy_(tok)
        return graphs.replay("decode")

    return step


def generate(model: Transformer, params, input_ids: torch.Tensor,
             generation_config: Optional[GenerationConfig] = None,
             generator: Optional[torch.Generator] = None, cache: Optional[KVCache] = None,
             **overrides: Any):
    """``max_new_tokens`` continuations of ``input_ids [B, S]`` (``:243``).

    Returns ``(sequences [B, S + max_new_tokens], cache)``.  ``params`` is a
    state dict for ``model`` (a shell on ``meta`` will do) or None for its
    own weights, and the loop runs where they are; ``cache`` a warm
    :class:`~.transformer.KVCache` to continue (each lane's index says how
    much it holds), else a fresh one of ``S + max_new_tokens`` positions.
    The final token is returned but never fed back, so the cache ends at
    ``S + max_new_tokens - 1`` written positions.  On the card the decode
    step replays one CUDA graph (:func:`make_graphed_decode_step`: the
    kernels of :func:`make_decode_step`'s step, without the host's launch
    time)."""
    gen = generation_config or GenerationConfig()
    if overrides:
        gen = dataclasses.replace(gen, **overrides)
    b, s = input_ids.shape
    device = next(iter(params.values())).device if params else model.device
    if cache is None:
        cache = KVCache.create(model.config, b, s + gen.max_new_tokens, device=device)
    else:
        check_cache_room(int(cache.index.max()), s, gen.max_new_tokens, cache.k.shape[2])
    input_ids = input_ids.to(device)
    sample = make_sampler(gen.do_sample, gen.temperature, gen.top_k, gen.top_p)
    logits, cache = make_prefill_step(model)(params, input_ids, cache)
    tok = sample(logits[:, -1], generator)
    done = (tok == gen.eos_token_id if gen.eos_token_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    toks = [tok]
    if gen.max_new_tokens > 1 and device.type == "cuda":
        step = make_graphed_decode_step(model, params, tok, cache)
    else:
        eager = make_decode_step(model)

        def step(t):
            nonlocal cache
            out, cache = eager(params, t, cache)
            return out

    for _ in range(gen.max_new_tokens - 1):
        tok = torch.where(done, gen.pad_token_id, sample(step(tok), generator)).to(torch.int32)
        if gen.eos_token_id is not None:
            done = done | (tok == gen.eos_token_id)
        toks.append(tok)
    seq = torch.cat([input_ids, torch.stack(toks, dim=1).to(input_ids.dtype)], dim=1)
    return seq, cache
