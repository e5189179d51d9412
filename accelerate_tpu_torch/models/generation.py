"""Per-lane token selection for the serving engine.

Port of the batched half of :mod:`accelerate_tpu.models.generation`:
:class:`GenerationConfig`, :func:`filter_logits_batched` (temperature, then
top-k, then top-p, per lane) and :func:`sample_tokens_batched`.

Greedy lanes take ``argmax`` — exact.  Sampled lanes draw by inverse CDF
from uniforms that a counter-based hash makes of each lane's key, a device
row ``(seed, counter)`` (:func:`uniforms`), as the reference carries a
device key per lane through its windows
(``accelerate_tpu/serving/pool.py:137-172``).  The engine seeds a lane
from ``(rng_seed, request id)`` (:func:`lane_key`) and each window advances
its counter by a fixed number of draws, so a request's sampled tokens
depend neither on the slot it lands in nor on its neighbours; no host state
takes part, so a CUDA graph of a window replays the draws.  The hash works
on 32-bit halves held in int64 tensors, whose products stay below 2^49: it
gives the same bits on the CPU and the card.  JAX's threefry stream differs,
so sampled tokens match the JAX package in distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-loop knobs (the transformers ``GenerationConfig`` analog)."""

    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None


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
