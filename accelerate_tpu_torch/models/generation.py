"""Per-lane token selection for the serving engine.

Port of the batched half of :mod:`accelerate_tpu.models.generation`:
:class:`GenerationConfig`, :func:`filter_logits_batched` (temperature, then
top-k, then top-p, per lane) and :func:`sample_tokens_batched`.

Greedy lanes take ``argmax`` — exact.  Sampled lanes draw from their own
``torch.Generator``; the engine seeds each from ``(rng_seed, request id)``
(:func:`lane_generator`), so a request's sampled tokens depend neither on
the slot it lands in nor on its neighbours.  JAX's threefry and torch's
Philox streams differ, so sampled tokens match the JAX package in
distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

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


def lane_generator(rng_seed: int, rid: int,
                   device: Union[str, torch.device]) -> torch.Generator:
    """A request's own sampling stream: seeded from ``(rng_seed, rid)`` only."""
    seed = np.random.SeedSequence([int(rng_seed), int(rid)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


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


def sample_tokens_batched(logits: torch.Tensor,
                          generators: Sequence[Optional[torch.Generator]], *,
                          temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """Per-lane token choice: ``[N, V]`` logits -> ``[N]`` int32 tokens.

    ``generators[n]`` is lane ``n``'s sampling stream, or ``None`` for a
    greedy lane (``do_sample=False`` or temperature 0), which takes
    ``argmax``.  Which lanes sample is host state, so an all-greedy pool —
    the common serving mix — never sorts the vocabulary or synchronises."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    lanes = [i for i, g in enumerate(generators) if g is not None]
    if not lanes:
        return tokens
    lf = filter_logits_batched(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(lf, dim=-1)
    for i in lanes:
        tokens[i] = torch.multinomial(probs[i], 1, generator=generators[i])[0].to(torch.int32)
    return tokens
