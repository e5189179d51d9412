"""The engine's device programs on the paged pool: prefill chunk, decode window.

Port of the direct paged arms of :mod:`accelerate_tpu.serving.pool`.  The
JAX package compiles one executable per shape and donates the page arrays;
PyTorch runs eagerly and the model's forward writes the pages in place, so
each program here is a plain function:

* :func:`prefill_chunk` — one prompt chunk through the model on a
  :class:`~accelerate_tpu_torch.models.transformer.PagedKVCache` with the
  prefill kernel (K2): the chunk's K/V land in the lane's pages and its
  queries attend over prior pages in place.
* :func:`decode_window` — ``window`` masked decode steps over every lane with
  the decode kernel (K1): the JAX ``_decode_scan`` as a Python loop.  Frozen
  lanes (inactive, or past their EOS) keep their index, and ``active = ~done``
  routes their writes to the null page each step.
* :class:`LaneState` — the per-lane decode vectors on the device; installing a
  request edits one slot of them in place.
* :func:`plan_chunks` — split a prompt into bucket-sized prefill chunks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..models.generation import sample_tokens_batched
from ..models.transformer import PagedKVCache, Transformer


def plan_chunks(prompt_len: int, buckets: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Split a prompt into prefill chunks drawn from the fixed bucket sizes.

    Returns ``((bucket_len, valid_len), ...)``: greedy largest-fit, so only
    the final chunk can be padded (``valid_len < bucket_len``)."""
    buckets = sorted(set(int(b) for b in buckets))
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"prefill buckets must be positive, got {buckets}")
    chunks = []
    remaining = prompt_len
    while remaining > 0:
        fit = [b for b in buckets if b <= remaining]
        b = max(fit) if fit else buckets[0]
        chunks.append((b, min(b, remaining)))
        remaining -= min(b, remaining)
    return tuple(chunks)


@dataclasses.dataclass
class LaneState:
    """Per-lane decode vectors on the device, ``[num_slots]`` each.

    ``pending`` is the token each lane feeds next; ``active`` gates lanes in
    the decode window; ``eos`` (-1 = none), ``temperature``, ``top_k`` (0 =
    off) and ``top_p`` (1 = off) are the sampling knobs.  ``generators`` is
    host state: a lane's own sampling stream, ``None`` for a greedy lane."""

    pending: torch.Tensor
    active: torch.Tensor
    eos: torch.Tensor
    temperature: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    generators: List[Optional[torch.Generator]]

    @classmethod
    def create(cls, num_slots: int, device) -> "LaneState":
        def full(value, dtype):
            return torch.full((num_slots,), value, dtype=dtype, device=device)

        return cls(
            pending=full(0, torch.int32), active=full(False, torch.bool),
            eos=full(-1, torch.int32), temperature=full(1.0, torch.float32),
            top_k=full(0, torch.int32), top_p=full(1.0, torch.float32),
            generators=[None] * num_slots,
        )

    def install(self, slot: int, token: int, eos: int, temperature: float,
                top_k: int, top_p: float, generator: Optional[torch.Generator]) -> None:
        """Hand lane ``slot`` to a prefilled request: plain in-place edits."""
        self.pending[slot] = token
        self.active[slot] = True
        self.eos[slot] = eos
        self.temperature[slot] = temperature
        self.top_k[slot] = top_k
        self.top_p[slot] = top_p
        self.generators[slot] = generator

    def retire(self, slot: int) -> None:
        self.active[slot] = False
        self.generators[slot] = None


@torch.inference_mode()
def prefill_chunk(model: Transformer, tokens: torch.Tensor, pages_k, pages_v,
                  k_scales, v_scales, table: torch.Tensor, base: int) -> None:
    """Run one ``[1, chunk_len]`` prompt chunk at positions ``base ..`` of the
    lane whose block table is ``table [P]``; its K/V are written into the
    page arrays in place."""
    device = tokens.device
    cache = PagedKVCache(
        pages_k=pages_k, pages_v=pages_v, k_scales=k_scales, v_scales=v_scales,
        tables=table[None], index=torch.tensor([base], dtype=torch.int32, device=device),
        active=torch.ones(1, dtype=torch.bool, device=device), kernel="prefill",
    )
    model(tokens, cache=cache)


@torch.inference_mode()
def decode_window(model: Transformer, window: int, pages_k, pages_v, k_scales,
                  v_scales, tables: torch.Tensor, index: torch.Tensor,
                  lanes: LaneState, pad: int) -> torch.Tensor:
    """``window`` masked decode steps over the whole slot pool.

    Each step feeds every lane's pending token at its own position, writes
    its KV there, and picks the next token per lane; lanes that are inactive
    or have emitted their EOS freeze — their index stops advancing, their
    writes go to the null page and their outputs are ``pad``.  Updates
    ``lanes.pending`` in place and returns the tokens ``[N, window]`` (on the
    device)."""
    cache = PagedKVCache(pages_k=pages_k, pages_v=pages_v, k_scales=k_scales,
                         v_scales=v_scales, tables=tables, index=index,
                         active=lanes.active.clone(), kernel="decode")
    tok = lanes.pending
    done = ~lanes.active
    out = []
    for _ in range(window):
        prev_index = cache.index
        cache.active = ~done
        logits, cache = model(tok[:, None], cache=cache)
        # the forward advanced every lane; frozen lanes roll back
        cache.index = torch.where(done, prev_index, prev_index + 1)
        nxt = sample_tokens_batched(
            logits[:, -1], lanes.generators, temperature=lanes.temperature,
            top_k=lanes.top_k, top_p=lanes.top_p,
        )
        nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
        done = done | ((lanes.eos >= 0) & (nxt == lanes.eos))
        out.append(nxt)
        tok = nxt
    lanes.pending.copy_(tok)
    return torch.stack(out, dim=1)
