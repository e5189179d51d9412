"""The engine's device programs on the paged pool: prefill, decode and verify windows.

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
* :func:`verify_window` — speculative decoding's linear verify: one forward
  over ``[slots, K+1]`` (each lane's pending token and K drafts) through
  K1's causal arm, then the acceptance rule per lane
  (``accelerate_tpu/serving/pool.py:267-335``).
* :func:`tree_verify_window` — the tree verify: one forward over ``[slots,
  nodes]`` draft-tree tokens through K1's tree-mask arm, the winning
  root-to-leaf path per lane, and :func:`tree_commit_paged`, which moves
  that path's KV to the lane's frontier (``:390-538``, ``:960-1063``).

Sampled lanes draw from their own ``torch.Generator`` in a fixed order
(linear: K uniform accept draws, K residual resamples, 1 bonus draw; tree:
``W + 2D`` draws), so a seed reproduces a run; all-greedy pools never touch
a generator or sort the vocabulary.

Every program returns the call's largest KV quantization round-trip error as an f32
device scalar (0 for native pages), the reference's ``quant_err`` output
(``accelerate_tpu/serving/pool.py:745-849``); nothing here reads it back.
* :class:`LaneState` — the per-lane decode vectors on the device; installing a
  request edits one slot of them in place.
* :func:`plan_chunks` — split a prompt into bucket-sized prefill chunks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..models.generation import filter_logits_batched, sample_tokens_batched
from ..models.transformer import PagedKVCache, Transformer
from ..ops.paged_attention import (
    TreeMask,
    _bytes_view,
    kv_qmax,
    paged_insert,
    paged_quantized_insert,
)


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


def _quant_err(cache: PagedKVCache, device) -> torch.Tensor:
    if cache.quant_err is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return cache.quant_err


@torch.inference_mode()
def prefill_chunk(model: Transformer, tokens: torch.Tensor, pages_k, pages_v,
                  k_scales, v_scales, table: torch.Tensor, base: int) -> torch.Tensor:
    """Run one ``[1, chunk_len]`` prompt chunk at positions ``base ..`` of the
    lane whose block table is ``table [P]``; its K/V are written into the
    page arrays (and, for quantized pages, their scales) in place.  Returns
    the chunk's quantization error, a device scalar."""
    device = tokens.device
    cache = PagedKVCache(
        pages_k=pages_k, pages_v=pages_v, k_scales=k_scales, v_scales=v_scales,
        tables=table[None], index=torch.tensor([base], dtype=torch.int32, device=device),
        active=torch.ones(1, dtype=torch.bool, device=device), kernel="prefill",
    )
    _, cache = model(tokens, cache=cache)
    return _quant_err(cache, device)


@torch.inference_mode()
def decode_window(model: Transformer, window: int, pages_k, pages_v, k_scales,
                  v_scales, tables: torch.Tensor, index: torch.Tensor,
                  lanes: LaneState, pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window`` masked decode steps over the whole slot pool.

    Each step feeds every lane's pending token at its own position, writes
    its KV there, and picks the next token per lane; lanes that are inactive
    or have emitted their EOS freeze — their index stops advancing, their
    writes go to the null page and their outputs are ``pad``.  Updates
    ``lanes.pending`` in place and returns the tokens ``[N, window]`` and the
    window's quantization error (both on the device)."""
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
    return torch.stack(out, dim=1), _quant_err(cache, tok.device)


# ------------------------------------------------------------------ speculation
_NEG = torch.finfo(torch.float32).min


def _commit(emit: torch.Tensor, acc: torch.Tensor, active: torch.Tensor,
            eos: torch.Tensor, pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accept/commit rule shared by both verify windows: a lane commits
    its emitted tokens up to its first rejection (the token at the first
    rejected position is the model's own, so one always lands), stops after
    its first EOS, and an inactive lane commits nothing.  Returns ``(out,
    n_commit)``: committed tokens with ``pad`` after them, and their count."""
    width = emit.shape[1]
    n_accept = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    committable = torch.arange(width, device=emit.device)[None, :] <= n_accept[:, None]
    is_eos = (emit == eos[:, None]) & (eos >= 0)[:, None]
    eos_before = (torch.cumsum(is_eos.to(torch.int32), dim=1) - is_eos.to(torch.int32)) > 0
    commit = committable & ~eos_before & active[:, None]
    n_commit = commit.sum(dim=1).to(torch.int32)
    out = torch.where(commit, emit, torch.full_like(emit, pad))
    return out, n_commit


def _pending(out: torch.Tensor, n_commit: torch.Tensor) -> torch.Tensor:
    """Each lane's last committed token: the next cycle's pending token."""
    last = torch.clamp(n_commit.long() - 1, min=0)
    return out.gather(1, last[:, None])[:, 0]


def _filtered(logits: torch.Tensor, lanes: LaneState) -> torch.Tensor:
    """Every position's logits ``[N, S, V]`` through its lane's sampling
    filters (temperature, top-k, top-p)."""
    n, s, v = logits.shape

    def rep(x):
        return x.repeat_interleave(s)

    return filter_logits_batched(logits.reshape(n * s, v), temperature=rep(lanes.temperature),
                                 top_k=rep(lanes.top_k), top_p=rep(lanes.top_p)).reshape(n, s, v)


def _draw(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits [..., V]``."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=gen).reshape(probs.shape[:-1]).to(torch.int32)


def _uniform(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _without(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``logits [..., V]`` with ``token [...]`` suppressed: the residual after
    a point-mass draft was rejected."""
    hit = torch.nn.functional.one_hot(token.long(), logits.shape[-1]).bool()
    return torch.where(hit, _NEG, logits)


def _paged_cache(pages_k, pages_v, k_scales, v_scales, tables, index, active):
    return PagedKVCache(pages_k=pages_k, pages_v=pages_v, k_scales=k_scales,
                        v_scales=v_scales, tables=tables, index=index, active=active,
                        kernel="decode")


@torch.inference_mode()
def verify_window(model: Transformer, pages_k, pages_v, k_scales, v_scales,
                  tables: torch.Tensor, index: torch.Tensor, tokens: torch.Tensor,
                  lanes: LaneState, pad: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One linear speculative verify over the whole slot pool.

    ``tokens [N, K+1]``: each lane's pending token, then its K drafts.  One
    forward writes all K+1 positions at each lane's index (inactive lanes'
    writes go to the null page) and gives the true next-token logits at
    every position.  Greedy lanes accept a draft while it equals the argmax
    and commit the argmaxes: the tokens plain decode would emit.  Sampled
    lanes take the Leviathan accept/resample rule for a point-mass drafter:
    draft ``d`` at position ``i`` is accepted with probability ``p_i(d)``
    under the lane's filtered distribution, else the token is resampled from
    ``p_i`` with ``d`` removed; one bonus token is drawn at the last
    position.  Commits stop at the first EOS.  Updates ``lanes.pending`` in
    place and returns ``(out [N, K+1], n_commit [N], quantization error)``
    on the device; the caller advances each lane's index by ``n_commit``."""
    n, kp1 = tokens.shape
    k = kp1 - 1
    cache = _paged_cache(pages_k, pages_v, k_scales, v_scales, tables, index,
                         lanes.active.clone())
    logits, cache = model(tokens, cache=cache)                   # [N, K+1, V] f32
    drafts = tokens[:, 1:]
    emit = torch.argmax(logits, dim=-1).to(torch.int32)
    acc = emit[:, :k] == drafts
    sampled = [i for i, g in enumerate(lanes.generators) if g is not None]
    if sampled:
        filt = _filtered(logits, lanes)
        for i in sampled:
            gen = lanes.generators[i]
            u = _uniform(k, gen, tokens.device)
            p_draft = torch.softmax(filt[i, :k], dim=-1).gather(1, drafts[i, :, None].long())[:, 0]
            accepted = u < p_draft
            res = _draw(_without(filt[i, :k], drafts[i]), gen)
            bonus = _draw(filt[i, k], gen)
            emit[i] = torch.cat([torch.where(accepted, drafts[i], res), bonus[None]])
            acc[i] = accepted
    out, n_commit = _commit(emit, acc, lanes.active, lanes.eos, pad)
    lanes.pending.copy_(_pending(out, n_commit))
    return out, n_commit, _quant_err(cache, tokens.device)


def tree_commit_paged(cache: PagedKVCache, prev_index: torch.Tensor,
                      path: torch.Tensor) -> None:
    """Commit a tree verify's winning path inside the page pool, in place
    (``accelerate_tpu/serving/pool.py:960-1013``): per layer, gather the
    ``D+1`` path nodes' K/V rows through each lane's block table into new
    tensors, then insert them at the lane frontier.  Quantized pools
    dequantize the gathered rows and requantize every page the insert
    touches (its round-trip error folds into ``cache.quant_err``).  Losing
    branches' rows past ``frontier + D`` are never visible: they lie past
    the lane's length."""
    page = cache.pages_k.shape[2]
    p_max = cache.tables.shape[1] - 1
    pos = prev_index.long()[:, None] + path.long()                   # [N, D+1]
    pid = torch.gather(cache.tables.long(), 1, torch.clamp(pos // page, 0, p_max))
    off = pos % page
    quantized = kv_qmax(cache.pages_k.dtype) is not None
    for layer in range(cache.pages_k.shape[0]):
        for pages, scales in ((cache.pages_k[layer], cache.k_scales[layer]),
                              (cache.pages_v[layer], cache.v_scales[layer])):
            rows = _bytes_view(pages)[pid, off].view(pages.dtype)    # a copy: [N, D+1, H, Dh]
            if quantized:
                rows = rows.float() * scales[pid][..., None]
                _, _, err = paged_quantized_insert(pages, scales, rows, cache.tables,
                                                   prev_index, cache.active)
                cache.quant_err = err if cache.quant_err is None \
                    else torch.maximum(cache.quant_err, err)
            else:
                paged_insert(pages, rows, cache.tables, prev_index, cache.active)


@torch.inference_mode()
def tree_verify_window(model: Transformer, tree, tree_mask: TreeMask, pages_k, pages_v,
                       k_scales, v_scales, tables: torch.Tensor, index: torch.Tensor,
                       tokens: torch.Tensor, lanes: LaneState, pad: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tree speculative verify over the whole slot pool.

    ``tree`` is a :class:`~accelerate_tpu_torch.serving.spec_exec.TreeSpec`
    and ``tree_mask`` its ancestor mask (built once by the engine);
    ``tokens [N, S]``: each lane's draft tree, node 0 its pending token.
    One forward writes the ``S`` nodes' KV at slots ``index + i`` and scores
    them at RoPE positions ``index + depth(i)`` under the ancestor mask (K1's
    tree-mask arm).  Greedy lanes take the branch with the longest prefix
    of drafts equal to the model's argmax at their parents (ties: the lowest
    branch) and commit the argmaxes along it: the tokens plain decode would
    emit.  Sampled lanes try each sibling candidate at the branch point
    against the running residual, fall through to a residual draw, then take
    the linear accept/resample rule down the chosen branch and one bonus
    draw at its deepest node (``W + 2D`` draws).  Commits stop at the first
    EOS.  The winning path's KV then moves to the frontier
    (:func:`tree_commit_paged`).  Updates ``lanes.pending`` in place and
    returns ``(out [N, D+1], n_commit [N], quantization error)``."""
    n = tokens.shape[0]
    dev = tokens.device
    w, depth = tree.width, tree.depth
    paths = torch.from_numpy(tree.paths).to(dev).long()              # [W, D+1]
    parent = torch.from_numpy(tree.parent).to(dev).long()
    prev_index = index
    positions = index.long()[:, None] + torch.from_numpy(tree.depth_arr).to(dev).long()[None, :]
    cache = _paged_cache(pages_k, pages_v, k_scales, v_scales, tables, index,
                         lanes.active.clone())
    logits, cache = model(tokens, positions=positions, cache=cache, tree_mask=tree_mask)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)          # [N, S]
    # ok[i]: node i's draft equals the model's argmax at its parent
    ok = tokens == greedy[:, parent]
    chain = paths[:, 1:].reshape(-1)
    acc_len = torch.cumprod(ok[:, chain].reshape(n, w, depth).to(torch.int32), dim=2).sum(dim=2)
    best = torch.argmax(acc_len, dim=1)                             # first max: lowest branch
    path = paths[best]                                              # [N, D+1]
    emit = greedy.gather(1, path)
    acc = ok.gather(1, path[:, 1:])
    sampled = [i for i, g in enumerate(lanes.generators) if g is not None]
    if sampled:
        filt = _filtered(logits, lanes)
        for i in sampled:
            gen = lanes.generators[i]
            # the branch point: each sibling tried against the running residual
            rem = filt[i, 0]
            taken = torch.zeros((), dtype=torch.bool, device=dev)
            pick = torch.zeros((), dtype=torch.long, device=dev)
            tok1 = torch.zeros((), dtype=torch.int32, device=dev)
            for b in range(w):
                d_b = tokens[i, int(tree.paths[b, 1])]
                p_b = torch.softmax(rem, dim=-1)[d_b.long()]
                take = ~taken & (_uniform((), gen, dev) < p_b)
                pick = torch.where(take, b, pick)
                tok1 = torch.where(take, d_b, tok1)
                taken = taken | take
                rem = _without(rem, d_b)
            tok1 = torch.where(taken, tok1, _draw(rem, gen))
            path_i = paths[pick]
            cols, accs = [tok1], [taken]
            # down the chosen branch: the linear point-mass rule
            for t in range(1, depth):
                filt_t = filt[i, path_i[t]]
                d_t = tokens[i, path_i[t + 1]]
                p_t = torch.softmax(filt_t, dim=-1)[d_t.long()]
                acc_t = _uniform((), gen, dev) < p_t
                cols.append(torch.where(acc_t, d_t, _draw(_without(filt_t, d_t), gen)))
                accs.append(acc_t)
            cols.append(_draw(filt[i, path_i[depth]], gen))
            emit[i] = torch.stack(cols)
            acc[i] = torch.stack(accs)
            path[i] = path_i
    out, n_commit = _commit(emit, acc, lanes.active, lanes.eos, pad)
    tree_commit_paged(cache, prev_index, path)
    lanes.pending.copy_(_pending(out, n_commit))
    return out, n_commit, _quant_err(cache, dev)
