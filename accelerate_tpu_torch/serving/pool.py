"""The engine's device programs: prefill, decode and verify windows, on either pool.

Port of :mod:`accelerate_tpu.serving.pool`: the direct paged arms and the
slab arms.  The JAX package compiles one executable per shape and donates
the KV arrays; here the model's forward writes them in place, and each
program is a plain function that reads and writes only tensors the engine
keeps for its life (pages and scales or slabs, tables, index, the lane
vectors, the verify token block) and makes no host decision from lane
state, so the engine can capture each as one CUDA graph (:mod:`.graphs`)
and replay it every cycle.  As in the reference, each window's traced body
is shared by both pools (``_decode_scan``, ``_verify_body``,
``_tree_verify_body`` branch on the cache type only where the KV moves):

* :func:`prefill_chunk` — one prompt chunk through the model's layers on a
  :class:`~accelerate_tpu_torch.models.transformer.PagedKVCache` with the
  prefill kernel (K2): the chunk's K/V land in the lane's pages and its
  queries attend over prior pages in place; the table and start position
  may be device buffers, so that one graph per bucket serves every chunk.
  :func:`slab_prefill_chunk` — the same into the slab pool's batch-1
  scratch (``accelerate_tpu/serving/pool.py:541``), attended by plain
  PyTorch (the reference's XLA).
* :func:`decode_window` / :func:`slab_decode_window` — ``window`` masked
  decode steps over every lane (the JAX ``_decode_scan`` as a Python loop),
  through the decode kernel (K1) on pages, through
  :func:`~accelerate_tpu_torch.models.transformer.cached_attention` on the
  slab.  Frozen lanes (inactive, or past their EOS) keep their index; on
  pages ``active = ~done`` routes their writes to the null page each step,
  on the slab they overwrite their own dead slot, as in the reference.
* :func:`verify_window` / :func:`slab_verify_window` — speculative
  decoding's linear verify: one forward over ``[slots, K+1]`` (each lane's
  pending token and K drafts), then the acceptance rule per lane
  (``accelerate_tpu/serving/pool.py:267-335``).
* :func:`tree_verify_window` / :func:`slab_tree_verify_window` — the tree
  verify: one forward over ``[slots, nodes]`` draft-tree tokens under the
  ancestor mask (K1's tree-mask arm on pages), the winning root-to-leaf
  path per lane, and its commit to the lane's frontier:
  :func:`tree_commit_paged` through the block tables (``:960-1063``),
  :func:`tree_commit_slab` in the slab (``_compact``, ``:524-534``).

Sampled lanes draw uniforms from their device keys (a fixed count a
cycle: one a decode step; linear verify ``2K + 1``; tree ``W + 2D``), so a
seed reproduces a run.  Each window has two variants, picked by the caller
from host state: without ``sampling`` every lane takes the argmax and
nothing sorts the vocabulary; with it the sampled arms run over every lane,
masked by ``lanes.sampled``.

Every program returns the call's largest KV quantization round-trip error as an f32
device scalar (0 for native pages and slabs), the reference's ``quant_err`` output
(``accelerate_tpu/serving/pool.py:745-849``); nothing here reads it back.
``plain=True`` (the engine's ``decode_kernel="xla"``) routes a paged
program's attention to the kernels' plain versions.
* :class:`LaneState` — the per-lane decode vectors on the device; installing a
  request edits one slot of them in place.
* :func:`plan_chunks` — split a prompt into bucket-sized prefill chunks.
* :func:`copy_page`, :func:`spill_extract`, :func:`promote_install` — the
  prefix cache's page traffic (``accelerate_tpu/serving/pool.py:1092-1180``):
  a copy-on-write of one page, the gather of a spilled chunk's pages, and
  the install of a promoted chunk into fresh pages.  The reference donates
  the pool and rebinds it; here they write the engine's pool tensors in
  place, because the windows' CUDA graphs read those very tensors.  Scales
  ride along with their pages, so a quantized page moves exactly.
* :func:`slab_insert`, :func:`copy_chunk` — the slab pool's copies
  (``make_insert`` ``:568``, ``make_copy_chunk`` ``:637``): a prefilled
  scratch into a freed slot, and a cached chunk's slab into the scratch.
  Both run eagerly, in place, on the stream behind any window in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.generation import (
    filter_logits_batched,
    sample_filtered,
    sample_tokens_batched,
    uniforms,
)
from ..models.transformer import KVCache, PagedKVCache, Transformer
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
    off) and ``top_p`` (1 = off) are the sampling knobs; ``sampled`` marks
    the lanes that sample, and ``keys [num_slots, 2]`` int64 holds each
    one's ``(seed, counter)`` (:func:`~accelerate_tpu_torch.models.
    generation.uniforms`).  Every edit is in place: a CUDA graph of a window
    reads these very tensors.  ``sampling`` is the host mirror of
    ``sampled``, from which the engine picks a window's variant without
    reading the card."""

    pending: torch.Tensor
    active: torch.Tensor
    eos: torch.Tensor
    temperature: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    keys: torch.Tensor
    sampled: torch.Tensor
    sampling: np.ndarray

    @classmethod
    def create(cls, num_slots: int, device) -> "LaneState":
        def full(value, dtype):
            return torch.full((num_slots,), value, dtype=dtype, device=device)

        return cls(
            pending=full(0, torch.int32), active=full(False, torch.bool),
            eos=full(-1, torch.int32), temperature=full(1.0, torch.float32),
            top_k=full(0, torch.int32), top_p=full(1.0, torch.float32),
            keys=torch.zeros((num_slots, 2), dtype=torch.int64, device=device),
            sampled=full(False, torch.bool), sampling=np.zeros(num_slots, bool),
        )

    @property
    def any_sampled(self) -> bool:
        """Does some lane sample?  (Host state: the window variant.)"""
        return bool(self.sampling.any())

    def install(self, slot: int, token: int, eos: int, temperature: float,
                top_k: int, top_p: float, key: Optional[int]) -> None:
        """Hand lane ``slot`` to a prefilled request: one-element fills on
        the device, ordered behind any window in flight.  ``key`` is the
        request's seed (:func:`~accelerate_tpu_torch.models.generation.
        lane_key`), or ``None`` for a greedy lane; the draw counter
        restarts at 0."""
        self.pending[slot].fill_(token)
        self.active[slot].fill_(True)
        self.eos[slot].fill_(eos)
        self.temperature[slot].fill_(temperature)
        self.top_k[slot].fill_(top_k)
        self.top_p[slot].fill_(top_p)
        self.keys[slot, 0].fill_(0 if key is None else key)
        self.keys[slot, 1].fill_(0)
        self.sampled[slot].fill_(key is not None)
        self.sampling[slot] = key is not None

    def retire(self, slot: int) -> None:
        self.active[slot].fill_(False)
        self.sampled[slot].fill_(False)
        self.sampling[slot] = False


_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width: gathers and scatters move
    them exactly, whatever the dtype (indexing float8 is not implemented on
    every PyTorch build)."""
    return t.view(_RAW[t.element_size()])


def copy_page(pool: Sequence[torch.Tensor], src: int, dst: int) -> None:
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` in every
    layer of ``pool = (pages_k, pages_v, k_scales, v_scales)``, scales
    included, in place on the current stream."""
    for t in pool:
        r = _raw(t)
        r[:, dst].copy_(r[:, src])


def spill_extract(pool: Sequence[torch.Tensor], ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gather the pages ``ids [npages]`` (int64, on the pool's device) of
    ``pool`` into new dense tensors ``(k [L, npages, page, Hkv, D], v,
    k_scales [L, npages, Hkv], v_scales)``; the pool is only read."""
    return tuple(_raw(t).index_select(1, ids).view(t.dtype) for t in pool)


def promote_install(pool: Sequence[torch.Tensor], chunk: Sequence[torch.Tensor],
                    ids: torch.Tensor) -> None:
    """Install a spilled chunk ``chunk = (k, v, k_scales, v_scales)`` (as
    :func:`spill_extract` returns it, on the pool's device) into the pages
    ``ids``, in place."""
    for t, c in zip(pool, chunk):
        _raw(t).index_copy_(1, ids, _raw(c.to(t.dtype)))


def _quant_err(cache, device) -> torch.Tensor:
    err = getattr(cache, "quant_err", None)
    if err is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return err


def _draws(lanes: LaneState, n: int) -> torch.Tensor:
    """This window's ``n`` uniforms per lane ``[N, n]``; every lane's draw
    counter advances by ``n``, in place."""
    u = uniforms(lanes.keys, n)
    lanes.keys[:, 1] += n
    return u


def _layer_stack(model: Transformer, tokens: torch.Tensor, cache, index: torch.Tensor) -> None:
    """A chunk's forward through the layers at positions ``index ..``: a
    chunk's logits are never read (under the reference's ``jit`` the final
    norm and the LM head are dead code)."""
    positions = index.long()[:, None] + torch.arange(tokens.shape[1],
                                                     device=tokens.device)[None, :]
    x = model.embed(tokens, positions)
    for i, layer in enumerate(model.layers):
        x = layer(x, positions, cache=cache, layer=i)


def _base_index(base, device) -> torch.Tensor:
    return (base if isinstance(base, torch.Tensor)
            else torch.full((1,), int(base), dtype=torch.int32, device=device))


@torch.inference_mode()
def prefill_chunk(model: Transformer, tokens: torch.Tensor, pages_k, pages_v,
                  k_scales, v_scales, table: torch.Tensor, base, plain: bool = False
                  ) -> torch.Tensor:
    """Run one ``[1, chunk_len]`` prompt chunk at positions ``base ..`` of the
    lane whose block table is ``table`` (``[P]`` or ``[1, P]``); its K/V are
    written into the page arrays (and, for quantized pages, their scales) in
    place.  ``base`` is an int or a one-element int32 tensor on the chunk's
    device: the engine passes its static buffers, written in place before
    each run, so that one captured graph per bucket serves every chunk of
    that bucket (the reference's per-bucket executable, whose table and base
    are device arguments).  The forward stops after the layer stack.
    Returns the chunk's quantization error, a device scalar."""
    device = tokens.device
    index = _base_index(base, device)
    cache = PagedKVCache(
        pages_k=pages_k, pages_v=pages_v, k_scales=k_scales, v_scales=v_scales,
        tables=table.reshape(1, -1), index=index,
        active=torch.ones(1, dtype=torch.bool, device=device), kernel="prefill", plain=plain,
    )
    _layer_stack(model, tokens, cache, index)
    return _quant_err(cache, device)


@torch.inference_mode()
def slab_prefill_chunk(model: Transformer, tokens: torch.Tensor, scratch_k: torch.Tensor,
                       scratch_v: torch.Tensor, base) -> None:
    """Run one ``[1, chunk_len]`` prompt chunk into the batch-1 scratch slab
    ``scratch_k``/``scratch_v [L, 1, M, Hkv, D]`` at positions ``base ..``
    (the reference's ``make_prefill_chunk``, whose scratch index is this
    ``base``): its K/V are written in place and its queries attend over the
    scratch by plain PyTorch.  A padded final chunk writes garbage past the
    prompt, which the causal mask never lets a later query read.  ``base``
    as for :func:`prefill_chunk`."""
    index = _base_index(base, tokens.device)
    _layer_stack(model, tokens, KVCache(k=scratch_k, v=scratch_v, index=index), index)


def slab_insert(pool_k: torch.Tensor, pool_v: torch.Tensor, scratch_k: torch.Tensor,
                scratch_v: torch.Tensor, slot: int) -> None:
    """Install a prefilled request: the whole scratch width
    ``[L, 1, Mp, Hkv, D]`` into slot ``slot`` of the slab pool ``[L, N, M,
    Hkv, D]`` at position 0, in place (``make_insert``,
    ``accelerate_tpu/serving/pool.py:568``; the lane's write index, ``prompt_len
    - 1``, is the engine's).  Other lanes are untouched."""
    width = scratch_k.shape[2]
    pool_k[:, slot, :width].copy_(scratch_k[:, 0])
    pool_v[:, slot, :width].copy_(scratch_v[:, 0])


def copy_chunk(scratch_k: torch.Tensor, scratch_v: torch.Tensor, node_k: torch.Tensor,
               node_v: torch.Tensor, start: int) -> None:
    """A prefix-cache hit on the slab pool: the cached chunk ``node_k``/
    ``node_v [L, 1, chunk, Hkv, D]`` into the scratch at ``start``, in place
    (``make_copy_chunk``, ``accelerate_tpu/serving/pool.py:637``; the next
    chunk starts ``chunk`` positions later)."""
    n = node_k.shape[2]
    scratch_k[:, :, start:start + n].copy_(node_k)
    scratch_v[:, :, start:start + n].copy_(node_v)


def _decode_scan(model: Transformer, window: int, cache, lanes: LaneState, pad: int,
                 sampling: bool):
    """The masked decode steps shared by the paged and slab windows.  Each
    step feeds every lane's pending token at its own position, writes its KV
    there, and picks the next token per lane; lanes that are inactive or
    have emitted their EOS freeze: their index stops advancing and their
    outputs are ``pad``.  On pages a frozen lane's writes go to the null
    page (``active = ~done``: a quantized page write requantizes the whole
    page); in the slab it overwrites its own dead slot.  Updates
    ``lanes.pending`` in place; returns the tokens ``[N, window]`` and the
    last cache."""
    paged = isinstance(cache, PagedKVCache)
    tok = lanes.pending
    done = ~lanes.active
    u = _draws(lanes, window) if sampling else None
    out = []
    for step in range(window):
        prev_index = cache.index
        if paged:
            cache.active = ~done
        logits, cache = model(tok[:, None], cache=cache)
        # the forward advanced every lane; frozen lanes roll back
        cache.index = torch.where(done, prev_index, prev_index + 1)
        if sampling:
            nxt = sample_tokens_batched(
                logits[:, -1], u[:, step], lanes.sampled, temperature=lanes.temperature,
                top_k=lanes.top_k, top_p=lanes.top_p,
            )
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
        done = done | ((lanes.eos >= 0) & (nxt == lanes.eos))
        out.append(nxt)
        tok = nxt
    lanes.pending.copy_(tok)
    return torch.stack(out, dim=1), cache


@torch.inference_mode()
def decode_window(model: Transformer, window: int, pages_k, pages_v, k_scales,
                  v_scales, tables: torch.Tensor, index: torch.Tensor,
                  lanes: LaneState, pad: int, sampling: Optional[bool] = None,
                  plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window`` masked decode steps over the whole paged slot pool
    (:func:`_decode_scan`), through K1.  ``sampling`` picks the variant
    (default: does some lane sample): without it every lane takes the
    argmax; with it sampled lanes draw one uniform a step.  Updates
    ``lanes.pending`` in place and returns the tokens ``[N, window]`` and
    the window's quantization error (both on the device)."""
    sampling = lanes.any_sampled if sampling is None else sampling
    cache = PagedKVCache(pages_k=pages_k, pages_v=pages_v, k_scales=k_scales,
                         v_scales=v_scales, tables=tables, index=index,
                         active=lanes.active.clone(), kernel="decode", plain=plain)
    toks, cache = _decode_scan(model, window, cache, lanes, pad, sampling)
    return toks, _quant_err(cache, toks.device)


@torch.inference_mode()
def slab_decode_window(model: Transformer, window: int, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, index: torch.Tensor, lanes: LaneState, pad: int,
                       sampling: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window`` masked decode steps over the slab pool ``pool_k``/``pool_v
    [L, N, M, Hkv, D]`` at the lanes' write ``index [N]`` (the reference's
    ``make_decode_window``, ``accelerate_tpu/serving/pool.py:175``), attended
    by plain PyTorch.  As :func:`decode_window`; the error is 0."""
    sampling = lanes.any_sampled if sampling is None else sampling
    toks, cache = _decode_scan(model, window, KVCache(k=pool_k, v=pool_v, index=index),
                               lanes, pad, sampling)
    return toks, _quant_err(cache, toks.device)


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
        return x[:, None].expand(n, s).reshape(n * s)

    return filter_logits_batched(logits.reshape(n * s, v), temperature=rep(lanes.temperature),
                                 top_k=rep(lanes.top_k), top_p=rep(lanes.top_p)).reshape(n, s, v)


def _prob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """The probability of ``token [...]`` under ``softmax(logits [..., V])``."""
    return torch.softmax(logits, dim=-1).gather(-1, token[..., None].long())[..., 0]


def _without(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``logits [..., V]`` with ``token [...]`` suppressed: the residual after
    a point-mass draft was rejected."""
    hit = torch.arange(logits.shape[-1], device=logits.device) == token[..., None]
    return torch.where(hit, _NEG, logits)


def _paged_cache(pages_k, pages_v, k_scales, v_scales, tables, index, active, plain):
    return PagedKVCache(pages_k=pages_k, pages_v=pages_v, k_scales=k_scales,
                        v_scales=v_scales, tables=tables, index=index, active=active,
                        kernel="decode", plain=plain)


def _verify_body(model: Transformer, cache, tokens: torch.Tensor, lanes: LaneState,
                 pad: int, sampling: bool):
    """Forward and accept/commit of one linear verify, shared by the paged
    and slab windows (the reference's ``_verify_body``)."""
    k = tokens.shape[1] - 1
    logits, cache = model(tokens, cache=cache)                   # [N, K+1, V] f32
    drafts = tokens[:, 1:]
    emit = torch.argmax(logits, dim=-1).to(torch.int32)
    acc = emit[:, :k] == drafts
    if sampling:
        u = _draws(lanes, 2 * k + 1)
        filt = _filtered(logits, lanes)
        accepted = u[:, :k] < _prob(filt[:, :k], drafts)
        res = sample_filtered(_without(filt[:, :k], drafts), u[:, k:2 * k])
        bonus = sample_filtered(filt[:, k], u[:, 2 * k])
        drawn = torch.cat([torch.where(accepted, drafts, res), bonus[:, None]], dim=1)
        sampled = lanes.sampled[:, None]
        emit = torch.where(sampled, drawn, emit)
        acc = torch.where(sampled, accepted, acc)
    out, n_commit = _commit(emit, acc, lanes.active, lanes.eos, pad)
    lanes.pending.copy_(_pending(out, n_commit))
    return out, n_commit, _quant_err(cache, tokens.device)


@torch.inference_mode()
def verify_window(model: Transformer, pages_k, pages_v, k_scales, v_scales,
                  tables: torch.Tensor, index: torch.Tensor, tokens: torch.Tensor,
                  lanes: LaneState, pad: int, sampling: Optional[bool] = None,
                  plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One linear speculative verify over the whole paged slot pool.

    ``tokens [N, K+1]``: each lane's pending token, then its K drafts.  One
    forward writes all K+1 positions at each lane's index (inactive lanes'
    writes go to the null page) and gives the true next-token logits at
    every position.  Greedy lanes accept a draft while it equals the argmax
    and commit the argmaxes: the tokens plain decode would emit.  With
    ``sampling`` (default: does some lane sample) every lane draws ``2K +
    1`` uniforms, and sampled lanes take the Leviathan accept/resample rule
    for a point-mass drafter, vectorised over the lanes: draft ``d`` at
    position ``i`` is accepted when its uniform falls below ``p_i(d)`` under
    the lane's filtered distribution, else the token is drawn from ``p_i``
    with ``d`` removed; one bonus token is drawn at the last position.
    Commits stop at the first EOS.  Updates ``lanes.pending`` in place and
    returns ``(out [N, K+1], n_commit [N], quantization error)`` on the
    device; the caller advances each lane's index by ``n_commit``."""
    sampling = lanes.any_sampled if sampling is None else sampling
    cache = _paged_cache(pages_k, pages_v, k_scales, v_scales, tables, index,
                         lanes.active.clone(), plain)
    return _verify_body(model, cache, tokens, lanes, pad, sampling)


@torch.inference_mode()
def slab_verify_window(model: Transformer, pool_k: torch.Tensor, pool_v: torch.Tensor,
                       index: torch.Tensor, tokens: torch.Tensor, lanes: LaneState, pad: int,
                       sampling: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`verify_window` over the slab pool (the reference's
    ``make_verify_window``, ``accelerate_tpu/serving/pool.py:217``): every
    lane, inactive ones included, writes its K+1 rows at its own index."""
    sampling = lanes.any_sampled if sampling is None else sampling
    return _verify_body(model, KVCache(k=pool_k, v=pool_v, index=index), tokens, lanes,
                        pad, sampling)


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


def tree_commit_slab(pool_k: torch.Tensor, pool_v: torch.Tensor, prev_index: torch.Tensor,
                     path: torch.Tensor) -> None:
    """Commit a tree verify's winning path inside the slab pool, in place
    (the reference's ``_compact``, ``accelerate_tpu/serving/pool.py:524-534``):
    gather each lane's ``D+1`` path rows at ``prev_index + path`` from every
    layer into new tensors, then write them at the lane's frontier (the
    write start clamped as ``dynamic_update_slice`` clamps it).  Losing
    branches' rows past ``frontier + D`` are never visible: they lie past
    the lane's length."""
    m = pool_k.shape[2]
    width = path.shape[1]
    lanes = torch.arange(path.shape[0], device=path.device)[:, None]
    src = torch.clamp(prev_index.long()[:, None] + path.long(), max=m - 1)     # [N, D+1]
    start = torch.clamp(prev_index.long(), 0, m - width)
    dst = start[:, None] + torch.arange(width, device=path.device)[None, :]
    for t in (pool_k, pool_v):
        t[:, lanes, dst] = t[:, lanes, src]             # the gather copies first


def _tree_verify_body(model: Transformer, tree, tree_mask: TreeMask, cache,
                      tokens: torch.Tensor, lanes: LaneState, pad: int, sampling: bool):
    """Forward, branch selection and commit of one tree verify, shared by
    the paged and slab windows (the reference's ``_tree_verify_body``);
    only the commit of the winning path's KV branches on the pool."""
    n = tokens.shape[0]
    dev = tokens.device
    w, depth = tree.width, tree.depth
    paths, parent, depth_arr = tree.on(dev)                          # [W, D+1], [S], [S]
    prev_index = cache.index
    positions = prev_index.long()[:, None] + depth_arr[None, :]
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
    if sampling:
        u = _draws(lanes, w + 2 * depth)
        filt = _filtered(logits, lanes)
        rows = torch.arange(n, device=dev)
        # the branch point: each sibling tried against the running residual
        rem = filt[:, 0]
        taken = torch.zeros(n, dtype=torch.bool, device=dev)
        pick = torch.zeros(n, dtype=torch.long, device=dev)
        tok1 = torch.zeros(n, dtype=torch.int32, device=dev)
        for b in range(w):
            d_b = tokens[:, int(tree.paths[b, 1])]
            take = ~taken & (u[:, b] < _prob(rem, d_b))
            pick = torch.where(take, b, pick)
            tok1 = torch.where(take, d_b, tok1)
            taken = taken | take
            rem = _without(rem, d_b)
        tok1 = torch.where(taken, tok1, sample_filtered(rem, u[:, w]))
        drawn_path = paths[pick]
        cols, accs = [tok1], [taken]
        # down the chosen branch: the linear point-mass rule
        for t in range(1, depth):
            filt_t = filt[rows, drawn_path[:, t]]
            d_t = tokens.gather(1, drawn_path[:, t + 1:t + 2])[:, 0]
            acc_t = u[:, w + 2 * t - 1] < _prob(filt_t, d_t)
            res = sample_filtered(_without(filt_t, d_t), u[:, w + 2 * t])
            cols.append(torch.where(acc_t, d_t, res))
            accs.append(acc_t)
        cols.append(sample_filtered(filt[rows, drawn_path[:, depth]], u[:, w + 2 * depth - 1]))
        sampled = lanes.sampled[:, None]
        emit = torch.where(sampled, torch.stack(cols, dim=1), emit)
        acc = torch.where(sampled, torch.stack(accs, dim=1), acc)
        path = torch.where(sampled, drawn_path, path)
    out, n_commit = _commit(emit, acc, lanes.active, lanes.eos, pad)
    if isinstance(cache, PagedKVCache):
        tree_commit_paged(cache, prev_index, path)
    else:
        tree_commit_slab(cache.k, cache.v, prev_index, path)
    lanes.pending.copy_(_pending(out, n_commit))
    return out, n_commit, _quant_err(cache, dev)


@torch.inference_mode()
def tree_verify_window(model: Transformer, tree, tree_mask: TreeMask, pages_k, pages_v,
                       k_scales, v_scales, tables: torch.Tensor, index: torch.Tensor,
                       tokens: torch.Tensor, lanes: LaneState, pad: int,
                       sampling: Optional[bool] = None, plain: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tree speculative verify over the whole paged slot pool.

    ``tree`` is a :class:`~accelerate_tpu_torch.serving.spec_exec.TreeSpec`
    and ``tree_mask`` its ancestor mask (built once by the engine);
    ``tokens [N, S]``: each lane's draft tree, node 0 its pending token.
    One forward writes the ``S`` nodes' KV at slots ``index + i`` and scores
    them at RoPE positions ``index + depth(i)`` under the ancestor mask (K1's
    tree-mask arm).  Greedy lanes take the branch with the longest prefix
    of drafts equal to the model's argmax at their parents (ties: the lowest
    branch) and commit the argmaxes along it: the tokens plain decode would
    emit.  With ``sampling`` (default: does some lane sample) every lane
    draws ``W + 2D`` uniforms, and sampled lanes, vectorised over the
    lanes, try each sibling candidate at the branch point against the
    running residual, fall through to a residual draw, then take the linear
    accept/resample rule down the chosen branch and one bonus draw at its
    deepest node.  Commits stop at the first EOS.  The winning path's KV
    then moves to the frontier (:func:`tree_commit_paged`).  Updates
    ``lanes.pending`` in place and returns ``(out [N, D+1], n_commit [N],
    quantization error)``."""
    sampling = lanes.any_sampled if sampling is None else sampling
    cache = _paged_cache(pages_k, pages_v, k_scales, v_scales, tables, index,
                         lanes.active.clone(), plain)
    return _tree_verify_body(model, tree, tree_mask, cache, tokens, lanes, pad, sampling)


@torch.inference_mode()
def slab_tree_verify_window(model: Transformer, tree, tree_mask: TreeMask,
                            pool_k: torch.Tensor, pool_v: torch.Tensor, index: torch.Tensor,
                            tokens: torch.Tensor, lanes: LaneState, pad: int,
                            sampling: Optional[bool] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`tree_verify_window` over the slab pool (the reference's
    ``make_tree_verify_window``, ``accelerate_tpu/serving/pool.py:338``):
    the ancestor mask through plain PyTorch attention, the winning path
    committed by :func:`tree_commit_slab`."""
    sampling = lanes.any_sampled if sampling is None else sampling
    return _tree_verify_body(model, tree, tree_mask,
                             KVCache(k=pool_k, v=pool_v, index=index), tokens, lanes, pad,
                             sampling)
