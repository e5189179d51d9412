"""Continuous-batching serving engine on the paged or the slab KV pool.

Port of :class:`accelerate_tpu.serving.engine.ServingEngine` with either
pool and no mesh.  ``paged=True`` (the port's default, the path that runs
the kernels) serves from the refcounted page pool; ``paged=False`` (the
reference's default) from the slab pool: one ``[L, slots, max_len, Hkv,
D]`` slab a lane, prompts prefilled chunk by chunk into a batch-1 scratch
slab and copied into the lane's slot when their last chunk lands, attended
by plain PyTorch, as the reference attends slabs by XLA.  One engine step
(described for the paged pool; the slab pool has no pages, so it never
preempts, and a prefix-cache hit copies a cached chunk into the scratch):

0. the deadline sweep (only while some request has a ``deadline_s``):
   running and queued requests past their budget are cancelled;
1. admission — open the FCFS head's prefill when a slot and its pages are
   free (up to one open prefill per slot with ``interleave_prefill``, their
   chunks picked shortest-remaining-first), then run prefill chunks
   (buckets from :func:`.pool.plan_chunks`) against the per-step
   prefill-token budget; each chunk's K/V is written
   straight into newly allocated lane pages by the prefill kernel (K2), and a
   request whose last chunk landed is installed into its lane.  With the
   prefix cache (:mod:`.prefix_cache`, on by default as in the reference) a
   chunk whose whole prefix is cached costs no forward: a device-tier hit
   aliases the cached pages into the lane's block table, a spilled one is
   promoted into fresh pages; fresh full chunks are retained by reference,
   and the one shared page a lane's decode writes into is copied on write
   at install;
2. dispatch of one decode cycle.  Without speculation, or when no lane
   drafts, it is a decode window: ``decode_window`` masked steps over every
   lane through the decode kernel (K1).  With ``speculate_k = K`` (n-gram
   prompt-lookup drafts, :mod:`.spec`) it is a linear verify: one forward
   over ``[slots, K+1]`` through K1's causal arm, landing 1..K+1 tokens a
   lane.  With ``draft_model`` it is a tree cycle: a draft forward of the
   served model's first layers drafts a ``1 + tree_width * tree_depth``-node
   token tree per lane (:mod:`.spec_exec`), and one tree verify forward
   scores every node through K1's tree-mask arm and commits the winning
   path's KV into the pages (:mod:`.pool`);
3. drain: the one readback of a window's tokens, which stream out to their
   requests.

With ``interleave_prefill`` steps 1 and 2 swap, as in the reference: the
window is dispatched first and the cycle's chunks queue behind it on the
card, charged against one joint budget with the window's tokens.

On the card every window and every prefill bucket's chunk is one CUDA
graph, captured at construction (:mod:`.graphs`) and replayed each cycle
(a chunk's tokens, block table and start position are written into static
buffers first).  With ``async_depth=1`` (the default, as in the reference)
the loop is the reference's depth-1 pipeline: step 3 drains the PREVIOUS
window (:mod:`.readback`), so the host's emit, admission and drafting run
while the card computes the window just dispatched; ``async_depth=0``
drains each window right after its dispatch.  :meth:`ServingEngine.cancel`
drops a queued request or retires a running lane at once.

Greedy outputs are token-identical to the JAX engine's on either pool,
with native and with quantized (int8, fp8-e4m3) pages, in either loop; a
request's sampled tokens depend only on ``(rng_seed, request id)``.
Arguments naming parts of the JAX engine the port has not ported raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models.generation import GenerationConfig, lane_key
from ..models.transformer import KVCache, Transformer
from ..ops.paged_attention import MAX_TREE_NODES, TreeMask
from .errors import AdmissionError
from .graphs import WindowGraphs
from .paging import DraftContextWindow, PagedKVPool
from .pool import (
    LaneState,
    copy_chunk,
    copy_page,
    decode_window,
    plan_chunks,
    prefill_chunk,
    promote_install,
    slab_decode_window,
    slab_insert,
    slab_prefill_chunk,
    slab_tree_verify_window,
    slab_verify_window,
    spill_extract,
    tree_verify_window,
    verify_window,
)
from .prefix_cache import PrefixCache
from .readback import CacheTransfer, Readback, stage
from .scheduler import Request, RequestState, Scheduler
from .spec_exec import (
    NgramDrafter,
    TreeDrafter,
    TreeSpec,
    build_draft,
    draft_transformer,
    make_draft_forward,
)


#: the clock of deadlines and service times (``submit_time``, the deadline
#: sweep, the service-time average): tests swap in a fake one
clock = time.perf_counter


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 item {item}")


class ServingEngine:
    """Serve many requests through one paged slot pool with in-flight admission.

    Parameters
    ----------
    model: the port's :class:`~accelerate_tpu_torch.models.transformer.Transformer`.
    params: a state dict loaded into ``model`` (``assign=True``: tensors on
        the engine's device are used as they are), or ``None`` to serve the
        model's own weights.
    num_slots: concurrent request lanes.
    max_len: per-lane KV capacity (default ``config.max_seq_len``).  A request
        needs ``prompt_len + max_new_tokens + max(decode_window, speculation
        span) <= max_len`` (the span: ``speculate_k + 1``, or the tree's
        nodes).
    prefill_buckets: chunk sizes for chunked prefill (default ``(128, 512)``
        clipped to ``max_prompt_len``).
    max_prompt_len: longest admissible prompt (default ``max_len``).
    prefill_token_budget: prefill tokens charged per engine step (default:
        the largest bucket).
    decode_window: decode steps per engine step.
    slot_order: slot-id preference for admission (tests permute it).
    paged: ``True`` (the port's default; the reference defaults to
        ``False``) — the paged pool, attended by the kernels K1 and K2;
        ``False`` — the reference's slab pool: ``KVCache.create(cfg,
        num_slots, max_len)`` and the batch-1 prefill scratch
        ``KVCache.create(cfg, 1, max_prompt_len)``, attended by plain
        PyTorch (no kernel, as the reference runs none there).  A prompt
        must then pad (:func:`~.pool.plan_chunks`) to at most
        ``max_prompt_len``.  With ``paged=False``, ``decode_kernel`` or
        ``prefill_kernel="pallas"``, ``kv_dtype``, ``interleave_prefill``,
        ``role`` other than ``"both"`` and ``prefix_host_mb`` raise the
        reference's ``ValueError``.
    decode_kernel: ``None`` (default: the kernels on the paged pool, plain
        PyTorch on the slab; a sliding-window or alibi model takes the
        kernels' plain versions, the kernels having neither arm),
        ``"pallas"`` (the kernels, named explicitly; ``ValueError`` for a
        sliding-window or alibi model, as the reference's config raises) or
        ``"xla"``: on the paged pool, K1 and K2 replaced by their plain
        versions, an in-engine A/B of the kernels.
    prefill_kernel: ``None`` (follows ``decode_kernel``), ``"pallas"`` or
        ``"xla"``: K2 or its plain version for the paged prefill chunks.
    page_size: tokens per KV page; default ``gcd(prefill_buckets)``.
    num_pages: physical pages including the null page; default the
        no-preemption worst case ``num_slots * max_len / page_size + 1``.
    kv_dtype: ``None`` (model dtype), ``"bf16"``, or the quantized page
        formats ``"int8"`` and ``"fp8"`` (e4m3): one f32 scale per (layer,
        page, kv-head), each touched page requantized at every insert.
        ``stats["kv_quant_error"]`` then holds the largest round-trip error
        of the values the last drained window wrote, or of the prefill
        chunks dispatched in its cycle where there were any (the reference's
        ``serve/kv_quant_error`` gauge), read at the window's drain;
        ``stats["kv_bytes_per_token"]`` is the pool's bytes per token across
        all layers, scales included (``serve/kv_bytes_per_token``).
    async_depth: ``1`` (default) — the depth-1 pipeline: each step drains
        the window dispatched one step earlier; ``0`` — the synchronous
        loop.  Any other value raises ``ValueError``.
    speculate_k: draft length K of n-gram speculation; ``0`` (default) off.
        Cycles where some lane drafts run one verify forward over ``[slots,
        K+1]`` instead of the decode window (``submit(..., speculate=False)``
        opts a request out).
    speculate_ngram: longest trailing n-gram the drafter tries.
    draft_model: tree speculation with a draft model: ``int n`` — the
        served model's first ``n`` layers, embedding, final norm and head
        (their tensors shared, not copied); ``(cfg, state_dict)`` — an
        explicit draft on the engine's device; ``"dir"`` or ``"dir#n"`` —
        a Hugging Face checkpoint directory streamed through
        :mod:`~accelerate_tpu_torch.models.hf_compat`, its first ``n``
        layers (default a quarter).  Replaces the linear verify; a
        sliding-window or alibi served model raises ``ValueError``.
    tree_width: sibling branches at the tree's branch point (the draft's
        top candidates); more than 1 needs ``draft_model``.
    tree_depth: draft chain length under each branch; default
        ``speculate_k`` when set, else 4.  A tree has ``1 + tree_width *
        tree_depth`` nodes, at most 32 (K1's tree-mask arm packs a node's
        ancestors into a uint32 word), and commits at most ``tree_depth +
        1`` tokens a lane per cycle.
    draft_ctx: the draft forward's context window per lane, in tokens.
    interleave_prefill: dispatch each step's decode window first and queue
        the cycle's prefill chunks behind it (the reference's decode-first
        ordering): the window's tokens (occupied lanes x width) are charged
        against the prefill-token budget, up to ``num_slots`` requests may
        be mid-prefill at once, their chunks picked shortest-remaining-first.
        Tokens are identical either way.  ``paged=False`` with it raises
        ``ValueError``.
    weights_version: a label of the parameter set served, kept as
        ``weights_version``.
    device: where the engine runs — the card unless ``device="cpu"``.

    On the card the constructor captures one CUDA graph per window kind
    (decode; linear verify, or tree draft and tree verify with its commit),
    a greedy and a sampling variant of each window that samples, and one
    per prefill bucket, on either pool; every cycle replays them.  The slab
    pool's insert of a prefilled scratch into its slot and its copy of a
    cached chunk into the scratch are a copy each and run eagerly.  ``stats`` counts, beside
    the plain counters: ``graph_captures`` and ``graph_replays`` (windows
    and chunks); ``interleaved_chunks`` (chunks dispatched behind a window
    of their cycle); ``cancelled`` (:meth:`cancel`) and ``deadline_shed``
    (requests refused at submit or cancelled by the sweep for their
    deadline); ``spec_drafted`` (draft
    tokens proposed: K per drafting lane, or ``tree_depth``),
    ``spec_accepted``, ``verify_forwards`` (verify forwards of either arm:
    one K1 launch a layer each), ``verify_lanes`` (occupied lanes summed
    over them), ``verify_committed`` (tokens they committed) and
    ``draft_s`` (the draft forwards' time on the card's stream between
    their first and last launch; host wall on the CPU); and the reference's
    pipeline accounting: ``host_overlap_ratio`` (host time between a
    window's dispatch and its drain, over that plus the drain's wait),
    ``device_idle_s`` (host wall with no window dispatched or in flight)
    and ``prefreed_lanes`` (lanes retired one cycle early because the
    window in flight provably finishes them).  ``decode_s`` is the host
    wall while some window was dispatched and not yet drained (with the
    pipeline it therefore holds the admission phases that ran under a
    window, and their chunks' card time); ``prefill_s`` the host wall of
    the admission phases that ran prefill chunks (under ``async_depth=0``
    ending in a device synchronisation; under the pipeline nothing waits
    there).

    prefix_cache_mb: byte budget (MiB) of the prefix KV cache's device
        tier (default 64, as in the reference); ``0``/``None`` turns it off.
        ``submit(..., cache_prefix=False)`` opts a request out.
    prefix_host_mb: byte budget (MiB) of the pinned host ring behind it:
        device-tier evictions demote chunks there (pages and scales copied
        off the card behind the window in flight) and a hit promotes them
        back into fresh pages.  Needs ``prefix_cache_mb``.
    prefix_disk_mb: byte budget (MiB) of a disk ring behind the host ring
        (files under ``prefix_disk_dir``).  Needs ``prefix_host_mb``.

    The cache adds to ``stats``: ``prefix_hit_tokens`` (prompt tokens
    served from the cache), ``prefix_hit_tokens_host`` (those promoted from
    the host or disk ring), ``prefix_miss_tokens`` (cache-eligible tokens
    prefilled), ``cow_copies``, ``promote_degraded`` (promotions that fell
    back to a prefill: a torn payload or page pressure),
    ``reclaim_evictions`` (cache chunks the page-reclaim ladder evicted),
    and ``spill_s``/``spill_bytes``, ``promote_s``/``promote_bytes`` (the
    transfers' time on the card's stream from CUDA events, host wall on the
    CPU, and their bytes); :meth:`prefix_cache_stats` adds the cache's own.

    On the slab pool a cached chunk is a device copy of its slab, ``[L, 1,
    chunk, Hkv, D]`` for K and V, charged against ``prefix_cache_mb``; a hit
    copies it into the scratch.

    ``mesh``, ``tp_axis`` other than ``"tp"``, ``role`` other than
    ``"both"`` (paged), ``registry`` and ``metrics_port`` raise
    ``NotImplementedError`` (ROADMAP Queue 1 item 8).
    """

    #: read by ``__init__``: capture the windows, and the prefill chunks, as
    #: CUDA graphs on the card.  Only :meth:`_eager` and :meth:`_eager_chunks`
    #: turn them off.
    _graph_windows = True
    _graph_chunks = True

    def __init__(
        self,
        model: Transformer,
        params=None,
        num_slots: int = 4,
        max_len: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        max_prompt_len: Optional[int] = None,
        prefill_token_budget: Optional[int] = None,
        decode_window: int = 4,
        pad_token_id: int = 0,
        rng_seed: int = 0,
        slot_order: Optional[Sequence[int]] = None,
        registry=None,
        paged: bool = True,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        decode_kernel: Optional[str] = None,
        prefill_kernel: Optional[str] = None,
        kv_dtype: Optional[str] = None,
        max_queue: Optional[int] = None,
        prefix_cache_mb: Optional[float] = 64.0,
        prefix_host_mb: Optional[float] = 0.0,
        prefix_disk_mb: Optional[float] = 0.0,
        prefix_disk_dir: Optional[str] = None,
        metrics_port: Optional[int] = None,
        async_depth: int = 1,
        speculate_k: int = 0,
        speculate_ngram: int = 3,
        draft_model=None,
        tree_width: int = 1,
        tree_depth: Optional[int] = None,
        draft_ctx: int = 64,
        interleave_prefill: bool = False,
        mesh=None,
        tp_axis: str = "tp",
        weights_version: str = "v0",
        role: str = "both",
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.paged = bool(paged)
        # the reference's refusals (accelerate_tpu/serving/engine.py:426-455)
        if decode_kernel not in (None, "xla", "pallas"):
            raise ValueError(f"decode_kernel must be 'xla' or 'pallas', got {decode_kernel!r}")
        if prefill_kernel not in (None, "xla", "pallas"):
            raise ValueError(f"prefill_kernel must be None, 'xla' or 'pallas', "
                             f"got {prefill_kernel!r}")
        if (decode_kernel == "pallas" or prefill_kernel == "pallas"
                or kv_dtype is not None) and not self.paged:
            raise ValueError("decode_kernel/prefill_kernel/kv_dtype act on the paged KV "
                             "pool; pass paged=True")
        self.interleave_prefill = bool(interleave_prefill)
        if self.interleave_prefill and not self.paged:
            raise ValueError("interleave_prefill needs the paged pool (the slab pool's "
                             "batch-1 prefill scratch admits one request at a time); "
                             "pass paged=True")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be 'prefill', 'decode' or 'both', got {role!r}")
        if role != "both" and not self.paged:
            raise ValueError("disaggregated roles move lanes between replicas as KV pages; "
                             "role='prefill'/'decode' requires paged=True")
        if (prefix_host_mb or 0.0) and not (self.paged and prefix_cache_mb):
            raise ValueError("prefix_host_mb spills prefix pages; it requires paged=True and "
                             "an enabled prefix cache (prefix_cache_mb > 0)")
        if mesh is not None:
            raise _not_ported("mesh= (tensor-parallel serving)", "8")
        if tp_axis != "tp":
            raise _not_ported("tp_axis= (tensor-parallel serving)", "8")
        if role != "both":
            raise _not_ported(f"role={role!r} (disaggregated prefill/decode)", "8")
        if registry is not None:
            raise _not_ported("registry= (the telemetry registry)", "8")
        if metrics_port is not None:
            raise _not_ported("metrics_port= (the metrics endpoint)", "8")
        #: which attention the paged pool runs: the kernels ("pallas") or
        #: their plain versions ("xla"); the prefill follows unless forced.
        #: Sliding-window and alibi models take the plain versions, as the
        #: reference's config sends them to its XLA path and refuses its
        #: kernels for them (accelerate_tpu/models/transformer.py:237-244)
        full_causal = model.config.full_causal
        for name, kernel in (("decode_kernel", decode_kernel),
                             ("prefill_kernel", prefill_kernel)):
            if kernel == "pallas" and not full_causal:
                raise ValueError(
                    f"{name}='pallas' supports full-causal rope/learned models; "
                    "sliding_window and alibi need the 'xla' reference path")
        self.decode_kernel = decode_kernel or ("pallas" if full_causal else "xla")
        self.prefill_kernel = prefill_kernel or self.decode_kernel
        #: label of the parameter set served
        self.weights_version = str(weights_version)
        self.async_depth = int(async_depth)
        if self.async_depth not in (0, 1):
            raise ValueError(f"async_depth must be 0 (synchronous) or 1 (depth-1 pipeline), "
                             f"got {async_depth}")
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, assign=True)
        if model.device != self.device:
            raise ValueError(f"model weights lie on {model.device}, engine runs on {self.device}")
        cfg = model.config
        self.model = model
        self.num_slots = int(num_slots)
        self.max_len = int(max_len if max_len is not None else cfg.max_seq_len)
        self.max_prompt_len = int(max_prompt_len if max_prompt_len is not None else self.max_len)
        if self.max_prompt_len > self.max_len:
            raise ValueError(f"max_prompt_len {self.max_prompt_len} > slot capacity {self.max_len}")
        if prefill_buckets is None:
            prefill_buckets = [b for b in (128, 512) if b <= self.max_prompt_len]
            if not prefill_buckets:
                prefill_buckets = [self.max_prompt_len]
        self.buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if self.buckets[-1] > self.max_prompt_len:
            raise ValueError(f"largest prefill bucket {self.buckets[-1]} exceeds "
                             f"max_prompt_len {self.max_prompt_len}")
        self.window = int(decode_window)
        self.speculate_k = int(speculate_k)
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        self.speculate_ngram = int(speculate_ngram)
        self.tree_width = int(tree_width)
        self.tree_depth = int(tree_depth if tree_depth is not None
                              else (self.speculate_k if self.speculate_k else 4))
        self.draft_ctx = int(draft_ctx)
        self.tree: Optional[TreeSpec] = None
        if draft_model is None:
            if self.tree_width != 1:
                raise ValueError("tree_width > 1 needs a draft model to rank sibling "
                                 "branches; pass draft_model=")
        else:
            if self.draft_ctx < 1:
                raise ValueError(f"draft_ctx must be >= 1, got {draft_ctx}")
            if not cfg.full_causal:
                raise ValueError("tree speculation needs a full-causal model: the ancestor "
                                 "mask replaces the causal row mask, which sliding_window "
                                 "and alibi models reshape")
            self.tree = TreeSpec(self.tree_width, self.tree_depth)
            if self.tree.nodes > MAX_TREE_NODES:
                raise ValueError(
                    f"tree has {self.tree.nodes} nodes but K1's tree-mask arm packs a "
                    f"node's ancestors into a uint32 word (<= {MAX_TREE_NODES} nodes); "
                    "shrink tree_width/tree_depth")
        # the widest pass one cycle can write at a lane's frontier
        self._spec_span = self.tree.nodes if self.tree is not None else self.speculate_k + 1
        self._spec_any = self.tree is not None or self.speculate_k > 0
        self.pad_token_id = int(pad_token_id)
        self.rng_seed = int(rng_seed)
        if slot_order is None:
            slot_order = range(self.num_slots)
        self.slot_order = tuple(int(s) for s in slot_order)
        if sorted(self.slot_order) != list(range(self.num_slots)):
            raise ValueError(f"slot_order must permute range({self.num_slots}), "
                             f"got {self.slot_order}")
        self.kv: Optional[PagedKVPool] = None
        self.pool: Optional[KVCache] = None
        self.scratch: Optional[KVCache] = None
        self.page_size = self.num_pages = None
        if self.paged:
            self.page_size = int(page_size if page_size is not None
                                 else math.gcd(*self.buckets))
            if any(b % self.page_size for b in self.buckets):
                raise ValueError(f"page_size {self.page_size} must divide every prefill "
                                 f"bucket, got {self.buckets}")
            self.num_pages = int(num_pages if num_pages is not None
                                 else self.num_slots * (self.max_len // self.page_size) + 1)
            self.kv = PagedKVPool(cfg, self.num_slots, self.max_len, self.page_size,
                                  self.num_pages, kv_dtype=kv_dtype, device=self.device)
            kv = self.kv
            self._pool = (kv.pages_k, kv.pages_v, kv.k_scales, kv.v_scales)
            self.quantized = kv.quantized
            kv_bytes_per_token = kv.kv_bytes_per_token
        else:
            # the slab pool and the batch-1 prefill scratch (the reference's
            # accelerate_tpu/serving/engine.py:600-602); their index is the
            # engine's static ``_index`` / ``_chunk_base``, so only k and v
            # are used from these
            self.pool = KVCache.create(cfg, self.num_slots, self.max_len, device=self.device)
            self.scratch = KVCache.create(cfg, 1, self.max_prompt_len, device=self.device)
            self.quantized = False
            kv_bytes_per_token = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim
                                  * self.pool.k.element_size())
        host_bytes = int((prefix_host_mb or 0.0) * 2**20)
        disk_bytes = int((prefix_disk_mb or 0.0) * 2**20)
        if disk_bytes and not host_bytes:
            raise ValueError("prefix_disk_mb sits behind the host ring; set prefix_host_mb")
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache_mb:
            self.prefix_cache = PrefixCache(
                int(prefix_cache_mb * 2**20),
                on_evict=self._on_prefix_evict if self.paged else None,
                host_capacity_bytes=host_bytes, spill=self._spill_node if host_bytes else None,
                disk_capacity_bytes=disk_bytes, disk_dir=prefix_disk_dir)
        # prefix-cache spills and promotions enqueued since the last
        # dispatch: they ride the next window and settle at its drain
        self._pending_spills: List[CacheTransfer] = []
        self._pending_promotions: List[CacheTransfer] = []
        self.scheduler = Scheduler(
            self.buckets,
            prefill_token_budget if prefill_token_budget is not None else self.buckets[-1],
            max_queue=max_queue, prefix_cache=self.prefix_cache,
            # interleaved: one open prefill per slot, SRTF among them
            max_prefills=self.num_slots if self.interleave_prefill else 1,
        )

        n = self.num_slots
        # host mirrors of the lane state; ``lanes`` holds the device copy
        self._slot_req: List[Optional[Request]] = [None] * n
        self._active = np.zeros(n, bool)
        self._eos = np.full(n, -1, np.int32)
        # each lane's KV write index: install sets it to prompt_len - 1, decode
        # advances it by the window — exact integer arithmetic on the host
        self._lane_len = np.zeros(n, np.int32)
        self._reserved_slots: set = set()
        self.lanes = LaneState.create(n, self.device)
        self._ngram: Optional[NgramDrafter] = None
        self._draft_window: Optional[DraftContextWindow] = None
        self.drafter = None
        if self.tree is not None:
            # tree speculation: the draft model, its context window, and the
            # ancestor mask with its packed words on the card, made once
            draft_cfg, draft_sd = build_draft(cfg, model.state_dict(), draft_model,
                                              draft_ctx=self.draft_ctx, depth=self.tree_depth,
                                              device=self.device)
            self.draft = draft_transformer(draft_cfg, draft_sd, self.device)
            self._tree_mask = TreeMask(self.tree.anc)
            # both device copies made now, never inside a capture: K1's
            # packed words, the bool mask of plain attention
            self._tree_mask.words(self.device)
            self._tree_mask.dense(self.device)
            self.tree.on(self.device)
            self._draft_window = DraftContextWindow(n, self.draft_ctx, pad=self.pad_token_id)
            self.drafter = TreeDrafter(self.tree, draft_cfg,
                                       make_draft_forward(self.draft, self.tree, self.draft_ctx))
        elif self.speculate_k:
            self._ngram = self.drafter = NgramDrafter(max_ngram=self.speculate_ngram)
        self._next_rid = 0
        #: plain counters; ``prefill_s`` / ``decode_s`` are host wall seconds
        #: (see the class docstring)
        self.stats = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "tokens_generated": 0,
            "prefill_chunks": 0,
            "prefill_tokens": 0,
            "interleaved_chunks": 0,
            "decode_steps": 0,
            "preemptions": 0,
            "prefill_s": 0.0,
            "decode_s": 0.0,
            "kv_quant_error": 0.0,
            "kv_bytes_per_token": kv_bytes_per_token,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "verify_forwards": 0,
            "verify_lanes": 0,
            "verify_committed": 0,
            "draft_s": 0.0,
            "graph_captures": 0,
            "graph_replays": 0,
            "host_overlap_ratio": 0.0,
            "device_idle_s": 0.0,
            "prefreed_lanes": 0,
            "prefix_hit_tokens": 0,
            "prefix_hit_tokens_host": 0,
            "prefix_miss_tokens": 0,
            "cow_copies": 0,
            "promote_degraded": 0,
            "reclaim_evictions": 0,
            "spill_s": 0.0,
            "spill_bytes": 0,
            "promote_s": 0.0,
            "promote_bytes": 0,
            "cancelled": 0,
            "deadline_shed": 0,
        }
        # the depth-1 pipeline: the at-most-one window in flight (always
        # None under async_depth=0), and the reference's overlap accounting
        self._inflight: Optional[Readback] = None
        # the window a step's dispatch handed back, parked between dispatch
        # and drain (interleaved admission runs in between: a forced flush
        # there lands it before the newer window)
        self._prev_handle: Optional[Readback] = None
        # tokens the decode window of this cycle charges against the joint
        # budget (read by interleaved admission only)
        self._cycle_decode_tokens = 0
        # deadlines: the service-time average behind submit's estimate, and
        # whether the sweep has a live deadline to watch
        self._service_ema = 0.0
        self._has_deadlines = False
        self._overlap_host_s = 0.0
        self._overlap_wait_s = 0.0
        self._t_pipeline_empty: Optional[float] = None
        self._busy_since: Optional[float] = None
        # quantization errors of prefill chunks, staged with the next window
        self._pending_prefill_qerr: List[torch.Tensor] = []

        # the windows' static inputs: written in place before each cycle
        dev = self.device
        if self.paged:
            self._tables = torch.zeros((n, self.kv.pages_per_lane), dtype=torch.int32,
                                       device=dev)
        self._index = torch.zeros(n, dtype=torch.int32, device=dev)
        if self.tree is not None:
            self._ctx = torch.zeros((n, self.draft_ctx), dtype=torch.int32, device=dev)
            self._ctx_len = torch.zeros(n, dtype=torch.int32, device=dev)
            self._draft_tokens = torch.zeros((n, self.tree.nodes), dtype=torch.int32, device=dev)
        elif self.speculate_k:
            self._drafts = torch.zeros((n, self.speculate_k), dtype=torch.int32, device=dev)
        self._windows = self._window_programs()
        # the prefill chunk's static inputs: tokens per bucket, the lane's
        # block table (paged) and the chunk's start position (on the slab
        # pool, the scratch's write index)
        self._chunk_tokens = {b: torch.zeros((1, b), dtype=torch.int32, device=dev)
                              for b in self.buckets}
        self._chunk_base = torch.zeros(1, dtype=torch.int32, device=dev)
        if self.paged:
            self._chunk_table = torch.zeros((1, self.kv.pages_per_lane), dtype=torch.int32,
                                            device=dev)
            plain = self.prefill_kernel == "xla"
            self._chunks = {b: functools.partial(prefill_chunk, self.model,
                                                 self._chunk_tokens[b], *self._pool,
                                                 self._chunk_table, self._chunk_base,
                                                 plain=plain)
                            for b in self.buckets}
        else:
            self._chunks = {b: functools.partial(slab_prefill_chunk, self.model,
                                                 self._chunk_tokens[b], self.scratch.k,
                                                 self.scratch.v, self._chunk_base)
                            for b in self.buckets}
        self.graphs: Optional[WindowGraphs] = None
        if dev.type == "cuda" and (self._graph_windows or self._graph_chunks):
            self.graphs = WindowGraphs(dev)
        if self.graphs is not None and self._graph_windows:
            for (kind, sampling), fn in self._windows.items():
                self.graphs.capture(self._graph_key(kind, sampling), fn, self._reset_lanes)
                self.stats["graph_captures"] += 1
        if self.graphs is not None and self._graph_chunks:
            # captured with the table all null page and base 0: the capture's
            # writes land in the garbage sink, as inactive lanes' do (on the
            # slab pool in the idle scratch)
            for b, fn in self._chunks.items():
                self.graphs.capture(self._chunk_key(b), fn, lambda: None)
                self.stats["graph_captures"] += 1

    @classmethod
    def _eager(cls, *args, **kwargs) -> "ServingEngine":
        """An engine whose windows and prefill chunks run launch by launch
        instead of as CUDA graphs: the A/B baseline of ``profile_engine`` and
        ``chip_smoke.py`` (with ``async_depth=0``, the loop before graphs and
        the pipeline).  Same arguments as the constructor."""
        engine = cls.__new__(cls)
        engine._graph_windows = engine._graph_chunks = False
        engine.__init__(*args, **kwargs)
        return engine

    @classmethod
    def _eager_chunks(cls, *args, **kwargs) -> "ServingEngine":
        """An engine whose windows are CUDA graphs but whose prefill chunks
        run launch by launch: the A/B baseline of the chunk graphs
        (``profile_engine``).  Same arguments as the constructor."""
        engine = cls.__new__(cls)
        engine._graph_chunks = False
        engine.__init__(*args, **kwargs)
        return engine

    # --------------------------------------------------------------- windows
    def _window_programs(self) -> dict:
        """``(kind, sampling) -> fn()``: each window over the engine's static
        buffers, greedy and sampling variants of the windows that sample.
        The same functions run eagerly (CPU, :meth:`_eager`) and are
        captured as graphs."""
        lanes, pad = self.lanes, self.pad_token_id
        windows = {}
        if self.paged:
            pool = (*self._pool, self._tables, self._index)
            plain = self.decode_kernel == "xla"
            decode = functools.partial(decode_window, self.model, self.window, *pool, lanes, pad,
                                       plain=plain)
            tree = (None if self.tree is None else functools.partial(
                tree_verify_window, self.model, self.tree, self._tree_mask, *pool,
                self._draft_tokens, lanes, pad, plain=plain))
            verify = functools.partial(verify_window, self.model, *pool, plain=plain)
        else:
            pool = (self.pool.k, self.pool.v, self._index)
            decode = functools.partial(slab_decode_window, self.model, self.window, *pool,
                                       lanes, pad)
            tree = (None if self.tree is None else functools.partial(
                slab_tree_verify_window, self.model, self.tree, self._tree_mask, *pool,
                self._draft_tokens, lanes, pad))
            verify = functools.partial(slab_verify_window, self.model, *pool)
        for sampling in (False, True):
            windows["decode", sampling] = functools.partial(decode, sampling=sampling)
            if tree is not None:
                windows["tree", sampling] = functools.partial(tree, sampling=sampling)
            elif self.speculate_k:
                windows["verify", sampling] = functools.partial(self._verify_program, verify,
                                                                sampling)
        if self.tree is not None:
            windows["draft", False] = self._draft_program
        return windows

    def _verify_program(self, verify, sampling: bool):
        tokens = torch.cat([self.lanes.pending[:, None], self._drafts], dim=1)
        return verify(tokens, self.lanes, self.pad_token_id, sampling=sampling)

    def _draft_program(self):
        self._draft_tokens.copy_(self.drafter.propose_device(self._ctx, self._ctx_len))

    def _pool_key(self, scratch: bool = False) -> tuple:
        """The KV a graph runs on: the pool's kind, its width (table width,
        or the length of the slab pool or, for a chunk, of its scratch) and
        its storage dtype."""
        if self.paged:
            return ("paged", self.kv.pages_per_lane, self.kv.storage_dtype)
        slab = self.scratch if scratch else self.pool
        return ("slab", slab.k.shape[2], slab.k.dtype)

    def _graph_key(self, kind: str, sampling: bool) -> tuple:
        span = self.window if kind == "decode" else self._spec_span
        return (kind, self.num_slots, span, sampling, *self._pool_key())

    def _chunk_key(self, bucket: int) -> tuple:
        return ("prefill", bucket, *self._pool_key(scratch=True))

    def _reset_lanes(self) -> None:
        """Undo a capture warm-up's writes: every lane was inactive (its KV
        writes went to the null page), but the windows rewrite the pending
        tokens and advance the draw counters."""
        self.lanes.pending.zero_()
        self.lanes.keys.zero_()

    def _run(self, kind: str):
        """Run one window: replay its graph on the card, else call it.  The
        variant follows host state: does some lane sample?"""
        sampling = kind != "draft" and self.lanes.any_sampled
        if self.graphs is None:
            return self._windows[kind, sampling]()
        self.stats["graph_replays"] += 1
        return self.graphs.replay(self._graph_key(kind, sampling))

    # ---------------------------------------------------------------- submit
    def submit(self, prompt, config: Optional[GenerationConfig] = None,
               on_token: Optional[Callable[[Request, int], None]] = None,
               cache_prefix: bool = True, speculate: bool = True,
               deadline_s: Optional[float] = None, request_class: Optional[str] = None,
               tenant: Optional[str] = None, **overrides) -> Request:
        """Queue one request; returns its :class:`Request` handle (filled in
        as the engine runs).  ``overrides`` patch the ``GenerationConfig``;
        ``cache_prefix=False`` opts the request out of prefix-KV reuse and
        population (prompts that must not be retained); ``speculate=False``
        opts it out of drafting.  ``deadline_s``: the request's budget in
        seconds from now.  When the queue ahead of it (requests waiting or
        mid-prefill, each costing the running average of completed
        requests' submit-to-done time) already exceeds it, the submit raises
        a retriable :class:`AdmissionError` with ``retry_after_s``; once
        admitted, a step that finds it past its budget cancels it (queued
        or running) and sets ``deadline_exceeded``.  ``request_class`` and
        ``tenant`` (the reference's per-class and per-tenant accounting)
        raise ``NotImplementedError``."""
        if request_class is not None:
            raise _not_ported("submit(request_class=) (per-class latency histograms)", "8")
        if tenant is not None:
            raise _not_ported("submit(tenant=) (per-tenant accounting)", "8")
        gen = config or GenerationConfig()
        if overrides:
            gen = dataclasses.replace(gen, **overrides)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        depth = self.scheduler.queue_depth
        if prompt.size > self.max_prompt_len:
            raise AdmissionError(
                f"prompt length {prompt.size} > max_prompt_len {self.max_prompt_len}",
                queue_depth=depth, retriable=False)
        # headroom for the widest pass a cycle writes at the frontier: a
        # decode window, a linear verify (K + 1) or a tree verify (its nodes)
        span = max(self.window, self._spec_span)
        need = prompt.size + gen.max_new_tokens + span
        if need > self.max_len:
            raise AdmissionError(
                f"prompt {prompt.size} + max_new_tokens {gen.max_new_tokens} + "
                f"max(decode_window, speculation span) {span} = {need} exceeds slot "
                f"capacity {self.max_len}", queue_depth=depth, retriable=False)
        # the padded final chunk must fit the prefill's write target: the
        # lane's pages, or the slab pool's scratch
        padded = sum(b for b, _ in plan_chunks(prompt.size, self.buckets))
        cap = self.max_len if self.paged else self.max_prompt_len
        if padded > cap:
            raise AdmissionError(
                f"prompt {prompt.size} pads to {padded} prefill tokens under buckets "
                f"{self.buckets}, exceeding capacity {cap}",
                queue_depth=depth, retriable=False)
        if deadline_s is not None:
            # each request ahead costs about one service time; optimistic
            # (admits everything) before the first completion
            est = depth * self._service_ema
            if est > float(deadline_s):
                self.stats["deadline_shed"] += 1
                raise AdmissionError(
                    f"deadline {deadline_s}s unmeetable: ~{est:.2f}s of queued work ahead "
                    f"({depth} requests)", queue_depth=depth,
                    retry_after_s=min(30.0, max(est - float(deadline_s), 0.1)), retriable=True)
        req = Request(rid=self._next_rid, prompt=prompt, config=gen, on_token=on_token,
                      cache_prefix=bool(cache_prefix), speculate=bool(speculate),
                      submit_time=clock(),
                      deadline_s=None if deadline_s is None else float(deadline_s))
        self._next_rid += 1
        self.scheduler.submit(req)
        self.stats["requests_submitted"] += 1
        if deadline_s is not None:
            self._has_deadlines = True
        return req

    def cancel(self, request: Union[Request, int]) -> bool:
        """Cancel a queued or running request (its :class:`Request` or rid).
        A queued one leaves the queue and releases its cache pins; a running
        lane retires now: its slot frees for the next admission, its tokens
        from a window in flight are dropped at that window's drain, and its
        pages free when that window retires (at once with none in flight).
        Tokens already streamed stay.  True when cancelled (the state becomes
        ``CANCELLED``); False for a request mid-prefill, done or unknown."""
        rid = request.rid if isinstance(request, Request) else int(request)
        if self.scheduler.cancel(rid) is not None:
            self.stats["cancelled"] += 1
            return True
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or req.rid != rid or not self._active[s]:
                continue
            self._retire_lane(s)
            req.state = RequestState.CANCELLED
            self.stats["cancelled"] += 1
            return True
        return False

    def _shed_blown_deadlines(self) -> None:
        """The deadline sweep (only while a deadline is live): cancel the
        running lanes and queued requests past their ``deadline_s``, setting
        ``deadline_exceeded``.  A request mid-prefill finishes its chunks;
        the sweep catches it once it runs."""
        now = clock()
        live = False
        st = self.stats
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or req.deadline_s is None or not self._active[s]:
                continue
            if now - req.submit_time <= req.deadline_s:
                live = True
                continue
            self._retire_lane(s)
            req.deadline_exceeded = True
            req.state = RequestState.CANCELLED
            st["deadline_shed"] += 1
        for req in list(self.scheduler.queue):
            if req.deadline_s is None:
                continue
            if now - req.submit_time <= req.deadline_s:
                live = True
                continue
            self.scheduler.cancel(req.rid)
            req.deadline_exceeded = True
            st["deadline_shed"] += 1
        self._has_deadlines = live or any(r.deadline_s is not None
                                          for r in self.scheduler.prefills)

    # ------------------------------------------------------------- admission
    def _next_free_slot(self) -> Optional[int]:
        for s in self.slot_order:
            if not self._active[s] and self._slot_req[s] is None \
                    and s not in self._reserved_slots:
                return s
        return None

    def _reclaim_pages(self, need: int, allow_preempt: bool) -> bool:
        """Free pages until ``need`` are available, by the reference's
        ladder, cheapest first (``accelerate_tpu/serving/engine.py:
        1878-1902``): (1) evict an unpinned prefix-cache leaf (dropping the
        cache's references frees the pages no lane aliases); (2) drain the
        windows in flight when pages wait on one (its deferred pages then
        free; the window parked by interleaved admission lands first); (3)
        when allowed, preempt the youngest running lane; (4) drop
        queued requests' cache pins, so that (1) reaches more leaves.  False
        when nothing is left to reclaim."""
        while self.kv.allocator.free_count < need:
            if self.prefix_cache is not None and self.prefix_cache.evict_one():
                self.stats["reclaim_evictions"] += 1
                continue
            if any(hd is not None and hd.deferred_pages
                   for hd in (self._inflight, self._prev_handle)):
                self._drain_inflight()
                continue
            if allow_preempt and self._preempt():
                continue
            if self.scheduler.drop_cache_pins() > 0:
                continue
            return False
        return True

    def _admission_pages_ok(self, req: Request) -> bool:
        """Can the queue head's whole prefill be paged in, without preempting
        a running lane (evicting one to admit behind it would invert FCFS)?
        Device-tier cached chunks alias pages and cost none; spilled ones are
        promoted into fresh pages and are charged (the count uses the match
        from submit, which admission may lengthen)."""
        padded = sum(b for b, _ in req.chunks)
        cached = sum(b for i, (b, _) in enumerate(req.chunks[:req.cached_chunks])
                     if i < len(req.cache_nodes) and req.cache_nodes[i].tier == "device")
        return self._reclaim_pages((padded - cached) // self.page_size, allow_preempt=False)

    def _ensure_prefill_pages(self, req: Request) -> bool:
        """Pages for ``req``'s next chunk (the scheduler's ``ready`` gate): none
        for a device-tier hit, a bucket's worth otherwise."""
        if req.next_chunk >= len(req.chunks):
            return True
        if req.next_chunk < req.cached_chunks:
            node = (req.cache_nodes[req.next_chunk]
                    if req.next_chunk < len(req.cache_nodes) else None)
            if node is None or node.tier == "device":
                return True
        bucket, _ = req.chunks[req.next_chunk]
        return self._reclaim_pages(bucket // self.page_size, allow_preempt=False)

    def _prefill_chunk(self, req: Request, bucket: int, chunk: np.ndarray,
                       start: int) -> Optional[torch.Tensor]:
        """Prefill one chunk: on the paged pool straight into newly allocated
        lane pages, on the slab pool into the scratch at ``start``; returns
        its quantization error (a device scalar of its own; ``None`` on the
        slab pool).  The chunk's tokens, table and start go into the static
        buffers by non-blocking copies from pageable memory (staged at the
        call, so the host arrays may change on return; nothing waits for a
        window in flight), then the bucket's graph replays (on the CPU and
        in :meth:`_eager` engines the same program runs launch by launch).
        The table maps the lane's shared prefix pages too: a chunk after a
        hit reads the cached KV in place, behind any copy-on-write or
        promotion on the same stream."""
        if self.paged:
            s = req.slot
            ids = self.kv.allocator.alloc(bucket // self.page_size)
            if ids is None:  # _ensure_prefill_pages ran first; this cannot happen
                raise RuntimeError("KV page pool exhausted mid-prefill")
            self.kv.lane_append_owned(s, ids)
            self._chunk_table.copy_(torch.from_numpy(self.kv.tables[s:s + 1]),
                                    non_blocking=True)
        self._chunk_tokens[bucket].copy_(torch.from_numpy(chunk[None]), non_blocking=True)
        self._chunk_base.fill_(start)
        if self.graphs is None or not self._graph_chunks:
            return self._chunks[bucket]()
        self.stats["graph_replays"] += 1
        err = self.graphs.replay(self._chunk_key(bucket))
        # the replay's output is rewritten by the next one: keep a copy
        return err.clone() if self.quantized else err

    def _admit(self) -> None:
        """Open prefills and run chunks against this step's budget (less the
        tokens of a window dispatched ahead, under interleave)."""
        sched = self.scheduler
        budget = sched.begin_step(self._cycle_decode_tokens if self.interleave_prefill else 0)
        t0 = time.perf_counter()
        chunks = 0
        st = self.stats
        while True:
            # open prefills, FCFS, up to the scheduler's cap while slots and
            # pages allow
            while sched.queue and len(sched.prefills) < sched.max_prefills:
                slot = self._next_free_slot()
                if slot is None or (self.paged and not self._admission_pages_ok(sched.queue[0])):
                    break
                sched.start_next(slot)
                self._reserved_slots.add(slot)
            if not sched.prefills:
                break
            took = sched.take_chunk(budget,
                                    ready=self._ensure_prefill_pages if self.paged else None)
            if took is None:
                break  # budget spent or page pressure: retry next step
            req, bucket, valid, start, cached = took
            chunks += 1
            if cached:
                node = req.cache_nodes[req.next_chunk - 1]
                spilled = node.tier != "device"
                if not self.paged:
                    # replay the cached slab into the scratch: one copy on
                    # the stream, no forward, no budget charged
                    copy_chunk(self.scratch.k, self.scratch.v, node.k, node.v, start)
                elif not spilled:
                    # the zero-copy hit: the node's pages join the lane's table
                    self.kv.lane_append_shared(req.slot, node.pages)
                elif not self._promote_node(req, node, bucket):
                    # a degraded promotion (a torn payload or page pressure)
                    # prefills the chunk instead; _populate_cache heals the
                    # node with the fresh pages
                    cached = False
                    st["promote_degraded"] += 1
                if cached:
                    st["prefix_hit_tokens"] += valid
                    if spilled:
                        st["prefix_hit_tokens_host"] += valid
            if not cached:
                chunk = np.zeros(bucket, np.int32)
                chunk[:valid] = req.prefill_tokens[start:start + valid]
                err = self._prefill_chunk(req, bucket, chunk, start)
                if self.quantized:
                    self._pending_prefill_qerr.append(err)
                budget -= bucket
                st["prefill_chunks"] += 1
                if self.interleave_prefill and self._cycle_decode_tokens:
                    # queued behind this cycle's window: the interleave happened
                    st["interleaved_chunks"] += 1
                if self.prefix_cache is not None and req.cache_prefix:
                    st["prefix_miss_tokens"] += valid
                    self._populate_cache(req, bucket, valid, start)
            st["prefill_tokens"] += valid
            done = sched.finish_prefill()
            if done is not None:
                self._install(done)
        if chunks:
            if self.async_depth == 0 and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            st["prefill_s"] += time.perf_counter() - t0

    def _install(self, req: Request) -> None:
        """Hand a fully prefilled request its lane.  Paged: its pages
        already hold the prompt's KV (its own, or aliased cache pages); only
        a shared tail page is copied on write before decode writes into it.
        Slab: the scratch is copied into the lane's slot.  The last prompt
        token stays pending so the first decode step computes the first
        generated token.  The copies and the lane vectors' edits are
        enqueued on the card's stream, behind any window in flight (which
        may still write the slot of a lane retired under it)."""
        s = req.slot
        ptoks = req.prefill_tokens
        if self.paged:
            self._cow_tail_page(s, len(ptoks))
        else:
            slab_insert(self.pool.k, self.pool.v, self.scratch.k, self.scratch.v, s)
        self._lane_len[s] = len(ptoks) - 1
        gen = req.config
        eos = -1 if gen.eos_token_id is None else int(gen.eos_token_id)
        sampled = gen.do_sample and gen.temperature > 0.0
        self.lanes.install(
            s, int(ptoks[-1]), eos, float(gen.temperature),
            0 if gen.top_k is None else int(gen.top_k),
            1.0 if gen.top_p is None else float(gen.top_p),
            lane_key(self.rng_seed, req.rid) if sampled else None,
        )
        if self._draft_window is not None:
            # the window's last token is the lane's pending token: the root
            # of every draft tree
            self._draft_window.begin(s, ptoks)
        self._active[s] = True
        self._eos[s] = eos
        self._slot_req[s] = req
        self._reserved_slots.discard(s)
        # the lane holds its own references now: the nodes this request read
        # or populated may go
        if self.prefix_cache is not None and req.cache_nodes:
            self.prefix_cache.release(req.cache_nodes)
            req.cache_nodes = []
        req.state = RequestState.RUNNING

    # ---------------------------------------------------------- prefix cache
    def _populate_cache(self, req: Request, bucket: int, valid: int, start: int) -> None:
        """Retain a freshly prefilled full chunk.  Paged: the node takes the
        lane's own page ids and one allocator reference per page, so the KV
        outlives the lane.  Slab: the node takes its own device copy of the
        chunk's scratch rows (the reference's ``PrefixCache.insert``),
        charged at its bytes.  A padded final chunk is skipped (its KV past
        ``valid`` is garbage), and once a chunk fails to retain the rest of
        the request's chain is abandoned: a child without its ancestors is
        unreachable."""
        if valid != bucket or req.cache_chain_broken:
            return
        parent = req.cache_nodes[-1] if req.cache_nodes else None
        tokens = req.prefill_tokens[start:start + bucket]
        if self.paged:
            npg = bucket // self.page_size
            ids = self.kv.chunk_ids(req.slot, start // self.page_size, npg)
            node = self.prefix_cache.insert_pages(parent, tokens, ids,
                                                  nbytes=self.kv.chunk_bytes(npg))
            if node is not None and node.pages == tuple(ids):
                # a new node (or a spilled one healed with these pages) holds
                # its own references, dropped by _on_prefix_evict
                self.kv.allocator.ref(ids)
        else:
            rows = slice(start, start + bucket)
            node = self.prefix_cache.insert(parent, tokens, self.scratch.k[:, :, rows].clone(),
                                            self.scratch.v[:, :, rows].clone())
        if node is None:
            req.cache_chain_broken = True
            return
        self.prefix_cache.acquire([node])
        req.cache_nodes.append(node)

    def _cow_tail_page(self, s: int, plen: int) -> None:
        """Copy-on-write of the one page where sharing and writing meet: the
        page holding position ``plen - 1``, the lane's first decode write.
        Chunk starts are page-aligned, so every other shared page lies
        before the frontier and every later page is the lane's own.  The
        copy is enqueued on the stream behind any window in flight and
        writes the pool in place.  Re-checked after each reclaim: an
        eviction may dissolve the sharing."""
        pslot = (plen - 1) // self.page_size
        pid = int(self.kv.tables[s, pslot])
        while int(self.kv.allocator.refs[pid]) > 1:
            new = self.kv.allocator.alloc(1)
            if new is None:
                if not self._reclaim_pages(1, allow_preempt=True):
                    raise RuntimeError("KV page pool exhausted during copy-on-write")
                continue
            copy_page(self._pool, pid, new[0])
            self.kv.lane_replace(s, pslot, new[0])
            self.stats["cow_copies"] += 1
            return

    def _on_prefix_evict(self, node) -> None:
        """The cache's eviction hook: drop the node's references on its pages
        (pages lanes still alias survive).  A spilled node arrives with no
        pages: :meth:`_spill_node` dropped them."""
        if node.pages:
            self.kv.allocator.deref(node.pages)

    def _marks(self):
        """CUDA events around a transfer on the stream, or ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        marks[0].record()
        return marks

    def _spill_node(self, node) -> CacheTransfer:
        """The cache's spill hook: gather the node's pages and scales on the
        card and copy them into pinned host buffers, behind the work already
        on the stream, then drop the node's page references at once (any
        later write to a page that frees is ordered behind the gather on the
        same stream).  Nothing waits: the transfer is the node's payload in
        flight until the drain of the window it rides lands it."""
        t0 = time.perf_counter()
        ids = torch.tensor(node.pages, dtype=torch.int64).to(self.device, non_blocking=True)
        on_card = self.device.type == "cuda"
        # the pinned buffers first, so that the events time the transfer alone
        host = tuple(torch.empty((t.shape[0], len(node.pages), *t.shape[2:]), dtype=t.dtype,
                                 pin_memory=True) for t in self._pool) if on_card else ()
        marks = self._marks()
        gathered = spill_extract(self._pool, ids)
        if on_card:
            for h, g in zip(host, gathered):
                h.copy_(g, non_blocking=True)
            marks[1].record()
        else:
            host = gathered
        self.kv.allocator.deref(node.pages)
        xfer = CacheTransfer("spill", sum(t.numel() * t.element_size() for t in gathered),
                             node=node, gathered=gathered, host=host, marks=marks,
                             seconds=time.perf_counter() - t0)
        self._pending_spills.append(xfer)
        return xfer

    def _promote_node(self, req: Request, node, bucket: int) -> bool:
        """Promote one spilled chunk for ``req``: allocate fresh pages, copy
        the payload up (from its pinned buffers, non-blocking; or straight
        from the device gather of a spill not drained yet) and install it
        into the pages in place, all behind the window in flight.  The pages
        join the lane; the node re-enters the device tier when the budget
        allows, taking its own references.  False, with nothing installed,
        on a missing or torn payload or unrecoverable page pressure: the
        chunk then prefills."""
        payload = self.prefix_cache.node_payload(node)
        if payload is None:
            return False
        npg = bucket // self.page_size
        chunk = payload.gathered if isinstance(payload, CacheTransfer) else payload
        want = [(t.shape[0], npg, *t.shape[2:]) for t in self._pool]
        if len(chunk) != len(want) or any(tuple(c.shape) != w or c.dtype != t.dtype
                                          for c, w, t in zip(chunk, want, self._pool)):
            return False
        ids = self.kv.allocator.alloc(npg)
        if ids is None:
            if not self._reclaim_pages(npg, allow_preempt=False):
                return False
            ids = self.kv.allocator.alloc(npg)
            if ids is None:
                return False
        t0 = time.perf_counter()
        marks = self._marks()
        source = () if isinstance(payload, CacheTransfer) else payload
        chunk = tuple(c.to(self.device, non_blocking=True) for c in chunk)
        promote_install(self._pool, chunk,
                        torch.tensor(ids, dtype=torch.int64).to(self.device, non_blocking=True))
        if marks:
            marks[1].record()
        self.kv.lane_append_owned(req.slot, ids)  # the lane takes the allocation's reference
        if self.prefix_cache.promote_node(node, ids):
            self.kv.allocator.ref(ids)
        self._pending_promotions.append(CacheTransfer(
            "promote", sum(c.numel() * c.element_size() for c in chunk), host=source,
            marks=marks, seconds=time.perf_counter() - t0))
        return True

    def _settle(self, spills: List[CacheTransfer], promotions: List[CacheTransfer]) -> None:
        """Land cache transfers (after the fetch of the window they rode, so
        nothing waits): a spill's host buffers become its node's payload
        unless the node moved on meanwhile (promoted, healed or dropped); a
        promotion's source buffers are released.  Their times and bytes go
        to ``stats``."""
        st = self.stats
        for xfer in spills:
            st["spill_s"] += xfer.finish()
            st["spill_bytes"] += xfer.nbytes
            if self.prefix_cache is not None and xfer.node.host is xfer:
                self.prefix_cache.settle_payload(xfer.node, xfer.host)
        for xfer in promotions:
            st["promote_s"] += xfer.finish()
            st["promote_bytes"] += xfer.nbytes

    def _hand_cache_traffic(self, hd: Optional[Readback]) -> None:
        """Attach the traffic enqueued since the last hand-off to ``hd``, the
        newest window (it retires no earlier than that traffic): the prefix
        cache's transfers settle at its drain, and the prefill chunks'
        quantization errors, staged behind the chunks, are read there (the
        handle's event now follows them).  With no window in flight the
        transfers settle now and the errors wait for the next window."""
        if self._pending_prefill_qerr and hd is not None:
            (errs,), ready = stage([torch.stack(self._pending_prefill_qerr)])
            self._pending_prefill_qerr = []
            hd.prefill_qerrs = (errs if hd.prefill_qerrs is None
                                else torch.cat([hd.prefill_qerrs, errs]))
            if ready is not None:
                hd.ready = ready
        spills, promotions = self._pending_spills, self._pending_promotions
        if not spills and not promotions:
            return
        self._pending_spills, self._pending_promotions = [], []
        if hd is not None:
            hd.spills.extend(spills)
            hd.promotions.extend(promotions)
        else:
            self._settle(spills, promotions)

    def prefix_cache_stats(self) -> dict:
        """Prefix-cache health: hit and miss tokens, the hit rate, and the
        cache's residency per tier (hit and miss only when it is off)."""
        out = {"prefix_hit_tokens": self.stats["prefix_hit_tokens"],
               "prefix_miss_tokens": self.stats["prefix_miss_tokens"]}
        covered = out["prefix_hit_tokens"] + out["prefix_miss_tokens"]
        out["hit_rate"] = out["prefix_hit_tokens"] / covered if covered else 0.0
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out

    def flush_prefix_cache(self) -> int:
        """Drop every cached chunk from every tier, as the reference does at
        a hot swap or a revive: land the window in flight and any transfer
        still pending, release queued requests' pins, then flush.  Returns
        the nodes removed."""
        if self.prefix_cache is None:
            return 0
        self._drain_inflight()
        self._hand_cache_traffic(None)
        self.scheduler.drop_cache_pins()
        return self.prefix_cache.flush()

    # ---------------------------------------------------------------- decode
    def _retire_lane(self, slot: int) -> int:
        """Tear down one running lane (finish / preempt / pre-free).  If the
        window in flight was dispatched with this lane live, its pages move
        to that window's deferral list and free at its drain; else they
        free now.  Returns pages freed now.  A slab lane has no pages: its
        slot is free at once, and a new request's insert into it queues
        behind the window in flight on the stream."""
        freed = 0
        if self.paged:
            inflight = self._inflight
            if inflight is not None and inflight.lane_live(slot):
                inflight.deferred_pages.extend(self.kv.lane_detach(slot))
            else:
                freed = self.kv.lane_release(slot)
        self.lanes.retire(slot)
        self._active[slot] = False
        self._slot_req[slot] = None
        self._lane_len[slot] = 0
        if self._ngram is not None:
            self._ngram.retire(slot)
        if self._draft_window is not None:
            self._draft_window.retire(slot)
        return freed

    def _preempt(self) -> bool:
        """Preempt the youngest running lane: release its pages and requeue it
        at the FRONT for replay over prompt + generated tokens, through the
        prefix cache (its first life's full chunks hit; greedy replay is
        token-exact; a sampled lane restarts its stream)."""
        victims = sorted((s for s in np.nonzero(self._active)[0]),
                         key=lambda s: self._slot_req[s].rid, reverse=True)
        for s in victims:
            req = self._slot_req[s]
            eff = len(req.prefill_tokens)
            padded = sum(b for b, _ in plan_chunks(eff, self.buckets))
            if eff > self.max_prompt_len or padded > self.max_len:
                continue  # grew past replayability
            self._retire_lane(s)
            self.scheduler.requeue(req)
            self.stats["preemptions"] += 1
            return True
        return False

    def _ensure_decode_capacity(self, width: int) -> None:
        """Map pages for every active lane's next ``width`` KV writes."""
        page = self.page_size
        for s in np.nonzero(self._active)[0]:
            need = (int(self._lane_len[s]) + width - 1) // page + 1
            while self._active[s]:
                missing = need - int(self.kv.lane_npages[s])
                if missing <= 0:
                    break
                ids = self.kv.allocator.alloc(missing)
                if ids is not None:
                    self.kv.lane_append_owned(s, ids)
                    break
                if not self._reclaim_pages(missing, allow_preempt=True):
                    raise RuntimeError("KV page pool exhausted: no lane left to "
                                       "reclaim for a decoding lane")

    def _prefree_exhausted(self) -> None:
        """Retire, before this step's admission, the lanes the window in
        flight provably finishes (``accelerate_tpu/serving/engine.py:
        2197-2238``): a lane with no EOS lands exactly ``width`` tokens a
        decode window, so ``len(tokens) + width >= max_new_tokens`` proves
        it done.  Its slot admits a new request this cycle instead of one
        later; its pages wait for the window's drain, where its tokens
        land (the handle's ``prefreed`` mark).  Lanes with an EOS and
        speculating lanes keep the one-window lag."""
        hd = self._inflight
        if hd is None or hd.kind != "decode":
            return
        for s in np.nonzero(self._active)[0]:
            s = int(s)
            req = self._slot_req[s]
            if req is None or not hd.lane_live(s) or hd.reqs[s] is not req:
                continue
            if self._eos[s] >= 0 or (self._spec_any and req.speculate):
                continue
            if len(req.tokens) + hd.width >= req.config.max_new_tokens:
                hd.prefreed.add(s)
                self._retire_lane(s)
                self.stats["prefreed_lanes"] += 1

    def _dispatch(self) -> Optional[Readback]:
        """Dispatch one decode cycle over the pool and return the handle the
        caller must drain: the previous window under the pipeline, this one
        under ``async_depth=0``, ``None`` when the pool is idle.
        Speculative cycles drain first: drafting and the verify need the
        previous window's tokens.  Sets ``_cycle_decode_tokens`` to the
        tokens the window charges (occupied lanes x width; 0 when idle)."""
        self._cycle_decode_tokens = 0
        if self._spec_any and self._inflight is not None:
            self._drain_inflight()
        if not self._active.any():
            self._drain_inflight()
            return None
        if self.paged:
            # pages for the widest pass this cycle could run; this may drain
            # the window in flight and preempt, so re-check occupancy
            self._ensure_decode_capacity(max(self.window, self._spec_span))
            if not self._active.any():
                self._drain_inflight()
                return None
        n_occupied = int(self._active.sum())
        hd = None
        if self.tree is not None:
            drafted = self._tree_lanes()
            if drafted.any():
                hd = self._tree_cycle(drafted, n_occupied)
        elif self.speculate_k:
            drafts = self._propose_drafts()
            if drafts is not None:
                hd = self._verify_cycle(*drafts, n_occupied)
        if hd is None:
            hd = self._decode_cycle(n_occupied)
        self._cycle_decode_tokens = n_occupied * hd.width
        if self.async_depth == 0:
            return hd
        prev, self._inflight = self._inflight, hd
        return prev

    def _note_dispatch(self) -> None:
        """Charge the gap since the pipeline last went empty as device idle
        time, and open the busy span."""
        now = time.perf_counter()
        if self._t_pipeline_empty is not None:
            self.stats["device_idle_s"] += now - self._t_pipeline_empty
            self._t_pipeline_empty = None
        if self._busy_since is None:
            self._busy_since = now

    def _upload_pool(self) -> None:
        """Block tables (paged) and write indices into the windows' static
        buffers.  Pageable non-blocking copies: the host arrays are staged
        at the call, so they may change on return, and nothing waits."""
        if self.paged:
            self._tables.copy_(torch.from_numpy(self.kv.tables), non_blocking=True)
        self._index.copy_(torch.from_numpy(self._lane_len), non_blocking=True)

    def _handle(self, kind: str, width: int, toks, counts, err, n_occupied: int,
                drafted: Optional[np.ndarray] = None) -> Readback:
        """Stage a dispatched window's outputs to the host and snapshot the
        lanes it saw; the handle's ``dispatch_t`` is now, the window's
        launches done."""
        if not self.quantized:
            err = None
        (toks, counts, err), ready = stage((toks, counts, err))
        return Readback(kind=kind, toks=toks, width=width, counts=counts, qerr=err,
                        active=self._active.copy(), reqs=list(self._slot_req),
                        eos=self._eos.copy(), n_occupied=n_occupied, drafted=drafted,
                        ready=ready)

    def _decode_cycle(self, n_occupied: int) -> Readback:
        """Dispatch one decode window over the pool."""
        self._note_dispatch()
        self._upload_pool()
        toks, err = self._run("decode")
        self._lane_len[self._active] += self.window
        self.stats["decode_steps"] += self.window
        return self._handle("decode", self.window, toks, None, err, n_occupied)

    def _propose_drafts(self):
        """Host n-gram drafts for this cycle: ``(drafts [N, K], drafted
        [N])``, or ``None`` when no active opted-in lane found a match (the
        cycle then runs the plain decode window).  Lanes without a match
        carry pad drafts, which verification rejects: they still land the
        one token the verify forward guarantees."""
        k = self.speculate_k
        drafts = np.full((self.num_slots, k), self.pad_token_id, np.int32)
        drafted = np.zeros(self.num_slots, bool)
        for s in np.nonzero(self._active)[0]:
            req = self._slot_req[s]
            if req is None or not req.speculate:
                continue
            d = self._ngram.propose(int(s), req.output_ids, k)
            if d is not None:
                drafts[s] = d
                drafted[s] = True
        if not drafted.any():
            return None
        return drafts, drafted

    def _tree_lanes(self) -> np.ndarray:
        """Active lanes opted into speculation (tree mode): the draft model
        drafts for every lane anyway; this mask scopes the accounting and
        the all-opted-out fallback to the decode window."""
        drafted = np.zeros(self.num_slots, bool)
        for s in np.nonzero(self._active)[0]:
            req = self._slot_req[s]
            drafted[s] = req is not None and req.speculate
        return drafted

    def _verify_dispatched(self, drafted: np.ndarray, drafted_tokens: int, steps: int) -> None:
        st = self.stats
        st["decode_steps"] += steps
        st["verify_forwards"] += 1
        st["verify_lanes"] += int(self._active.sum())
        st["spec_drafted"] += int(drafted.sum()) * drafted_tokens

    def _verify_cycle(self, drafts: np.ndarray, drafted: np.ndarray,
                      n_occupied: int) -> Readback:
        """Dispatch one linear verify over ``[slots, K+1]``: the lanes'
        pending tokens (on the card) and their drafts."""
        self._note_dispatch()
        self._upload_pool()
        self._drafts.copy_(torch.from_numpy(drafts), non_blocking=True)
        out, n_commit, err = self._run("verify")
        k = self.speculate_k
        self._verify_dispatched(drafted, k, k + 1)
        return self._handle("verify", k + 1, out, n_commit, err, n_occupied,
                            drafted=drafted.copy())

    def _tree_cycle(self, drafted: np.ndarray, n_occupied: int) -> Readback:
        """Dispatch one draft forward and one tree verify: the draft's
        ``[slots, nodes]`` token trees stay on the card.  The context
        window's last token is each lane's pending token, so the tree's
        root is the token the verify must score first.  The draft's time:
        events on the card's stream around its replay (read at the drain),
        else host wall."""
        self._note_dispatch()
        self._upload_pool()
        dw = self._draft_window
        self._ctx.copy_(torch.from_numpy(dw.tokens), non_blocking=True)
        self._ctx_len.copy_(torch.from_numpy(dw.length), non_blocking=True)
        marks = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 if self.device.type == "cuda" else None)
        if marks:
            marks[0].record()
        t_draft = time.perf_counter()
        self._run("draft")
        t_draft = time.perf_counter() - t_draft
        if marks:
            marks[1].record()
        out, n_commit, err = self._run("tree")
        depth = self.tree.depth
        self._verify_dispatched(drafted, depth, depth + 1)
        hd = self._handle("verify", depth + 1, out, n_commit, err, n_occupied,
                          drafted=drafted.copy())
        hd.draft_marks, hd.draft_s = marks, t_draft
        return hd

    # ----------------------------------------------------------------- drain
    def _drain_inflight(self) -> None:
        """Flush the pipeline: land the windows in flight, oldest first (the
        window parked by an interleaved step before the one dispatched after
        it, or tokens would land out of order)."""
        prev, self._prev_handle = self._prev_handle, None
        if prev is not None:
            self._drain(prev)
        hd, self._inflight = self._inflight, None
        if hd is not None:
            self._drain(hd)

    def _drain(self, hd: Readback) -> None:
        """Land one window: wait for its staged outputs (the one blocking
        point), then all host bookkeeping against its dispatch-time lane
        snapshot."""
        t0 = time.perf_counter()
        hd.fetch()
        t1 = time.perf_counter()
        # overlap accounting: host work since dispatch ran under the card;
        # the wait is what the pipeline failed to hide (under async_depth=0
        # the drain follows the dispatch at once: the ratio stays near 0)
        self._overlap_host_s += max(t0 - hd.dispatch_t, 0.0)
        self._overlap_wait_s += t1 - t0
        denom = self._overlap_host_s + self._overlap_wait_s
        if denom > 0.0:
            self.stats["host_overlap_ratio"] = self._overlap_host_s / denom
        toks = hd.toks.numpy()
        counts = hd.counts.numpy() if hd.counts is not None else np.full(self.num_slots,
                                                                          hd.width)
        st = self.stats
        if hd.qerr is not None:
            st["kv_quant_error"] = float(hd.qerr)
        if hd.prefill_qerrs is not None:
            st["kv_quant_error"] = float(hd.prefill_qerrs.max())
        if hd.kind == "verify":
            # the write-index mirror advances by what the card committed,
            # for lanes still owned by the request the window ran for
            for s in np.nonzero(hd.active)[0]:
                if hd.reqs[s] is not None and self._slot_req[s] is hd.reqs[s]:
                    self._lane_len[s] += int(counts[s])
            st["verify_committed"] += int(counts[hd.active].sum())
            st["spec_accepted"] += int(np.maximum(counts[hd.drafted] - 1, 0).sum())
            st["draft_s"] += (hd.draft_marks[0].elapsed_time(hd.draft_marks[1]) / 1e3
                              if hd.draft_marks else hd.draft_s)
        self._emit(toks, counts, hd)
        self._settle(hd.spills, hd.promotions)
        hd.spills, hd.promotions = [], []
        if hd.deferred_pages:
            # the fetch proved the window done: its writes to detached
            # lanes' pages have landed, so the pages may recycle
            hd.settle(self.kv.allocator)
        if self._inflight is None:
            now = time.perf_counter()
            self._t_pipeline_empty = now
            st["decode_s"] += now - self._busy_since
            self._busy_since = None

    def _emit(self, toks: np.ndarray, counts: np.ndarray, hd: Readback) -> None:
        """Land a window's tokens on their requests: ``toks[s, :counts[s]]``
        is lane ``s``'s output (a whole decode window, or a verify's
        committed prefix), cut at the lane's EOS and at the request's length
        cap.  Lanes are those of the window's dispatch-time snapshot: a lane
        retired or preempted since then no longer owns its slot and its
        tokens drop, unless it was pre-freed (its request completes here);
        finished lanes free their slot."""
        width = toks.shape[1]
        mask, reqs, eos = hd.active, hd.reqs, hd.eos
        valid = (np.arange(width)[None, :] < counts[:, None]) & mask[:, None]
        is_eos = valid & (toks == eos[:, None]) & (eos >= 0)[:, None]
        has_eos = is_eos.any(axis=1)
        first_eos = np.where(has_eos, is_eos.argmax(axis=1), width)
        n_take = np.minimum(valid.sum(axis=1), first_eos + 1)
        for s in np.nonzero(n_take > 0)[0]:
            req = reqs[s]
            if req is None:
                continue
            owner = self._slot_req[s] is req
            if not owner and not (int(s) in hd.prefreed and req.state is RequestState.RUNNING):
                continue
            n = min(int(n_take[s]), req.config.max_new_tokens - len(req.tokens))
            if n <= 0:
                continue
            for t in toks[s, :n]:
                req.emit(int(t))
            if owner and self._draft_window is not None:
                self._draft_window.push(int(s), toks[s, :n])
            self.stats["tokens_generated"] += n
            hit_eos = bool(has_eos[s]) and n == int(n_take[s])
            if hit_eos or len(req.tokens) >= req.config.max_new_tokens:
                if owner:
                    self._retire_lane(s)
                req.state = RequestState.DONE
                self.stats["requests_completed"] += 1
                # the submit-to-done average behind submit's deadline estimate
                dur = max(clock() - req.submit_time, 0.0)
                self._service_ema = (dur if self._service_ema == 0.0
                                     else 0.8 * self._service_ema + 0.2 * dur)

    # ----------------------------------------------------------------- drive
    def step(self) -> None:
        """One engine iteration: the deadline sweep (while a deadline is
        live), pre-free the lanes the window in flight finishes, budgeted
        chunked-prefill admission and the dispatch of one decode cycle (the
        dispatch first under ``interleave_prefill``), then the drain of the
        window the pipeline hands back (with the traffic that rode it)."""
        if self._has_deadlines:
            self._shed_blown_deadlines()
        self._prefree_exhausted()
        if self.interleave_prefill:
            # the window first; the cycle's chunks queue behind it while the
            # window it hands back stays parked until the drain below
            self._prev_handle = self._dispatch()
            self._admit()
        else:
            self._admit()
            self._prev_handle = self._dispatch()
        # the newest window runs after everything enqueued this step: the
        # cache transfers and the chunks' errors land at its drain
        self._hand_cache_traffic(self._inflight if self._inflight is not None
                                 else self._prev_handle)
        prev, self._prev_handle = self._prev_handle, None
        if prev is not None:
            self._drain(prev)

    @property
    def has_work(self) -> bool:
        # a window in flight is work: its tokens have not landed yet
        return (self.scheduler.has_queued or bool(self._active.any())
                or self._inflight is not None)

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive :meth:`step` until every submitted request completes."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def serve(self, prompts: Sequence, configs=None,
              on_token: Optional[Callable[[Request, int], None]] = None) -> List[Request]:
        """Submit every prompt (``configs`` is one shared or a per-request list
        of ``GenerationConfig``), run to completion, return the requests in
        submission order."""
        reqs = []
        for i, p in enumerate(prompts):
            cfg = configs[i] if isinstance(configs, (list, tuple)) else configs
            reqs.append(self.submit(p, config=cfg, on_token=on_token))
        self.run()
        return reqs
