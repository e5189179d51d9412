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

Telemetry (:mod:`accelerate_tpu_torch.telemetry`), as in the reference:
every stats counter is mirrored into ``serve/<key>_total`` of the engine's
registry, with the latency histograms (``serve/ttft_s``,
``serve/token_latency_s``, ``serve/queue_wait_s``,
``serve/prefill_compute_s``, ``serve/decode_s_per_token``), per-class and
per-tenant families and the pool's gauges; every request keeps a latency
waterfall (:mod:`~accelerate_tpu_torch.telemetry.reqtrace`); lifecycle
events land in the flight recorder, tagged with the engine's id, and each
step is a heartbeat; every window and chunk program is wrapped in a
:class:`~accelerate_tpu_torch.telemetry.RecompileWatchdog` and costed in
the engine's :class:`~accelerate_tpu_torch.telemetry.CostTable`;
``metrics_port`` starts the debug server.  Gauges hold host values only:
nothing hands a gauge a graph's output, which the next replay rewrites.
The fleet surface (:meth:`ServingEngine.pause_admission`,
:meth:`~ServingEngine.swap_params`, :meth:`~ServingEngine.kill`,
:meth:`~ServingEngine.export_inflight`, :meth:`~ServingEngine.adopt`,
:meth:`~ServingEngine.revive`) and the fault points of
:mod:`.faults` follow the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import time
import weakref
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..logging import get_logger
from ..models.generation import GenerationConfig, lane_key
from ..models.transformer import KVCache, Transformer
from ..ops.paged_attention import MAX_TREE_NODES, NULL_PAGE, TreeMask
from ..telemetry import (
    CostTable,
    RecompileWatchdog,
    detect_device_peaks,
    get_flight_recorder,
    get_registry,
    get_reqtrace,
    get_tracer,
    slo_tick,
    start_debug_server,
)
from ..telemetry.watchdog import tensor_signature
from . import costs, faults, transfer
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
#: sweep, the service-time average) and of the latency histograms: tests
#: swap in a fake one
clock = time.perf_counter

logger = get_logger(__name__)

# Serving latencies live between ~100 us (a CPU-test decode step) and ~100 s
# (a deep queue on a loaded pool): 24 x2 buckets from 100 us cover it.
_LATENCY_BUCKETS = tuple(1e-4 * 2.0**i for i in range(24))

# Process-wide replica ids ("e0", "e1", ...): every flight-recorder event and
# request-trace phase an engine emits is tagged with its id, so several
# engines' events in the one process-wide ring stay apart.
_ENGINE_IDS = itertools.count()

# every engine alive in the process: swap_params refuses to overwrite
# storage another one serves from
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()

#: ``stats`` keys that are levels, not running totals: published as the
#: reference's gauges (``serve/kv_quant_error``, the pool's
#: ``serve/kv_bytes_per_token``, ``serve/host_overlap_ratio``), not as
#: ``serve/<key>_total`` counters
_LEVEL_KEYS = frozenset({"kv_quant_error", "kv_bytes_per_token", "host_overlap_ratio"})


class _Stats(dict):
    """``ServingEngine.stats``: a plain numeric dict (benches reset it in
    place) that is also callable — ``engine.stats()`` returns a copy with
    the per-request trace rollup under ``"requests"`` and the per-tenant
    books under ``"tenants"``."""

    def __call__(self) -> dict:
        out = dict(self)
        engine = getattr(self, "engine", None)
        out["requests"] = (get_reqtrace().summary(engine_id=engine.engine_id)
                           if engine is not None else {})
        out["tenants"] = ({t: dict(v) for t, v in engine._tenant_stats.items()}
                          if engine is not None else {})
        return out


#: each window kind's program name (the reference's executable names)
_PROGRAM_NAMES = {"decode": "decode_window", "verify": "verify_window",
                  "tree": "tree_verify_window", "draft": "draft_forward"}


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

    registry: the :class:`~accelerate_tpu_torch.telemetry.MetricsRegistry`
        the engine, its pool and its cache record into (default: the process
        registry).
    metrics_port: start (or join) the process-wide debug server
        (``/metrics``, ``/healthz``, ``/debug/flight``, ``/debug/stacks``,
        ``/debug/requests``, ``/debug/slo``) on this port; ``0`` binds an
        ephemeral port, ``None`` defers to ``ATPU_METRICS_PORT`` (off when
        unset).  A scrape runs :meth:`analyze_costs` first.

    ``mesh``, ``tp_axis`` other than ``"tp"`` and ``role`` other than
    ``"both"`` (paged) raise ``NotImplementedError`` (ROADMAP Queue 1 items
    9e and 8b).
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
            raise _not_ported("mesh= (tensor-parallel serving)", "9e")
        if tp_axis != "tp":
            raise _not_ported("tp_axis= (tensor-parallel serving)", "9e")
        if role != "both":
            raise _not_ported(f"role={role!r} (disaggregated prefill/decode)", "8b")
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
        self.metrics = registry if registry is not None else get_registry()
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
        self._draft_spec = draft_model
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
                                  self.num_pages, kv_dtype=kv_dtype, device=self.device,
                                  registry=self.metrics)
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
                disk_capacity_bytes=disk_bytes, disk_dir=prefix_disk_dir, registry=self.metrics)
        # prefix-cache spills and promotions enqueued since the last
        # dispatch: they ride the next window and settle at its drain
        self._pending_spills: List[CacheTransfer] = []
        self._pending_promotions: List[CacheTransfer] = []
        # forensics and cost accounting: lifecycle events land in the
        # process flight recorder tagged with this engine's id, each request
        # keeps a waterfall, and each program's FLOPs and bytes go to a
        # private cost table, computed off the serve loop (analyze_costs)
        self.tracer = get_tracer()
        self.engine_id = f"e{next(_ENGINE_IDS)}"
        self.recorder = get_flight_recorder().tagged(engine=self.engine_id)
        self.reqtrace = get_reqtrace()
        self.cost_table = CostTable(self.metrics)
        self.device_peaks = detect_device_peaks(self.device)
        self.scheduler = Scheduler(
            self.buckets,
            prefill_token_budget if prefill_token_budget is not None else self.buckets[-1],
            max_queue=max_queue, prefix_cache=self.prefix_cache,
            # interleaved: one open prefill per slot, SRTF among them
            max_prefills=self.num_slots if self.interleave_prefill else 1,
            recorder=self.recorder,
        )
        #: True while a drain or a hot swap holds new prefills back (queued
        #: requests stay queued; running lanes run to completion)
        self.admission_paused = False
        # fault containment: the first exception to escape a step parks
        # here and every later step re-raises it until revive()
        self._poisoned: Optional[BaseException] = None
        self._step_count = 0

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
        self._slot_ever_used = np.zeros(n, bool)
        #: plain counters, the reference's first; ``prefill_s`` / ``decode_s``
        #: are host wall seconds (see the class docstring).  Every bump goes
        #: through :meth:`_bump`, which mirrors it into ``serve/<key>_total``
        self.stats = _Stats({
            "requests_submitted": 0,
            "requests_completed": 0,
            "tokens_generated": 0,
            "prefill_chunks": 0,
            "prefill_tokens": 0,
            "interleaved_chunks": 0,
            "decode_steps": 0,
            "occupied_lane_steps": 0,
            "slots_reused": 0,
            "prefix_hit_tokens": 0,
            "prefix_hit_tokens_host": 0,
            "prefix_miss_tokens": 0,
            "cancelled": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "preemptions": 0,
            "cow_copies": 0,
            "prefreed_lanes": 0,
            "hot_swaps": 0,
            "deadline_shed": 0,
            "requests_replayed": 0,
            "prefill_s": 0.0,
            "decode_s": 0.0,
            "kv_quant_error": 0.0,
            "kv_bytes_per_token": kv_bytes_per_token,
            "verify_forwards": 0,
            "verify_lanes": 0,
            "verify_committed": 0,
            "draft_s": 0.0,
            "graph_captures": 0,
            "graph_replays": 0,
            "host_overlap_ratio": 0.0,
            "device_idle_s": 0.0,
            "promote_degraded": 0,
            "reclaim_evictions": 0,
            "spill_s": 0.0,
            "spill_bytes": 0,
            "promote_s": 0.0,
            "promote_bytes": 0,
        })
        self.stats.engine = self
        self._init_metrics()
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
        # the decode window's given tokens (-1: free), for decode replay of
        # adopted requests; the host copy is uploaded while any is given
        self._forced = torch.full((n, self.window), -1, dtype=torch.int32, device=dev)
        self._forced_host = np.full((n, self.window), -1, np.int32)
        self._forced_live = False
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
        self._init_programs()
        self.graphs: Optional[WindowGraphs] = None
        if dev.type == "cuda" and (self._graph_windows or self._graph_chunks):
            self.graphs = WindowGraphs(dev)
        # the captures' warm-ups write the null page, which inactive lanes
        # read back: restore it, so that a graphed engine starts where an
        # eager one does
        null = ([(t, t[:, NULL_PAGE].clone()) for t in self._pool]
                if self.graphs is not None and self.paged else [])
        if self.graphs is not None and self._graph_windows:
            for (kind, sampling), fn in self._windows.items():
                self._capture(self._graph_key(kind, sampling), fn, self._reset_lanes,
                              _PROGRAM_NAMES[kind])
        if self.graphs is not None and self._graph_chunks:
            # captured with the table all null page and base 0: the capture's
            # writes land in the garbage sink, as inactive lanes' do (on the
            # slab pool in the idle scratch)
            for b, fn in self._chunks.items():
                self._capture(self._chunk_key(b), fn, lambda: None, f"prefill_{b}")
        for t, saved in null:
            t[:, NULL_PAGE].copy_(saved)
        self.debug_server = start_debug_server(metrics_port, registry=self.metrics,
                                               recorder=self.recorder)
        if self.debug_server is not None:
            self.debug_server.add_collector(self.analyze_costs)
        _LIVE_ENGINES.add(self)

    def _capture(self, key, fn, reset, program: str) -> None:
        """Capture one graph; what the capture added to the allocator is the
        program's own card memory (its cost-table ``hbm_peak_bytes``)."""
        before = torch.cuda.memory_allocated(self.device)
        self.graphs.capture(key, fn, reset)
        self.cost_table.set_hbm_peak_bytes(f"serve/{program}",
                                           torch.cuda.memory_allocated(self.device) - before)
        self._bump("graph_captures")

    def _init_metrics(self) -> None:
        """The registry's serving instruments (the reference's names): one
        counter per running total of ``stats``, the latency histograms and
        the gauges; per-class and per-tenant families are made on first
        use."""
        m = self.metrics
        self._counters = {k: m.counter(f"serve/{k}_total")
                          for k in self.stats if k not in _LEVEL_KEYS}
        self._ttft_hist = m.histogram("serve/ttft_s", buckets=_LATENCY_BUCKETS,
                                      help="submit-to-first-token wall time")
        self._class_ttft_hists: dict = {}
        # tenant attribution: per-tenant counter and TTFT families; the
        # numeric rollup behind stats()["tenants"] sums exactly to the
        # global counters (every _bump_tenant sits beside a _bump)
        self._tenant_counters: dict = {}
        self._tenant_ttft_hists: dict = {}
        self._tenant_stats: dict = {}
        self._tenant_kv_gauges: dict = {}
        self._token_hist = m.histogram("serve/token_latency_s", buckets=_LATENCY_BUCKETS,
                                       help="inter-token wall time (first token = TTFT)")
        self._queue_wait_hist = m.histogram(
            "serve/queue_wait_s", buckets=_LATENCY_BUCKETS,
            help="submit to first prefill chunk taken (trace queue_wait phase)")
        self._prefill_phase_hist = m.histogram(
            "serve/prefill_compute_s", buckets=_LATENCY_BUCKETS,
            help="per-chunk prefill share of a request's waterfall "
                 "(fresh compute, cached replay, or promoted chunks alike)")
        self._decode_tok_hist = m.histogram(
            "serve/decode_s_per_token", buckets=_LATENCY_BUCKETS,
            help="per-request decode-window share amortized over the tokens "
                 "the window committed (closes at drain)")
        self._promote_wait_hist = m.histogram(
            "serve/promote_wait_s", buckets=_LATENCY_BUCKETS,
            help="host-tier promotion dispatch to landed-at-drain wait")
        self._queue_gauge = m.gauge("serve/queue_depth", help="requests queued or mid-prefill")
        self._occupancy_gauge = m.gauge("serve/slot_occupancy",
                                        help="fraction of slots active this window")
        self._hit_rate_gauge = m.gauge(
            "serve/prefix_hit_rate",
            help="prefix_hit_tokens / (hit + miss) over cache-eligible prefill")
        self._hit_rate_device_gauge = m.gauge(
            "serve/prefix_hit_rate_device",
            help="device-tier share of the prefix hit rate: tokens served by "
                 "zero-copy page aliasing / (hit + miss)")
        self._hit_rate_host_gauge = m.gauge(
            "serve/prefix_hit_rate_host",
            help="spilled-tier share of the prefix hit rate: tokens served by "
                 "host/disk promotion / (hit + miss)")
        self._decode_flops_gauge = m.gauge(
            "serve/decode_flops_per_token",
            help="decode-window FLOPs (the cost table's formula) / (window * num_slots)")
        self._hbm_gauge = m.gauge(
            "serve/hbm_peak_bytes",
            help="largest card memory one serving program holds of its own "
                 "(what its graph capture added to the allocator)")
        self._accept_rate_gauge = m.gauge(
            "serve/spec_accept_rate",
            help="accepted / proposed draft tokens (cumulative) under speculative decoding")
        self._accept_len_hist = m.histogram(
            "serve/spec_accept_len", buckets=tuple(float(i) for i in range(33)),
            help="accepted draft tokens per drafted lane per verify cycle")
        self._draft_ms_hist = m.histogram(
            "serve/draft_ms", buckets=tuple(1e-2 * 2.0**i for i in range(20)),
            help="host wall time per cycle to dispatch the draft forward "
                 "(tree speculation only)")
        self._tree_nodes_counter = m.counter(
            "serve/spec_tree_nodes",
            help="token-tree nodes verified (occupied lanes x tree nodes, cumulative)")
        m.gauge("serve/decode_kernel",
                help="info gauge: decode attention program — 1 = pallas "
                     "(the paged kernel, K1), 0 = xla (its plain version)",
                ).set(1.0 if self.decode_kernel == "pallas" else 0.0)
        m.gauge("serve/prefill_kernel",
                help="info gauge: prefill attention program — 1 = pallas "
                     "(the paged prefill kernel, K2), 0 = xla (its plain version)",
                ).set(1.0 if self.prefill_kernel == "pallas" else 0.0)
        self._pf_rate_gauge = m.gauge(
            "serve/prefill_tokens_per_s",
            help="prefill throughput over the trailing steps that ran at "
                 "least one chunk (valid tokens / wall time between them)")
        self._interleave_gauge = m.gauge(
            "serve/prefill_interleave_ratio",
            help="fraction of prefill chunks dispatched behind a same-cycle decode window")
        self._pf_last_t: Optional[float] = None
        self._pf_last_tokens = 0
        m.gauge("serve/tp_degree",
                help="info gauge: tensor-parallel degree (1 = single card)").set(1.0)
        m.gauge("serve/role",
                help="info gauge: disaggregated serving role — 0 = both "
                     "(monolithic), 1 = prefill-only, 2 = decode-only").set(0.0)
        self._kv_quant_gauge = (
            m.gauge("serve/kv_quant_error",
                    help="max abs KV round-trip quantization error of the values "
                         "written this cycle — only published under quantized kv_dtype")
            if self.quantized else None)
        self._overlap_gauge = m.gauge(
            "serve/host_overlap_ratio",
            help="fraction of serve-loop host work hidden under device execution: "
                 "host_s / (host_s + readback_wait_s), cumulative; 0 under async_depth=0")
        self._idle_gauge = m.gauge(
            "serve/device_idle_ms",
            help="cumulative ms the device sat with no window dispatched or in flight")

    def _init_programs(self) -> None:
        """Wrap every program in a :class:`RecompileWatchdog` (budget 1: each
        is one program, one CUDA graph on the card) and state its cost
        formula (:mod:`.costs`)."""
        def watch(fn, name):
            return RecompileWatchdog(fn, name=f"serve/{name}", budget=1, registry=self.metrics,
                                     signature=tensor_signature)

        cfg = self.model.config
        self._programs = {kind: watch(functools.partial(self._run_window, kind),
                                      _PROGRAM_NAMES[kind])
                          for kind, _ in self._windows}
        if self.paged and (self.quantized or self.decode_kernel == "pallas"):
            # the reference's nested watchdog: serve/paged_attn accounts the
            # in-place paged attention, which replaces the decode program's
            # attention and must never add one of its own
            self._programs["decode"] = watch(watch(self._programs["decode"], "paged_attn"),
                                             _PROGRAM_NAMES["decode"])
        self._prefill = {b: watch(functools.partial(self._run_chunk, b), f"prefill_{b}")
                         for b in self.buckets}
        self._lane_install = watch(self.lanes.install, "lane_install")
        self._copy_page = watch(copy_page, "copy_page") if self.paged else None
        self._insert = None if self.paged else watch(slab_insert, "insert")
        self._copy = ({b: watch(copy_chunk, f"copy_{b}") for b in self.buckets}
                      if self.prefix_cache is not None and not self.paged else {})
        spilling = self.prefix_cache is not None and self.prefix_cache.host_capacity > 0
        self._spill_extract = ({b: watch(spill_extract, f"spill_{b}") for b in self.buckets}
                               if spilling else {})
        self._promote_install = ({b: watch(promote_install, f"promote_{b}")
                                  for b in self.buckets} if spilling else {})
        # the cost formulas, with the model's geometry bound in
        weight_bytes = costs.tensor_bytes(self.model.state_dict().values())
        layer_bytes = costs.tensor_bytes(self.model.layers.state_dict().values())
        embed_elem = self.model.embed_tokens.weight.element_size()
        if self.paged:
            kv_elem, page = costs.elem(self.kv.storage_dtype), self.page_size
            lanes_keys = lambda shapes: (shapes[0][0][0], shapes[0][0][1] * page)  # noqa: E731
            chunk_keys = lambda shapes: shapes[1][0][1] * page  # noqa: E731
            page_bytes = self.kv.page_kv_bytes
        else:
            kv_elem, page = self.pool.k.element_size(), 1
            lanes_keys = lambda shapes: (shapes[0][0][1], shapes[0][0][2])  # noqa: E731
            chunk_keys = lambda shapes: shapes[1][0][2]  # noqa: E731
            page_bytes = 0
        q = self.quantized
        self._costs = {
            "decode_window": costs.decode_window(cfg, weight_bytes, self.window, kv_elem, page,
                                                 q, lanes_keys),
            "verify_window": costs.verify_window(cfg, weight_bytes, self.speculate_k + 1,
                                                 kv_elem, page, q, lanes_keys),
            "tree_verify_window": costs.verify_window(cfg, weight_bytes, self._spec_span,
                                                      kv_elem, page, q, lanes_keys),
            "lane_install": costs.write(costs.LANE_INSTALL_BYTES),
            "copy_page": costs.copy(page_bytes),
        }
        # K and V of one position, every layer (the slab pool's copies)
        row_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * kv_elem
        if not self.paged:
            self._costs["insert"] = costs.copy(row_bytes * self.max_prompt_len)
        for b in self.buckets:
            self._costs[f"prefill_{b}"] = costs.prefill_chunk(
                cfg, layer_bytes, embed_elem, b, kv_elem, page, q, chunk_keys)
            if self.paged:
                self._costs[f"spill_{b}"] = self._costs[f"promote_{b}"] = costs.copy(
                    self.kv.chunk_bytes(b // page))
            else:
                self._costs[f"copy_{b}"] = costs.copy(row_bytes * b)
        if self.tree is not None:
            draft = self.draft
            self._costs["draft_forward"] = costs.verify_window(
                draft.config, costs.tensor_bytes(draft.state_dict().values()), self.draft_ctx,
                costs.elem(draft.config.dtype), 1, False,
                lambda shapes: (shapes[0][0][0], self.draft_ctx))

    def _cost_capture(self, program: str, fn, args) -> None:
        """Record ``program``'s input shapes and cost formula on its first call."""
        name = f"serve/{program}"
        if not self.cost_table.captured(name):
            self.cost_table.capture(name, fn, args, cost=self._costs.get(program))

    def _bump(self, key: str, n=1) -> None:
        self.stats[key] += n
        self._counters[key].inc(n)

    def _bump_tenant(self, tenant: Optional[str], key: str, n: int = 1) -> None:
        """Mirror a ``_bump`` into the caller tenant's lazily created counter
        family (``serve/<key>_tenant_<tenant>_total``) and the numeric rollup
        behind ``stats()["tenants"]``."""
        if tenant is None:
            return
        counters = self._tenant_counters.get(tenant)
        if counters is None:
            counters = self._tenant_counters[tenant] = {}
            self._tenant_stats[tenant] = {}
        counter = counters.get(key)
        if counter is None:
            counter = counters[key] = self.metrics.counter(f"serve/{key}_tenant_{tenant}_total")
            self._tenant_stats[tenant][key] = 0
        self._tenant_stats[tenant][key] += n
        counter.inc(n)

    def _tenant_ttft(self, tenant: Optional[str], value: float) -> None:
        """Per-tenant TTFT histogram family (``serve/ttft_s_tenant_<t>``)."""
        if tenant is None:
            return
        hist = self._tenant_ttft_hists.get(tenant)
        if hist is None:
            hist = self._tenant_ttft_hists[tenant] = self.metrics.histogram(
                f"serve/ttft_s_tenant_{tenant}", buckets=_LATENCY_BUCKETS)
        hist.observe(value)

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
                                       plain=plain, forced=self._forced)
            tree = (None if self.tree is None else functools.partial(
                tree_verify_window, self.model, self.tree, self._tree_mask, *pool,
                self._draft_tokens, lanes, pad, plain=plain))
            verify = functools.partial(verify_window, self.model, *pool, plain=plain)
        else:
            pool = (self.pool.k, self.pool.v, self._index)
            decode = functools.partial(slab_decode_window, self.model, self.window, *pool,
                                       lanes, pad, forced=self._forced)
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

    def _window_inputs(self, kind: str) -> tuple:
        """The static inputs a window reads whose shapes set its cost: the
        block tables (or the slab) and the write indices, and a verify's
        drafts."""
        inputs = ((self._tables, self._index) if self.paged else (self.pool.k, self._index))
        if kind == "draft":
            return (self._ctx, self._ctx_len)
        if kind == "tree":
            return inputs + (self._draft_tokens,)
        if kind == "verify":
            return inputs + (self._drafts,)
        return inputs

    def _run(self, kind: str):
        """Run one window through its watched program."""
        program = self._programs[kind]
        self._cost_capture(_PROGRAM_NAMES[kind], program, self._window_inputs(kind))
        return program()

    def _run_window(self, kind: str):
        """One window: replay its graph on the card, else call it.  The
        variant follows host state: does some lane sample?"""
        sampling = kind != "draft" and self.lanes.any_sampled
        if self.graphs is None:
            return self._windows[kind, sampling]()
        self._bump("graph_replays")
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
        or running) and sets ``deadline_exceeded``.  ``request_class`` is a
        free-form traffic label: TTFT is also observed into
        ``serve/ttft_s_class_<class>``.  ``tenant`` attributes the request to
        a caller: every counter it moves (submissions, tokens, preemptions,
        sheds, completions, replays) is mirrored into
        ``serve/<key>_tenant_<tenant>_total`` and ``stats()["tenants"]``,
        and its TTFT into ``serve/ttft_s_tenant_<tenant>``."""
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
                self._bump("deadline_shed")
                self._bump_tenant(tenant, "deadline_shed")
                self.recorder.record("serve/deadline_shed", where="admission",
                                     deadline_s=float(deadline_s), estimate_s=est,
                                     queue_depth=depth)
                raise AdmissionError(
                    f"deadline {deadline_s}s unmeetable: ~{est:.2f}s of queued work ahead "
                    f"({depth} requests)", queue_depth=depth,
                    retry_after_s=min(30.0, max(est - float(deadline_s), 0.1)), retriable=True)
        now = clock()
        req = Request(rid=self._next_rid, prompt=prompt, config=gen, on_token=on_token,
                      cache_prefix=bool(cache_prefix), speculate=bool(speculate),
                      submit_step=self._step_count, submit_time=now, last_token_time=now,
                      deadline_s=None if deadline_s is None else float(deadline_s),
                      request_class=request_class, tenant=tenant)
        self._next_rid += 1
        # the waterfall opens here: queue_wait runs until the first prefill
        # chunk is taken (None when tracing is off: every hook checks)
        req.trace = self.reqtrace.begin(rid=req.rid, engine=self.engine_id,
                                        prompt_len=int(prompt.size), submit_t=now)
        self.scheduler.submit(req)
        self._bump("requests_submitted")
        self._bump_tenant(tenant, "requests_submitted")
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
        req = self.scheduler.cancel(rid)
        if req is not None:
            self._bump("cancelled")
            self.reqtrace.complete(req.trace, status="cancelled")
            return True
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or req.rid != rid or not self._active[s]:
                continue
            self._retire_lane(s)
            req.state = RequestState.CANCELLED
            req.finish_step = self._step_count
            self._bump("cancelled")
            self.recorder.record("serve/cancel_running", rid=rid, slot=s, step=self._step_count,
                                 tokens=len(req.tokens))
            self.reqtrace.complete(req.trace, status="cancelled")
            return True
        return False

    def _shed_blown_deadlines(self) -> None:
        """The deadline sweep (only while a deadline is live): cancel the
        running lanes and queued requests past their ``deadline_s``, setting
        ``deadline_exceeded``.  A request mid-prefill finishes its chunks;
        the sweep catches it once it runs."""
        now = clock()
        live = False
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or req.deadline_s is None or not self._active[s]:
                continue
            elapsed = now - req.submit_time
            if elapsed <= req.deadline_s:
                live = True
                continue
            self._retire_lane(s)
            req.deadline_exceeded = True
            req.state = RequestState.CANCELLED
            req.finish_step = self._step_count
            self._shed(req, "running", elapsed, slot=s, tokens=len(req.tokens))
        for req in list(self.scheduler.queue):
            if req.deadline_s is None:
                continue
            elapsed = now - req.submit_time
            if elapsed <= req.deadline_s:
                live = True
                continue
            self.scheduler.cancel(req.rid)
            req.deadline_exceeded = True
            self._shed(req, "queued", elapsed)
        self._has_deadlines = live or any(r.deadline_s is not None
                                          for r in self.scheduler.prefills)

    # ------------------------------------------------------- drain / hot swap
    def pause_admission(self) -> None:
        """Stop starting new prefills.  Queued requests stay queued, a
        request already mid-prefill finishes its chunks, and running lanes
        decode to completion: after enough :meth:`step` calls the engine is
        :attr:`drained`."""
        self.admission_paused = True

    def resume_admission(self) -> None:
        """Re-open admission; queued requests start prefilling next step."""
        self.admission_paused = False

    @property
    def drained(self) -> bool:
        """No lane active, no prefill open, no window in flight: the
        quiescence :meth:`swap_params` requires.  Queued requests do not
        block it: they hold no device state."""
        return (not self._active.any() and self._inflight is None
                and self._prev_handle is None and not self.scheduler.prefills
                and not self._reserved_slots)

    def swap_params(self, params, version: Optional[str] = None) -> None:
        """Hot-swap the served weights: ``params`` (a state dict with the
        engine model's names, shapes, dtypes and devices) is copied **in
        place** into the tensors the engine's model holds, quantized codes
        and scales alike.  The CUDA graphs hold those tensors' addresses,
        so every graph replays the new weights and none is captured again.
        The caller's tensors that the engine was built on (``params=`` is
        loaded with ``assign=True``) are therefore overwritten.

        Requires :attr:`drained` (``RuntimeError`` otherwise).  Raises
        ``ValueError``, before anything changes, when a name, shape, dtype
        or device differs (a graph cannot take another shape), and
        ``RuntimeError`` naming the engine when another live engine reads
        the same storage (the swap would change its tokens).  An injected
        ``hot_swap_upload`` fault raises before any state changes.  The
        prefix cache is flushed on every tier (its KV was computed under the
        old weights) and queued requests' pins are dropped; a
        self-speculative draft (``draft_model=n``) takes the new weights'
        first layers.  Admission stays where the caller left it."""
        if not self.drained:
            raise RuntimeError(
                "swap_params requires a drained engine (pause_admission, then step until "
                "engine.drained): active lanes or an in-flight window would mix weight "
                "versions mid-request")
        targets = self.model.state_dict(keep_vars=True)
        new = dict(params)
        if set(new) != set(targets):
            missing, extra = sorted(set(targets) - set(new)), sorted(set(new) - set(targets))
            raise ValueError(f"swap_params: names differ from the served model's "
                             f"(missing {missing[:4]}, unexpected {extra[:4]})")
        for name, t in targets.items():
            src = new[name]
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype \
                    or src.device != t.device:
                raise ValueError(
                    f"swap_params: {name} is {tuple(src.shape)} {src.dtype} on {src.device}, "
                    f"the served tensor {tuple(t.shape)} {t.dtype} on {t.device}: the "
                    "captured graphs cannot take another shape, dtype or device")
        self._check_unshared(targets.values())
        if faults.ACTIVE is not None and faults.ACTIVE.fire("hot_swap_upload"):
            # fail before touching any state: the engine keeps serving the
            # old weights, cache included
            raise faults.FaultInjected("injected hot-swap upload failure (weights unchanged)")
        self.scheduler.drop_cache_pins()
        flushed = self.prefix_cache.flush() if self.prefix_cache is not None else 0
        with torch.no_grad():
            for name, t in targets.items():
                if new[name] is not t:
                    t.copy_(new[name])
            if self.tree is not None and isinstance(self._draft_spec, int):
                # the self-speculative draft takes the new weights' first
                # layers (where it aliases the served tensors, it has them)
                for name, t in self.draft.state_dict(keep_vars=True).items():
                    if t.data_ptr() != targets[name].data_ptr():
                        t.copy_(new[name])
        old = self.weights_version
        if version is not None:
            self.weights_version = str(version)
        self._bump("hot_swaps")
        self.recorder.record("serve/hot_swap", old_version=old,
                             new_version=self.weights_version, step=self._step_count,
                             cache_nodes_flushed=flushed)

    def _check_unshared(self, tensors) -> None:
        """Refuse a swap into storage another live engine reads."""
        def storages(ts):
            return {(t.device, t.untyped_storage().data_ptr()) for t in ts}

        mine = storages(tensors)
        for other in list(_LIVE_ENGINES):
            if other is self:
                continue
            theirs = storages(other.model.state_dict().values())
            if mine & theirs:
                raise RuntimeError(
                    f"swap_params: engine {other.engine_id} serves from the same storage as "
                    f"engine {self.engine_id}; an in-place swap would change its tokens (build "
                    "each engine on its own copy of the weights)")

    # -------------------------------------------------------- fault tolerance
    def kill(self, reason: str = "replica killed") -> None:
        """Poison this engine as if its card vanished mid-window: every
        later :meth:`step` raises without touching the pool, until
        :meth:`revive`.  A supervisor exports the requests it owes
        (:meth:`export_inflight`) and replays them on a survivor
        (:meth:`adopt`)."""
        self._poisoned = faults.FaultInjected(reason)
        self.recorder.record("serve/engine_poisoned", error=reason, step=self._step_count)

    def export_inflight(self) -> List[Request]:
        """Every request this engine still owes an answer, detached and
        ready for :meth:`adopt` on a survivor
        (:func:`.transfer.export_inflight`)."""
        return transfer.export_inflight(self)

    def adopt(self, request: Request) -> Request:
        """Admit a request exported from a dead replica at the front of the
        queue (:func:`.transfer.adopt`): greedy lanes replay token-exact;
        sampled lanes resume on a re-seeded stream."""
        return transfer.adopt(self, request)

    def revive(self) -> None:
        """Bring a poisoned engine back to a serviceable idle state: land
        whatever the dead step left in flight through the handles' fetch (a
        failed fetch is recorded, and the window's pages settle anyway),
        settle or discard the prefix cache's transfers, retire every lane
        (a request mid-prefill's pages too), drop the open prefills and
        any request left in the queue, flush the prefix cache, put the lane
        vectors on the card back to their initial values (the next dispatch
        trusts nothing a dying window left there) and clear the poison."""
        handles = [h for h in (self._prev_handle, self._inflight) if h is not None]
        self._prev_handle = self._inflight = None
        spills, promotions = list(self._pending_spills), list(self._pending_promotions)
        for hd in handles:
            try:
                hd.fetch()  # proves the window's writes landed
            except Exception as exc:
                self.recorder.record("serve/revive_fetch_failed", error=repr(exc))
                hd.fetched = True
            if self.paged and hd.deferred_pages:
                hd.settle(self.kv.allocator)
            spills += hd.spills
            promotions += hd.promotions
        self._pending_spills, self._pending_promotions = [], []
        self._pending_prefill_qerr.clear()
        try:
            self._settle(spills, promotions)
        except Exception as exc:
            # the transfers rode the dying stream: their payloads cannot be
            # trusted, so the nodes drop instead of staying spilled
            self.recorder.record("serve/revive_spill_failed", error=repr(exc))
            if self.prefix_cache is not None:
                for xfer in spills:
                    if xfer.node.host is xfer:
                        self.prefix_cache.discard_spilled(xfer.node)
        self._cycle_decode_tokens = 0
        for s in range(self.num_slots):
            if self._active[s] or self._slot_req[s] is not None or s in self._reserved_slots:
                self._retire_lane(s)
        self.scheduler.take_prefills()
        self._reserved_slots.clear()
        for req in list(self.scheduler.queue):
            # export_inflight normally emptied the queue; what is left has
            # no owner to stream to
            self.scheduler.cancel(req.rid)
        if self.prefix_cache is not None:
            self.scheduler.drop_cache_pins()
            self.prefix_cache.flush()
        self.lanes.reset()
        self._t_pipeline_empty = None
        self._busy_since = None
        self._poisoned = None
        self.admission_paused = False
        self.recorder.record("serve/revive", step=self._step_count)

    def _shed(self, req: Request, where: str, elapsed: float, **fields) -> None:
        """Account one request the deadline sweep cancelled."""
        self._bump("deadline_shed")
        self._bump_tenant(req.tenant, "deadline_shed")
        self.recorder.record("serve/deadline_shed", where=where, rid=req.rid,
                             deadline_s=req.deadline_s, elapsed_s=elapsed, **fields)
        if req.trace is not None:
            req.trace.annotate("deadline_shed", where=where, deadline_s=req.deadline_s)
            self.reqtrace.complete(req.trace, status="shed")

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
                self._bump("reclaim_evictions")
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
        program = self._prefill[bucket]
        self._cost_capture(f"prefill_{bucket}", program,
                           (self._chunk_tokens[bucket],
                            self._chunk_table if self.paged else self.scratch.k))
        with self.tracer.span("serve/prefill_chunk", bucket=bucket):
            return program()

    def _run_chunk(self, bucket: int) -> Optional[torch.Tensor]:
        """One prefill chunk from the static buffers: replay its graph on the
        card, else call it."""
        if self.graphs is None or not self._graph_chunks:
            return self._chunks[bucket]()
        self._bump("graph_replays")
        err = self.graphs.replay(self._chunk_key(bucket))
        # the replay's output is rewritten by the next one: keep a copy
        return err.clone() if self.quantized else err

    def _admit(self) -> None:
        """Open prefills and run chunks against this step's budget (less the
        tokens of a window dispatched ahead, under interleave).  Paused
        admission opens none, but a prefill already open finishes."""
        sched = self.scheduler
        if self.admission_paused and not sched.prefills:
            return
        budget = sched.begin_step(self._cycle_decode_tokens if self.interleave_prefill else 0)
        t0 = time.perf_counter()
        chunks = 0
        while True:
            # open prefills, FCFS, up to the scheduler's cap while slots and
            # pages allow
            while (not self.admission_paused and sched.queue
                   and len(sched.prefills) < sched.max_prefills):
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
            tr = req.trace
            if tr is not None and not tr.queue_done:
                # first chunk taken: the queue_wait phase ends here
                tr.queue_done = True
                self._queue_wait_hist.observe(
                    tr.phase("queue_wait", queue_depth=sched.queue_depth))
            spilled = False
            if cached:
                node = req.cache_nodes[req.next_chunk - 1]
                spilled = node.tier != "device"
                if not self.paged:
                    # replay the cached slab into the scratch: one copy on
                    # the stream, no forward, no budget charged
                    program = self._copy[bucket]
                    args = (self.scratch.k, self.scratch.v, node.k, node.v, start)
                    self._cost_capture(f"copy_{bucket}", program, args)
                    with self.tracer.span("serve/copy_chunk", bucket=bucket, start=start):
                        program(*args)
                elif not spilled:
                    # the zero-copy hit: the node's pages join the lane's table
                    self.kv.lane_append_shared(req.slot, node.pages)
                elif not self._promote_node(req, node, bucket):
                    # a degraded promotion (a fault, a torn payload or page
                    # pressure) prefills the chunk instead; _populate_cache
                    # heals the node with the fresh pages
                    cached = False
                    self._bump("promote_degraded")
                    self.recorder.record("serve/promote_degraded", rid=req.rid, bucket=bucket,
                                         step=self._step_count)
                if cached:
                    self._bump("prefix_hit_tokens", valid)
                    if spilled:
                        self._bump("prefix_hit_tokens_host", valid)
            if not cached:
                chunk = np.zeros(bucket, np.int32)
                chunk[:valid] = req.prefill_tokens[start:start + valid]
                err = self._prefill_chunk(req, bucket, chunk, start)
                if self.quantized:
                    self._pending_prefill_qerr.append(err)
                budget -= bucket
                self._bump("prefill_chunks")
                if self.interleave_prefill and self._cycle_decode_tokens:
                    # queued behind this cycle's window: the interleave happened
                    self._bump("interleaved_chunks")
                if self.prefix_cache is not None and req.cache_prefix:
                    self._bump("prefix_miss_tokens", valid)
                    self._populate_cache(req, bucket, valid, start)
            self._bump("prefill_tokens", valid)
            if tr is not None:
                # one tiled phase per admitted chunk, with the hit's tier
                source = "fresh" if not cached else "promoted" if spilled else "cached"
                self._prefill_phase_hist.observe(tr.phase(
                    "prefill", chunk=req.next_chunk - 1, bucket=bucket, tokens=valid,
                    source=source))
            done = sched.finish_prefill()
            if done is not None:
                self._install(done)
        if chunks:
            if self.async_depth == 0 and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._bump("prefill_s", time.perf_counter() - t0)

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
            args = (self.pool.k, self.pool.v, self.scratch.k, self.scratch.v, s)
            self._cost_capture("insert", self._insert, args)
            self._insert(*args)
        self._lane_len[s] = len(ptoks) - 1
        self.recorder.record("serve/install", rid=req.rid, slot=s, step=self._step_count,
                             prompt_len=len(ptoks))
        gen = req.config
        eos = -1 if gen.eos_token_id is None else int(gen.eos_token_id)
        sampled = gen.do_sample and gen.temperature > 0.0
        args = (s, int(ptoks[-1]), eos, float(gen.temperature),
                0 if gen.top_k is None else int(gen.top_k),
                1.0 if gen.top_p is None else float(gen.top_p),
                lane_key(self.rng_seed, req.rid) if sampled else None)
        self._cost_capture("lane_install", self._lane_install, args)
        self._lane_install(*args)
        if self._draft_window is not None:
            # the window's last token is the lane's pending token: the root
            # of every draft tree
            self._draft_window.begin(s, ptoks)
        if req.replay_decode:
            # the prompt's KV is in the pages: the streamed tokens go through
            # the decode windows that follow
            req.replay_len, req.replay_done = len(req.tokens), 0
        self._active[s] = True
        self._eos[s] = eos
        if self._slot_ever_used[s]:
            self._bump("slots_reused")
        self._slot_ever_used[s] = True
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
            args = (self._pool, pid, new[0])
            self._cost_capture("copy_page", self._copy_page, args)
            with self.tracer.span("serve/copy_page", src=pid, dst=new[0]):
                self._copy_page(*args)
            self.kv.lane_replace(s, pslot, new[0])
            self._bump("cow_copies")
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
        bucket = len(node.pages) * self.page_size
        program = self._spill_extract[bucket]
        self._cost_capture(f"spill_{bucket}", program, (self._pool, ids))
        with self.tracer.span("serve/spill_d2h", bucket=bucket):
            gathered = program(self._pool, ids)
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
        self.recorder.record("serve/spill", bucket=bucket, step=self._step_count,
                             behind_window=self._inflight is not None
                             or self._prev_handle is not None)
        return xfer

    def _promote_node(self, req: Request, node, bucket: int) -> bool:
        """Promote one spilled chunk for ``req``: allocate fresh pages, copy
        the payload up (from its pinned buffers, non-blocking; or straight
        from the device gather of a spill not drained yet) and install it
        into the pages in place, all behind the window in flight.  The pages
        join the lane; the node re-enters the device tier when the budget
        allows, taking its own references.  False, with nothing installed,
        on a missing or torn payload or unrecoverable page pressure: the
        chunk then prefills; an injected ``promote_h2d`` fault degrades the
        same way."""
        if faults.ACTIVE is not None and faults.ACTIVE.fire("promote_h2d"):
            self.recorder.record("serve/fault", point="promote_h2d", rid=req.rid,
                                 step=self._step_count)
            return False
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
        behind = self._inflight is not None or self._prev_handle is not None
        marks = self._marks()
        source = () if isinstance(payload, CacheTransfer) else payload
        chunk = tuple(c.to(self.device, non_blocking=True) for c in chunk)
        args = (self._pool, chunk,
                torch.tensor(ids, dtype=torch.int64).to(self.device, non_blocking=True))
        program = self._promote_install[bucket]
        self._cost_capture(f"promote_{bucket}", program, args)
        with self.tracer.span("serve/promote_h2d", bucket=bucket, behind_window=behind):
            program(*args)
        if marks:
            marks[1].record()
        self.kv.lane_append_owned(req.slot, ids)  # the lane takes the allocation's reference
        if self.prefix_cache.promote_node(node, ids):
            self.kv.allocator.ref(ids)
        self._pending_promotions.append(CacheTransfer(
            "promote", sum(c.numel() * c.element_size() for c in chunk), host=source,
            marks=marks, seconds=time.perf_counter() - t0,
            record={"rid": req.rid, "bucket": bucket, "behind_window": behind,
                    "step": self._step_count, "trace": req.trace}))
        if req.trace is not None:
            req.trace.annotate("promote_dispatch", bucket=bucket, behind_window=behind)
        self.recorder.record("serve/promote_h2d", rid=req.rid, bucket=bucket,
                             behind_window=behind, step=self._step_count)
        return True

    def _settle(self, spills: List[CacheTransfer], promotions: List[CacheTransfer]) -> None:
        """Land cache transfers (after the fetch of the window they rode, so
        nothing waits): a spill's host buffers become its node's payload
        unless the node moved on meanwhile (promoted, healed or dropped); a
        promotion's source buffers are released.  Their times and bytes go
        to ``stats``."""
        for xfer in spills:
            self._bump("spill_s", xfer.finish())
            self._bump("spill_bytes", xfer.nbytes)
            if self.prefix_cache is not None and xfer.node.host is xfer:
                self.prefix_cache.settle_payload(xfer.node, xfer.host)
        for xfer in promotions:
            self._bump("promote_s", xfer.finish())
            self._bump("promote_bytes", xfer.nbytes)
            rec = dict(xfer.record or {})
            tr = rec.pop("trace", None)
            if tr is not None and not tr.finished:
                self._promote_wait_hist.observe(tr.phase("promote_wait", bucket=rec["bucket"]))
            self.recorder.record("serve/promote_land", **rec)

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
        if self.paged:
            # a slab lane keeps its write index, as the reference's device
            # index does: the dead lane writes and reads its own slot there,
            # and its row enters an fp8 product's amax
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
            freed = self._retire_lane(s)
            self.scheduler.requeue(req)
            self._bump("preemptions")
            self._bump_tenant(req.tenant, "preemptions")
            self.recorder.record("serve/preempt", rid=req.rid, slot=int(s),
                                 step=self._step_count, pages_freed=freed, effective_len=eff)
            if req.trace is not None:
                req.trace.annotate("preempt", slot=int(s), pages_freed=freed,
                                   generated=len(req.tokens))
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
            new = hd.width - (int(hd.replayed[s]) if hd.replayed is not None else 0)
            if len(req.tokens) + new >= req.config.max_new_tokens:
                hd.prefreed.add(s)
                self._retire_lane(s)
                self._bump("prefreed_lanes")

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
        self._occupancy_gauge.set(n_occupied / self.num_slots)
        if faults.ACTIVE is not None and faults.ACTIVE.fire("decode_dispatch"):
            raise faults.FaultInjected(f"injected decode-window dispatch failure "
                                       f"(step {self._step_count}, {n_occupied} lanes)")
        hd = None
        if self._spec_any and self._replaying():
            pass  # decode replay runs through the decode window
        elif self.tree is not None:
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
            self._bump("device_idle_s", now - self._t_pipeline_empty)
            self._idle_gauge.set(self.stats["device_idle_s"] * 1e3)
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
                drafted: Optional[np.ndarray] = None,
                replayed: Optional[np.ndarray] = None) -> Readback:
        """Stage a dispatched window's outputs to the host and snapshot the
        lanes it saw; the handle's ``dispatch_t`` is now, the window's
        launches done."""
        if not self.quantized:
            err = None
        (toks, counts, err), ready = stage((toks, counts, err))
        return Readback(kind=kind, toks=toks, width=width, counts=counts, qerr=err,
                        active=self._active.copy(), reqs=list(self._slot_req),
                        eos=self._eos.copy(), n_occupied=n_occupied, drafted=drafted,
                        ready=ready, replayed=replayed)

    def _replaying(self) -> bool:
        """Does some running lane still owe decode replay?"""
        return any(req is not None and req.replay_done < req.replay_len
                   for req in self._slot_req)

    def _give_replayed(self) -> Optional[np.ndarray]:
        """Write the next window's given tokens: each running lane under
        decode replay takes the next of its streamed tokens, up to a window.
        Returns the tokens given a lane (``None`` when none is), which the
        drain does not emit again."""
        if not (self._forced_live or self._replaying()):
            return None
        self._forced_host.fill(-1)
        given = np.zeros(self.num_slots, np.int32)
        for s in np.nonzero(self._active)[0]:
            req = self._slot_req[s]
            if req is None or req.replay_done >= req.replay_len:
                continue
            k = min(self.window, req.replay_len - req.replay_done)
            self._forced_host[s, :k] = req.tokens[req.replay_done:req.replay_done + k]
            req.replay_done += k
            given[s] = k
        self._forced.copy_(torch.from_numpy(self._forced_host), non_blocking=True)
        self._forced_live = bool(given.any())
        return given if self._forced_live else None

    def _attention_span(self):
        """The reference's ``serve/paged_attn`` span, nested in a window's
        span where the paged pool attends in place (the kernels, or
        quantized pages)."""
        if self.paged and (self.quantized or self.decode_kernel == "pallas"):
            return self.tracer.span("serve/paged_attn", kernel=self.decode_kernel)
        return contextlib.nullcontext()

    def _decode_cycle(self, n_occupied: int) -> Readback:
        """Dispatch one decode window over the pool."""
        self._note_dispatch()
        self._upload_pool()
        replayed = self._give_replayed()
        with self.tracer.span("serve/decode_window", occupied=n_occupied):
            with self._attention_span():
                toks, err = self._run("decode")
        self._lane_len[self._active] += self.window
        self._bump("decode_steps", self.window)
        self._bump("occupied_lane_steps", n_occupied * self.window)
        return self._handle("decode", self.window, toks, None, err, n_occupied,
                            replayed=replayed)

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

    def _verify_dispatched(self, drafted: np.ndarray, drafted_tokens: int, steps: int,
                           n_occupied: int) -> None:
        self._bump("decode_steps", steps)
        self._bump("occupied_lane_steps", n_occupied * steps)
        self._bump("verify_forwards")
        self._bump("verify_lanes", int(self._active.sum()))
        self._bump("spec_drafted", int(drafted.sum()) * drafted_tokens)

    def _verify_cycle(self, drafts: np.ndarray, drafted: np.ndarray,
                      n_occupied: int) -> Readback:
        """Dispatch one linear verify over ``[slots, K+1]``: the lanes'
        pending tokens (on the card) and their drafts."""
        self._note_dispatch()
        self._upload_pool()
        self._drafts.copy_(torch.from_numpy(drafts), non_blocking=True)
        with self.tracer.span("serve/verify_window", occupied=n_occupied,
                              drafted=int(drafted.sum())):
            with self._attention_span():
                out, n_commit, err = self._run("verify")
        k = self.speculate_k
        self._verify_dispatched(drafted, k, k + 1, n_occupied)
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
        with self.tracer.span("serve/draft_forward", occupied=n_occupied):
            self._run("draft")
        t_draft = time.perf_counter() - t_draft
        self._draft_ms_hist.observe(t_draft * 1e3)
        if marks:
            marks[1].record()
        with self.tracer.span("serve/tree_verify_window", occupied=n_occupied,
                              drafted=int(drafted.sum())):
            with self._attention_span():
                out, n_commit, err = self._run("tree")
        depth = self.tree.depth
        self._verify_dispatched(drafted, depth, depth + 1, n_occupied)
        self._tree_nodes_counter.inc(n_occupied * self.tree.nodes)
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
        """Land one window (:meth:`_drain_impl`).  A drain that fails
        poisons the engine (:meth:`step`) with the handle already detached:
        a pre-freed lane's request lives only on it, so it goes back to the
        queue here, or :meth:`export_inflight` would never see it."""
        try:
            self._drain_impl(hd)
        except BaseException:
            for s in hd.prefreed:
                req = hd.reqs[s]
                if req is not None and req.state is RequestState.RUNNING:
                    self.scheduler.requeue(req)
            raise

    def _drain_impl(self, hd: Readback) -> None:
        """Wait for the window's staged outputs (the one blocking point),
        then all host bookkeeping against its dispatch-time lane snapshot.
        The ``fetch_slow`` / ``fetch_fail`` fault points stand in for a
        stalled or failed readback."""
        if faults.ACTIVE is not None:
            if faults.ACTIVE.fire("fetch_slow"):
                time.sleep(faults.ACTIVE.slow_ms / 1e3)
            if faults.ACTIVE.fire("fetch_fail"):
                raise faults.FaultInjected(f"injected readback failure (step {self._step_count})")
        t0 = time.perf_counter()
        with self.tracer.span("serve/readback", kind=hd.kind, occupied=hd.n_occupied):
            hd.fetch()
        t1 = time.perf_counter()
        # overlap accounting: host work since dispatch ran under the card;
        # the wait is what the pipeline failed to hide (under async_depth=0
        # the drain follows the dispatch at once: the ratio stays near 0)
        host, wait = max(t0 - hd.dispatch_t, 0.0), t1 - t0
        self._overlap_host_s += host
        self._overlap_wait_s += wait
        denom = self._overlap_host_s + self._overlap_wait_s
        if denom > 0.0:
            self.stats["host_overlap_ratio"] = self._overlap_host_s / denom
            self._overlap_gauge.set(self.stats["host_overlap_ratio"])
        self.recorder.record("serve/readback", step=self._step_count, window=hd.kind,
                             wait_ms=wait * 1e3, overlapped_ms=host * 1e3)
        toks = hd.toks.numpy()
        counts = hd.counts.numpy() if hd.counts is not None else np.full(self.num_slots,
                                                                          hd.width)
        st = self.stats
        if hd.qerr is not None:
            st["kv_quant_error"] = float(hd.qerr)
        if hd.prefill_qerrs is not None:
            st["kv_quant_error"] = float(hd.prefill_qerrs.max())
        if self._kv_quant_gauge is not None and (hd.qerr is not None
                                                 or hd.prefill_qerrs is not None):
            # a host value that has landed, never a graph's output
            self._kv_quant_gauge.set(st["kv_quant_error"])
        if hd.kind == "verify":
            # the write-index mirror advances by what the card committed,
            # for lanes still owned by the request the window ran for
            for s in np.nonzero(hd.active)[0]:
                if hd.reqs[s] is not None and self._slot_req[s] is hd.reqs[s]:
                    self._lane_len[s] += int(counts[s])
            self._bump("verify_committed", int(counts[hd.active].sum()))
            accepted = int(np.maximum(counts[hd.drafted] - 1, 0).sum())
            self._bump("spec_accepted", accepted)
            for s in np.nonzero(hd.drafted)[0]:
                self._accept_len_hist.observe(float(max(int(counts[s]) - 1, 0)))
            if st["spec_drafted"]:
                self._accept_rate_gauge.set(st["spec_accepted"] / st["spec_drafted"])
            self.recorder.record("serve/verify", step=self._step_count,
                                 drafted_lanes=int(hd.drafted.sum()),
                                 committed=int(counts.sum()), accepted=accepted)
            self._bump("draft_s", hd.draft_marks[0].elapsed_time(hd.draft_marks[1]) / 1e3
                       if hd.draft_marks else hd.draft_s)
        self._trace_drain(hd, counts, t0, t1)
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
            self._bump("decode_s", now - self._busy_since)
            self._busy_since = None

    def _trace_drain(self, hd: Readback, counts: np.ndarray, t0: float, t1: float) -> None:
        """Close each live lane's decode (or spec_verify) waterfall phase at
        the drain, where a window's cost is known: the phase spans the
        trace's cursor to the end of the fetch, and the fetch's wait rides
        along as ``wait_s``.  Runs before the tokens land, so the phases
        precede the first-token mark."""
        phase = "spec_verify" if hd.kind == "verify" else "decode"
        wait = max(t1 - t0, 0.0)
        for s, req in hd.live_requests():
            tr = req.trace
            if tr is None or tr.finished:
                continue
            dur = tr.phase(phase, now=t1, step=self._step_count, lanes=hd.n_occupied,
                           wait_s=wait)
            n = max(int(counts[s]), 1)
            self._decode_tok_hist.observe(dur / n, n)

    def _emit(self, toks: np.ndarray, counts: np.ndarray, hd: Readback) -> None:
        """Land a window's tokens on their requests: ``toks[s, :counts[s]]``
        is lane ``s``'s output (a whole decode window, or a verify's
        committed prefix), cut at the lane's EOS and at the request's length
        cap.  Lanes are those of the window's dispatch-time snapshot: a lane
        retired or preempted since then no longer owns its slot and its
        tokens drop, unless it was pre-freed (its request completes here);
        finished lanes free their slot.  A lane's first ``hd.replayed[s]``
        tokens were given (decode replay): streamed before, not again."""
        width = toks.shape[1]
        mask, reqs, eos = hd.active, hd.reqs, hd.eos
        valid = (np.arange(width)[None, :] < counts[:, None]) & mask[:, None]
        is_eos = valid & (toks == eos[:, None]) & (eos >= 0)[:, None]
        has_eos = is_eos.any(axis=1)
        first_eos = np.where(has_eos, is_eos.argmax(axis=1), width)
        n_take = np.minimum(valid.sum(axis=1), first_eos + 1)
        now = clock()
        for s in np.nonzero(n_take > 0)[0]:
            req = reqs[s]
            if req is None:
                continue
            owner = self._slot_req[s] is req
            if not owner and not (int(s) in hd.prefreed and req.state is RequestState.RUNNING):
                continue
            given = int(hd.replayed[s]) if hd.replayed is not None else 0
            if owner and given and self._draft_window is not None:
                self._draft_window.push(int(s), toks[s, :given])
            n = min(int(n_take[s]) - given, req.config.max_new_tokens - len(req.tokens))
            if n <= 0:
                continue
            if not req.tokens:
                self._first_token(req, now)
            new = toks[s, given:given + n]
            for t in new:
                req.emit(int(t))
            if owner and self._draft_window is not None:
                self._draft_window.push(int(s), new)
            self._bump("tokens_generated", n)
            self._bump_tenant(req.tenant, "tokens_generated", n)
            # the window lands n tokens at once: each is charged its share
            # of the wall time since the lane's last arrival
            self._token_hist.observe(max(now - req.last_token_time, 0.0) / n, n)
            req.last_token_time = now
            hit_eos = bool(has_eos[s]) and given + n == int(n_take[s])
            if hit_eos or len(req.tokens) >= req.config.max_new_tokens:
                if owner:
                    self._retire_lane(s)
                self._finish_request(int(s), req, now)

    def _first_token(self, req: Request, now: float) -> None:
        """TTFT into the global, per-class and per-tenant histograms."""
        ttft = now - req.submit_time
        self._ttft_hist.observe(ttft)
        if req.trace is not None:
            req.trace.mark_first_token(now)
        if req.request_class:
            hist = self._class_ttft_hists.get(req.request_class)
            if hist is None:
                hist = self._class_ttft_hists[req.request_class] = self.metrics.histogram(
                    f"serve/ttft_s_class_{req.request_class}", buckets=_LATENCY_BUCKETS)
            hist.observe(ttft)
        self._tenant_ttft(req.tenant, ttft)

    def _finish_request(self, slot: int, req: Request, now: float) -> None:
        req.state = RequestState.DONE
        req.finish_step = self._step_count
        # the submit-to-done average behind submit's deadline estimate
        dur = max(now - req.submit_time, 0.0)
        self._service_ema = (dur if self._service_ema == 0.0
                             else 0.8 * self._service_ema + 0.2 * dur)
        self._bump("requests_completed")
        self._bump_tenant(req.tenant, "requests_completed")
        self.recorder.record("serve/finish", rid=req.rid, slot=slot, step=self._step_count,
                             tokens=len(req.tokens), steps=self._step_count - req.submit_step)
        if req.trace is not None:
            req.trace.tokens = len(req.tokens)
            self.reqtrace.complete(req.trace, status="done")

    # ----------------------------------------------------------------- drive
    def step(self) -> None:
        """One engine iteration: the deadline sweep (while a deadline is
        live), pre-free the lanes the window in flight finishes, budgeted
        chunked-prefill admission and the dispatch of one decode cycle (the
        dispatch first under ``interleave_prefill``), then the drain of the
        window the pipeline hands back (with the traffic that rode it).

        Fault containment: the first exception to escape a step parks in
        the engine and every later step raises it, until :meth:`revive`."""
        if self._poisoned is not None:
            raise self._poisoned
        try:
            self._step_impl()
        except Exception as exc:
            self._poisoned = exc
            self.recorder.record("serve/engine_poisoned", error=repr(exc), step=self._step_count)
            raise

    def _step_impl(self) -> None:
        if self._has_deadlines:
            self._shed_blown_deadlines()
        if (faults.ACTIVE is not None and self.paged and self._active.any()
                and faults.ACTIVE.fire("page_exhaustion")):
            # stand-in for the pool running dry: the reclaim ladder's last
            # resort (preempt the youngest lane), after a drain as the
            # ladder's step 2 does: with the window still in flight the
            # victim could re-install into its old slot before the drain and
            # the stale window's tokens would land twice
            if self._inflight is not None:
                self._drain_inflight()
            self._preempt()
        queue_depth = self.scheduler.queue_depth
        self._queue_gauge.set(queue_depth)
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
        st = self.stats
        if self.prefix_cache is not None:
            covered = st["prefix_hit_tokens"] + st["prefix_miss_tokens"]
            if covered:
                hit, host_hit = st["prefix_hit_tokens"], st["prefix_hit_tokens_host"]
                self._hit_rate_gauge.set(hit / covered)
                self._hit_rate_device_gauge.set((hit - host_hit) / covered)
                self._hit_rate_host_gauge.set(host_hit / covered)
        self._update_prefill_gauges()
        if self.paged:
            self.kv.publish_gauges()
        self._step_count += 1
        # progress heartbeat for the stall detector and /healthz, and the
        # ring's per-step record of the pool
        self.recorder.heartbeat("serve/step", step=self._step_count, queue=queue_depth,
                                occupied=int(self._active.sum()))

    def _update_prefill_gauges(self) -> None:
        """``serve/prefill_tokens_per_s`` (valid prompt tokens over the wall
        between steps that made prefill progress; idle stretches slide the
        window) and ``serve/prefill_interleave_ratio``."""
        chunks = self.stats["prefill_chunks"]
        if chunks:
            self._interleave_gauge.set(self.stats["interleaved_chunks"] / chunks)
        tokens = self.stats["prefill_tokens"]
        now = time.perf_counter()
        if self._pf_last_t is None or tokens < self._pf_last_tokens:
            self._pf_last_t, self._pf_last_tokens = now, tokens
            return
        if tokens == self._pf_last_tokens:
            self._pf_last_t = now  # no prefill this step: slide the window
            return
        dt = now - self._pf_last_t
        if dt > 0.0:
            self._pf_rate_gauge.set((tokens - self._pf_last_tokens) / dt)
        self._pf_last_t, self._pf_last_tokens = now, tokens

    @property
    def has_work(self) -> bool:
        # a window in flight is work: its tokens have not landed yet
        return (self.scheduler.has_queued or bool(self._active.any())
                or self._inflight is not None)

    def _update_tenant_kv_gauges(self) -> None:
        """Per-tenant KV occupancy gauges (``serve/kv_pages_tenant_<t>``):
        pages held by each tenant's lanes (lanes on the slab pool).  A
        tenant with no live lane reads 0."""
        if not self._tenant_stats:
            return
        held: dict = {}
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or req.tenant is None:
                continue
            held[req.tenant] = held.get(req.tenant, 0) + (
                int(self.kv.lane_npages[s]) if self.paged else 1)
        for tenant in self._tenant_stats:
            gauge = self._tenant_kv_gauges.get(tenant)
            if gauge is None:
                gauge = self._tenant_kv_gauges[tenant] = self.metrics.gauge(
                    f"serve/kv_pages_tenant_{tenant}")
            gauge.set(held.get(tenant, 0))

    def _log_health(self, dt: float, d_tokens: int) -> None:
        """One-line serve-health summary (the ``metrics_interval`` heartbeat)."""
        occupancy = float(self._active.mean()) if self.num_slots else 0.0
        logger.info(
            f"serve health: queue={self.scheduler.queue_depth} occupancy={occupancy:.2f} "
            f"tokens/s={d_tokens / dt if dt > 0 else 0.0:.1f} "
            f"token_p99={self._token_hist.percentile(99) * 1e3:.2f}ms "
            f"completed={self.stats['requests_completed']}"
            f"/{self.stats['requests_submitted']}")

    def run(self, max_steps: Optional[int] = None,
            metrics_interval: Optional[float] = None) -> None:
        """Drive :meth:`step` until every submitted request completes.
        ``metrics_interval`` (seconds) logs a one-line health summary at
        that cadence, refreshes the per-tenant KV gauges and ticks the
        installed SLO engine (:func:`~accelerate_tpu_torch.telemetry.
        slo_tick`); off by default."""
        steps = 0
        last_log = time.perf_counter()
        last_tokens = self.stats["tokens_generated"]
        while self.has_work:
            self.step()
            steps += 1
            if metrics_interval is not None:
                now = time.perf_counter()
                if now - last_log >= metrics_interval:
                    self._log_health(now - last_log,
                                     self.stats["tokens_generated"] - last_tokens)
                    self._update_tenant_kv_gauges()
                    slo_tick()
                    last_log = now
                    last_tokens = self.stats["tokens_generated"]
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def serve(self, prompts: Sequence, configs=None,
              on_token: Optional[Callable[[Request, int], None]] = None,
              metrics_interval: Optional[float] = None) -> List[Request]:
        """Submit every prompt (``configs`` is one shared or a per-request list
        of ``GenerationConfig``), run to completion, return the requests in
        submission order.  ``metrics_interval`` goes to :meth:`run`."""
        reqs = []
        for i, p in enumerate(prompts):
            cfg = configs[i] if isinstance(configs, (list, tuple)) else configs
            reqs.append(self.submit(p, config=cfg, on_token=on_token))
        self.run(metrics_interval=metrics_interval)
        return reqs

    # ------------------------------------------------------------------ stats
    def mean_slot_occupancy(self) -> float:
        """Occupied lane-steps / total lane-steps across decode windows."""
        total = self.stats["decode_steps"] * self.num_slots
        return self.stats["occupied_lane_steps"] / total if total else 0.0

    def analyze_costs(self) -> dict:
        """Evaluate the cost table over every program the engine has run
        and publish ``serve/decode_flops_per_token`` (the decode window's
        FLOPs over ``window * num_slots``) and ``serve/hbm_peak_bytes``
        (the largest card memory one program's graph holds; none on the
        CPU).  Off the serve loop: benches call it, and the debug server
        runs it before each ``/metrics`` scrape.  Returns the table's
        snapshot."""
        snap = self.cost_table.analyze_all()
        decode_flops = self.cost_table.flops("serve/decode_window")
        if decode_flops:
            self._decode_flops_gauge.set(decode_flops / (self.window * self.num_slots))
        hbm = self.cost_table.max_hbm_peak_bytes()
        if hbm:
            self._hbm_gauge.set(hbm)
        return snap

    def kv_pool_bytes(self) -> int:
        """Card bytes the KV state occupies: the page pool (pages and
        scales), or the slab pool plus the prefill scratch."""
        if self.paged:
            return self.kv.kv_bytes()
        return sum(t.numel() * t.element_size()
                   for t in (self.pool.k, self.pool.v, self.scratch.k, self.scratch.v))

    def compiled_executable_counts(self) -> dict:
        """Distinct call signatures of each program (its
        :class:`RecompileWatchdog`), under the reference's keys: at most 1
        each after any workload, and on the card each is one CUDA graph
        per signature.  ``decode_window``, ``lane_install``, ``copy_page``
        (paged; 0 until the first copy-on-write) or ``insert`` (slab),
        ``verify_window`` or ``tree_verify_window`` and ``draft_forward``
        (speculation; 0 until the first drafted cycle), ``prefill_<b>``,
        ``copy_<b>`` (slab with the prefix cache), and ``spill_<b>`` /
        ``promote_<b>`` (the host tier).  ``lane_install`` counts from the
        first install: the port's lane vectors always live on the card,
        where the reference's count starts at the first install after a
        window."""
        out = {"decode_window": self._programs["decode"].jit_cache_size(),
               "lane_install": self._lane_install.jit_cache_size()}
        if self.paged:
            out["copy_page"] = self._copy_page.jit_cache_size()
        else:
            out["insert"] = self._insert.jit_cache_size()
        for kind in ("tree", "verify", "draft"):
            if kind in self._programs:
                out[_PROGRAM_NAMES[kind]] = self._programs[kind].jit_cache_size()
        for group, programs in (("prefill", self._prefill), ("copy", self._copy),
                                ("spill", self._spill_extract),
                                ("promote", self._promote_install)):
            for b, program in programs.items():
                out[f"{group}_{b}"] = program.jit_cache_size()
        return out
