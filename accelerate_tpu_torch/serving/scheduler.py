"""Host-side request scheduling for the continuous-batching engine.

Port of :mod:`accelerate_tpu.serving.scheduler`: a FCFS request queue,
per-request :class:`~accelerate_tpu_torch.models.generation.GenerationConfig`,
chunked-prefill progress, and an admission policy bounded by a prefill-token
budget per engine step (the Orca/Sarathi knob that keeps decode-step latency
jitter bounded while new prompts stream in).  One request prefills at a time
by default (``max_prefills=1``); the interleaved engine keeps up to one open
prefill per slot and picks their chunks shortest-remaining-first.

With a :class:`~accelerate_tpu_torch.serving.prefix_cache.PrefixCache`
attached, the scheduler also resolves prefix reuse: ``submit`` walks the
radix tree for the longest cached chunk-aligned prefix and pins the matched
nodes, ``start_next`` and ``requeue`` walk it again (requests admitted since
may have populated more of it), and ``take_chunk`` charges cached chunks
nothing against the prefill-token budget.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..models.generation import GenerationConfig
from ..telemetry import get_flight_recorder
from .errors import AdmissionError
from .pool import plan_chunks


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Request:
    """One serving request: prompt + generation config + progress.

    ``on_token(request, token)`` streams each generated token as the engine
    lands it (window granularity); ``tokens`` accumulates the generated ids
    (EOS included when hit, never the post-EOS padding).  ``speculate=False``
    opts the request out of drafting (it still rides along in verify
    windows other lanes trigger, with pad drafts that verification
    rejects).

    Prefix-cache state: the first ``cached_chunks`` entries of ``chunks``
    are covered by the pinned radix nodes at the head of ``cache_nodes``,
    which also collects the nodes this request populates (released at
    install); ``cache_chain_broken`` stops population once a chunk could
    not be retained (a later chunk without its ancestors is unreachable);
    ``cache_prefix=False`` opts the request out of reuse and population.

    ``deadline_s``: the request's budget in seconds from ``submit_time``
    (``None``: no deadline); the engine sheds it at admission when the
    queue's estimate says it cannot be met, and cancels it once it is blown,
    setting ``deadline_exceeded``."""

    rid: int
    prompt: np.ndarray                      # [S] int32
    config: GenerationConfig
    on_token: Optional[Callable[["Request", int], None]] = None
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    chunks: Tuple[Tuple[int, int], ...] = ()
    next_chunk: int = 0
    speculate: bool = True
    cache_prefix: bool = True
    cached_chunks: int = 0
    cache_nodes: List[Any] = dataclasses.field(default_factory=list)
    cache_chain_broken: bool = False
    submit_step: int = -1
    finish_step: int = -1
    # wall-clock stamps (time.perf_counter) for TTFT / per-token latency
    submit_time: float = 0.0
    last_token_time: float = 0.0
    deadline_s: Optional[float] = None
    deadline_exceeded: bool = False
    # traffic-class label ("chat", "batch", ...) for per-class TTFT
    # histograms; None stays out of the per-class series entirely
    request_class: Optional[str] = None
    # tenant attribution label: rides the Request through preemption,
    # export_inflight and failover ``adopt`` like ``trace`` does, so the
    # per-tenant counters stay exact across replays
    tenant: Optional[str] = None
    # per-request latency waterfall (telemetry.reqtrace.RequestTrace; None
    # when tracing is off); the same object rides through preemption and
    # failover, which appends a ``failover`` phase to it
    trace: Optional[Any] = dataclasses.field(default=None, repr=False)
    # decode replay (a request adopted from a dead replica): prefill the
    # prompt only, then feed the tokens already streamed through the
    # decode steps that first computed them; ``replay_len`` of them, of
    # which ``replay_done`` are in dispatched windows (both reset at install)
    replay_decode: bool = False
    replay_len: int = 0
    replay_done: int = 0

    @property
    def done(self) -> bool:
        return self.state is RequestState.DONE

    @property
    def output_ids(self) -> np.ndarray:
        """Prompt + generated tokens."""
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What prefill must process now: the prompt, plus — after a
        preemption — every token already generated (replay resumes exactly
        where generation stopped; ``tokens`` is never re-emitted).  Under
        decode replay, the prompt alone: the generated tokens go through
        decode windows instead."""
        if not self.tokens or self.replay_decode:
            return self.prompt
        return self.output_ids

    def emit(self, token: int) -> None:
        self.tokens.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))


class Scheduler:
    """FCFS admission with a per-step prefill-token budget.

    Chunks are charged against ``prefill_token_budget`` each engine step, so
    a long prompt spreads across steps instead of stalling every running
    request for its whole prefill (chunked prefill, Sarathi-style).  The
    first forward-pass chunk of each step runs even over budget, or a bucket
    wider than the budget could never run.  ``max_prefills``: requests that
    may be mid-prefill at once (1, or one per slot in the interleaved
    engine): admission stays FCFS, and :meth:`take_chunk` picks among them
    shortest-remaining-first.  ``prefix_cache``: the engine's cache, or
    ``None``.
    """

    def __init__(self, prefill_buckets: Sequence[int], prefill_token_budget: int,
                 max_queue: Optional[int] = None, prefix_cache=None, max_prefills: int = 1,
                 recorder=None):
        self.buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if not self.buckets:
            raise ValueError("need at least one prefill bucket")
        self.budget = int(prefill_token_budget)
        if self.budget < self.buckets[0]:
            raise ValueError(
                f"prefill_token_budget {self.budget} cannot fit the smallest "
                f"bucket {self.buckets[0]} — no prompt would ever be admitted"
            )
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_prefills = int(max_prefills)
        if self.max_prefills < 1:
            raise ValueError(f"max_prefills must be >= 1, got {max_prefills}")
        self.queue: deque = deque()
        # requests mid-prefill, in admission order
        self._prefills: List[Request] = []
        self._chunk_this_step = False
        self.prefix_cache = prefix_cache
        # request-lifecycle events for post-mortems (a no-op ring append when
        # telemetry is off); the engine passes its tagged recorder
        self.recorder = recorder if recorder is not None else get_flight_recorder()

    @property
    def prefills(self) -> Tuple[Request, ...]:
        """Every request mid-prefill, in admission order."""
        return tuple(self._prefills)

    @property
    def prefilling(self) -> Optional[Request]:
        """The oldest open prefill (the only one under ``max_prefills=1``)."""
        return self._prefills[0] if self._prefills else None

    def take_prefills(self) -> List[Request]:
        """Detach and return every open prefill (a replica's export: the
        requests replay on a survivor)."""
        out, self._prefills = self._prefills, []
        return out

    def _match_prefix(self, request: Request) -> None:
        """(Re)walk the radix tree for ``request``'s longest cached prefix and
        pin the matched chain.  Pins of an earlier walk are released after
        the new chain is acquired: the old nodes stay resident during the
        walk, so the fresh match is equal or longer."""
        if self.prefix_cache is None or not request.cache_prefix:
            return
        nodes = self.prefix_cache.match(request.prefill_tokens, request.chunks)
        self.prefix_cache.acquire(nodes)
        if request.cache_nodes:
            self.prefix_cache.release(request.cache_nodes)
        request.cache_nodes = list(nodes)
        request.cached_chunks = len(nodes)

    def submit(self, request: Request) -> None:
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            depth = self.queue_depth
            raise AdmissionError(
                f"admission queue full ({len(self.queue)} >= max_queue {self.max_queue})",
                queue_depth=depth, retry_after_s=min(30.0, 0.5 * depth), retriable=True,
            )
        request.chunks = plan_chunks(len(request.prefill_tokens), self.buckets)
        self._match_prefix(request)
        self.queue.append(request)
        self.recorder.record(
            "serve/submit", rid=request.rid, prompt_len=len(request.prompt),
            chunks=len(request.chunks), cached_chunks=request.cached_chunks,
            queue_depth=len(self.queue),
        )

    def requeue(self, request: Request) -> None:
        """Put a preempted RUNNING request back at the FRONT of the queue; it
        replays prompt + generated tokens, re-planned into chunks and
        re-matched against the prefix cache, so the replay aliases what the
        request populated in its first life."""
        request.state = RequestState.QUEUED
        request.slot = None
        request.chunks = plan_chunks(len(request.prefill_tokens), self.buckets)
        request.next_chunk = 0
        request.cached_chunks = 0
        request.cache_chain_broken = False
        self._match_prefix(request)
        self.queue.appendleft(request)
        if request.trace is not None:
            request.trace.annotate(
                "requeue", effective_len=len(request.prefill_tokens),
                cached_chunks=request.cached_chunks,
            )
        self.recorder.record(
            "serve/requeue", rid=request.rid,
            effective_len=len(request.prefill_tokens),
            cached_chunks=request.cached_chunks, queue_depth=len(self.queue),
        )

    def drop_cache_pins(self) -> int:
        """Release every queued request's prefix-cache pins (the engine's
        last-resort page reclaim: pinned nodes block eviction, and a queued
        request matches again at admission).  Returns requests unpinned."""
        dropped = 0
        if self.prefix_cache is None:
            return 0
        for req in self.queue:
            if req.cache_nodes:
                self.prefix_cache.release(req.cache_nodes)
                req.cache_nodes = []
                req.cached_chunks = 0
                dropped += 1
        return dropped

    def cancel(self, rid: int) -> Optional[Request]:
        """Drop a QUEUED request (not yet prefilling) from the queue: it
        becomes ``CANCELLED`` and its prefix-cache pins are released.
        Returns it, or ``None`` when ``rid`` is not queued (prefilling,
        running, done or unknown)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                if self.prefix_cache is not None and req.cache_nodes:
                    self.prefix_cache.release(req.cache_nodes)
                    req.cache_nodes = []
                req.state = RequestState.CANCELLED
                self.recorder.record("serve/cancel", rid=rid)
                return req
        return None

    @property
    def has_queued(self) -> bool:
        return bool(self.queue) or bool(self._prefills)

    @property
    def queue_depth(self) -> int:
        """Requests waiting or mid-prefill."""
        return len(self.queue) + len(self._prefills)

    def begin_step(self, decode_tokens: int = 0) -> int:
        """Fresh prefill-token budget for this engine step: the budget less
        ``decode_tokens``, what the decode window dispatched this cycle
        already charged (the interleaved engine's joint decode + prefill
        bound; never below 0)."""
        self._chunk_this_step = False
        return max(self.budget - int(decode_tokens), 0)

    def start_next(self, slot: int) -> Optional[Request]:
        """Pop the FCFS head into PREFILL state, bound for ``slot``, while
        fewer than ``max_prefills`` are open."""
        if len(self._prefills) >= self.max_prefills or not self.queue:
            return None
        req = self.queue.popleft()
        req.state = RequestState.PREFILL
        req.slot = slot
        # requests admitted since submit may have populated the chunks this
        # one needs (the batch-submit case)
        self._match_prefix(req)
        self._prefills.append(req)
        self.recorder.record(
            "serve/prefill_start", rid=req.rid, slot=slot,
            chunks=len(req.chunks), cached_chunks=req.cached_chunks,
        )
        return req

    @staticmethod
    def _remaining_compute(req: Request) -> int:
        """Tokens still needing a forward pass (cached chunks cost none):
        the reference's shortest-remaining-first key among open prefills."""
        skip = max(req.next_chunk, req.cached_chunks)
        return sum(v for _, v in req.chunks[skip:])

    def take_chunk(self, budget: int, ready: Optional[Callable[[Request], bool]] = None,
                   ) -> Optional[Tuple[Request, int, int, int, bool]]:
        """Next prefill chunk fitting ``budget``: ``(request, bucket_len,
        valid_len, start, cached)`` or None.  Among the open prefills whose
        next chunk fits, the pick is shortest-remaining-first (remaining
        forward-pass tokens), FCFS rid breaking ties.  ``ready`` is an
        optional gate (the paged engine's page check): a request short of
        pages does not block one that fits.  The slab engine passes
        ``None``: its one prefill at a time writes the scratch.  A
        cached chunk (covered by a pinned prefix-cache node) charges nothing
        against the budget.  The first forward-pass chunk since
        :meth:`begin_step` ignores the budget."""
        best, best_key = None, None
        for req in self._prefills:
            if req.next_chunk >= len(req.chunks):
                continue
            bucket, _ = req.chunks[req.next_chunk]
            cached = req.next_chunk < req.cached_chunks
            if not cached and bucket > budget and self._chunk_this_step:
                continue
            if ready is not None and not ready(req):
                continue
            key = (self._remaining_compute(req), req.rid)
            if best_key is None or key < best_key:
                best, best_key = req, key
        if best is None:
            return None
        bucket, valid = best.chunks[best.next_chunk]
        cached = best.next_chunk < best.cached_chunks
        start = sum(v for _, v in best.chunks[:best.next_chunk])
        best.next_chunk += 1
        if not cached:
            self._chunk_this_step = True
        return best, bucket, valid, start, cached

    def finish_prefill(self) -> Optional[Request]:
        """Hand over an open prefill that has run every chunk, for install
        (at most one a call: the engine installs each before the next
        chunk)."""
        for i, req in enumerate(self._prefills):
            if req.next_chunk >= len(req.chunks):
                del self._prefills[i]
                return req
        return None
