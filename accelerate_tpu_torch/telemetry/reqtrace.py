"""Per-request latency waterfalls: phase attribution across the serving stack.

Port of :mod:`accelerate_tpu.telemetry.reqtrace` (pure Python, unchanged).

The flight recorder and span tracer observe the *engine* — ``serve/ttft_s``
is one number per request and ``serve/decode_window`` aggregates over every
lane in the batch — so a p99 TTFT regression cannot be attributed to queue
wait vs. prefill compute vs. a host-tier promote vs. readback stalls.  This
module records a **per-request** phase waterfall instead:

``queue_wait``
    submit → the request's first prefill chunk is taken off the queue.
``prefill``
    one phase per admitted chunk, tagged ``source=`` ``fresh`` (computed),
    ``cached`` (device-tier prefix hit, zero-copy or gather), or
    ``promoted`` (host-tier hit promoted H2D) plus the chunk token count.
``decode`` / ``spec_verify``
    one phase per decode (or speculative verify) window the request's lane
    was live in, amortized over the lanes in that window.  Phases close at
    **drain**, not dispatch — under ``async_depth=1`` a window's cost is
    only known when its readback lands, so attribution is async-depth-aware
    by construction.  The blocking tail of the drain is recorded as a
    ``readback_wait`` *overlay* (see below).
``promote_wait``
    a pending host→device prefix promotion landed for this request.
``failover``
    the request was adopted by a surviving replica after an ejection; the
    same trace object rides along (``export_inflight``/``adopt`` carry it),
    so the waterfall spans replicas instead of restarting.

Phases **tile**: each trace keeps a cursor that starts at submit time and
advances to ``now`` every time a phase closes, so the durations of the tiled
phases sum exactly to the covered wall interval.  That is what makes the
acceptance check "``queue_wait + prefill + decode`` up to the first token
sums to observed TTFT" hold by construction rather than by luck.

Two kinds of entries do **not** advance the cursor (``overlay: true``):

``readback_wait``
    the portion of a decode/verify phase spent blocked in ``fetch()`` —
    attribution *within* the decode share, already counted by it.  Stored
    as the phase's ``wait_s`` attribute on the hot path; the overlay view
    is synthesized at render time (:meth:`RequestTrace._phase_entries`).
``sse_write``
    wall time the HTTP handler thread spent writing SSE frames; it runs
    concurrently with engine phases on another thread.

Memory is bounded by ring + tail-based retention: completed traces are
dropped unless they errored / failed over / were shed, or land in the
slowest-K by TTFT or by total latency.  Retained and recent traces stay
addressable by the ``X-Request-Id`` the API server emits via
``GET /debug/requests/<id>`` (see ``telemetry/server.py``).

``ATPU_TELEMETRY=0`` disables tracing with the rest of telemetry;
:func:`set_enabled` overrides just this module (the ``--trace-ab`` bench
uses it to isolate tracing overhead from the rest of the stack).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from . import metrics as _metrics

_OVERRIDE: Optional[bool] = None

#: phases that advance the tiling cursor, in the order they typically occur
PHASES = (
    "queue_wait", "prefill", "promote_wait", "decode", "spec_verify", "failover",
)
#: overlay entries — attribution inside / alongside a tiled phase
OVERLAYS = ("readback_wait", "sse_write")


def set_enabled(on: Optional[bool]) -> None:
    """Force request tracing on/off; ``None`` restores the telemetry default."""
    global _OVERRIDE
    _OVERRIDE = None if on is None else bool(on)


def tracing_enabled() -> bool:
    if _OVERRIDE is not None:
        return _OVERRIDE
    return _metrics.enabled()


class RequestTrace:
    """One request's waterfall.  Single-writer on the engine driver thread
    (failover hands a request between drivers, never concurrently); the SSE
    accumulators are written by the HTTP handler thread into separate fields,
    so no per-phase lock is needed on the hot path."""

    __slots__ = (
        "tid", "key", "rid", "engine", "replicas", "submit_t", "cursor",
        "queue_done", "first_token_t", "finish_t", "status", "phases",
        "events", "phases_at_first", "dropped_phases", "max_phases",
        "prompt_len", "tokens", "sse_write_s", "sse_writes", "retained",
    )

    def __init__(self, tid: int, rid: int, engine: str, prompt_len: int,
                 submit_t: float, max_phases: int = 512):
        self.tid = tid
        self.key: Optional[str] = None      # front-door-minted id, once known
        self.rid = rid                      # current engine rid (changes on adopt)
        self.engine = engine                # current replica id
        self.replicas: List[str] = [engine]
        self.submit_t = submit_t
        self.cursor = submit_t
        self.queue_done = False
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.status = "active"
        self.phases: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.phases_at_first: Optional[int] = None
        self.dropped_phases = 0
        self.max_phases = max_phases
        self.prompt_len = prompt_len
        self.tokens = 0
        self.sse_write_s = 0.0
        self.sse_writes = 0
        self.retained = 0       # ring-membership refcount (registry-managed)

    # ------------------------------------------------------------- recording
    def phase(self, name: str, now: Optional[float] = None, **attrs: Any) -> float:
        """Close a tiled phase: duration is ``now - cursor``; cursor advances.

        Past ``max_phases`` consecutive same-name phases coalesce (a very
        long decode compresses naturally) so a single request cannot grow
        host memory unboundedly.
        """
        if now is None:
            now = time.perf_counter()
        dur = max(now - self.cursor, 0.0)
        self.cursor = now
        if len(self.phases) >= self.max_phases:
            last = self.phases[-1]
            if last.get("phase") == name and not last.get("overlay"):
                last["dur_s"] += dur
                last["coalesced"] = last.get("coalesced", 1) + 1
                self.dropped_phases += 1
                return dur
            self.dropped_phases += 1
            return dur
        self.phases.append(
            {"phase": name, "t0_s": max(now - dur - self.submit_t, 0.0),
             "dur_s": dur, **attrs})
        return dur

    def overlay(self, name: str, t0_abs: float, dur: float, **attrs: Any) -> None:
        """Record a non-tiling entry (does not advance the cursor)."""
        if len(self.phases) >= self.max_phases:
            self.dropped_phases += 1
            return
        entry = {"phase": name, "t0_s": max(t0_abs - self.submit_t, 0.0),
                 "dur_s": max(dur, 0.0), "overlay": True}
        if attrs:
            entry.update(attrs)
        self.phases.append(entry)

    def annotate(self, event: str, **attrs: Any) -> None:
        """Lifecycle annotation (preempt, requeue, shed, export, …)."""
        if len(self.events) < 256:
            entry = {"event": event,
                     "t_s": max(time.perf_counter() - self.submit_t, 0.0),
                     "engine": self.engine}
            if attrs:
                entry.update(attrs)
            self.events.append(entry)

    def add_sse_write(self, dur: float) -> None:
        self.sse_write_s += max(dur, 0.0)
        self.sse_writes += 1

    def mark_first_token(self, now: float) -> None:
        if self.first_token_t is None:
            self.first_token_t = now
            self.phases_at_first = len(self.phases)

    def note_engine(self, engine: str, rid: int) -> None:
        self.engine = engine
        self.rid = rid
        if engine not in self.replicas:
            self.replicas.append(engine)

    # --------------------------------------------------------------- derived
    @property
    def finished(self) -> bool:
        return self.finish_t is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def total_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def ttft_attributed_s(self) -> Optional[float]:
        """Sum of tiled phases closed before the first token was emitted —
        the ``queue_wait + prefill + decode`` decomposition of TTFT."""
        if self.phases_at_first is None:
            return None
        return sum(p["dur_s"] for p in self.phases[: self.phases_at_first]
                   if not p.get("overlay"))

    @property
    def flagged(self) -> bool:
        """Unconditionally retained: error/shed outcomes or a failover path."""
        return (self.status in ("error", "shed", "cancelled")
                or len(self.replicas) > 1)

    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for p in self._phase_entries():
            agg = out.setdefault(p["phase"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1 + p.get("coalesced", 1) - 1
            agg["total_s"] += p["dur_s"]
        if self.sse_writes:
            out["sse_write"] = {"count": self.sse_writes,
                                "total_s": self.sse_write_s}
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "id": self.key if self.key is not None else str(self.rid),
            "tid": self.tid,
            "rid": self.rid,
            "engine": self.engine,
            "replicas": list(self.replicas),
            "status": self.status,
            "prompt_len": self.prompt_len,
            "tokens": self.tokens,
            "ttft_s": self.ttft_s,
            "total_s": self.total_s,
            "phases": len(self.phases),
            "failover": len(self.replicas) > 1,
        }

    def _phase_entries(self) -> List[Dict[str, Any]]:
        """Recorded phases plus render-time ``readback_wait`` overlays.

        The drain hot path stores the blocked-fetch tail as a ``wait_s``
        attribute on the decode/verify phase it belongs to rather than
        allocating a second entry per lane per window; the overlay view is
        synthesized here, where only debug-endpoint readers pay for it."""
        out: List[Dict[str, Any]] = []
        for p in self.phases:
            out.append(dict(p))
            if p["phase"] in ("decode", "spec_verify"):
                wait = p.get("wait_s", 0.0)
                if wait > 0.0:
                    out.append({
                        "phase": "readback_wait",
                        "t0_s": max(p["t0_s"] + p["dur_s"] - wait, 0.0),
                        "dur_s": wait, "overlay": True,
                    })
        return out

    def waterfall(self) -> Dict[str, Any]:
        """The JSON body of ``GET /debug/requests/<id>``."""
        out = self.summary()
        out["ttft_attributed_s"] = self.ttft_attributed_s
        out["phase_list"] = self._phase_entries()
        out["phase_totals"] = self.phase_totals()
        out["events"] = [dict(e) for e in self.events]
        out["dropped_phases"] = self.dropped_phases
        out["sse_write_s"] = self.sse_write_s
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """Single-request Chrome trace (open in Perfetto / about:tracing).

        Tiled phases land on track 1, overlays on track 2, annotations as
        instant events on track 3 — all relative to submit time.
        """
        events: List[Dict[str, Any]] = []
        for p in self._phase_entries():
            args = {k: v for k, v in p.items()
                    if k not in ("phase", "t0_s", "dur_s", "overlay")}
            events.append({
                "name": p["phase"], "ph": "X",
                "ts": p["t0_s"] * 1e6, "dur": p["dur_s"] * 1e6,
                "pid": 1, "tid": 2 if p.get("overlay") else 1,
                "args": args,
            })
        for e in self.events:
            args = {k: v for k, v in e.items() if k not in ("event", "t_s")}
            events.append({"name": e["event"], "ph": "i", "s": "t",
                           "ts": e["t_s"] * 1e6, "pid": 1, "tid": 3,
                           "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": self.summary()}


class RequestTraceRegistry:
    """Process-wide trace index with bounded, tail-biased retention.

    Active traces are capped at ``max_active`` (oldest evicted).  On
    completion a trace enters the ``recent`` ring and stays addressable
    until it falls out — unless it is *flagged* (error / shed / cancelled /
    failover) or lands in the slowest-K by TTFT or total latency, in which
    case it is retained until displaced by a slower/newer flagged one.
    """

    def __init__(self, recent: int = 64, flagged: int = 64,
                 slowest_k: int = 16, max_active: int = 4096):
        self._lock = threading.Lock()
        self._next_tid = 0
        self.slowest_k = slowest_k
        self.max_active = max_active
        self._active: "collections.OrderedDict[int, RequestTrace]" = collections.OrderedDict()
        self._by_key: Dict[str, RequestTrace] = {}
        self._by_rid: Dict[str, RequestTrace] = {}
        self._recent: Deque[RequestTrace] = collections.deque(maxlen=recent)
        self._flagged: Deque[RequestTrace] = collections.deque(maxlen=flagged)
        self._slow_ttft: List[RequestTrace] = []
        self._slow_total: List[RequestTrace] = []
        self.traces_started = 0
        self.traces_completed = 0
        self.traces_dropped = 0

    # -------------------------------------------------------------- lifecycle
    def begin(self, rid: int, engine: str, prompt_len: int,
              submit_t: Optional[float] = None) -> Optional[RequestTrace]:
        """Open a trace for a freshly submitted request; ``None`` when off."""
        if not tracing_enabled():
            return None
        if submit_t is None:
            submit_t = time.perf_counter()
        with self._lock:
            self._next_tid += 1
            tr = RequestTrace(self._next_tid, rid, engine, prompt_len, submit_t)
            self._active[tr.tid] = tr
            self._index_rid(tr)
            self.traces_started += 1
            if len(self._active) > self.max_active:
                _, evicted = self._active.popitem(last=False)
                evicted.status = "evicted"
                self._unindex(evicted)
                self.traces_dropped += 1
        return tr

    def rekey(self, trace: Optional[RequestTrace], key: str) -> None:
        """Bind the front-door-minted id; it becomes the authoritative key."""
        if trace is None:
            return
        with self._lock:
            trace.key = str(key)
            self._by_key[trace.key] = trace

    def rebind(self, trace: Optional[RequestTrace], engine: str, rid: int) -> None:
        """Re-index after failover adoption gave the request a new rid."""
        if trace is None:
            return
        with self._lock:
            trace.note_engine(engine, rid)
            self._index_rid(trace)

    def complete(self, trace: Optional[RequestTrace], status: str = "done") -> None:
        if trace is None or trace.finished:
            return
        now = time.perf_counter()
        trace.finish_t = now
        trace.status = status
        with self._lock:
            self._active.pop(trace.tid, None)
            self.traces_completed += 1
            evicted: List[RequestTrace] = []
            if len(self._recent) == self._recent.maxlen:
                evicted.append(self._recent[0])
            self._recent.append(trace)
            trace.retained += 1
            if trace.flagged:
                if len(self._flagged) == self._flagged.maxlen:
                    evicted.append(self._flagged[0])
                self._flagged.append(trace)
                trace.retained += 1
            evicted += self._offer_slowest(self._slow_ttft, trace, trace.ttft_s)
            evicted += self._offer_slowest(self._slow_total, trace, trace.total_s)
            for old in evicted:
                old.retained -= 1
                if not self._is_retained(old):
                    self._unindex(old)
                    self.traces_dropped += 1

    # -------------------------------------------------------------- indexing
    def _index_rid(self, tr: RequestTrace) -> None:
        self._by_rid[f"{tr.engine}:{tr.rid}"] = tr
        # bare-rid fallback for in-process use (last writer wins; the
        # front-door key is the authoritative cross-replica handle)
        self._by_rid[str(tr.rid)] = tr

    def _unindex(self, tr: RequestTrace) -> None:
        if tr.key is not None and self._by_key.get(tr.key) is tr:
            del self._by_key[tr.key]
        for eng in tr.replicas:
            k = f"{eng}:{tr.rid}"
            if self._by_rid.get(k) is tr:
                del self._by_rid[k]
        if self._by_rid.get(str(tr.rid)) is tr:
            del self._by_rid[str(tr.rid)]

    def _offer_slowest(self, heap: List[RequestTrace], tr: RequestTrace,
                       val: Optional[float]) -> List[RequestTrace]:
        """Keep the K slowest; return whoever fell off."""
        if val is None:
            return []
        attr = "total_s" if heap is self._slow_total else "ttft_s"
        # steady-state fast path: a full ring whose floor the newcomer
        # cannot beat costs one comparison, not a sort (heap is kept
        # sorted descending, so the floor is the last element)
        if len(heap) >= self.slowest_k and val <= (getattr(heap[-1], attr) or 0.0):
            return []
        heap.append(tr)
        tr.retained += 1
        heap.sort(key=lambda t: getattr(t, attr) or 0.0, reverse=True)
        if len(heap) > self.slowest_k:
            return [heap.pop()]
        return []

    def _is_retained(self, tr: RequestTrace) -> bool:
        # ring membership is refcounted at insert/evict time so a
        # steady-state eviction costs two dict/int checks, not identity
        # scans across every ring
        return tr.retained > 0 or tr.tid in self._active

    # --------------------------------------------------------------- queries
    @staticmethod
    def _normalize(key: str) -> str:
        for prefix in ("chatcmpl-", "cmpl-"):
            if key.startswith(prefix):
                return key[len(prefix):]
        return key

    def lookup(self, key: str) -> Optional[RequestTrace]:
        """Resolve an ``X-Request-Id`` (``cmpl-N`` / ``chatcmpl-N`` / bare),
        a front-door key, or an engine rid (optionally ``<engine>:<rid>``)."""
        key = str(key)
        with self._lock:
            for k in (key, self._normalize(key)):
                tr = self._by_key.get(k)
                if tr is not None:
                    return tr
            for k in (key, self._normalize(key)):
                tr = self._by_rid.get(k)
                if tr is not None:
                    return tr
        return None

    def index(self) -> Dict[str, Any]:
        """The ``GET /debug/requests`` body: active + recent + retained."""
        with self._lock:
            return {
                "enabled": tracing_enabled(),
                "counts": {
                    "started": self.traces_started,
                    "completed": self.traces_completed,
                    "dropped": self.traces_dropped,
                    "active": len(self._active),
                },
                "active": [t.summary() for t in self._active.values()],
                "recent": [t.summary() for t in self._recent],
                "flagged": [t.summary() for t in self._flagged],
                "slowest_ttft": [t.summary() for t in self._slow_ttft],
                "slowest_total": [t.summary() for t in self._slow_total],
            }

    def summary(self, engine_id: Optional[str] = None) -> Dict[str, Any]:
        """Compact rollup for ``ServingEngine.stats()["requests"]``."""
        with self._lock:
            traces = list(self._active.values()) + list(self._recent)
            if engine_id is not None:
                traces = [t for t in traces if engine_id in t.replicas]
            done = [t for t in traces if t.finished and t.ttft_s is not None]
            out: Dict[str, Any] = {
                "active": sum(1 for t in traces if not t.finished),
                "completed": self.traces_completed,
                "retained_slowest": len(self._slow_ttft) + len(self._slow_total),
                "failovers": sum(1 for t in traces if len(t.replicas) > 1),
            }
            if done:
                ttfts = sorted(t.ttft_s for t in done)
                out["recent_ttft_p50_s"] = ttfts[len(ttfts) // 2]
                out["recent_ttft_max_s"] = ttfts[-1]
            return out

    def reset(self) -> None:
        """Drop every trace and index (bench/test isolation)."""
        with self._lock:
            self._active.clear()
            self._by_key.clear()
            self._by_rid.clear()
            self._recent.clear()
            self._flagged.clear()
            del self._slow_ttft[:]
            del self._slow_total[:]
            self.traces_started = 0
            self.traces_completed = 0
            self.traces_dropped = 0


_DEFAULT = RequestTraceRegistry()


def get_reqtrace() -> RequestTraceRegistry:
    """Process-wide registry (engines, front door, and debug server share it)."""
    return _DEFAULT
