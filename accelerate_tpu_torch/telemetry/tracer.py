"""Span tracing: nested wall-clock spans, Chrome-trace export, device hookup.

Port of :mod:`accelerate_tpu.telemetry.tracer`.

``span("name")`` works as a context manager or decorator and costs two
``perf_counter`` calls plus one small dict append when enabled.  Spans nest
through a per-thread stack, so the recorded events reconstruct the call tree
both in the Chrome trace viewer (Perfetto / ``chrome://tracing`` read the
``traceEvents`` JSON natively) and in :meth:`Tracer.aggregate`, which rolls
them up per name for the bench JSON contract.

While a device profile is active (a caller running ``torch.profiler``
flips :func:`set_device_trace_active`), every span additionally enters a
``torch.profiler.record_function`` range, so the same names appear on the
profiler's timeline beside the card's kernels.  A span never synchronises
the card: it times the host.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

_DEVICE_TRACE_ACTIVE = False


def set_device_trace_active(active: bool) -> None:
    """Flag a live ``torch.profiler`` capture: spans mirror into
    ``record_function`` ranges."""
    global _DEVICE_TRACE_ACTIVE
    _DEVICE_TRACE_ACTIVE = bool(active)


def device_trace_active() -> bool:
    return _DEVICE_TRACE_ACTIVE


class Tracer:
    """Bounded in-memory span recorder.

    ``max_events`` caps the retained Chrome-trace events (FIFO drop, counted in
    ``dropped_events``) so an unbounded training loop cannot grow host memory;
    the per-name aggregate keeps counting regardless.
    """

    def __init__(self, enabled: Optional[bool] = None, max_events: int = 100_000):
        if enabled is None:
            enabled = os.environ.get("ATPU_TELEMETRY", "1").lower() not in ("0", "false", "off")
        self.enabled = enabled
        self.max_events = int(max_events)
        self.dropped_events = 0
        # deque(maxlen=) evicts the oldest event in O(1); the old list-FIFO
        # paid an O(n) ``pop(0)`` under the lock on every span once the ring
        # filled.  Eviction is silent, so the drop counter checks fullness
        # before each append.
        self._events: Deque[Dict[str, Any]] = collections.deque(maxlen=self.max_events)
        self._agg: Dict[str, Dict[str, float]] = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------- recording
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        """Record one wall-clock span; extra kwargs land in the event's args."""
        if not self.enabled:
            yield self
            return
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        annotation = None
        if _DEVICE_TRACE_ACTIVE:
            import torch.profiler

            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            if annotation is not None:
                annotation.__exit__(None, None, None)
            stack.pop()
            event = {
                "name": name,
                "ph": "X",
                "ts": (t0 - self._epoch) * 1e6,  # Chrome trace wants microseconds
                "dur": dt * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
            }
            if args or depth:
                event["args"] = {**args, "depth": depth}
            with self._lock:
                if len(self._events) >= self.max_events:
                    self.dropped_events += 1
                self._events.append(event)
                agg = self._agg.get(name)
                if agg is None:
                    agg = self._agg[name] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
                agg["count"] += 1
                agg["total_s"] += dt
                if dt > agg["max_s"]:
                    agg["max_s"] = dt

    def trace(self, fn=None, *, name: Optional[str] = None):
        """Decorator form: ``@tracer.trace`` or ``@tracer.trace(name="...")``."""
        if fn is None:
            return functools.partial(self.trace, name=name)
        span_name = name or getattr(fn, "__qualname__", getattr(fn, "__name__", "span"))

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with self.span(span_name):
                return fn(*a, **kw)

        return wrapper

    # --------------------------------------------------------------- exports
    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """Per-name rollup ``{name: {count, total_s, mean_s, max_s}}``."""
        with self._lock:
            return {
                name: {**agg, "mean_s": agg["total_s"] / agg["count"]}
                for name, agg in self._agg.items()
            }

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (open in Perfetto / about:tracing)."""
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped_events},
        }

    def dump(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path`` and return it."""
        dirname = os.path.dirname(os.path.abspath(path))
        os.makedirs(dirname, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._agg.clear()
            self.dropped_events = 0
            self._epoch = time.perf_counter()


_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    """Process-wide default tracer (the one built-in surfaces record into)."""
    return _DEFAULT


def span(name: str, **args: Any):
    """``with telemetry.span("phase"): ...`` on the default tracer."""
    return _DEFAULT.span(name, **args)


def trace(fn=None, *, name: Optional[str] = None):
    """Decorator on the default tracer."""
    return _DEFAULT.trace(fn, name=name)
