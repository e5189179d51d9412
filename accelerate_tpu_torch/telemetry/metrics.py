"""Process-local metrics: counters, gauges, fixed-bucket histograms.

Port of :mod:`accelerate_tpu.telemetry.metrics`.  The registry is the numeric half of the telemetry layer (spans live in
:mod:`.tracer`).  Design constraints, in order:

1. **Hot-path cost ~O(ns)** — instruments sit inside the compiled-step wrapper
   and the serving engine's per-window loop, so an observation is a float
   compare + a ``bisect`` into a tuple, no locks on read, no allocation.
   A disabled registry (``set_enabled(False)`` / ``ATPU_TELEMETRY=0``) turns
   every instrument method into a single boolean check.
2. **No samples stored** — histograms are fixed-bucket (Prometheus-style
   cumulative-on-export): p50/p90/p99 come from linear interpolation inside
   the owning bucket, so memory is O(buckets) regardless of observation count
   and the error is bounded by bucket resolution.
3. **Lazy device reads** — a gauge may be set to a 0-d ``torch.Tensor``;
   it is read with ``.item()`` at *snapshot* time, so instrumenting e.g. the
   per-step grad norm never inserts a device synchronisation into the loop.
   The tensor is read as it is at the snapshot: a caller must not hand a
   gauge a CUDA graph's static output (the next replay overwrites it, and
   ``.item()`` is illegal while a capture is open), only a host value that
   has landed or a tensor that nothing rewrites.

Exports: ``snapshot()`` (plain nested dict), ``export_to_trackers()`` (a flat
scalar dict through any roster of trackers with a ``log(values, step=)``
method), and ``prometheus_text()`` (text exposition format, scrapeable from a
serving process).
"""

from __future__ import annotations

import bisect
import math
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_ENABLED = os.environ.get("ATPU_TELEMETRY", "1").lower() not in ("0", "false", "off")


def set_enabled(enabled: bool) -> None:
    """Globally enable/disable metric recording (spans have their own switch).

    Disabling makes every ``inc``/``set``/``observe`` a no-op boolean check —
    the knob the bench overhead A/B flips.  Already-recorded values persist.
    """
    global _ENABLED
    _ENABLED = bool(enabled)


def enabled() -> bool:
    return _ENABLED


def _coerce(value: Any) -> float:
    """Materialize a numeric observation — this is where a device value pays
    its read, which is why gauges defer it to snapshot time."""
    if isinstance(value, torch.Tensor):
        return float(value.item())
    return float(value)


class Counter:
    """Monotonic (by convention) cumulative count; ``add`` accepts any step."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self._value += amount

    add = inc

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


class Gauge:
    """Last-written value.  May hold a 0-d tensor until snapshot."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value: Any = 0.0

    def set(self, value: Any) -> None:
        if _ENABLED:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self._value = _coerce(self._value) + amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return _coerce(self._value)

    def reset(self) -> None:
        self._value = 0.0


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` bucket upper bounds growing geometrically from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"need start > 0, factor > 1, count >= 1; got {start}, {factor}, {count}"
        )
    return tuple(start * factor**i for i in range(count))


# Default latency buckets: 10 us .. ~524 s in x2 steps (27 buckets) — spans a
# single histogram from kernel-launch to checkpoint-write timescales with
# <= 2x (one-bucket) relative error on any percentile.
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-5, 2.0, 27)


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are upper bounds (ascending); an implicit +Inf bucket catches
    overflow.  ``percentile(q)`` walks the cumulative counts to the owning
    bucket and interpolates linearly inside it (for the +Inf bucket the lower
    edge is returned, and ``max`` caps every answer), so the estimate is exact
    to within one bucket's width — tested against ``numpy.quantile``.
    """

    __slots__ = ("name", "help", "_bounds", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None, help: str = ""):
        self.name = name
        self.help = help
        bounds = tuple(sorted(buckets if buckets is not None else DEFAULT_TIME_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # final slot = +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value``; ``n > 1`` records it ``n`` times in one update
        (the serving emit path lands a whole window/verify batch of identical
        amortized latencies without a per-token Python loop)."""
        if not _ENABLED or n < 1:
            return
        value = float(value)
        self._counts[bisect.bisect_left(self._bounds, value)] += n
        self._count += n
        self._sum += value * n
        if value < self._min:
            self._min = value
        if value > self._max:
            self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    # The internal extrema start at +/-inf so `observe` is branch-light; the
    # public accessors clamp the empty case to 0 (inf poisons JSON exports).
    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Interpolated ``q``-th percentile (``q`` in [0, 100])."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        if self._count == 0:
            return 0.0
        target = q / 100.0 * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            lo = self._bounds[i - 1] if i > 0 else min(self._min, self._bounds[0])
            hi = self._bounds[i] if i < len(self._bounds) else self._max
            lo = max(lo, self._min)
            hi = min(hi, self._max)
            if cum + c >= target:
                frac = (target - cum) / c
                return min(self._max, max(self._min, lo + frac * (hi - lo)))
            cum += c
        return self._max

    @property
    def bounds(self) -> Tuple[float, ...]:
        """Bucket upper bounds (ascending; the implicit +Inf bucket is last
        in :meth:`bucket_counts` but carries no bound here)."""
        return self._bounds

    def bucket_counts(self) -> Tuple[int, ...]:
        """Point-in-time per-bucket counts, ``len(bounds) + 1`` long (final
        slot = +Inf overflow).  NON-cumulative, unlike the Prometheus
        exposition — two snapshots subtract bucket-wise into a *windowed*
        histogram, which is how :class:`~.timeseries.TimeSeriesStore`
        computes a windowed p99 without ever resetting cumulative state."""
        return tuple(self._counts)

    def bucket_snapshot(self) -> Dict[str, Any]:
        """Everything a windowed-delta consumer needs in one immutable grab:
        bounds, per-bucket counts, total count, and sum.  Cumulative state is
        untouched — the Prometheus exposition stays byte-identical."""
        return {
            "bounds": self._bounds,
            "counts": tuple(self._counts),
            "count": self._count,
            "sum": self._sum,
        }

    def snapshot(self) -> Dict[str, float]:
        if self._count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self.mean,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def reset(self) -> None:
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf


def _prom_name(name: str, namespace: str) -> str:
    """Metric names use '/' namespacing internally; Prometheus wants [a-zA-Z0-9_:]."""
    safe = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    return f"{namespace}_{safe}" if namespace else safe


def _fmt(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_help(text: str) -> str:
    """Prometheus exposition: HELP text escapes backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class MetricsRegistry:
    """Named roster of counters/gauges/histograms with get-or-create access.

    One process-wide default instance (``get_registry()``) backs the
    Accelerator, serving engine, data loader, and checkpoint instrumentation;
    construct private registries for isolation in tests.
    """

    def __init__(self, namespace: str = "atpu"):
        self.namespace = namespace
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kwargs):
        metric = self._metrics.get(name)
        if metric is None:
            with self._lock:
                metric = self._metrics.get(name)
                if metric is None:
                    metric = cls(name, **kwargs)
                    self._metrics[name] = metric
        if not isinstance(metric, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(metric).__name__}, "
                f"not {cls.__name__}"
            )
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets, help=help)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterable[Any]:
        return iter(list(self._metrics.values()))

    def get(self, name: str):
        return self._metrics.get(name)

    def items(self) -> List[Tuple[str, Any]]:
        """Stable (name, metric) pairs — the iteration surface the
        time-series sampler walks (a list copy, safe against concurrent
        lazy-family registration)."""
        with self._lock:
            return sorted(self._metrics.items())

    # ------------------------------------------------------------ exporters
    def snapshot(self) -> Dict[str, Any]:
        """Plain nested dict: counters/gauges → float, histograms → stat dict.

        This is the moment deferred gauge values (0-d tensors) are read.
        """
        out: Dict[str, Any] = {}
        for name, metric in sorted(self._metrics.items()):
            if isinstance(metric, Histogram):
                out[name] = metric.snapshot()
            else:
                out[name] = metric.value
        return out

    def flat_snapshot(self) -> Dict[str, float]:
        """Scalar-only flattening (histogram stats suffixed ``/p50`` etc.) —
        the shape a tracker's ``log`` wants."""
        flat: Dict[str, float] = {}
        for name, value in self.snapshot().items():
            if isinstance(value, dict):
                for stat, v in value.items():
                    flat[f"{name}/{stat}"] = v
            else:
                flat[name] = value
        return flat

    def export_to_trackers(self, trackers, step: Optional[int] = None) -> Dict[str, float]:
        """Log the flat snapshot through a roster of trackers (any object
        with a ``log(values, step=)`` method)."""
        flat = self.flat_snapshot()
        for tracker in trackers:
            tracker.log(flat, step=step)
        return flat

    def prometheus_text(self) -> str:
        """Prometheus text exposition (v0.0.4) of the whole registry."""
        ns = self.namespace
        lines: List[str] = []
        for name, metric in sorted(self._metrics.items()):
            pname = _prom_name(name, ns)
            if isinstance(metric, Counter):
                if metric.help:
                    lines.append(f"# HELP {pname}_total {_escape_help(metric.help)}")
                lines.append(f"# TYPE {pname}_total counter")
                lines.append(f"{pname}_total {_fmt(metric.value)}")
            elif isinstance(metric, Gauge):
                if metric.help:
                    lines.append(f"# HELP {pname} {_escape_help(metric.help)}")
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(metric.value)}")
            elif isinstance(metric, Histogram):
                if metric.help:
                    lines.append(f"# HELP {pname} {_escape_help(metric.help)}")
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for bound, c in zip(metric._bounds, metric._counts):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {metric.count}')
                lines.append(f"{pname}_sum {_fmt(metric.sum)}")
                lines.append(f"{pname}_count {metric.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every metric (instrument objects stay registered)."""
        for metric in self._metrics.values():
            metric.reset()

    def clear(self) -> None:
        """Drop every metric (handles held by instrumented code go stale)."""
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every built-in surface records into."""
    return _DEFAULT
