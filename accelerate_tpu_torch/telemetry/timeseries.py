"""Bounded in-memory time series over the metrics registry.

Port of :mod:`accelerate_tpu.telemetry.timeseries` (pure Python, unchanged).

The registry (:mod:`.metrics`) is deliberately cumulative: counters only go
up, histogram buckets only fill.  That answers "how much, ever" but not "how
fast, lately" — and SLO burn rates, tenant rollups, and incident bundles are
all questions about *windows*.  :class:`TimeSeriesStore` closes the gap with
the cheapest structure that works: a ``deque``-backed ring of full registry
snapshots taken on the cadence the serving loop already has (the
``serve(metrics_interval=)`` tick / the front door's heartbeat beat), plus
windowed arithmetic over pairs of snapshots:

* ``rate(name, window_s)`` — counter delta / wall delta between the newest
  sample and the newest sample at least ``window_s`` old;
* ``quantile(name, q, window_s)`` — interpolated percentile over the
  *bucket-count deltas* of a histogram (only observations that landed inside
  the window), with cumulative state untouched;
* ``family(prefix, window_s, suffix=...)`` — per-label rollups for the lazily
  created metric families (``serve/tokens_generated_tenant_<tenant>_total``
  and friends): one call returns ``{label: windowed rate}``.

Nothing here starts a thread.  ``maybe_sample()`` is a single float compare
when not due, and everything is a no-op under ``ATPU_TELEMETRY=0`` — the
store is as killable as the metrics it samples.  Capacity is bounded
(``capacity`` samples; the deque evicts the oldest), so memory is
O(capacity x registry size) regardless of uptime.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, enabled, get_registry


class TimeSeriesStore:
    """Ring of timestamped registry snapshots with windowed delta queries.

    ``clock`` is injectable (tests drive a fake clock); it must be monotonic
    for the windowed math to make sense.  ``interval_s`` gates
    :meth:`maybe_sample`; :meth:`sample` always takes one.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        capacity: int = 720,
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 2:
            raise ValueError(f"need capacity >= 2 to form a window, got {capacity}")
        self.registry = registry if registry is not None else get_registry()
        self.capacity = int(capacity)
        self.interval_s = float(interval_s)
        self.clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_sample = -float("inf")

    # ------------------------------------------------------------- sampling
    def __len__(self) -> int:
        return len(self._ring)

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Take a snapshot iff ``interval_s`` has elapsed since the last one.

        The not-due path is one comparison — callers wire this straight into
        per-step loops without their own bookkeeping."""
        if not enabled():
            return False
        if now is None:
            now = self.clock()
        if now - self._last_sample < self.interval_s:
            return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Snapshot every counter/gauge/histogram into the ring (and return
        the sample).  Gauges materialize here — never on the hot path."""
        if now is None:
            now = self.clock()
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for name, metric in self.registry.items():
            if isinstance(metric, Counter):
                counters[name] = metric.value
            elif isinstance(metric, Histogram):
                hists[name] = metric.bucket_snapshot()
            elif isinstance(metric, Gauge):
                try:
                    gauges[name] = metric.value
                except Exception:  # a device array may be unreadable mid-teardown
                    continue
        sample = {"t": float(now), "counters": counters, "gauges": gauges,
                  "hists": hists}
        with self._lock:
            self._ring.append(sample)
            self._last_sample = float(now)
        return sample

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last copy of the last ``n`` samples (all when ``None``) —
        what a diagnostic bundle freezes."""
        with self._lock:
            samples = list(self._ring)
        return samples if n is None else samples[-int(n):]

    # ------------------------------------------------------------- windows
    def window(self, window_s: float, now: Optional[float] = None
               ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """The (old, new) sample pair spanning ``window_s``: new is the
        latest sample, old is the NEWEST sample at least ``window_s`` older
        than it (the tightest pair covering the window).  ``None`` until two
        samples exist; if the ring is younger than the window the oldest
        sample stands in, so early answers cover "since startup"."""
        del now  # the window is anchored on the newest sample, not the clock
        with self._lock:
            if len(self._ring) < 2:
                return None
            newest = self._ring[-1]
            cutoff = newest["t"] - float(window_s)
            old = self._ring[0]
            for s in self._ring:
                if s["t"] > cutoff:
                    break
                old = s
            if old is newest:
                old = self._ring[-2]
            return old, newest

    def delta(self, name: str, window_s: float) -> Optional[float]:
        """Counter increase across the window (None: no data / unknown name)."""
        pair = self.window(window_s)
        if pair is None:
            return None
        old, new = pair
        if name not in new["counters"]:
            return None
        return new["counters"][name] - old["counters"].get(name, 0.0)

    def rate(self, name: str, window_s: float) -> Optional[float]:
        """Windowed per-second rate of a cumulative counter."""
        pair = self.window(window_s)
        if pair is None:
            return None
        old, new = pair
        if name not in new["counters"]:
            return None
        dt = new["t"] - old["t"]
        if dt <= 0:
            return None
        return (new["counters"][name] - old["counters"].get(name, 0.0)) / dt

    def span_s(self, window_s: float) -> Optional[float]:
        """Actual wall span of the pair :meth:`window` would return."""
        pair = self.window(window_s)
        if pair is None:
            return None
        return pair[1]["t"] - pair[0]["t"]

    def hist_delta(self, name: str, window_s: float
                   ) -> Optional[Dict[str, Any]]:
        """Bucket-wise histogram delta across the window: the distribution of
        ONLY the observations that landed inside it."""
        pair = self.window(window_s)
        if pair is None:
            return None
        old, new = pair
        if name not in new["hists"]:
            return None
        h_new = new["hists"][name]
        h_old = old["hists"].get(name)
        if h_old is None or h_old["bounds"] != h_new["bounds"]:
            h_old = {"counts": (0,) * len(h_new["counts"]), "count": 0, "sum": 0.0}
        counts = tuple(
            max(0, a - b) for a, b in zip(h_new["counts"], h_old["counts"])
        )
        return {
            "bounds": h_new["bounds"],
            "counts": counts,
            "count": max(0, h_new["count"] - h_old["count"]),
            "sum": h_new["sum"] - h_old["sum"],
        }

    def quantile(self, name: str, q: float, window_s: float) -> Optional[float]:
        """Interpolated ``q``-th percentile (``q`` in [0, 100]) of a
        histogram's observations WITHIN the window.  Same owning-bucket
        interpolation as :meth:`Histogram.percentile`, minus the min/max
        clamps (extrema are cumulative, not windowed)."""
        d = self.hist_delta(name, window_s)
        if d is None or d["count"] == 0:
            return None
        bounds, counts, total = d["bounds"], d["counts"], d["count"]
        target = q / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return bounds[-1]

    def good_fraction(self, name: str, threshold: float, window_s: float
                      ) -> Optional[float]:
        """Fraction of the window's histogram observations <= ``threshold``
        (linear interpolation inside the bucket the threshold splits) — the
        latency-SLO primitive."""
        d = self.hist_delta(name, window_s)
        if d is None or d["count"] == 0:
            return None
        bounds, counts = d["bounds"], d["counts"]
        good = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else None
            if hi is not None and hi <= threshold:
                good += c
            elif lo < threshold and hi is not None:
                good += c * (threshold - lo) / (hi - lo)
            # +Inf bucket observations never count as good
        return good / d["count"]

    def family(self, prefix: str, window_s: float, suffix: str = ""
               ) -> Dict[str, float]:
        """Windowed rates for every counter matching ``prefix + <label> +
        suffix`` — the rollup view over a lazily created metric family, e.g.
        ``family("serve/tokens_generated_tenant_", 60, suffix="_total")`` →
        ``{"alpha": 123.4, "bravo": 5.6}``."""
        pair = self.window(window_s)
        if pair is None:
            return {}
        old, new = pair
        dt = new["t"] - old["t"]
        if dt <= 0:
            return {}
        out: Dict[str, float] = {}
        for name, value in new["counters"].items():
            if not name.startswith(prefix):
                continue
            label = name[len(prefix):]
            if suffix:
                if not label.endswith(suffix):
                    continue
                label = label[: -len(suffix)]
            if not label:
                continue
            out[label] = (value - old["counters"].get(name, 0.0)) / dt
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_sample = -float("inf")
