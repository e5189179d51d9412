"""Declarative SLOs evaluated as multi-window burn rates over the ring store.

Port of :mod:`accelerate_tpu.telemetry.slo` (pure Python, unchanged).

An SLO here is the operator-facing triple (what counts as *good*, what the
*objective* is, which *windows* to judge it over), compiled down to windowed
queries against :class:`~.timeseries.TimeSeriesStore`.  Three kinds cover the
serving surface:

* ``availability`` — good/total (or bad/total) counter pairs; the good
  fraction is the windowed delta ratio;
* ``latency`` — a histogram plus a threshold: the good fraction is the share
  of the window's observations at or under the threshold (windowed bucket
  deltas, so a morning of fast requests cannot hide an afternoon of slow
  ones);
* ``throughput`` — a counter plus a floor: the good fraction is
  ``min(1, windowed_rate / floor)``.

The **burn rate** is ``(1 - good_fraction) / (1 - objective)`` — 1.0 means
the error budget drains exactly at the rate the objective allows, 14.4 means
a 30-day budget is gone in ~2 days.  Each SLO is judged over a FAST and a
SLOW window simultaneously (multi-window multi-burn, the SRE-workbook
shape): the fast window catches the step change, the slow window suppresses
blips, and only both over the threshold counts as *fast-burn*.

Fast-burn has a consequence beyond a gauge: the engine fires its
``on_fast_burn`` hook (by default :func:`~.diagnostics.capture_bundle`) to
freeze the evidence — flight ring, stacks, slowest-K waterfalls, the
time-series window itself — rate-limited to one bundle per SLO per
``cooldown_s``.  Burn rates are also exported as
``serve/slo_burn_rate_<name>`` gauges (the fast window's value) and served
at ``GET /debug/slo``.

Everything is injectable (store, clock, hook) and everything is inert under
``ATPU_TELEMETRY=0``.  ``tick()`` — the only call sites the serving loops
need — is sampling + evaluation gated on the store's cadence, a float
compare when not due.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .metrics import MetricsRegistry, enabled, get_registry
from .timeseries import TimeSeriesStore

KINDS = ("availability", "latency", "throughput")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective.

    ``objective`` is the target good fraction (0.999 = "three nines").
    Kind-specific fields:

    * availability: ``total`` (counter name) plus ``good`` OR ``bad`` (good
      is derived as total - bad when only bad is given);
    * latency: ``hist`` (histogram name) + ``threshold_s``;
    * throughput: ``counter`` + ``floor_per_s``.
    """

    name: str
    kind: str
    objective: float = 0.999
    # availability
    total: Optional[str] = None
    good: Optional[str] = None
    bad: Optional[str] = None
    # latency
    hist: Optional[str] = None
    threshold_s: Optional[float] = None
    # throughput
    counter: Optional[str] = None
    floor_per_s: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"SLO kind must be one of {KINDS}, got {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {self.objective}")
        if self.kind == "availability" and not (
            self.total and (self.good or self.bad)
        ):
            raise ValueError(f"availability SLO {self.name!r} needs total + good|bad")
        if self.kind == "latency" and not (self.hist and self.threshold_s):
            raise ValueError(f"latency SLO {self.name!r} needs hist + threshold_s")
        if self.kind == "throughput" and not (self.counter and self.floor_per_s):
            raise ValueError(f"throughput SLO {self.name!r} needs counter + floor_per_s")


def default_specs(
    ttft_threshold_s: float = 2.0,
    ttft_objective: float = 0.99,
    availability_objective: float = 0.999,
    tokens_floor_per_s: float = 1.0,
) -> List[SloSpec]:
    """The stock serving SLOs over counters the engine already emits:
    admission availability (sheds against submissions), TTFT tail latency,
    and a tokens/s floor."""
    return [
        SloSpec(name="availability", kind="availability",
                objective=availability_objective,
                total="serve/requests_submitted_total",
                bad="serve/deadline_shed_total"),
        SloSpec(name="ttft_p99", kind="latency", objective=ttft_objective,
                hist="serve/ttft_s", threshold_s=ttft_threshold_s),
        SloSpec(name="tokens_floor", kind="throughput", objective=0.99,
                counter="serve/tokens_generated_total",
                floor_per_s=tokens_floor_per_s),
    ]


class SloEngine:
    """Evaluates a roster of :class:`SloSpec` against a ring store.

    ``burn_threshold`` defaults to 14.4 (the SRE-workbook fast-burn page:
    2% of a 30-day budget in one hour).  ``on_fast_burn(slo_name, detail)``
    fires at most once per SLO per ``cooldown_s`` and must return the bundle
    path (or None); when left None the hook resolves lazily to
    :func:`~.diagnostics.capture_bundle` so tests can install a counter.
    """

    def __init__(
        self,
        store: TimeSeriesStore,
        specs: Sequence[SloSpec] = (),
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        burn_threshold: float = 14.4,
        cooldown_s: float = 900.0,
        registry: Optional[MetricsRegistry] = None,
        clock: Optional[Callable[[], float]] = None,
        on_fast_burn: Optional[Callable[[str, Dict[str, Any]], Any]] = None,
    ):
        self.store = store
        self.specs: Dict[str, SloSpec] = {}
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.cooldown_s = float(cooldown_s)
        self.registry = registry if registry is not None else store.registry
        self.clock = clock if clock is not None else store.clock
        self.on_fast_burn = on_fast_burn
        self._gauges: Dict[str, Any] = {}
        self._last_bundle: Dict[str, float] = {}
        self.bundles: List[Any] = []  # paths returned by the hook, newest last
        for spec in specs:
            self.add(spec)

    def add(self, spec: SloSpec) -> None:
        self.specs[spec.name] = spec

    # ----------------------------------------------------------- evaluation
    def _good_fraction(self, spec: SloSpec, window_s: float) -> Optional[float]:
        if spec.kind == "availability":
            total = self.store.delta(spec.total, window_s)
            if not total:  # None or zero traffic: no verdict
                return None
            if spec.good is not None:
                good = self.store.delta(spec.good, window_s) or 0.0
            else:
                good = total - (self.store.delta(spec.bad, window_s) or 0.0)
            return max(0.0, min(1.0, good / total))
        if spec.kind == "latency":
            return self.store.good_fraction(spec.hist, spec.threshold_s, window_s)
        rate = self.store.rate(spec.counter, window_s)
        if rate is None:
            return None
        return max(0.0, min(1.0, rate / spec.floor_per_s))

    def _burn(self, spec: SloSpec, window_s: float) -> Optional[float]:
        gf = self._good_fraction(spec, window_s)
        if gf is None:
            return None
        return (1.0 - gf) / (1.0 - spec.objective)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Burn rates for every SLO over both windows; ``fast_burning`` is
        the multi-window verdict (both windows over threshold).  Windows with
        no data evaluate to burn None and never alert."""
        if now is None:
            now = self.clock()
        out: Dict[str, Dict[str, Any]] = {}
        for name, spec in self.specs.items():
            fast = self._burn(spec, self.fast_window_s)
            slow = self._burn(spec, self.slow_window_s)
            burning = (
                fast is not None and slow is not None
                and fast >= self.burn_threshold and slow >= self.burn_threshold
            )
            out[name] = {
                "kind": spec.kind,
                "objective": spec.objective,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "fast_burn": fast,
                "slow_burn": slow,
                "burn_threshold": self.burn_threshold,
                "fast_burning": burning,
                "last_bundle_age_s": (
                    now - self._last_bundle[name]
                    if name in self._last_bundle else None
                ),
            }
        return out

    def tick(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """The serving-loop entry point: maybe-sample the store, evaluate,
        export gauges, and fire (rate-limited) fast-burn diagnostics.  A
        no-op dict under ``ATPU_TELEMETRY=0``; a single float compare when
        the store's sampling interval has not elapsed."""
        if not enabled():
            return {}
        if now is None:
            now = self.clock()
        if not self.store.maybe_sample(now):
            return {}
        verdicts = self.evaluate(now)
        for name, v in verdicts.items():
            gauge = self._gauges.get(name)
            if gauge is None:
                gauge = self.registry.gauge(f"serve/slo_burn_rate_{name}")
                self._gauges[name] = gauge
            gauge.set(v["fast_burn"] if v["fast_burn"] is not None else 0.0)
            if v["fast_burning"]:
                self._maybe_capture(name, v, now)
        return verdicts

    def any_fast_burning(self) -> bool:
        """Latest verdict without forcing a sample — the opt-in /healthz
        input (cheap enough for a health probe)."""
        if not enabled():
            return False
        return any(v["fast_burning"] for v in self.evaluate().values())

    # ---------------------------------------------------------- diagnostics
    def _maybe_capture(self, name: str, verdict: Dict[str, Any], now: float) -> None:
        last = self._last_bundle.get(name)
        if last is not None and now - last < self.cooldown_s:
            return
        self._last_bundle[name] = now
        hook = self.on_fast_burn
        if hook is None:
            from .diagnostics import capture_bundle
            hook = lambda slo, detail: capture_bundle(  # noqa: E731
                reason=f"slo-fast-burn:{slo}", store=self.store,
                slo_detail=detail, registry=self.registry,
            )
        try:
            path = hook(name, dict(verdict, slo=name))
        except Exception:
            return  # diagnostics must never take down the serving loop
        if path is not None:
            self.bundles.append(path)


# ------------------------------------------------------------ global wiring
_GLOBAL: Optional[SloEngine] = None


def get_slo_engine() -> Optional[SloEngine]:
    """The process-global engine the serving loops tick, or None when SLOs
    were never installed (the common, zero-cost case)."""
    return _GLOBAL


def install_slos(
    specs: Optional[Sequence[SloSpec]] = None,
    store: Optional[TimeSeriesStore] = None,
    registry: Optional[MetricsRegistry] = None,
    **kwargs,
) -> SloEngine:
    """Install the process-global SLO engine (replacing any previous one).

    ``specs`` defaults to :func:`default_specs`; ``store`` defaults to a
    fresh ring over ``registry`` (defaults to the process registry).
    Remaining ``kwargs`` pass to :class:`SloEngine`."""
    global _GLOBAL
    if registry is None:
        registry = get_registry()
    if store is None:
        store = TimeSeriesStore(registry=registry)
    if specs is None:
        specs = default_specs()
    _GLOBAL = SloEngine(store, specs=specs, registry=registry, **kwargs)
    return _GLOBAL


def uninstall_slos() -> None:
    global _GLOBAL
    _GLOBAL = None


def slo_tick(now: Optional[float] = None) -> None:
    """One branch for callers that do not want to hold a reference: tick the
    global engine if installed.  This is the call the serving loops make."""
    eng = _GLOBAL
    if eng is not None:
        eng.tick(now)
