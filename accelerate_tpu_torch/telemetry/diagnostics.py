"""Auto-diagnostic bundles: freeze the evidence while the incident is live.

Port of :mod:`accelerate_tpu.telemetry.diagnostics`.

A fast-burning SLO is precisely the moment the usual forensic surfaces are
about to rot: the flight ring is overwriting the events that explain the
burn, the slowest-K request waterfalls are being evicted by newer traffic,
and the windowed time-series that *shows* the burn only lives in memory.
:func:`capture_bundle` snapshots all of it into one JSON artifact under
``$ATPU_FLIGHT_DIR`` — the same dump machinery the
:class:`~.flight_recorder.StallDetector` uses, extended with:

* the slowest-K request waterfalls (TTFT and total) from the reqtrace
  retention rings — full phase attributions, not summaries;
* the time-series tail covering the offending window, so the bundle contains
  the burn itself, not just the state after it;
* the SLO verdict that pulled the trigger (burn rates, windows, objective);
* optionally a short ``torch.profiler`` CUDA trace when a card is visible
  and ``ATPU_SLO_DEVICE_TRACE`` is set — the only piece that touches the
  device, and it is entirely best-effort (on the CPU there is none).

Rate limiting (one bundle per SLO per cooldown) lives in the caller
(:class:`~.slo.SloEngine`); this module only captures.  Inert under
``ATPU_TELEMETRY=0``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ..logging import get_logger
from .flight_recorder import FLIGHT_DIR_ENV, get_flight_recorder
from .metrics import MetricsRegistry, enabled
from .reqtrace import get_reqtrace
from .timeseries import TimeSeriesStore

logger = get_logger(__name__)

#: Set to 1 to append a short torch.profiler CUDA trace to each bundle (card
#: only; best-effort, adds ~``ATPU_SLO_DEVICE_TRACE_MS`` of wall time).
DEVICE_TRACE_ENV = "ATPU_SLO_DEVICE_TRACE"
DEVICE_TRACE_MS_ENV = "ATPU_SLO_DEVICE_TRACE_MS"


def _slowest_waterfalls(k: int) -> Dict[str, Any]:
    """Full waterfalls for the retained slowest-K traces (both rings)."""
    reg = get_reqtrace()
    out: Dict[str, Any] = {"slowest_ttft": [], "slowest_total": []}
    try:
        with reg._lock:
            ttft = list(reg._slow_ttft)[:k]
            total = list(reg._slow_total)[:k]
        out["slowest_ttft"] = [t.waterfall() for t in ttft]
        out["slowest_total"] = [t.waterfall() for t in total]
    except Exception:
        logger.warning("slo bundle: waterfall capture failed", exc_info=True)
    return out


def _device_trace(directory: str) -> Optional[str]:
    """Best-effort short profiler trace next to the bundle (card only): the
    card's activity over ``ATPU_SLO_DEVICE_TRACE_MS`` as Chrome trace JSON."""
    if os.environ.get(DEVICE_TRACE_ENV, "0").lower() in ("0", "false", "off"):
        return None
    try:
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        if not torch.cuda.is_available():
            return None
        trace_dir = os.path.join(directory, "device-trace")
        os.makedirs(trace_dir, exist_ok=True)
        dur_ms = float(os.environ.get(DEVICE_TRACE_MS_ENV, "50"))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(dur_ms / 1000.0)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        return trace_dir
    except Exception:
        logger.warning("slo bundle: device trace failed", exc_info=True)
        return None


def capture_bundle(
    reason: str,
    store: Optional[TimeSeriesStore] = None,
    slo_detail: Optional[Dict[str, Any]] = None,
    registry: Optional[MetricsRegistry] = None,
    recorder=None,
    slowest_k: int = 8,
    tail_samples: int = 64,
    directory: Optional[str] = None,
) -> Optional[str]:
    """Capture one diagnostic bundle; returns the artifact path (None when
    no ``ATPU_FLIGHT_DIR``/``directory`` is configured or telemetry is off).

    The bundle is a superset of a stall dump: ``reason``, thread stacks, the
    flight-ring tail, a metrics snapshot (all via
    :meth:`FlightRecorder.dump`), plus ``slo`` (the triggering verdict),
    ``timeseries`` (the newest ``tail_samples`` ring samples — the offending
    window), and ``slowest_requests`` (full waterfalls).  Written with the
    ``slo-`` filename prefix so operators can tell burn bundles from
    stall/crash dumps in a shared directory.
    """
    if not enabled():
        return None
    rec = recorder if recorder is not None else get_flight_recorder()
    dump = rec.dump(reason)
    if registry is not None and getattr(rec, "registry", None) is not registry:
        # dump() snapshots rec.registry; honour an explicit override (a
        # private bench/test registry) for the metrics section
        from .flight_recorder import _json_safe

        try:
            dump["metrics"] = _json_safe(registry.snapshot())
        except Exception:
            pass
    dump["kind"] = "slo_bundle"
    if slo_detail is not None:
        dump["slo"] = slo_detail
    if store is not None:
        dump["timeseries"] = store.tail(tail_samples)
    dump["slowest_requests"] = _slowest_waterfalls(slowest_k)
    rec.record("serve/slo_bundle", reason=reason)
    out_dir = directory or os.environ.get(FLIGHT_DIR_ENV)
    if out_dir:
        trace_dir = _device_trace(out_dir)
        if trace_dir:
            dump["device_trace_dir"] = trace_dir
    path = rec.write_artifact(dump, directory=directory, prefix="slo")
    if path:
        logger.warning("SLO diagnostic bundle written to %s (%s)", path, reason)
    return path
