"""Unified telemetry: metrics, spans, watchdog, cost table, flight recorder.

Port of :mod:`accelerate_tpu.telemetry` (same names, same ``__all__``):
observability for the serving hot path, with no dependency beyond torch.

* :mod:`.metrics` — process-local counters/gauges/fixed-bucket histograms;
  snapshot as a plain dict, export through the ``GeneralTracker`` roster, or
  serve as Prometheus text exposition.
* :mod:`.tracer` — nested wall-clock spans (``with span("phase"):``), dumped
  as Chrome trace-event JSON (Perfetto-compatible) and mirrored into
  ``torch.profiler.record_function`` while a device trace is active.
* :mod:`.watchdog` — per-callable ``(shape, dtype, device)`` signature
  accounting with budgets: a program meeting new shapes becomes a logged
  warning and a gauge, not a mystery slowdown.
* :mod:`.cost` — per-executable FLOPs and bytes from the caller's cost
  formulas over the recorded shapes, the card memory a graph capture took,
  and the cards' published peaks.
* :mod:`.flight_recorder` — bounded ring of lifecycle events, a stall
  detector that dumps all-thread stacks when progress heartbeats stop, and
  crash hooks writing JSON artifacts to ``ATPU_FLIGHT_DIR``.
* :mod:`.reqtrace` — per-request latency waterfalls (queue wait, per-chunk
  prefill, drain-attributed decode share, promote/readback waits) that
  survive preemption and cross-replica failover; bounded ring + slowest-K
  retention, served at ``/debug/requests[/<id>]``.
* :mod:`.server` — opt-in stdlib HTTP daemon (``ATPU_METRICS_PORT``)
  serving ``/metrics``, ``/healthz``, ``/debug/flight``, ``/debug/stacks``,
  ``/debug/requests``, ``/debug/slo``.
* :mod:`.timeseries` — bounded ring of registry snapshots sampled on the
  serving loops' existing ticks; windowed counter rates and windowed
  histogram quantiles from bucket deltas, with per-label family rollups.
* :mod:`.slo` — declarative SLOs (availability / latency / throughput)
  judged as multi-window burn rates over the ring store, exported as
  ``serve/slo_burn_rate_<name>`` gauges and ``GET /debug/slo``.
* :mod:`.diagnostics` — burn-triggered bundles: flight ring + stacks +
  slowest-K waterfalls + the offending time-series window, written to
  ``ATPU_FLIGHT_DIR`` (rate-limited by the SLO engine's cooldown).

Everything is on by default and costs nanoseconds per observation;
``ATPU_TELEMETRY=0`` (or :func:`set_enabled` / ``get_tracer().enabled``)
turns the hot-path hooks into single boolean checks and disables the
recorder, detector, and debug server outright.
"""

from .cost import (
    CPU_FALLBACK_PEAKS,
    CostTable,
    DevicePeaks,
    HARDWARE_PEAKS,
    detect_device_peaks,
)
from .diagnostics import capture_bundle
from .flight_recorder import (
    FlightRecorder,
    StallDetector,
    all_thread_stacks,
    get_flight_recorder,
    install_crash_hooks,
)
from .metrics import (
    Counter,
    DEFAULT_TIME_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    enabled,
    exponential_buckets,
    get_registry,
    set_enabled,
)
from .reqtrace import (
    RequestTrace,
    RequestTraceRegistry,
    get_reqtrace,
    tracing_enabled,
)
from .server import (
    DebugServer,
    TelemetryEndpoints,
    get_debug_server,
    resolve_metrics_port,
    start_debug_server,
    stop_debug_server,
)
from .slo import (
    SloEngine,
    SloSpec,
    default_specs,
    get_slo_engine,
    install_slos,
    slo_tick,
    uninstall_slos,
)
from .timeseries import TimeSeriesStore
from .tracer import (
    Tracer,
    device_trace_active,
    get_tracer,
    set_device_trace_active,
    span,
    trace,
)
from .watchdog import RecompileWatchdog, arg_signature, watch_recompiles

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS",
    "exponential_buckets",
    "get_registry",
    "set_enabled",
    "enabled",
    "Tracer",
    "get_tracer",
    "span",
    "trace",
    "set_device_trace_active",
    "device_trace_active",
    "RecompileWatchdog",
    "watch_recompiles",
    "arg_signature",
    "CostTable",
    "DevicePeaks",
    "HARDWARE_PEAKS",
    "CPU_FALLBACK_PEAKS",
    "detect_device_peaks",
    "FlightRecorder",
    "StallDetector",
    "get_flight_recorder",
    "install_crash_hooks",
    "all_thread_stacks",
    "RequestTrace",
    "RequestTraceRegistry",
    "get_reqtrace",
    "tracing_enabled",
    "DebugServer",
    "TelemetryEndpoints",
    "start_debug_server",
    "get_debug_server",
    "stop_debug_server",
    "resolve_metrics_port",
    "TimeSeriesStore",
    "SloSpec",
    "SloEngine",
    "default_specs",
    "install_slos",
    "uninstall_slos",
    "get_slo_engine",
    "slo_tick",
    "capture_bundle",
]
