"""Live debug endpoint: a stdlib HTTP daemon serving metrics + forensics.

Port of :mod:`accelerate_tpu.telemetry.server`: a serving process is
scraped by Prometheus and poked by operators during incidents; a Python
REPL on a serving host is not an observability surface.

Opt-in only — nothing listens unless ``ATPU_METRICS_PORT`` is set or a
surface is constructed with ``ServingEngine(metrics_port=...)``. Port ``0`` binds an ephemeral port
(tests). Endpoints:

- ``GET /metrics`` — Prometheus text exposition of the registry. Registered
  collectors (e.g. :meth:`CostTable.analyze_all`) run first, so scrape-time
  gauges are fresh.
- ``GET /healthz`` — 200 while the flight recorder's last heartbeat is
  younger than ``unhealthy_after_s``, 503 otherwise (or before the first
  heartbeat once one was ever expected). JSON body with the age.
- ``GET /debug/flight`` — ring-tail JSON from the flight recorder
  (``?n=100`` limits the tail).
- ``GET /debug/stacks`` — plain-text stack traces of every live thread.
- ``GET /debug/requests`` — per-request trace index (active + recent +
  retained-slowest; see :mod:`.reqtrace`).
- ``GET /debug/requests/<id>`` — one request's phase waterfall, addressable
  by the ``X-Request-Id`` the API server emits (``cmpl-N`` / bare rid);
  ``?format=chrome`` returns a single-request Chrome-trace JSON instead.
- ``GET /debug/slo`` — burn-rate verdicts for every installed SLO (see
  :mod:`.slo`); ``{"enabled": false}`` when no
  engine is installed.

The server is a ``ThreadingHTTPServer`` on a daemon thread: it dies with the
process and never blocks shutdown. ``ATPU_TELEMETRY=0`` disables it
entirely (:func:`start_debug_server` returns ``None``).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..logging import get_logger
from .flight_recorder import FlightRecorder, all_thread_stacks, get_flight_recorder
from .metrics import MetricsRegistry, enabled, get_registry
from .reqtrace import get_reqtrace

logger = get_logger(__name__)

__all__ = [
    "DebugServer",
    "TelemetryEndpoints",
    "start_debug_server",
    "get_debug_server",
    "stop_debug_server",
    "resolve_metrics_port",
]

#: Environment variable: port for the debug server (0 = ephemeral).
METRICS_PORT_ENV = "ATPU_METRICS_PORT"
#: Environment variable: bind host (default all interfaces — it is a scrape
#: endpoint; set 127.0.0.1 to keep it local).
METRICS_HOST_ENV = "ATPU_METRICS_HOST"

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def resolve_metrics_port(explicit: Optional[int] = None) -> Optional[int]:
    """Explicit argument wins; else ``ATPU_METRICS_PORT``; else ``None``
    (disabled). Note ``0`` is a valid, *enabled* value (ephemeral port)."""
    if explicit is not None:
        return int(explicit)
    raw = os.environ.get(METRICS_PORT_ENV)
    if raw is None or raw.strip() == "":
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring invalid %s=%r", METRICS_PORT_ENV, raw)
        return None


class TelemetryEndpoints:
    """The telemetry HTTP surface as plain callables, decoupled from any
    server: registry + recorder + scrape-time collectors, and the body of
    every route (``/metrics``, ``/healthz``, ``/debug/flight``,
    ``/debug/stacks``).  :class:`DebugServer` binds it to its own daemon
    port; an HTTP front door can mux the SAME routes onto its own port
    instead of running a second server — one process, one telemetry
    surface, whichever port you scrape.

    ``health_extra`` augments the heartbeat check: a callable returning
    ``(healthy, details)`` merged into the ``/healthz`` body — the front
    door passes the router's per-replica aggregation, so a single stuck
    replica flips the endpoint to 503 even while others heartbeat.

    ``slo_healthz`` (opt-in, default off) additionally flips ``/healthz``
    to 503 while any installed SLO is fast-burning — for deployments whose
    load balancer should drain a replica that is torching its error budget.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        recorder: Optional[FlightRecorder] = None,
        unhealthy_after_s: float = 60.0,
        health_extra: Optional[Callable[[], Tuple[bool, Dict[str, Any]]]] = None,
        slo_healthz: bool = False,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.recorder = recorder if recorder is not None else get_flight_recorder()
        self.unhealthy_after_s = float(unhealthy_after_s)
        self.health_extra = health_extra
        self.slo_healthz = bool(slo_healthz)
        self._collectors: List[Callable[[], Any]] = []

    def add_collector(self, fn: Callable[[], Any]) -> None:
        """Register a callable run (best-effort) before each ``/metrics``
        render — used for scrape-time refreshes like lazy cost analysis."""
        if fn not in self._collectors:
            self._collectors.append(fn)

    # -- endpoint bodies (also callable in-process, e.g. from tests) ------

    def render_metrics(self) -> str:
        for collector in list(self._collectors):
            try:
                collector()
            except Exception:
                logger.debug("metrics collector failed", exc_info=True)
        return self.registry.prometheus_text()

    def health(self) -> Tuple[bool, Dict[str, Any]]:
        age = self.recorder.heartbeat_age()
        healthy = age is None or age < self.unhealthy_after_s
        body: Dict[str, Any] = {
            "healthy": healthy,
            "heartbeat_age_s": age,
            "unhealthy_after_s": self.unhealthy_after_s,
            "events_total": self.recorder.events_total,
        }
        if self.health_extra is not None:
            try:
                extra_ok, extra = self.health_extra()
            except Exception:
                logger.warning("health_extra hook failed", exc_info=True)
                extra_ok, extra = False, {"health_extra": "raised"}
            healthy = healthy and extra_ok
            body.update(extra)
            body["healthy"] = healthy
        if self.slo_healthz:
            from .slo import get_slo_engine  # lazy: avoids an import cycle

            engine = get_slo_engine()
            burning = engine is not None and engine.any_fast_burning()
            healthy = healthy and not burning
            body["slo_fast_burning"] = burning
            body["healthy"] = healthy
        return healthy, body

    def flight_tail(self, n: Optional[int] = None) -> Dict[str, Any]:
        return {
            "events": self.recorder.tail(n),
            "events_total": self.recorder.events_total,
            "dropped": self.recorder.dropped,
            "heartbeat_age_s": self.recorder.heartbeat_age(),
        }

    def render_stacks(self) -> str:
        chunks = []
        for name, frames in all_thread_stacks().items():
            chunks.append(f"-- thread {name} --")
            chunks.extend(frames)
            chunks.append("")
        return "\n".join(chunks)

    def handle(self, path: str, query: str = "") -> Tuple[int, str, str]:
        """Route one GET: ``(status, content_type, body)``, or a 404 triple
        for paths outside the telemetry surface.  Exists so embedders (the
        API front door) dispatch with one call instead of re-implementing
        the route table."""
        if path == "/metrics":
            return 200, PROMETHEUS_CONTENT_TYPE, self.render_metrics()
        if path == "/healthz":
            healthy, body = self.health()
            return (200 if healthy else 503, "application/json",
                    json.dumps(body, indent=1))
        if path == "/debug/flight":
            n = None
            q = parse_qs(query)
            if "n" in q:
                try:
                    n = int(q["n"][0])
                except ValueError:
                    pass
            return 200, "application/json", json.dumps(self.flight_tail(n), indent=1)
        if path == "/debug/stacks":
            return 200, "text/plain; charset=utf-8", self.render_stacks()
        if path == "/debug/slo":
            from .slo import get_slo_engine  # lazy: avoids an import cycle

            engine = get_slo_engine()
            if engine is None:
                body: Dict[str, Any] = {"enabled": False, "slos": {}}
            else:
                body = {"enabled": True, "slos": engine.evaluate(),
                        "bundles": list(engine.bundles)}
            return 200, "application/json", json.dumps(body, indent=1)
        if path == "/debug/requests" or path == "/debug/requests/":
            return 200, "application/json", json.dumps(get_reqtrace().index(), indent=1)
        if path.startswith("/debug/requests/"):
            key = path[len("/debug/requests/"):]
            trace = get_reqtrace().lookup(key)
            if trace is None:
                return (404, "application/json",
                        json.dumps({"error": "unknown request id", "id": key}))
            fmt = parse_qs(query).get("format", [""])[0]
            body = trace.chrome_trace() if fmt == "chrome" else trace.waterfall()
            return 200, "application/json", json.dumps(body, indent=1, default=repr)
        return 404, "text/plain; charset=utf-8", "not found\n"


class _Handler(BaseHTTPRequestHandler):
    # Quiet: route access logs through our logger at debug level instead of
    # writing to stderr mid-training.
    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("debug server: " + fmt % args)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        debug: "DebugServer" = self.server.debug_server  # type: ignore[attr-defined]
        parts = urlsplit(self.path)
        try:
            if parts.path == "/":
                self._respond(
                    200,
                    "text/plain; charset=utf-8",
                    "accelerate_tpu_torch debug server\n"
                    "endpoints: /metrics /healthz /debug/flight /debug/stacks "
                    "/debug/requests /debug/requests/<id> /debug/slo\n",
                )
            else:
                code, ctype, body = debug.endpoints.handle(parts.path, parts.query)
                self._respond(code, ctype, body)
        except Exception as exc:  # never take down the scrape thread
            logger.warning("debug server handler failed", exc_info=True)
            try:
                self._respond(500, "text/plain; charset=utf-8", f"error: {exc!r}\n")
            except Exception:
                pass

    def _respond(self, code: int, content_type: str, body: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class DebugServer:
    """Owns the HTTP daemon plus the :class:`TelemetryEndpoints` it exposes."""

    def __init__(
        self,
        port: int,
        host: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        recorder: Optional[FlightRecorder] = None,
        unhealthy_after_s: float = 60.0,
    ):
        self.endpoints = TelemetryEndpoints(
            registry=registry, recorder=recorder,
            unhealthy_after_s=unhealthy_after_s,
        )
        host = host if host is not None else os.environ.get(METRICS_HOST_ENV, "0.0.0.0")
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.debug_server = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="atpu-debug-server",
            daemon=True,
        )
        self._thread.start()

    # endpoint state + bodies delegate to the shared surface so existing
    # callers (tests, engine wiring) keep their one-object view
    @property
    def registry(self) -> MetricsRegistry:
        return self.endpoints.registry

    @property
    def recorder(self) -> FlightRecorder:
        return self.endpoints.recorder

    @property
    def unhealthy_after_s(self) -> float:
        return self.endpoints.unhealthy_after_s

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def url(self) -> str:
        host = self.host if self.host not in ("0.0.0.0", "") else "127.0.0.1"
        return f"http://{host}:{self.port}"

    def add_collector(self, fn: Callable[[], Any]) -> None:
        self.endpoints.add_collector(fn)

    def render_metrics(self) -> str:
        return self.endpoints.render_metrics()

    def health(self) -> Tuple[bool, Dict[str, Any]]:
        return self.endpoints.health()

    def flight_tail(self, n: Optional[int] = None) -> Dict[str, Any]:
        return self.endpoints.flight_tail(n)

    def render_stacks(self) -> str:
        return self.endpoints.render_stacks()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


_DEFAULT: Optional[DebugServer] = None
_DEFAULT_LOCK = threading.Lock()


def start_debug_server(
    port: Optional[int] = None,
    host: Optional[str] = None,
    registry: Optional[MetricsRegistry] = None,
    recorder: Optional[FlightRecorder] = None,
    unhealthy_after_s: float = 60.0,
) -> Optional[DebugServer]:
    """Start (or return) the process-wide debug server.

    Returns ``None`` when no port is configured (neither argument nor
    ``ATPU_METRICS_PORT``) or telemetry is globally disabled. A second call
    returns the existing server — surfaces share one endpoint; a mismatched
    ``registry`` on the second call is ignored with a debug log.
    """
    global _DEFAULT
    if not enabled():
        return None
    resolved = resolve_metrics_port(port)
    if resolved is None:
        return None
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            if registry is not None and registry is not _DEFAULT.registry:
                logger.debug(
                    "debug server already running on %s with a different "
                    "registry; keeping the original",
                    _DEFAULT.url,
                )
            return _DEFAULT
        try:
            _DEFAULT = DebugServer(
                resolved,
                host=host,
                registry=registry,
                recorder=recorder,
                unhealthy_after_s=unhealthy_after_s,
            )
        except OSError as exc:
            logger.warning("debug server failed to bind port %s: %s", resolved, exc)
            return None
        logger.info("debug server listening on %s", _DEFAULT.url)
        return _DEFAULT


def get_debug_server() -> Optional[DebugServer]:
    return _DEFAULT


def stop_debug_server() -> None:
    """Stop and forget the process-wide server (tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _DEFAULT.stop()
            _DEFAULT = None
