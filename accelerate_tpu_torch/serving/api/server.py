"""The HTTP edge: OpenAI-style routes on a stdlib ``ThreadingHTTPServer``.

Port of :mod:`accelerate_tpu.serving.api.server`.

Routes (all JSON unless noted):

- ``POST /v1/completions`` / ``POST /v1/chat/completions`` — generate;
  ``"stream": true`` switches the response to SSE (``text/event-stream``,
  OpenAI chunk objects, ``data: [DONE]`` terminator).
- ``GET /v1/models`` — the served model plus one entry per live weights
  version (the A/B surface; pin with ``"model": "<name>@<version>"``).
- ``DELETE /v1/requests/<id>`` — cancel by response id (``cmpl-…`` /
  ``chatcmpl-…`` / bare rid), queued or running.
- ``GET /metrics`` | ``/healthz`` | ``/debug/flight`` | ``/debug/stacks`` |
  ``/debug/requests[/<id>]`` | ``/debug/slo`` — the telemetry surface,
  muxed onto this port through the shared
  :class:`~accelerate_tpu_torch.telemetry.server.TelemetryEndpoints` (one process,
  one scrape target).  ``/healthz`` additionally aggregates per-replica
  router health: any stuck replica flips it to 503 (and, with
  ``slo_healthz=True``, so does any fast-burning SLO).

Tenant attribution: generation requests are attributed to a tenant taken
from the ``X-Tenant`` header, falling back to the API-key prefix of an
``Authorization: Bearer <tenant>-...`` token.  The resolved tenant rides
:class:`CompletionCall` into the engine (per-tenant metric families) and is
echoed back as ``X-Tenant`` on every response that carries
``X-Request-Id``, so callers can verify which bucket they billed.

Status mapping: malformed body → 400 (``invalid_request_error``); unknown
model → 404; queue-full backpressure (retriable
:class:`~accelerate_tpu_torch.serving.errors.AdmissionError`) → 429 with a
``Retry-After`` header; capacity refusals → 400; stale heartbeat → 503 on
``/healthz``.  A client that disconnects mid-stream gets its request
cancelled (running lanes included) so its slot and KV pages free
immediately.

Every handler thread crosses into the engine only through the
:class:`~accelerate_tpu_torch.serving.api.frontdoor.FrontDoor` ticket API,
and makes no call on the card.
"""

from __future__ import annotations

import json
import os
import random
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

from ...logging import get_logger
from ...telemetry import (
    MetricsRegistry,
    TelemetryEndpoints,
    get_registry,
    get_reqtrace,
)
from .. import faults
from ..errors import AdmissionError, DeadlineExceeded
from .frontdoor import FrontDoor
from .protocol import (
    SSE_DONE,
    ChatTemplate,
    CompletionCall,
    ValidationError,
    completion_chunk,
    completion_response,
    error_body,
    parse_chat_request,
    parse_completion_request,
    sse_frame,
)

logger = get_logger(__name__)

__all__ = ["ApiServer"]

#: Max accepted request body (token-id prompts are compact; 8 MiB is ample).
MAX_BODY_BYTES = 8 << 20

#: Tenant labels become metric-name segments (``serve/*_tenant_<t>_total``),
#: so the charset is the metric-name charset — anything else is dropped
#: rather than half-sanitized into a colliding label.
_TENANT_RE = re.compile(r"[A-Za-z0-9_]{1,64}")


def _tenant_from_headers(headers) -> Optional[str]:
    """Resolve the tenant for one request from gateway-controlled headers.

    ``X-Tenant`` wins; otherwise the prefix of an
    ``Authorization: Bearer <tenant>-<secret>`` API key is used (the common
    key-minting convention).  Returns ``None`` — unattributed — when neither
    yields a well-formed label; never raises.
    """
    raw = headers.get("X-Tenant")
    if raw and _TENANT_RE.fullmatch(raw.strip()):
        return raw.strip().lower()
    auth = headers.get("Authorization") or ""
    if auth.startswith("Bearer "):
        prefix = auth[len("Bearer "):].strip().split("-", 1)[0]
        if prefix and _TENANT_RE.fullmatch(prefix):
            return prefix.lower()
    return None


def _retry_after(seconds: float) -> str:
    """``Retry-After`` header value with +-25% jitter: a flood refused in the
    same instant must not retry in the same instant — synchronized retries
    would re-flood admission exactly one hint later."""
    return str(max(1, int(seconds * (0.75 + 0.5 * random.random()) + 0.5)))


def _request_id(call: CompletionCall, rid: int) -> str:
    return f"{'chatcmpl' if call.chat else 'cmpl'}-{rid}"


def _parse_request_id(raw: str) -> Optional[int]:
    for prefix in ("chatcmpl-", "cmpl-"):
        if raw.startswith(prefix):
            raw = raw[len(prefix):]
            break
    try:
        return int(raw)
    except ValueError:
        return None


class _ApiHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("api server: " + fmt % args)

    @property
    def api(self) -> "ApiServer":
        return self.server.api_server  # type: ignore[attr-defined]

    # ----------------------------------------------------------- plumbing
    def _send(self, code: int, body: Dict[str, Any],
              extra_headers: Optional[Dict[str, str]] = None) -> None:
        payload = json.dumps(body, indent=1).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _send_text(self, code: int, content_type: str, text: str) -> None:
        payload = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _read_body(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ValidationError("request body is required")
        if length > MAX_BODY_BYTES:
            raise ValidationError(f"request body exceeds {MAX_BODY_BYTES} bytes")
        raw = self.rfile.read(length)
        try:
            return json.loads(raw)
        except (ValueError, UnicodeDecodeError) as exc:
            raise ValidationError(f"body is not valid JSON: {exc}") from exc

    # ------------------------------------------------------------- routes
    def do_GET(self) -> None:  # noqa: N802 - http.server API
        api = self.api
        api.http_requests.inc()
        parts = urlsplit(self.path)
        try:
            if parts.path == "/v1/models":
                self._send(200, api.models_body())
            elif parts.path == "/":
                self._send_text(
                    200, "text/plain; charset=utf-8",
                    "accelerate_tpu serving front door\n"
                    "endpoints: /v1/completions /v1/chat/completions "
                    "/v1/models /metrics /healthz /debug/flight "
                    "/debug/stacks /debug/requests /debug/slo\n",
                )
            else:
                code, ctype, body = api.endpoints.handle(parts.path, parts.query)
                self._send_text(code, ctype, body)
        except Exception as exc:
            self._safe_error(exc)

    def do_DELETE(self) -> None:  # noqa: N802 - http.server API
        api = self.api
        api.http_requests.inc()
        parts = urlsplit(self.path)
        try:
            prefix = "/v1/requests/"
            if not parts.path.startswith(prefix):
                self._send(404, error_body("not found", "invalid_request_error"))
                return
            rid = _parse_request_id(parts.path[len(prefix):])
            if rid is None:
                self._send(400, error_body(
                    "request id must be cmpl-<n>, chatcmpl-<n>, or an integer",
                    "invalid_request_error",
                ))
                return
            cancelled = api.frontdoor.cancel(rid)
            self._send(200 if cancelled else 404, {
                "id": f"cmpl-{rid}",
                "object": "request.cancellation",
                "cancelled": cancelled,
            })
        except Exception as exc:
            self._safe_error(exc)

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        api = self.api
        api.http_requests.inc()
        api.http_inflight.inc()
        parts = urlsplit(self.path)
        try:
            if parts.path == "/v1/completions":
                call = parse_completion_request(self._read_body(),
                                                encode=api.encode)
            elif parts.path == "/v1/chat/completions":
                call = parse_chat_request(self._read_body(),
                                          template=api.chat_template,
                                          encode=api.encode)
            else:
                self._send(404, error_body("not found", "invalid_request_error"))
                return
            # attribution comes from headers, never the JSON body: the body
            # is caller-controlled, the headers are gateway-controlled
            call.tenant = _tenant_from_headers(self.headers)
            self._generate(call)
        except ValidationError as exc:
            self._send(400, error_body(str(exc), "invalid_request_error",
                                       param=exc.param))
        except AdmissionError as exc:
            self._admission_refused(exc)
        except TimeoutError as exc:
            # the driver didn't pick up the ticket in time: the engine is
            # wedged or saturated, but the condition is transient — tell the
            # client to come back, not that the server is broken
            self._send(503, error_body(
                str(exc), "service_unavailable", code="driver_busy",
            ), extra_headers={"Retry-After": _retry_after(5.0)})
        except Exception as exc:
            self._safe_error(exc)
        finally:
            api.http_inflight.dec()

    # ---------------------------------------------------------- generation
    def _admission_refused(self, exc: AdmissionError) -> None:
        api = self.api
        if exc.retriable:
            api.http_429.inc()
            headers = {}
            if exc.retry_after_s is not None:
                headers["Retry-After"] = _retry_after(exc.retry_after_s)
            self._send(429, error_body(
                str(exc), "rate_limit_error", code="engine_overloaded",
            ), extra_headers=headers)
        elif "not found" in str(exc):
            self._send(404, error_body(str(exc), "invalid_request_error",
                                       code="model_not_found", param="model"))
        else:
            self._send(400, error_body(str(exc), "invalid_request_error",
                                       code="capacity_exceeded"))

    def _generate(self, call: CompletionCall) -> None:
        api = self.api
        version = api.frontdoor.resolve_model(call.model)
        req, stream = api.frontdoor.submit(call, model_version=version)
        # address the request by the front door's id, not req.rid: engine
        # rids are per-replica and rewritten on failover adoption
        request_id = _request_id(call, stream.rid)
        created = int(time.time())
        model = call.model or api.frontdoor.model_name
        if call.stream:
            self._stream_response(call, stream.rid, stream, request_id,
                                  created, model)
            return
        if not stream.wait_done(api.request_timeout_s):
            api.frontdoor.cancel(stream.rid)
            self._send(504, error_body(
                f"generation exceeded {api.request_timeout_s}s",
                "timeout_error",
            ))
            return
        if isinstance(stream.error, DeadlineExceeded):
            self._send(504, error_body(
                str(stream.error), "timeout_error", code="deadline_exceeded",
            ))
            return
        if stream.error is not None:
            self._send(500, error_body(
                f"generation failed: {stream.error!r}", "internal_error",
            ))
            return
        headers = {"X-Request-Id": request_id}
        if call.tenant is not None:
            headers["X-Tenant"] = call.tenant
        self._send(200, completion_response(
            call, request_id, created, model, stream.final_tokens,
            eos_token_id=call.stop_token_id,
            cancelled=stream.final_state is not None
            and stream.final_state.name == "CANCELLED",
            decode=api.decode,
        ), extra_headers=headers)

    def _stream_response(self, call: CompletionCall, rid: int, stream,
                         request_id: str, created: int, model: str) -> None:
        api = self.api
        api.sse_streams.inc()
        # SSE: no Content-Length — the body ends when the connection closes
        # (Connection: close keeps that well-formed under HTTP/1.1)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream; charset=utf-8")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Request-Id", request_id)
        if call.tenant is not None:
            self.send_header("X-Tenant", call.tenant)
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        first = True
        # per-request waterfall: accumulate this handler thread's SSE write
        # time into the trace (an overlay — it runs concurrently with engine
        # phases on another thread, so it never enters the TTFT tiling)
        trace = get_reqtrace().lookup(str(rid))
        sse_t0 = time.perf_counter()
        try:
            while True:
                try:
                    token = stream.get(timeout=api.request_timeout_s)
                except Exception:
                    api.frontdoor.cancel(rid)
                    return
                if token is None:
                    break
                if (faults.ACTIVE is not None
                        and faults.ACTIVE.fire("handler_disconnect")):
                    # stand-in for the client's socket dying mid-stream: the
                    # except below must cancel the lane and free its pages
                    raise BrokenPipeError("injected SSE client disconnect")
                w0 = time.perf_counter()
                self.wfile.write(sse_frame(completion_chunk(
                    call, request_id, created, model, token, first,
                    decode=api.decode,
                )).encode("utf-8"))
                self.wfile.flush()
                if trace is not None:
                    trace.add_sse_write(time.perf_counter() - w0)
                first = False
            cancelled = (stream.final_state is not None
                         and stream.final_state.name == "CANCELLED")
            if stream.error is not None:
                # headers are long gone — an explicit error chunk is the only
                # honest way to end a broken SSE stream
                reason = "error"
            else:
                reason = ("cancelled" if cancelled else "stop"
                          if (call.stop_token_id is not None
                              and stream.final_tokens
                              and stream.final_tokens[-1] == call.stop_token_id)
                          else "length")
            self.wfile.write(sse_frame(completion_chunk(
                call, request_id, created, model, None, first,
                finish_reason=reason, decode=api.decode,
            )).encode("utf-8"))
            self.wfile.write(SSE_DONE.encode("utf-8"))
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-stream: free its lane and KV now
            api.frontdoor.cancel(rid)
        finally:
            if trace is not None and trace.sse_writes:
                trace.overlay("sse_write", sse_t0, trace.sse_write_s,
                              writes=trace.sse_writes)
            api.sse_streams.dec()

    def _safe_error(self, exc: Exception) -> None:
        logger.warning("api handler failed", exc_info=True)
        try:
            self._send(500, error_body(f"internal error: {exc!r}",
                                       "internal_error"))
        except Exception:  # noqa: swallowed-exception (client socket is gone)
            pass


class _HttpServer(ThreadingHTTPServer):
    """Handler threads are daemons, and the accept backlog is sized for
    bursts: the stdlib default (5) turns a flood into TCP connection resets
    before admission control can answer 429."""

    daemon_threads = True
    request_queue_size = 128


class ApiServer:
    """Binds the front door + telemetry surface to one HTTP port.

    Parameters
    ----------
    frontdoor: a started :class:`FrontDoor` (this server never steps
        engines itself).
    host/port: bind address; port ``0`` picks an ephemeral port (tests).
        Default host comes from ``ATPU_API_HOST`` (fallback 127.0.0.1 — the
        generation API is not a scrape endpoint; expose it deliberately).
    registry: metrics registry for the HTTP counters (default: the process
        registry, i.e. the same one the engines publish to — one
        ``/metrics`` page tells the whole story).
    encode/decode: optional tokenizer hooks (``str -> ids`` and
        ``ids -> str``).  Without them the API is token-id native.
    chat_template: token-id chat template for ``/v1/chat/completions``.
    unhealthy_after_s: heartbeat staleness threshold for ``/healthz``.
    request_timeout_s: server-side cap on one generation (504 + cancel).
    slo_healthz: opt-in — flip ``/healthz`` to 503 while any installed SLO
        is fast-burning (both burn windows over threshold).  Off by default
        because a load balancer draining a replica for an error-budget burn
        is a policy decision, not a liveness fact.
    """

    def __init__(
        self,
        frontdoor: FrontDoor,
        host: Optional[str] = None,
        port: int = 0,
        registry: Optional[MetricsRegistry] = None,
        encode=None,
        decode=None,
        chat_template: Optional[ChatTemplate] = None,
        unhealthy_after_s: float = 60.0,
        request_timeout_s: float = 600.0,
        slo_healthz: bool = False,
    ):
        self.frontdoor = frontdoor
        self.encode = encode
        self.decode = decode
        self.chat_template = chat_template if chat_template is not None \
            else ChatTemplate()
        self.request_timeout_s = float(request_timeout_s)
        self.metrics = registry if registry is not None else get_registry()
        self.endpoints = TelemetryEndpoints(
            registry=self.metrics,
            unhealthy_after_s=unhealthy_after_s,
            health_extra=self._router_health,
            slo_healthz=slo_healthz,
        )
        self.http_requests = self.metrics.counter(
            "serve/http_requests_total",
            help="HTTP requests accepted by the serving front door",
        )
        self.http_inflight = self.metrics.gauge(
            "serve/http_inflight",
            help="generation requests currently inside a handler thread",
        )
        self.http_429 = self.metrics.counter(
            "serve/http_429_total",
            help="requests refused with 429 under admission backpressure",
        )
        self.sse_streams = self.metrics.gauge(
            "serve/sse_streams",
            help="SSE token streams currently open",
        )
        host = host if host is not None else os.environ.get(
            "ATPU_API_HOST", "127.0.0.1"
        )
        self._httpd = _HttpServer((host, int(port)), _ApiHandler)
        self._httpd.api_server = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="atpu-api-server",
            daemon=True,
        )
        self._thread.start()
        logger.info("serving front door listening on %s", self.url)

    # ------------------------------------------------------------- surface
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

    def models_body(self) -> Dict[str, Any]:
        """``GET /v1/models``: the served name plus one pinnable entry per
        live weights version."""
        created = int(time.time())
        name = self.frontdoor.model_name
        data = [{
            "id": name, "object": "model", "created": created,
            "owned_by": "accelerate_tpu",
        }]
        for version, replicas in sorted(self.frontdoor.model_versions().items()):
            data.append({
                "id": f"{name}@{version}", "object": "model",
                "created": created, "owned_by": "accelerate_tpu",
                "weights_version": version, "replicas": replicas,
            })
        return {"object": "list", "data": data}

    def _router_health(self) -> Tuple[bool, Dict[str, Any]]:
        """Per-replica aggregation merged into ``/healthz``: a replica with
        queued-or-running work whose engine never steps shows up here as
        ``has_work`` with a stale heartbeat — and the stale heartbeat alone
        already trips the base check; this adds the per-replica view and the
        routing counters an operator needs to see which replica it is."""
        health = self.frontdoor.health()
        return True, {"router": health}

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
