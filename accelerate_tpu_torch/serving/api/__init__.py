"""OpenAI-compatible HTTP front door for the serving engine (port of
:mod:`accelerate_tpu.serving.api`).

Three layers, separable on purpose:

- :mod:`.protocol` — wire validation, chat templating, SSE framing (pure
  functions, no threads, no engine).
- :mod:`.frontdoor` — the driver thread that exclusively owns the
  :class:`~accelerate_tpu_torch.serving.router.ReplicaRouter` and makes
  every call on the card; handler threads cross only through its ticket
  API and per-request :class:`~.frontdoor.TokenStream` queues.
- :mod:`.server` — the stdlib ``ThreadingHTTPServer`` edge: OpenAI routes,
  SSE streaming, backpressure → 429, disconnect → cancel, and the muxed
  telemetry surface (``/metrics``, ``/healthz``, ``/debug/*``).

``python -m accelerate_tpu_torch.serve`` (see
:mod:`accelerate_tpu_torch.serve`) wires the three into a runnable service.
"""

from .frontdoor import FrontDoor, TokenStream
from .protocol import (
    SSE_DONE,
    ChatTemplate,
    CompletionCall,
    ValidationError,
    completion_chunk,
    completion_response,
    parse_chat_request,
    parse_completion_request,
    sse_frame,
)
from .server import ApiServer

__all__ = [
    "ApiServer",
    "FrontDoor",
    "TokenStream",
    "ChatTemplate",
    "CompletionCall",
    "ValidationError",
    "parse_completion_request",
    "parse_chat_request",
    "completion_response",
    "completion_chunk",
    "sse_frame",
    "SSE_DONE",
]
