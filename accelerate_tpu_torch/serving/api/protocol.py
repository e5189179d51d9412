"""OpenAI wire protocol: request validation, chat templating, SSE framing.

Port of :mod:`accelerate_tpu.serving.api.protocol`, a copy of its pure
functions (same inputs, same outputs and the same ``ValidationError``
texts).  Pure host-side data plumbing — no engine, no device, no threads.
The handler layer (:mod:`.server`) parses bytes into :class:`CompletionCall`
here, and renders :class:`~accelerate_tpu_torch.serving.scheduler.Request` results
back into OpenAI response / SSE-chunk dicts here, so the protocol surface is
testable without ever binding a port.

Token-id native: this stack serves models, not tokenizers.  ``prompt`` (and
chat message ``content``) is accepted as an **array of token ids** — a form
the OpenAI completions API itself permits — and responses always carry a
``token_ids`` extension field alongside ``text``.  Plain-string prompts are
supported only when the front door was built with ``encode``/``decode``
hooks (any callable pair; e.g. a sentencepiece model); without them a string
prompt is a 400, not a crash.

SSE framing follows the OpenAI streaming contract: each event is
``data: <json>\n\n`` with object type ``text_completion`` (completions) or
``chat.completion.chunk`` (chat, deltas), and the stream terminates with the
literal ``data: [DONE]\n\n`` sentinel.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ValidationError",
    "CompletionCall",
    "ChatTemplate",
    "parse_completion_request",
    "parse_chat_request",
    "completion_response",
    "completion_chunk",
    "sse_frame",
    "SSE_DONE",
]

#: Terminal SSE frame, verbatim from the OpenAI streaming contract.
SSE_DONE = "data: [DONE]\n\n"


class ValidationError(ValueError):
    """Malformed request body — the front door maps it to HTTP 400 with an
    OpenAI-style ``invalid_request_error`` envelope."""

    def __init__(self, message: str, param: Optional[str] = None):
        super().__init__(message)
        self.param = param


@dataclasses.dataclass
class CompletionCall:
    """One validated generation call, engine-ready.

    ``prompt`` is always token ids by the time this exists; ``model`` is the
    raw model string (version pinning is resolved by the front door, which
    knows what the router serves); ``chat`` marks which response dialect
    (``text_completion`` vs ``chat.completion``) the caller spoke.
    """

    prompt: List[int]
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stop_token_id: Optional[int] = None
    stream: bool = False
    model: Optional[str] = None
    echo: bool = False
    chat: bool = False
    # SLO budget in seconds from submit: admission sheds (429) when the
    # queue estimate says it is unmeetable, and a running lane that blows it
    # is cancelled with a 504 (engine-side deadline sweep)
    deadline_s: Optional[float] = None
    # caller attribution: set by the HTTP layer from the ``X-Tenant`` header
    # (or the Authorization API-key prefix), never from the JSON body — the
    # body is caller-controlled, the header is gateway-controlled.  Threads
    # through FrontDoor -> ReplicaRouter -> ServingEngine.submit(tenant=)
    tenant: Optional[str] = None


def _require_dict(body: Any) -> Dict[str, Any]:
    if not isinstance(body, dict):
        raise ValidationError("request body must be a JSON object")
    return body


def _token_list(value: Any, param: str) -> List[int]:
    if not isinstance(value, (list, tuple)) or not value:
        raise ValidationError(f"{param} must be a non-empty array of token ids",
                              param=param)
    out = []
    for t in value:
        if isinstance(t, bool) or not isinstance(t, int):
            raise ValidationError(
                f"{param} must contain only integer token ids (got {t!r})",
                param=param,
            )
        if t < 0:
            raise ValidationError(f"{param} token ids must be >= 0", param=param)
        out.append(int(t))
    return out


def _coerce_prompt(value: Any, param: str,
                   encode: Optional[Callable[[str], Sequence[int]]]) -> List[int]:
    """Token ids pass through; strings go through the ``encode`` hook."""
    if isinstance(value, str):
        if encode is None:
            raise ValidationError(
                f"{param} is a string but this server has no tokenizer; "
                f"send an array of token ids",
                param=param,
            )
        return [int(t) for t in encode(value)]
    return _token_list(value, param)


def _number(body: Dict[str, Any], key: str, default, lo, hi, integral=False):
    value = body.get(key, default)
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValidationError(f"{key} must be a number", param=key)
    if integral and int(value) != value:
        raise ValidationError(f"{key} must be an integer", param=key)
    if not (lo <= value <= hi):
        raise ValidationError(f"{key} must be in [{lo}, {hi}]", param=key)
    return int(value) if integral else float(value)


def _common_fields(body: Dict[str, Any]) -> Dict[str, Any]:
    n = _number(body, "n", 1, 1, 1, integral=True)
    if n != 1:  # unreachable via the bounds, kept for a clear message
        raise ValidationError("only n=1 is supported", param="n")
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise ValidationError("stream must be a boolean", param="stream")
    stop = body.get("stop")
    stop_token_id = None
    if stop is not None:
        if isinstance(stop, bool) or not isinstance(stop, int):
            raise ValidationError(
                "stop must be a single token id on this server", param="stop"
            )
        stop_token_id = int(stop)
    model = body.get("model")
    if model is not None and not isinstance(model, str):
        raise ValidationError("model must be a string", param="model")
    return dict(
        max_tokens=_number(body, "max_tokens", 16, 1, 1 << 20, integral=True),
        temperature=_number(body, "temperature", 1.0, 0.0, 2.0),
        top_p=_number(body, "top_p", None, 0.0, 1.0),
        top_k=_number(body, "top_k", None, 1, 1 << 20, integral=True),
        stop_token_id=stop_token_id,
        stream=stream,
        model=model,
        deadline_s=_number(body, "deadline_s", None, 0.001, 3600.0),
    )


def parse_completion_request(
    body: Any, encode: Optional[Callable[[str], Sequence[int]]] = None
) -> CompletionCall:
    """Validate a ``POST /v1/completions`` body into a :class:`CompletionCall`."""
    body = _require_dict(body)
    if "prompt" not in body:
        raise ValidationError("prompt is required", param="prompt")
    echo = body.get("echo", False)
    if not isinstance(echo, bool):
        raise ValidationError("echo must be a boolean", param="echo")
    return CompletionCall(
        prompt=_coerce_prompt(body["prompt"], "prompt", encode),
        echo=echo,
        chat=False,
        **_common_fields(body),
    )


@dataclasses.dataclass
class ChatTemplate:
    """Token-id chat template: per-role prefix/suffix ids framing each
    message, plus the generation prompt appended after the last message.

    The default is the empty template — plain concatenation of message
    content — which is exactly right for the token-id-native tests/benches
    (the ids ARE the conversation).  Deployments with a real tokenizer pass
    the ids their model's chat format uses (e.g. ``<|im_start|>`` blocks).
    """

    role_prefix: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )
    role_suffix: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )
    generation_prefix: Tuple[int, ...] = ()

    def render(self, messages: Sequence[Dict[str, Any]],
               encode: Optional[Callable[[str], Sequence[int]]]) -> List[int]:
        ids: List[int] = []
        for i, msg in enumerate(messages):
            if not isinstance(msg, dict):
                raise ValidationError(
                    "messages must be objects with role and content",
                    param=f"messages[{i}]",
                )
            role = msg.get("role")
            if role not in ("system", "user", "assistant", "tool"):
                raise ValidationError(
                    f"unknown role {role!r}", param=f"messages[{i}].role"
                )
            if "content" not in msg:
                raise ValidationError(
                    "content is required", param=f"messages[{i}].content"
                )
            ids.extend(self.role_prefix.get(role, ()))
            ids.extend(
                _coerce_prompt(msg["content"], f"messages[{i}].content", encode)
            )
            ids.extend(self.role_suffix.get(role, ()))
        ids.extend(self.generation_prefix)
        return ids


def parse_chat_request(
    body: Any,
    template: Optional[ChatTemplate] = None,
    encode: Optional[Callable[[str], Sequence[int]]] = None,
) -> CompletionCall:
    """Validate a ``POST /v1/chat/completions`` body: messages are rendered
    through the chat template into one token-id prompt."""
    body = _require_dict(body)
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ValidationError(
            "messages must be a non-empty array", param="messages"
        )
    template = template if template is not None else ChatTemplate()
    return CompletionCall(
        prompt=template.render(messages, encode),
        echo=False,
        chat=True,
        **_common_fields(body),
    )


# --------------------------------------------------------------- responses
def _finish_reason(tokens: Sequence[int], call: CompletionCall,
                   eos_token_id: Optional[int], cancelled: bool) -> str:
    if cancelled:
        return "cancelled"
    if (eos_token_id is not None and tokens
            and int(tokens[-1]) == int(eos_token_id)):
        return "stop"
    return "length"


def completion_response(
    call: CompletionCall,
    request_id: str,
    created: int,
    model: str,
    tokens: Sequence[int],
    eos_token_id: Optional[int] = None,
    cancelled: bool = False,
    decode: Optional[Callable[[Sequence[int]], str]] = None,
) -> Dict[str, Any]:
    """The full (non-streaming) response object, completions or chat dialect."""
    tokens = [int(t) for t in tokens]
    text = decode(tokens) if decode is not None else ""
    reason = _finish_reason(tokens, call, eos_token_id, cancelled)
    if call.chat:
        choice: Dict[str, Any] = {
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "token_ids": tokens,
            "finish_reason": reason,
        }
        object_type = "chat.completion"
    else:
        out_tokens = list(call.prompt) + tokens if call.echo else tokens
        choice = {
            "index": 0,
            "text": decode(out_tokens) if decode is not None else "",
            "token_ids": out_tokens,
            "finish_reason": reason,
        }
        object_type = "text_completion"
    return {
        "id": request_id,
        "object": object_type,
        "created": created,
        "model": model,
        "choices": [choice],
        "usage": {
            "prompt_tokens": len(call.prompt),
            "completion_tokens": len(tokens),
            "total_tokens": len(call.prompt) + len(tokens),
        },
    }


def completion_chunk(
    call: CompletionCall,
    request_id: str,
    created: int,
    model: str,
    token: Optional[int],
    first: bool,
    finish_reason: Optional[str] = None,
    decode: Optional[Callable[[Sequence[int]], str]] = None,
) -> Dict[str, Any]:
    """One streaming chunk.  ``token=None`` with a ``finish_reason`` is the
    final summary chunk (no content) that precedes ``data: [DONE]``."""
    tokens = [] if token is None else [int(token)]
    text = decode(tokens) if decode is not None and tokens else ""
    if call.chat:
        delta: Dict[str, Any] = {}
        if first:
            delta["role"] = "assistant"
        if tokens:
            delta["content"] = text
        choice: Dict[str, Any] = {
            "index": 0,
            "delta": delta,
            "token_ids": tokens,
            "finish_reason": finish_reason,
        }
        object_type = "chat.completion.chunk"
    else:
        choice = {
            "index": 0,
            "text": text,
            "token_ids": tokens,
            "finish_reason": finish_reason,
        }
        object_type = "text_completion"
    return {
        "id": request_id,
        "object": object_type,
        "created": created,
        "model": model,
        "choices": [choice],
    }


def sse_frame(payload: Dict[str, Any]) -> str:
    """One ``data:`` SSE event (compact JSON, double-newline terminated)."""
    return f"data: {json.dumps(payload, separators=(',', ':'))}\n\n"


def error_body(message: str, err_type: str, code: Optional[str] = None,
               param: Optional[str] = None) -> Dict[str, Any]:
    """OpenAI error envelope (``{"error": {...}}``)."""
    return {
        "error": {
            "message": message,
            "type": err_type,
            "param": param,
            "code": code,
        }
    }
