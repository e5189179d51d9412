"""Typed admission refusals (port of :mod:`accelerate_tpu.serving.errors`).

* ``retriable=True`` — transient backpressure (queue at ``max_queue``):
  retrying the same request later can succeed.
* ``retriable=False`` — a capacity refusal (prompt too long for this
  engine): retrying on the same engine can never succeed.

``AdmissionError`` subclasses ``ValueError`` so callers that catch plain
refusals keep working.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["AdmissionError"]


class AdmissionError(ValueError):
    """An engine refused to admit a request.

    ``queue_depth``: requests queued or mid-prefill at refusal time;
    ``retry_after_s``: hint for when the same submit could succeed;
    ``retriable``: transient backpressure vs a capacity refusal."""

    def __init__(self, message: str, *, queue_depth: int = 0,
                 retry_after_s: Optional[float] = None, retriable: bool = True):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = retry_after_s
        self.retriable = bool(retriable)

    def __repr__(self) -> str:
        return (
            f"AdmissionError({str(self)!r}, queue_depth={self.queue_depth}, "
            f"retry_after_s={self.retry_after_s}, retriable={self.retriable})"
        )
