"""Typed admission refusals (port of :mod:`accelerate_tpu.serving.errors`).

* ``retriable=True`` — transient backpressure (queue at ``max_queue``):
  retrying the same request later can succeed.
* ``retriable=False`` — a capacity refusal (prompt too long for this
  engine): retrying on the same engine can never succeed.

``AdmissionError`` subclasses ``ValueError`` so callers that catch plain
refusals keep working.  :class:`DeadlineExceeded` is the typed end of a
request the deadline sweep cancelled after it ran (the front door's 504).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["AdmissionError", "DeadlineExceeded"]


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


class DeadlineExceeded(RuntimeError):
    """A running request blew its ``deadline_s`` and was cancelled by the
    engine's deadline sweep.  The API layer maps this to HTTP 504 — the
    request was admitted and partially served, unlike an
    :class:`AdmissionError` shed (429) where nothing ran.  ``elapsed_s`` is
    how long the request had been in flight when the sweep caught it."""

    def __init__(self, message: str, *, deadline_s: float = 0.0, elapsed_s: float = 0.0):
        super().__init__(message)
        self.deadline_s = float(deadline_s)
        self.elapsed_s = float(elapsed_s)
