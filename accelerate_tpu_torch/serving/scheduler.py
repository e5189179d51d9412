"""Host-side request scheduling for the continuous-batching engine.

Port of :mod:`accelerate_tpu.serving.scheduler` without prefix-cache
matching: a FCFS request queue, per-request
:class:`~accelerate_tpu_torch.models.generation.GenerationConfig`,
chunked-prefill progress, and an admission policy bounded by a prefill-token
budget per engine step (the Orca/Sarathi knob that keeps decode-step latency
jitter bounded while new prompts stream in).  One request prefills at a time.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..models.generation import GenerationConfig
from .errors import AdmissionError
from .pool import plan_chunks


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class Request:
    """One serving request: prompt + generation config + progress.

    ``on_token(request, token)`` streams each generated token as the engine
    lands it (window granularity); ``tokens`` accumulates the generated ids
    (EOS included when hit, never the post-EOS padding)."""

    rid: int
    prompt: np.ndarray                      # [S] int32
    config: GenerationConfig
    on_token: Optional[Callable[["Request", int], None]] = None
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    chunks: Tuple[Tuple[int, int], ...] = ()
    next_chunk: int = 0

    @property
    def done(self) -> bool:
        return self.state is RequestState.DONE

    @property
    def output_ids(self) -> np.ndarray:
        """Prompt + generated tokens."""
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What prefill must process now: the prompt, plus — after a
        preemption — every token already generated (replay resumes exactly
        where generation stopped; ``tokens`` is never re-emitted)."""
        if not self.tokens:
            return self.prompt
        return self.output_ids

    def emit(self, token: int) -> None:
        self.tokens.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))


class Scheduler:
    """FCFS admission with a per-step prefill-token budget.

    One request prefills at a time; its chunks are charged against
    ``prefill_token_budget`` each engine step, so a long prompt spreads
    across steps instead of stalling every running request for its whole
    prefill (chunked prefill, Sarathi-style).  The first chunk of each step
    runs even over budget, or a bucket wider than the budget could never run.
    """

    def __init__(self, prefill_buckets: Sequence[int], prefill_token_budget: int,
                 max_queue: Optional[int] = None):
        self.buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if not self.buckets:
            raise ValueError("need at least one prefill bucket")
        self.budget = int(prefill_token_budget)
        if self.budget < self.buckets[0]:
            raise ValueError(
                f"prefill_token_budget {self.budget} cannot fit the smallest "
                f"bucket {self.buckets[0]} — no prompt would ever be admitted"
            )
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.queue: deque = deque()
        #: the request mid-prefill, if any
        self.prefilling: Optional[Request] = None
        self._chunk_this_step = False

    def submit(self, request: Request) -> None:
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            depth = self.queue_depth
            raise AdmissionError(
                f"admission queue full ({len(self.queue)} >= max_queue {self.max_queue})",
                queue_depth=depth, retry_after_s=min(30.0, 0.5 * depth), retriable=True,
            )
        request.chunks = plan_chunks(len(request.prefill_tokens), self.buckets)
        self.queue.append(request)

    def requeue(self, request: Request) -> None:
        """Put a preempted RUNNING request back at the FRONT of the queue; it
        replays prompt + generated tokens."""
        request.state = RequestState.QUEUED
        request.slot = None
        request.chunks = plan_chunks(len(request.prefill_tokens), self.buckets)
        request.next_chunk = 0
        self.queue.appendleft(request)

    @property
    def has_queued(self) -> bool:
        return bool(self.queue) or self.prefilling is not None

    @property
    def queue_depth(self) -> int:
        """Requests waiting or mid-prefill."""
        return len(self.queue) + (self.prefilling is not None)

    def begin_step(self) -> int:
        """Fresh prefill-token budget for this engine step."""
        self._chunk_this_step = False
        return self.budget

    def start_next(self, slot: int) -> Optional[Request]:
        """Pop the FCFS head into PREFILL state, bound for ``slot``."""
        if self.prefilling is not None or not self.queue:
            return None
        req = self.queue.popleft()
        req.state = RequestState.PREFILL
        req.slot = slot
        self.prefilling = req
        return req

    def take_chunk(self, budget: int, ready: Optional[Callable[[Request], bool]] = None,
                   ) -> Optional[Tuple[Request, int, int, int]]:
        """Next prefill chunk fitting ``budget``: ``(request, bucket_len,
        valid_len, start)`` or None.  ``ready`` is an optional gate (the
        engine's page check).  The first chunk since :meth:`begin_step`
        ignores the budget."""
        req = self.prefilling
        if req is None or req.next_chunk >= len(req.chunks):
            return None
        bucket, valid = req.chunks[req.next_chunk]
        if bucket > budget and self._chunk_this_step:
            return None
        if ready is not None and not ready(req):
            return None
        start = sum(v for _, v in req.chunks[:req.next_chunk])
        req.next_chunk += 1
        self._chunk_this_step = True
        return req, bucket, valid, start

    def finish_prefill(self) -> Optional[Request]:
        """If the open prefill has run every chunk, hand it over for install."""
        req = self.prefilling
        if req is not None and req.next_chunk >= len(req.chunks):
            self.prefilling = None
            return req
        return None
