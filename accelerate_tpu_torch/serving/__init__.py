"""Continuous-batching serving on a refcounted KV page pool (paged path only)."""

from .engine import ServingEngine
from .errors import AdmissionError
from .paging import NULL_PAGE, PageAllocator, PagedKVPool
from .pool import LaneState, decode_window, plan_chunks, prefill_chunk
from .scheduler import Request, RequestState, Scheduler

__all__ = [
    "ServingEngine",
    "AdmissionError",
    "NULL_PAGE",
    "PageAllocator",
    "PagedKVPool",
    "LaneState",
    "decode_window",
    "plan_chunks",
    "prefill_chunk",
    "Request",
    "RequestState",
    "Scheduler",
]
