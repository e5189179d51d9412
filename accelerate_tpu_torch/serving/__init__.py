"""Continuous-batching serving on a refcounted KV page pool, and the fleet
around it: the replica router, live page migration between replicas and the
OpenAI-compatible front door (:mod:`.api`)."""

from .engine import ServingEngine
from .errors import AdmissionError, DeadlineExceeded
from .faults import FaultInjected, FaultInjector, FaultPlan
from .paging import NULL_PAGE, PageAllocator, PagedKVPool
from .pool import LaneState, decode_window, plan_chunks, prefill_chunk
from .prefix_cache import PrefixCache, PrefixNode, rolling_hash
from .router import ReplicaRouter
from .scheduler import Request, RequestState, Scheduler
from .transfer import MigrationError, PageMigrator

__all__ = [
    "ServingEngine",
    "AdmissionError",
    "DeadlineExceeded",
    "FaultInjected",
    "FaultInjector",
    "FaultPlan",
    "MigrationError",
    "PageMigrator",
    "ReplicaRouter",
    "NULL_PAGE",
    "PageAllocator",
    "PagedKVPool",
    "LaneState",
    "decode_window",
    "plan_chunks",
    "prefill_chunk",
    "PrefixCache",
    "PrefixNode",
    "rolling_hash",
    "Request",
    "RequestState",
    "Scheduler",
]
