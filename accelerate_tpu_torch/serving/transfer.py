"""Request-state marshalling between replicas: export from a dead engine,
adopt on a survivor.

Port of the recovery half of :mod:`accelerate_tpu.serving.transfer`
(:func:`export_inflight`, :func:`adopt`, :class:`MigrationError`).  A
request moves between engines by throwing its KV away and rebuilding it on
the adopter: the prompt prefilled, the tokens it had streamed fed through
decode windows (the reference re-prefills ``prompt + generated``);
token-exact under greedy, re-seeded under sampling.  Tokens already
streamed are never sent again.  The
reference's live page migration (``PageMigrator``, ``handoff``,
``migration_executables``) waits for the router (ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

from typing import List

from .errors import AdmissionError
from .pool import plan_chunks
from .scheduler import Request, RequestState

__all__ = ["MigrationError", "adopt", "export_inflight"]


class MigrationError(RuntimeError):
    """A migration that could not run; nothing was mutated on either engine.

    ``retriable=True`` — transient destination pressure (no free slot, page
    pool dry): the lane stays where it is and the caller may try again next
    step.  ``retriable=False`` — the pair can never migrate this lane: the
    caller falls back to the export/adopt replay path.
    """

    def __init__(self, reason: str, retriable: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.retriable = retriable


def export_inflight(engine) -> List[Request]:
    """Snapshot every request ``engine`` still owes an answer — running
    lanes, lanes pre-freed under a window that never landed, the open
    prefills and the waiting queue — detached from the engine and ready for
    :func:`adopt` on a survivor.

    A running lane exports as ``prompt + generated so far``
    (``Request.prefill_tokens``), from which :func:`adopt` replays it and
    generation resumes where it stopped.  Prefix-cache pins on this engine are released
    and the prefill plan cleared (the adopter re-plans against its own
    buckets and cache).  Nothing on the card is touched (the engine may be
    poisoned mid-window); :meth:`~.engine.ServingEngine.revive` tears it
    down.  Returns the requests in rid order (submit order)."""
    out: List[Request] = []
    for s in range(engine.num_slots):
        req = engine._slot_req[s]
        if req is not None and req.state is RequestState.RUNNING:
            out.append(req)
    for hd in (engine._prev_handle, engine._inflight):
        if hd is None:
            continue
        # a pre-freed lane's request left _slot_req when its last window
        # dispatched, and is owed that window's tokens from a drain this
        # engine will never run: it lives only on the handle
        for s in hd.prefreed:
            req = hd.reqs[s]
            if (req is not None and req.state is RequestState.RUNNING
                    and not any(req is r for r in out)):
                out.append(req)
    out.extend(engine.scheduler.take_prefills())
    out.extend(engine.scheduler.queue)
    engine.scheduler.queue.clear()
    for req in out:
        if engine.prefix_cache is not None and req.cache_nodes:
            engine.prefix_cache.release(req.cache_nodes)
        req.cache_nodes = []
        req.cached_chunks = 0
        req.cache_chain_broken = False
        req.chunks = ()
        req.next_chunk = 0
        req.slot = None
        req.state = RequestState.QUEUED
    out.sort(key=lambda r: r.rid)
    for req in out:
        if req.trace is not None:
            req.trace.annotate("export_inflight", rid=req.rid, generated=len(req.tokens))
    engine.recorder.record("serve/export_inflight", count=len(out), step=engine._step_count)
    return out


def adopt(engine, request: Request) -> Request:
    """Admit a request exported from a dead replica at the FRONT of
    ``engine``'s queue (it already waited its turn once).  Where the
    reference re-prefills ``prompt + generated``, the port prefills the
    prompt and replays the generated tokens through decode windows
    (``Request.replay_decode``), none streamed again: the lane's K/V is
    what the dead replica computed, so greedy lanes continue token-exact on
    the card too; sampled lanes resume on a re-seeded stream (the new rid
    seeds the lane at install), right in distribution but not sample for
    sample.  The capacity checks are the reference's, on the effective
    prompt.  Raises a non-retriable :class:`~.errors.AdmissionError` when it
    cannot fit this engine; never refused for queue depth."""
    eff = len(request.prefill_tokens)
    if eff > engine.max_prompt_len:
        raise AdmissionError(
            f"replayed prompt+generated length {eff} > max_prompt_len {engine.max_prompt_len}",
            queue_depth=engine.scheduler.queue_depth, retriable=False)
    span = max(engine.window, engine._spec_span)
    remaining = max(request.config.max_new_tokens - len(request.tokens), 1)
    if eff + remaining + span > engine.max_len:
        raise AdmissionError(
            f"replayed length {eff} + remaining {remaining} + span {span} exceeds slot "
            f"capacity {engine.max_len}", queue_depth=engine.scheduler.queue_depth,
            retriable=False)
    padded = sum(b for b, _ in plan_chunks(eff, engine.buckets))
    cap = engine.max_len if engine.paged else engine.max_prompt_len
    if padded > cap:
        raise AdmissionError(
            f"replayed length {eff} pads to {padded} prefill tokens under buckets "
            f"{engine.buckets}, exceeding capacity {cap}",
            queue_depth=engine.scheduler.queue_depth, retriable=False)
    old_rid = request.rid
    # the port replays by decode: the prompt is prefilled, and the streamed
    # tokens go through decode windows, so the replayed lane's K/V is the
    # one the dead replica computed (a greedy lane continues bit for bit on
    # the card, where a prefill of them rounds otherwise)
    request.replay_decode = True
    request.rid = engine._next_rid
    engine._next_rid += 1
    if request.trace is not None:
        # the same trace crosses replicas: the ejection-to-adoption interval
        # closes as a failover phase and the trace is re-indexed under the
        # new rid, so the waterfall continues
        request.trace.phase("failover", from_engine=request.trace.engine,
                            to_engine=engine.engine_id, old_rid=old_rid, rid=request.rid,
                            generated=len(request.tokens))
        engine.reqtrace.rebind(request.trace, engine.engine_id, request.rid)
    engine.scheduler.requeue(request)
    engine._bump("requests_submitted")
    engine._bump("requests_replayed")
    # the tenant label rides the Request across the failover
    engine._bump_tenant(request.tenant, "requests_submitted")
    engine._bump_tenant(request.tenant, "requests_replayed")
    if request.deadline_s is not None:
        engine._has_deadlines = True
    engine.recorder.record("serve/adopt", rid=request.rid, old_rid=old_rid, effective_len=eff,
                           generated=len(request.tokens))
    return request
