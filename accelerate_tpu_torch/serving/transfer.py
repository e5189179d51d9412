"""Live KV page migration and request-state marshalling between replicas.

Port of :mod:`accelerate_tpu.serving.transfer`.  Two ways move a request
between engines:

* :func:`export_inflight` / :func:`adopt` throw its KV away and rebuild it on
  the adopter: the prompt prefilled, the tokens it had streamed fed through
  decode windows (the reference re-prefills ``prompt + generated``);
  token-exact under greedy, re-seeded under sampling.  Tokens already
  streamed are never sent again.
* :class:`PageMigrator` moves the KV itself: a lane's live pages, their
  per-page scales, its write index, its pending token and its sampling
  stream ``(seed, counter)`` travel to the destination, which installs them
  into pages of its own allocator and continues **bit-identically**, greedy
  and sampled alike, at a copy cost in pages, whatever compute made them.

Two arms (``mode="auto"`` picks by device):

- **d2d**: both pools on the same kind of device; the gathered pages go
  straight from the source's pool into the destination's, never through
  the host.
- **bounce**: the gathered pages are copied into page-locked host memory,
  waited for (the one blocking point, as a window's readback), and copied
  up into the destination, as a hierarchical-cache promotion is.  On the
  CPU the bounce goes through an ordinary host buffer.

Unlike the reference, no id list is padded with the null page: the gather
and the install take the lane's live page ids only, so the install never
writes one page twice (the null page is never written).  Each engine's
gather (``serve/migrate_extract``) and install (``serve/migrate_install``)
are made lazily on its first migration and watched by a
:class:`~accelerate_tpu_torch.telemetry.RecompileWatchdog` keyed by the
pool they touch, so a lane's page count is no new program.  The install is
an in-place ``index_copy_`` into the destination's page tensors, whose
addresses its CUDA graphs hold: no graph is captured again.  Both engines
enqueue on the calling thread's current stream, so the install runs behind
the destination's window in flight and the gather behind everything the
source dispatched; the source drains its own pipeline first (the migration
barrier that makes its host mirrors and its lane vectors current).

Failure semantics: every refusal raises :class:`MigrationError` before any
engine state mutates.  ``retriable=True`` (destination slot or page
pressure): try again next step.  ``retriable=False`` (geometry mismatch,
an injected ``migrate_d2d`` / ``migrate_bounce`` fault): fall back to the
export/adopt replay path; the source lane is untouched and the source
replica stays healthy.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry import (
    MetricsRegistry,
    RecompileWatchdog,
    get_flight_recorder,
    get_registry,
    get_tracer,
)
from ..telemetry.watchdog import tensor_signature
from . import faults
from .errors import AdmissionError
from .pool import _raw, plan_chunks, promote_install, spill_extract
from .remote import apply_report, describe, report_line
from .scheduler import Request, RequestState

__all__ = ["MigrationError", "PageMigrator", "adopt", "export_inflight", "geometry_mismatch",
           "migration_executables"]

# Migration wall time spans ~10 us (a one-page d2d handoff) to ~100 s (a
# full lane bounced over a congested host link): 20 x2 buckets from 10 us
# in ms units cover it.
_MIGRATE_MS_BUCKETS = tuple(1e-2 * 2.0**i for i in range(20))


class MigrationError(RuntimeError):
    """A migration that could not run; nothing was mutated on either engine.

    ``retriable=True`` — transient destination pressure (no free slot, page
    pool dry): the lane stays where it is and the caller may try again next
    step.  ``retriable=False`` — the pair can never migrate this lane
    (geometry mismatch, lane finished, injected fault): the caller falls
    back to the export/adopt replay path.
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


# ----------------------------------------------------------------- executables
def _pool_signature(args, kwargs):
    """A migration program's signature: the pool it reads or writes (its
    first argument), not the lane's page count."""
    return tensor_signature(args[:1], {})


def migration_executables(engine):
    """The engine's ``(extract, install)`` migration pair, made on first
    use and kept: ``serve/migrate_extract`` (the gather of a lane's pages
    and scales) and ``serve/migrate_install`` (their in-place scatter into
    fresh pages).  Lazy because most engines never migrate: the programs
    ``compiled_executable_counts`` lists grow on the replicas that take
    part, and by exactly this pair."""
    if engine._migrate_extract is None:
        engine._migrate_extract = RecompileWatchdog(
            spill_extract, name="serve/migrate_extract", budget=1,
            registry=engine.metrics, signature=_pool_signature)
        engine._migrate_install = RecompileWatchdog(
            promote_install, name="serve/migrate_install", budget=1,
            registry=engine.metrics, signature=_pool_signature)
    return engine._migrate_extract, engine._migrate_install


def _ids(page_ids: Sequence[int], device: torch.device) -> torch.Tensor:
    """Page ids as an int64 index on ``device``: a pageable non-blocking
    copy, staged at the call, that waits for nothing on the stream."""
    return torch.from_numpy(np.asarray(page_ids, np.int64)).to(device, non_blocking=True)


def _bounce(chunk: Sequence[torch.Tensor], device: torch.device) -> tuple:
    """Copy a gathered chunk through host memory onto ``device``: into
    page-locked buffers behind the gather, one wait for them (the bounce's
    blocking point), then non-blocking copies up.  On the CPU an ordinary
    host buffer stands in.  Moves the bits as integers of their width."""
    if chunk[0].device.type != "cuda":
        host = [_raw(c).clone() for c in chunk]
    else:
        host = [torch.empty(c.shape, dtype=_raw(c).dtype, pin_memory=True) for c in chunk]
        for h, c in zip(host, chunk):
            h.copy_(_raw(c), non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(torch.cuda.current_stream(chunk[0].device))
        landed.synchronize()
    return tuple(h.to(device, non_blocking=True).view(c.dtype) for h, c in zip(host, chunk))


def geometry_mismatch(a: dict, b: dict) -> Optional[str]:
    """``None`` when a lane can move from the replica ``a`` describes to
    ``b``'s (:func:`.remote.describe`), whatever ranks serve them; else the
    reason.  The pools must agree on page geometry and storage dtype, so
    that the gathered pages feed the destination's install bit for bit.
    The kv heads count over the whole
    mesh, so replicas of different tp degrees take each other's lanes; a
    mesh replica and an engine without a mesh do not."""
    if a["mesh"] != b["mesh"]:
        return "a mesh replica and an engine without a mesh: lanes move between meshes"
    if not (a["paged"] and b["paged"]):
        return "both engines must run the paged KV pool"
    ga, gb = a["geometry"], b["geometry"]
    for key in ("page_size", "pages_per_lane", "storage_dtype"):
        if ga[key] != gb[key]:
            return f"{key} differs ({ga[key]} vs {gb[key]})"
    if any(ga[k] != gb[k] for k in ("layers", "kv_heads", "head_dim")):
        return "KV pool geometry (layers/heads/head_dim) differs"
    return None


def _head_dims(chunk) -> tuple:
    """The head axis of each tensor of a gathered chunk: ``[L, n, page,
    Hkv, D]`` pages, ``[L, n, Hkv]`` scales."""
    return tuple(c.dim() - 2 if c.dim() == 5 else c.dim() - 1 for c in chunk)


def _shard_bytes(chunk) -> "torch.Tensor":
    """A chunk's bits as one flat uint8 host tensor (the wire form)."""
    return torch.cat([_raw(c).contiguous().cpu().reshape(-1).view(torch.uint8)
                      for c in chunk])


def _shard_from_bytes(buf: "torch.Tensor", layout) -> tuple:
    """:func:`_shard_bytes`' inverse: ``layout`` is each tensor's shape
    and dtype name."""
    out, at = [], 0
    for shape, dtype in layout:
        dt = getattr(torch, dtype)
        n = int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
        raw = _RAW_BY_SIZE[torch.empty((), dtype=dt).element_size()]
        out.append(buf[at:at + n].clone().view(raw).reshape(shape).view(dt))
        at += n
    return tuple(out)


_RAW_BY_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


# ------------------------------------------------------------------- migrator
class PageMigrator:
    """Move live decode lanes between :class:`~.engine.ServingEngine`
    replicas.

    Stateless apart from telemetry: every :meth:`migrate` call is one whole
    lane move (or a clean :class:`MigrationError` refusal), so one migrator
    can serve a whole router.  Pass the registry the engines use to keep
    bench arms apart."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.metrics = registry if registry is not None else get_registry()
        self.recorder = get_flight_recorder().tagged(engine="migrator")
        self.tracer = get_tracer()
        self._migrations = self.metrics.counter(
            "serve/migrations_total",
            help="live lanes moved between replicas with their KV pages "
                 "(d2d and host-bounce arms both); replay fallbacks do not "
                 "count — they bump serve/requests_replayed_total instead",
        )
        self._bytes = self.metrics.counter(
            "serve/migrate_bytes_total",
            help="KV payload bytes migrated between replicas (live pages + "
                 "quant scales, at storage dtype) — the crossover input of "
                 "the migrate-vs-replay A/B",
        )
        self._handoffs = self.metrics.counter(
            "serve/prefill_handoffs_total",
            help="lanes handed off prefill-role -> decode-role right after "
                 "their last prefill chunk landed (disaggregated policy); a "
                 "subset of serve/migrations_total",
        )
        self._ms_hist = self.metrics.histogram(
            "serve/migrate_ms",
            buckets=_MIGRATE_MS_BUCKETS,
            help="wall time per lane migration, source drain barrier through "
                 "destination lane install dispatch (the install itself "
                 "overlaps the destination's decode)",
        )

    # ------------------------------------------------------------ feasibility
    @staticmethod
    def compatible(src, dst) -> Optional[str]:
        """``None`` when lanes can migrate ``src -> dst`` in this process
        (:func:`geometry_mismatch`, between engines of one mesh or none);
        else the reason."""
        if src is dst:
            return "source and destination are the same engine"
        ranks = [None if getattr(e, "mesh", None) is None else e.mesh.ranks for e in (src, dst)]
        if ranks[0] != ranks[1] or src.tp_degree != dst.tp_degree:
            # each rank moves its own head shard between engines of one mesh
            return ("the engines are not on one mesh: between replicas on other ranks a "
                    "router over processes moves the lane (migrate_across)")
        return geometry_mismatch(describe(src), describe(dst))

    @staticmethod
    def resolve_mode(src, dst) -> str:
        """``"d2d"`` when both pools live on the same kind of device (the
        copy stays on the card, or goes card to card), else ``"bounce"``."""
        if src.kv.pages_k.device.type != dst.kv.pages_k.device.type:
            return "bounce"
        return "d2d"

    # -------------------------------------------------------------- migration
    def migrate(self, src, dst, slot: int, mode: str = "auto",
                reason: str = "rebalance") -> Request:
        """Move the running lane in ``src`` slot ``slot`` to ``dst``, KV
        pages included, and return its request, which continues on the
        destination bit-identically (greedy and sampled: the lane's draw
        counter travels, unlike :func:`adopt`'s re-seed).  Raises
        :class:`MigrationError` with nothing mutated otherwise."""
        req = src._slot_req[slot]
        if req is None or req.state is not RequestState.RUNNING or not src._active[slot]:
            raise MigrationError(f"no running lane in slot {slot}")
        why = self.compatible(src, dst)
        if why is not None:
            raise MigrationError(why)
        if mode == "auto":
            mode = self.resolve_mode(src, dst)
        if mode not in ("d2d", "bounce"):
            raise MigrationError(f"unknown migration mode {mode!r}")
        if dst._next_free_slot() is None:
            raise MigrationError("destination has no free slot", retriable=True)
        t0 = time.perf_counter()
        # the source's migration barrier: land its windows in flight, so the
        # lane's write index (a host mirror) and its pending token and draw
        # counter (on the card) are the lane's live state; the source's
        # other lanes go on with the next step
        src._drain_inflight()
        if not src._active[slot] or src._slot_req[slot] is not req:
            raise MigrationError("lane finished while draining the source")
        lane_len = int(src._lane_len[slot])
        span = max(dst.window, dst._spec_span)
        remaining = max(req.config.max_new_tokens - len(req.tokens), 1)
        if lane_len + 1 + remaining + span > dst.max_len:
            raise MigrationError(
                f"lane length {lane_len} + remaining {remaining} + span {span} "
                f"exceeds destination capacity {dst.max_len}")
        page_ids = src.kv.lane_pages(slot)
        npages = len(page_ids)
        lanes = src.lanes
        # one read of the lane's device state (the pipeline is drained: it
        # waits only for what the source enqueued since)
        pending, seed, counter = torch.cat(
            [lanes.pending[slot:slot + 1].long(), lanes.keys[slot]]).tolist()
        sampled = bool(lanes.sampling[slot])
        point = f"migrate_{mode}"
        if faults.ACTIVE is not None and faults.ACTIVE.fire(point):
            self.recorder.record("serve/fault", point=point, rid=req.rid, slot=int(slot),
                                 src=src.engine_id, dst=dst.engine_id)
            raise MigrationError(f"injected {point} fault")
        new_ids = dst.kv.allocator.alloc(npages)
        if new_ids is None:
            if dst._reclaim_pages(npages, allow_preempt=False):
                new_ids = dst.kv.allocator.alloc(npages)
            if new_ids is None:
                raise MigrationError("destination page pool exhausted", retriable=True)
        extract, _ = migration_executables(src)
        _, install = migration_executables(dst)
        behind = dst._inflight is not None or dst._prev_handle is not None
        with self.tracer.span("serve/migrate", mode=mode, pages=npages, behind_window=behind):
            chunk = extract(src._pool, _ids(page_ids, src.device))
            if mode == "bounce":
                chunk = _bounce(chunk, dst.device)
            else:
                chunk = tuple(c.to(dst.device, non_blocking=True) for c in chunk)
            # in place, on the stream behind the destination's window in
            # flight: its graphs keep reading the same page tensors
            install(dst._pool, chunk, _ids(new_ids, dst.device))
        # the source's lane drops its page references now: a later source
        # prefill recycling them is ordered behind the gather on the stream
        src._retire_lane(slot)
        dst_slot = self._install_lane(dst, req, new_ids, lane_len, int(pending),
                                      int(seed) if sampled else None, int(counter))
        old_rid = req.rid
        req.rid = dst._next_rid
        dst._next_rid += 1
        req.slot = dst_slot
        if req.trace is not None:
            # the same trace crosses replicas, as in failover: the waterfall
            # gains a migrate phase instead of restarting
            req.trace.phase("migrate", from_engine=src.engine_id, to_engine=dst.engine_id,
                            old_rid=old_rid, rid=req.rid, mode=mode, pages=npages,
                            generated=len(req.tokens))
            dst.reqtrace.rebind(req.trace, dst.engine_id, req.rid)
        self._reestablish_prefix(dst, req, new_ids, lane_len)
        nbytes = src.kv.chunk_bytes(npages)
        self._migrations.inc()
        self._bytes.inc(nbytes)
        self._ms_hist.observe((time.perf_counter() - t0) * 1e3)
        self.recorder.record("serve/migrate", rid=req.rid, old_rid=old_rid, mode=mode,
                             src=src.engine_id, dst=dst.engine_id, slot=int(slot),
                             dst_slot=dst_slot, pages=npages, bytes=nbytes,
                             behind_window=behind, reason=reason)
        return req

    def handoff(self, src, dst, slot: int, mode: str = "auto") -> Request:
        """Prefill handoff: migrate a freshly prefilled lane off a
        prefill-role replica onto a decode-role one, the disaggregated
        steady state.  Counted apart from rebalancing migrations: handoffs
        are the policy (every lane, once), rebalancing the exception."""
        req = self.migrate(src, dst, slot, mode=mode, reason="prefill_handoff")
        self._handoffs.inc()
        self.recorder.record("serve/prefill_handoff", rid=req.rid, src=src.engine_id,
                             dst=dst.engine_id, generated=len(req.tokens))
        return req

    def count(self, nbytes: int, handoff: bool) -> None:
        """Count one lane move made elsewhere (a router over processes
        counts every move on every rank, as the reference's one process
        does)."""
        self._migrations.inc()
        self._bytes.inc(nbytes)
        if handoff:
            self._handoffs.inc()

    # ------------------------------------------------------ across processes
    def migrate_across(self, src, dst, slot: int, req: Request, world, src_ranks,
                       dst_ranks, reason: str = "rebalance", handoff: bool = False):
        """Move ``req``'s running lane in slot ``slot`` of a replica on
        ``src_ranks`` to one on the disjoint ``dst_ranks``, through the
        host: every rank of the world calls it alike (``world``:
        :class:`.remote.World`), ``src`` / ``dst`` the engines where this
        rank serves them, else ``None``.

        Three exchanges.  The source's ranks drain their windows and report
        the lane (write index, pending token, ``(seed, counter)``, the
        tokens the drain landed since the last report) or a refusal; the
        destination's ranks take a slot and pages, or refuse, before any
        state changes.  Then each source tp rank's gathered pages (its kv
        heads) go to every destination rank whose heads they overlap, in
        one ``all_to_all_single`` of host bytes over the world's gloo group
        (gloo's point-to-point send cannot take a card tensor): with equal
        tp degrees rank ``r`` to rank ``r``, else each destination rank
        cuts its heads from the shards it received.  The lane then retires
        on the source and installs on the destination, which continues it
        bit-identically (the reference re-lays the chunk with
        ``device_put``).  Raises :class:`MigrationError` on every rank on a
        refusal; returns ``(rid, slot)`` of the lane on the destination."""
        t0 = time.perf_counter()
        # 1. the lane, from the source's ranks
        sent, chunk = None, None
        if src is not None:
            try:
                meta, chunk = self._extract(src, slot, req)
                sent = ("ok", meta)
            except MigrationError as exc:
                sent = ("refused", exc.reason, exc.retriable)
            except Exception as exc:  # noqa: BLE001 (a refusal on every rank)
                sent = ("refused", f"the source failed: {exc!r}", False)
            # the tokens the drain landed go round, whatever the outcome
            sent += (report_line(req),)
        says = [world.gather(sent)[r] for r in src_ranks]
        apply_report(req, says[0][-1], local=src is not None)
        refused = next((s for s in says if s[0] == "refused"), None)
        if refused is not None:
            raise MigrationError(refused[1], retriable=refused[2])
        meta = says[0][1]
        # 2. a slot and pages on the destination
        plan = None
        if dst is not None:
            try:
                plan = ("ok", self._reserve(dst, meta, req))
            except MigrationError as exc:
                plan = ("refused", exc.reason, exc.retriable)
        got = world.gather(plan)
        says = [got[r] for r in dst_ranks]
        refused = next((s for s in says if s[0] == "refused"), None)
        if refused is not None:
            if plan is not None and plan[0] == "ok":
                dst.kv.allocator.deref(plan[1]["ids"])
            raise MigrationError(refused[1], retriable=refused[2])
        where = says[0][1]
        # 3. the pages, each source shard to the destination ranks it overlaps
        chunk = self._send_heads(world, chunk, meta, src_ranks, dst_ranks)
        # 4. the lane leaves the source and lands on the destination
        if src is not None:
            src._retire_lane(slot)
        if dst is not None:
            chunk = tuple(c.to(dst.device, non_blocking=True) for c in chunk)
            _, install = migration_executables(dst)
            with self.tracer.span("serve/migrate", mode="bounce", pages=meta["npages"],
                                  behind_window=dst._inflight is not None):
                install(dst._pool, chunk, _ids(plan[1]["ids"], dst.device))
            dst_slot = self._install_lane(dst, req, plan[1]["ids"], meta["lane_len"],
                                          meta["pending"], meta["seed"], meta["counter"])
            old_rid = req.rid
            req.rid = dst._next_rid
            dst._next_rid += 1
            req.slot = dst_slot
            if req.trace is not None:
                req.trace.phase("migrate", from_engine=meta["engine"],
                                to_engine=dst.engine_id, old_rid=old_rid, rid=req.rid,
                                mode="bounce", pages=meta["npages"], generated=len(req.tokens))
                dst.reqtrace.rebind(req.trace, dst.engine_id, req.rid)
            self._reestablish_prefix(dst, req, plan[1]["ids"], meta["lane_len"])
        self.count(meta["nbytes"], handoff)
        self._ms_hist.observe((time.perf_counter() - t0) * 1e3)
        self.recorder.record("serve/migrate", rid=where["rid"], mode="bounce",
                             src=meta["engine"], dst=where["engine"], slot=int(slot),
                             dst_slot=where["slot"], pages=meta["npages"],
                             bytes=meta["nbytes"], ranks=[list(src_ranks), list(dst_ranks)],
                             reason=reason)
        if handoff:
            self.recorder.record("serve/prefill_handoff", rid=where["rid"], src=meta["engine"],
                                 dst=where["engine"], generated=len(req.tokens))
        return where["rid"], where["slot"]

    def _extract(self, src, slot: int, req: Request) -> tuple:
        """The source side of :meth:`migrate_across`: the lane's state (the
        wire's ``meta``) and its gathered pages on the host."""
        live = src._slot_req[slot]
        if live is not req or req.state is not RequestState.RUNNING or not src._active[slot]:
            raise MigrationError(f"no running lane in slot {slot}")
        src._drain_inflight()
        if not src._active[slot] or src._slot_req[slot] is not req:
            raise MigrationError("lane finished while draining the source")
        page_ids = src.kv.lane_pages(slot)
        lanes = src.lanes
        pending, seed, counter = torch.cat(
            [lanes.pending[slot:slot + 1].long(), lanes.keys[slot]]).tolist()
        sampled = bool(lanes.sampling[slot])
        if faults.ACTIVE is not None and faults.ACTIVE.fire("migrate_bounce"):
            self.recorder.record("serve/fault", point="migrate_bounce", rid=req.rid,
                                 slot=int(slot), src=src.engine_id)
            raise MigrationError("injected migrate_bounce fault")
        extract, _ = migration_executables(src)
        chunk = tuple(c.cpu() for c in extract(src._pool, _ids(page_ids, src.device)))
        meta = dict(lane_len=int(src._lane_len[slot]), pending=int(pending),
                    seed=int(seed) if sampled else None, counter=int(counter),
                    npages=len(page_ids), nbytes=src.kv.chunk_bytes(len(page_ids)),
                    engine=src.engine_id,
                    layout=[(tuple(c.shape), str(c.dtype).replace("torch.", "")) for c in chunk],
                    tp=src.tp_degree)
        return meta, chunk

    @staticmethod
    def _reserve(dst, meta: dict, req: Request) -> dict:
        """The destination side's refusals, before anything changes, and
        its pages: a free slot, the capacity for the rest of the lane."""
        s = dst._next_free_slot()
        if s is None:
            raise MigrationError("destination has no free slot", retriable=True)
        span = max(dst.window, dst._spec_span)
        remaining = max(req.config.max_new_tokens - len(req.tokens), 1)
        if meta["lane_len"] + 1 + remaining + span > dst.max_len:
            raise MigrationError(
                f"lane length {meta['lane_len']} + remaining {remaining} + span {span} "
                f"exceeds destination capacity {dst.max_len}")
        ids = dst.kv.allocator.alloc(meta["npages"])
        if ids is None:
            if dst._reclaim_pages(meta["npages"], allow_preempt=False):
                ids = dst.kv.allocator.alloc(meta["npages"])
            if ids is None:
                raise MigrationError("destination page pool exhausted", retriable=True)
        return dict(ids=list(ids), slot=dst._next_free_slot(), rid=dst._next_rid,
                    engine=dst.engine_id, tp=dst.tp_degree)

    @staticmethod
    def _send_heads(world, chunk, meta: dict, src_ranks, dst_ranks):
        """Each source shard to the destination ranks whose kv heads it
        overlaps, in one ``all_to_all_single`` of host bytes; on a
        destination rank, its heads of the whole chunk (else ``None``)."""
        ts, td = len(src_ranks), len(dst_ranks)
        heads = meta["layout"][0][0][3] * ts
        hs, hd = heads // ts, heads // td

        def overlaps(i, j):
            return i * hs < (j + 1) * hd and j * hd < (i + 1) * hs

        me = world.rank
        nbytes = sum(int(np.prod(shape)) * torch.empty((), dtype=getattr(torch, dt)).element_size()
                     for shape, dt in meta["layout"])
        send = [0] * world.size
        recv = [0] * world.size
        if me in src_ranks:
            i = src_ranks.index(me)
            for j, r in enumerate(dst_ranks):
                if overlaps(i, j):
                    send[r] = nbytes
        if me in dst_ranks:
            j = dst_ranks.index(me)
            for i, r in enumerate(src_ranks):
                if overlaps(i, j):
                    recv[r] = nbytes
        payload = _shard_bytes(chunk) if me in src_ranks else torch.empty(0, dtype=torch.uint8)
        inp = torch.cat([payload] * sum(1 for n in send if n)) if any(send) else payload[:0]
        out = torch.empty(sum(recv), dtype=torch.uint8)
        dist.all_to_all_single(out, inp, output_split_sizes=recv, input_split_sizes=send,
                               group=world.group)
        if me not in dst_ranks:
            return None
        j = dst_ranks.index(me)
        parts, at = [], 0
        first = None
        for i, r in enumerate(src_ranks):
            if not recv[r]:
                continue
            first = i if first is None else first
            parts.append(_shard_from_bytes(out[at:at + nbytes], meta["layout"]))
            at += nbytes
        dims = _head_dims(parts[0])
        whole = [torch.cat([p[k] for p in parts], dim=dims[k]) for k in range(len(dims))]
        lo = j * hd - first * hs
        return tuple(t.narrow(d, lo, hd) for t, d in zip(whole, dims))

    # -------------------------------------------------------------- internals
    @staticmethod
    def _install_lane(dst, req: Request, new_ids: List[int], lane_len: int, pending: int,
                      seed: Optional[int], counter: int) -> int:
        """Wire the migrated lane into ``dst``: ``_install``'s twin without
        the prefill.  The block-table row maps the freshly installed pages,
        the host mirrors take the carried write index, and the lane vectors
        on the card the carried pending token and ``(seed, counter)`` (not
        a new seed: that is what makes the continuation bit-identical where
        :func:`adopt` is right only in distribution), by one-element fills
        behind any window in flight."""
        s = dst._next_free_slot()
        dst.kv.lane_append_owned(s, new_ids)
        gen = req.config
        eos = -1 if gen.eos_token_id is None else int(gen.eos_token_id)
        args = (s, pending, eos, float(gen.temperature),
                0 if gen.top_k is None else int(gen.top_k),
                1.0 if gen.top_p is None else float(gen.top_p), seed, counter)
        dst._cost_capture("lane_install", dst._lane_install, args)
        dst._lane_install(*args)
        dst._lane_len[s] = lane_len
        dst._active[s] = True
        dst._eos[s] = eos
        if dst._draft_window is not None:
            # the draft context from the sequence's tail: its last token is
            # the lane's pending token, the root of every draft tree
            dst._draft_window.begin(s, req.output_ids)
        if dst._slot_ever_used[s]:
            dst._bump("slots_reused")
        dst._slot_ever_used[s] = True
        dst._slot_req[s] = req
        dst._reserved_slots.discard(s)
        if req.deadline_s is not None:
            dst._has_deadlines = True
        req.state = RequestState.RUNNING
        return s

    @staticmethod
    def _reestablish_prefix(dst, req: Request, new_ids: List[int], lane_len: int) -> None:
        """Re-establish the prompt's prefix-cache entries on the
        destination: each full prompt chunk aliases the lane's new pages
        (zero copy) and takes its own allocator references, as
        ``_populate_cache`` does, so that later requests sharing the prefix
        hit there.  Chunks reaching the lane's write frontier are skipped:
        decode writes there, and a cached page must not change."""
        if dst.prefix_cache is None or not req.cache_prefix:
            return
        ptoks = np.asarray(req.prompt, np.int32).reshape(-1)
        page = dst.page_size
        frontier = (lane_len // page) * page
        parent = None
        start = 0
        for bucket, valid in plan_chunks(len(ptoks), dst.buckets):
            if valid != bucket or start + bucket > frontier:
                break
            npg = bucket // page
            first = start // page
            ids = list(new_ids[first:first + npg])
            node = dst.prefix_cache.insert_pages(parent, ptoks[start:start + bucket], ids,
                                                 nbytes=dst.kv.chunk_bytes(npg))
            if node is None:
                break
            if node.pages == tuple(ids):
                # a new node holds its own references (dropped at its
                # eviction); a deduplicated insert keeps the resident pages
                dst.kv.allocator.ref(ids)
            parent = node
            start += bucket
