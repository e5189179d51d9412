"""Prefix-affinity router over :class:`ServingEngine` replicas.

Port of :mod:`accelerate_tpu.serving.router`: N independent engines behind
one front door, on one card or several.  Tensor-parallel engines
(``ServingEngine(mesh=)``) route like any other when they share one mesh:
every rank runs the same router over its engines, and a handoff or a
migration moves each rank's own head shard (:mod:`.transfer`).  Their
failures raise on every rank instead of failing over (below).  Replicas
on disjoint meshes, a router over processes, and failover and the
breaker over mesh replicas are ROADMAP Queue 1 item 9e-ii f.  The routing decision is
where a fleet's win lands: each replica's prefix-cache radix tree holds the
KV of the prefixes *it* served, so a request routed to the replica that
holds its prefix reads cached KV instead of prefilling again, while a
round-robin placement scatters a shared prefix over every replica and pays
its prefill everywhere.

Policy ``"affinity"`` (default): the prompt's leading chunks are matched
against each replica's radix tree (:meth:`PrefixCache.match`, a host-side
walk, no device work, nothing pinned) and each replica scored by the
matched tokens; the best positive score wins, load breaking ties, and
zero scores fall back to the least-loaded replica.  ``"round_robin"`` is
the A/B baseline.

Policy ``"disaggregated"`` splits the fleet by :class:`ServingEngine` role:
new requests route (affinity-scored) to prefill-capable replicas only, and
once a ``role="prefill"`` replica's last prompt chunk lands the router
hands the lane off (its KV pages, block table, scales, pending token and
draw counter) to the least-loaded decode-capable replica through
:class:`~.transfer.PageMigrator`.  Decode continues bit-identically, greedy
or sampled.  The same machinery backs :meth:`migrate_lane` (live
rebalancing) and upgrades failover from replay to migration while a dying
replica's pages are still readable.

Failover: a replica refusing a ``submit`` with an
:class:`~.errors.AdmissionError` (queue backpressure, ``retriable=True``,
or a capacity refusal, ``retriable=False``) is skipped and the request tries
the others by load; the last refusal propagates only when every replica
refuses.  Matching is on the type, never on the message.  A replica whose
step raises, or that arrives poisoned (:meth:`ServingEngine.kill`), is
ejected: its lanes migrate off while its pages are readable (under the
disaggregated policy), and everything else it owed is replayed on
survivors by decode replay (:func:`.transfer.adopt`), token-exact under
greedy; it comes back through a half-open circuit breaker.

Elasticity: :meth:`add_replica`, :meth:`drain_replica` (no new requests;
what it accepted runs to completion, then :meth:`step` detaches it) and
:meth:`detach_replica`; each routed request carries a stable
``replica_id``.  :meth:`hot_swap` rolls new weights over the replicas one
at a time (pause admission, drain while the others serve,
:meth:`ServingEngine.swap_params`, resume): the swap copies in place into
the replica's own tensors, so each replica must hold its own copy of the
weights (``swap_params`` refuses storage another live engine serves,
before anything changes); ``serve.build_service`` builds them so.
``submit(..., model_version=)`` pins a request to one weights label.

Telemetry: ``serve/replicas`` (info), ``serve/router_affinity_hit_rate``
and one ``serve/route`` flight event per submit with the chosen replica and
its affinity score.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..telemetry import (
    MetricsRegistry,
    get_flight_recorder,
    get_registry,
    get_reqtrace,
)
from . import faults
from .engine import ServingEngine
from .errors import AdmissionError
from .pool import plan_chunks
from .scheduler import PlanDivergence, Request, RequestState
from .transfer import MigrationError, PageMigrator

_POLICIES = ("affinity", "round_robin", "disaggregated")


def mesh_ranks(engine) -> Optional[tuple]:
    """The ranks of a tensor-parallel engine's mesh (``None`` on one card)."""
    mesh = getattr(engine, "mesh", None)
    return None if mesh is None else tuple(int(r) for r in mesh.devices.reshape(-1))


def _check_one_mesh(engines: Sequence[ServingEngine]) -> None:
    """Replicas behind one router run on one card each, or all on one
    mesh; replicas on disjoint meshes (or a mesh beside single-card ones)
    need a router over processes: ``NotImplementedError``."""
    meshes = {mesh_ranks(e) for e in engines}
    if len(meshes) > 1:
        raise NotImplementedError(
            f"replicas on different meshes ({sorted(meshes, key=str)}): a router over "
            "processes is not ported yet: ROADMAP Queue 1 item 9e-ii f")


class ReplicaRouter:
    """Route :meth:`submit` calls across N engine replicas; aggregate health.

    Parameters
    ----------
    engines: the replicas.  Each owns its KV pool, scheduler and prefix
        cache; the router reads only each replica's host-side radix tree and
        queue depths (a migration moves pages through the engines).
    policy: ``"affinity"`` (prefix-cache affinity, least-loaded fallback),
        ``"round_robin"`` (the A/B baseline) or ``"disaggregated"``
        (prefill/decode roles with lane handoff).
    registry: metrics registry for the router's gauges (defaults to the
        process registry — pass the same private registry benches give their
        engines to keep arms isolated).
    """

    def __init__(
        self,
        engines: Sequence[ServingEngine],
        policy: str = "affinity",
        registry: Optional[MetricsRegistry] = None,
        breaker_base_s: float = 0.5,
        breaker_max_s: float = 30.0,
    ):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        _check_one_mesh(engines)
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        if policy == "disaggregated":
            roles = [getattr(e, "role", "both") for e in engines]
            if not any(r in ("prefill", "both") for r in roles):
                raise ValueError(
                    "disaggregated policy needs at least one prefill-capable "
                    f"replica (role 'prefill' or 'both'); got roles {roles}"
                )
            if not any(r in ("decode", "both") for r in roles):
                raise ValueError(
                    "disaggregated policy needs at least one decode-capable "
                    f"replica (role 'decode' or 'both'); got roles {roles}"
                )
            if not all(e.paged for e in engines):
                raise ValueError(
                    "disaggregated routing moves lanes between replicas as "
                    "KV pages; every replica needs paged=True"
                )
        self.engines: List[ServingEngine] = list(engines)
        # stable per-replica identities, parallel to ``engines``: positions
        # shift when an earlier replica detaches, ids never do
        self._ids: List[int] = list(range(len(self.engines)))
        self._next_id = len(self.engines)
        self._draining: set = set()  # stable ids not admitting new requests
        self.policy = policy
        self.metrics = registry if registry is not None else get_registry()
        self.recorder = get_flight_recorder().tagged(engine="router")
        self._rr_next = 0
        self._routed = 0
        self._affinity_hits = 0
        self._replicas_gauge = self.metrics.gauge(
            "serve/replicas",
            help="info gauge: engine replicas behind the ReplicaRouter",
        )
        self._replicas_gauge.set(float(len(self.engines)))
        self._affinity_gauge = self.metrics.gauge(
            "serve/router_affinity_hit_rate",
            help="fraction of routed requests whose chosen replica already "
                 "held a matching prefix in its radix tree",
        )
        # half-open circuit breaker over ejected replicas: replica_id ->
        # {"engine", "failures", "open_until"}.  While open, no traffic; once
        # ``open_until`` passes, one probe (revive + a step) either re-admits
        # the replica or doubles the backoff.
        self.breaker_base_s = float(breaker_base_s)
        self.breaker_max_s = float(breaker_max_s)
        self._breaker: Dict[int, dict] = {}
        self._ejections = 0
        self._ejections_counter = self.metrics.counter(
            "serve/replica_ejections_total",
            help="replicas ejected by the router supervisor after a poisoned "
                 "step (their in-flight requests replay on survivors)",
        )
        # lazy: built on first handoff/migration so routers that never move
        # a lane register no migration metrics
        self._migrator: Optional[PageMigrator] = None

    @property
    def migrator(self) -> PageMigrator:
        """The router's :class:`PageMigrator`, built on first use."""
        if self._migrator is None:
            self._migrator = PageMigrator(registry=self.metrics)
        return self._migrator

    @staticmethod
    def _prefill_capable(engine: ServingEngine) -> bool:
        return getattr(engine, "role", "both") in ("prefill", "both")

    @staticmethod
    def _decode_capable(engine: ServingEngine) -> bool:
        return getattr(engine, "role", "both") in ("decode", "both")

    # ------------------------------------------------------------- placement
    def _load(self, engine: ServingEngine) -> int:
        """Host-side load proxy: queued + mid-prefill + active lanes.  Under
        the pipelined engine loop (``async_depth=1``) the active count lags
        a finishing lane by one drain — at most one step of load skew per
        replica, in the conservative (over-counting) direction."""
        return engine.scheduler.queue_depth + int(engine._active.sum())

    def _affinity(self, engine: ServingEngine, prompt: np.ndarray) -> int:
        """Tokens of ``prompt`` this replica's radix tree already holds —
        a read-only walk over full leading chunks (LRU touch only; nothing
        is pinned until the engine's own admission runs)."""
        if engine.prefix_cache is None:
            return 0
        chunks = plan_chunks(len(prompt), engine.buckets)
        nodes = engine.prefix_cache.match(prompt, chunks)
        return sum(len(n.tokens) for n in nodes)

    def _admittable(self, model_version: Optional[str] = None) -> List[int]:
        """Replica indices routing may place NEW requests on: not draining,
        — when the caller pinned a ``model_version`` — serving exactly that
        weights label, and, under the disaggregated policy, prefill-capable
        (every new request prefills before it decodes; decode-only replicas
        receive their lanes by migration, never by submit)."""
        return [
            i for i in range(len(self.engines))
            if self._ids[i] not in self._draining
            and (model_version is None
                 or self.engines[i].weights_version == model_version)
            and (self.policy != "disaggregated"
                 or self._prefill_capable(self.engines[i]))
        ]

    def _choose(self, prompt: np.ndarray, candidates: Sequence[int]) -> tuple:
        """``(replica_index, affinity_score)`` under the configured policy,
        restricted to ``candidates`` (admittable indices)."""
        if self.policy == "round_robin":
            i = candidates[self._rr_next % len(candidates)]
            self._rr_next += 1
            return i, 0
        scores = {i: self._affinity(self.engines[i], prompt) for i in candidates}
        best = max(scores.values())
        if best > 0:
            # highest score wins; load breaks ties among equals
            tied = [i for i, sc in scores.items() if sc == best]
            i = min(tied, key=lambda i: self._load(self.engines[i]))
            return i, best
        i = min(candidates, key=lambda i: self._load(self.engines[i]))
        return i, 0

    # ------------------------------------------------------------ submission
    def submit(
        self,
        prompt,
        config=None,
        on_token: Optional[Callable[[Request, int], None]] = None,
        model_version: Optional[str] = None,
        **kwargs: Any,
    ) -> Request:
        """Route one request to a replica and queue it there.  The returned
        :class:`Request` carries ``replica`` — the index it landed on — and
        ``replica_id`` — its stable identity — so callers can drive or cancel
        against the right engine even after an earlier replica detaches.
        ``model_version`` pins the request to replicas serving that weights
        label (the A/B knob); ``None`` routes across every version."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        candidates = self._admittable(model_version)
        if not candidates:
            # every replica is draining (or none serves the pinned version):
            # retriable iff capacity could come back without client changes
            raise AdmissionError(
                f"no admittable replica"
                + (f" serving model version {model_version!r}"
                   if model_version is not None else "")
                + f" ({len(self.engines)} attached, "
                  f"{len(self._draining)} draining)",
                retriable=model_version is None,
            )
        idx, score = self._choose(prompt, candidates)
        # failover ladder: chosen replica first, then the rest by load
        order = [idx] + sorted(
            (i for i in candidates if i != idx),
            key=lambda i: self._load(self.engines[i]),
        )
        last_err: Optional[Exception] = None
        for n_try, i in enumerate(order):
            try:
                req = self.engines[i].submit(
                    prompt, config=config, on_token=on_token, **kwargs
                )
            except AdmissionError as exc:
                last_err = exc
                continue
            req.replica = i
            req.replica_id = self._ids[i]
            self._routed += 1
            if i == idx and score > 0:
                self._affinity_hits += 1
            self._affinity_gauge.set(self._affinity_hits / self._routed)
            self.recorder.record(
                "serve/route", rid=req.rid, replica=i, affinity=int(score),
                policy=self.policy, failover=n_try,
            )
            return req
        raise last_err  # every replica refused; surface the final reason

    def cancel(self, request) -> bool:
        """Cancel on whichever replica holds the request.  Resolution order:
        the stable ``replica_id`` (survives detach re-indexing; a request
        whose replica already detached is necessarily finished — drain waits
        for it — so that cancel is simply False), then the positional
        ``replica`` index, then a full scan."""
        rid = getattr(request, "replica_id", None)
        if rid is not None:
            if rid not in self._ids:
                return False  # its replica drained + detached: request done
            return self.engines[self._ids.index(rid)].cancel(request)
        idx = getattr(request, "replica", None)
        if idx is not None and 0 <= idx < len(self.engines):
            return self.engines[idx].cancel(request)
        return any(e.cancel(request) for e in self.engines)

    # ------------------------------------------------------------- elasticity
    def replica_ids(self) -> List[int]:
        """Stable ids of the attached replicas, in ``engines`` order."""
        return list(self._ids)

    def add_replica(self, engine: ServingEngine) -> int:
        """Attach a freshly built replica; it is admittable immediately.
        Returns its stable replica id."""
        _check_one_mesh([*self.engines, engine])
        self.engines.append(engine)
        rid = self._next_id
        self._next_id += 1
        self._ids.append(rid)
        self._replicas_gauge.set(float(len(self.engines)))
        self.recorder.record(
            "serve/replica_add", replica_id=rid, replicas=len(self.engines),
            weights_version=engine.weights_version,
        )
        return rid

    def drain_replica(self, replica_id: int) -> None:
        """Stop routing NEW requests to ``replica_id``.  Everything it
        already accepted — running lanes AND its queue — runs to completion
        under the normal drive; once idle, :meth:`step` detaches it.  At
        least one replica must stay admitting (drain the front door itself
        by shutting the server down, not by starving the router)."""
        if replica_id not in self._ids:
            raise ValueError(f"unknown replica id {replica_id}")
        remaining = [i for i in self._ids if i not in self._draining]
        if remaining == [replica_id]:
            raise ValueError(
                "cannot drain the last admitting replica; add_replica a "
                "successor first"
            )
        self._draining.add(replica_id)
        self.recorder.record(
            "serve/replica_drain", replica_id=replica_id,
            queue_depth=self.engines[self._ids.index(replica_id)]
            .scheduler.queue_depth,
        )

    def detach_replica(self, replica_id: int) -> ServingEngine:
        """Remove an idle replica and return its engine (callers may keep it
        warm for re-attach).  Raises if it still has work — use
        :meth:`drain_replica` + the drive loop to get it idle first."""
        if replica_id not in self._ids:
            raise ValueError(f"unknown replica id {replica_id}")
        i = self._ids.index(replica_id)
        engine = self.engines[i]
        if engine.has_work:
            raise RuntimeError(
                f"replica {replica_id} still has work "
                f"(queue={engine.scheduler.queue_depth}); drain it first"
            )
        del self.engines[i]
        del self._ids[i]
        self._draining.discard(replica_id)
        self._replicas_gauge.set(float(len(self.engines)))
        self.recorder.record(
            "serve/replica_detach", replica_id=replica_id,
            replicas=len(self.engines),
        )
        return engine

    def _reap_drained(self) -> None:
        """Detach every draining replica that has gone idle."""
        for rid in [r for r in self._ids if r in self._draining]:
            if not self.engines[self._ids.index(rid)].has_work:
                self.detach_replica(rid)

    def hot_swap(self, params: Any, version: Optional[str] = None,
                 max_steps: int = 100_000, step_fn=None) -> int:
        """Rolling zero-downtime weight swap: every attached replica, one at
        a time, pauses admission, drains its lanes while the OTHER replicas
        keep serving (its own queued requests merely wait and then decode
        under the new weights), copies ``params`` into it through
        :meth:`ServingEngine.swap_params` (prefix cache flushed, no graph
        captured again), and resumes.  No in-flight request is failed or
        served by a mixture of weight versions.  ``step_fn`` (default
        :meth:`step`) is called while waiting for each drain — the HTTP
        front door passes a hook that also keeps servicing its submit inbox.
        Returns the number of replicas swapped."""
        step_fn = step_fn if step_fn is not None else self.step
        swapped = 0
        for rid in list(self._ids):
            if rid not in self._ids or rid in self._draining:
                continue  # detached or draining mid-rollout: skip
            engine = self.engines[self._ids.index(rid)]
            engine.pause_admission()
            try:
                steps = 0
                while not engine.drained:
                    step_fn()
                    steps += 1
                    if steps > max_steps:
                        raise RuntimeError(
                            f"replica {rid} did not drain in {max_steps} steps"
                        )
                engine.swap_params(params, version=version)
                swapped += 1
            finally:
                engine.resume_admission()
        return swapped

    def versions(self) -> dict:
        """``weights_version -> replica count`` over attached replicas (the
        ``/v1/models`` surface)."""
        out: dict = {}
        for e in self.engines:
            out[e.weights_version] = out.get(e.weights_version, 0) + 1
        return out

    # ------------------------------------------------------- lane migration
    def _pick_migration_dst(
        self, src: ServingEngine
    ) -> Optional[ServingEngine]:
        """Least-loaded decode-capable replica whose pool geometry matches
        ``src``'s, or None when nothing can receive a lane right now."""
        cands = [
            e for e in self.engines
            if e is not src and e._poisoned is None
            and self._decode_capable(e)
            and self.migrator.compatible(src, e) is None
        ]
        if not cands:
            return None
        return min(cands, key=self._load)

    def _fallback_replay(self, src: ServingEngine, req: Request) -> None:
        """Migration's non-retriable fallback: retire the lane on ``src``
        and replay the request on a survivor by decode replay, the
        export/adopt path for one lane.  Greedy lanes stay token-exact;
        sampled lanes resume re-seeded."""
        if req.slot is not None and src._slot_req[req.slot] is req:
            src._retire_lane(req.slot)
        if src.prefix_cache is not None and req.cache_nodes:
            src.prefix_cache.release(req.cache_nodes)
        req.cache_nodes = []
        req.cached_chunks = 0
        req.cache_chain_broken = False
        req.chunks = ()
        req.next_chunk = 0
        req.slot = None
        req.state = RequestState.QUEUED
        self._replay_one(req)

    def _sweep_handoffs(self) -> None:
        """Disaggregated steady state: every installed lane on a
        ``role="prefill"`` replica has its last prompt chunk landed (install
        happens only then) and is waiting to decode somewhere else — hand
        each off to the least-loaded decode-capable replica.  Destination
        pressure (retriable :class:`MigrationError`) leaves the lane in
        place for the next sweep; a non-retriable failure falls back to
        single-lane replay so no request ever strands on a replica that
        will never decode it."""
        for src in list(self.engines):
            if getattr(src, "role", "both") != "prefill":
                continue
            for s in range(src.num_slots):
                req = src._slot_req[s]
                if req is None or req.state is not RequestState.RUNNING:
                    continue
                dst = self._pick_migration_dst(src)
                if dst is None:
                    return  # no decode capacity anywhere; retry next step
                try:
                    self.migrator.handoff(src, dst, s)
                except MigrationError as exc:
                    if exc.retriable:
                        continue
                    self._fallback_replay(src, req)
                else:
                    i = self.engines.index(dst)
                    req.replica = i
                    req.replica_id = self._ids[i]

    def migrate_lane(
        self,
        from_replica: Optional[int] = None,
        to_replica: Optional[int] = None,
        slot: Optional[int] = None,
        reason: str = "rebalance",
    ) -> bool:
        """Live rebalancing: move one running lane between replicas without
        interrupting its generation.  Replicas are named by stable id
        (:meth:`replica_ids`).  Defaults pick the move a rebalancer wants:
        the hottest source (by queued + active load, among replicas with a
        running lane), its youngest lane (highest rid — least sunk decode
        work behind it), and the coldest compatible decode-capable
        destination.  Returns True when the lane left the source — migrated
        bit-identically, or (non-retriable failure) replayed token-exact
        under greedy; False when nothing could move (no source lane, no
        destination, or a retriable refusal worth retrying later)."""
        if from_replica is not None:
            if from_replica not in self._ids:
                raise ValueError(f"unknown replica id {from_replica}")
            src = self.engines[self._ids.index(from_replica)]
        else:
            hot = [e for e in self.engines
                   if any(r is not None and r.state is RequestState.RUNNING
                          for r in e._slot_req)]
            if not hot:
                return False
            src = max(hot, key=self._load)
        if slot is None:
            running = [(s, r) for s, r in enumerate(src._slot_req)
                       if r is not None and r.state is RequestState.RUNNING]
            if not running:
                return False
            slot = max(running, key=lambda sr: sr[1].rid)[0]
        req = src._slot_req[slot]
        if req is None:
            return False
        if to_replica is not None:
            if to_replica not in self._ids:
                raise ValueError(f"unknown replica id {to_replica}")
            dst = self.engines[self._ids.index(to_replica)]
        else:
            dst = self._pick_migration_dst(src)
            if dst is None:
                return False
        try:
            self.migrator.migrate(src, dst, slot, reason=reason)
        except MigrationError as exc:
            if exc.retriable:
                return False
            self._fallback_replay(src, req)
            return True
        i = self.engines.index(dst)
        req.replica = i
        req.replica_id = self._ids[i]
        return True

    # -------------------------------------------------------- fault recovery
    def _migrate_off(self, engine: ServingEngine) -> None:
        """Failover upgrade (disaggregated policy): while the dying
        replica's pages are still readable, move its RUNNING lanes to
        survivors bit-identically instead of replaying them.  The first
        failure of any kind aborts the remaining attempts — a replica that
        cannot be read coherently falls back to export/replay for
        everything still on it (the lanes it keeps stay untouched, so the
        fallback sees them exactly as a plain ejection would)."""
        for s in range(engine.num_slots):
            req = engine._slot_req[s]
            if req is None or req.state is not RequestState.RUNNING:
                continue
            dst = self._pick_migration_dst(engine)
            if dst is None:
                return
            try:
                self.migrator.migrate(engine, dst, s, reason="failover")
            except Exception as exc:
                # the dying replica could not be read coherently (or the
                # destination refused): record it and let the caller's
                # export/replay pass take everything still on the engine
                self.recorder.record(
                    "serve/migrate_failover_abort", slot=s, error=repr(exc),
                )
                return
            i = self.engines.index(dst)
            req.replica = i
            req.replica_id = self._ids[i]

    def _eject_and_replay(self, engine: ServingEngine, exc: BaseException) -> None:
        """Remove a dead replica and replay everything it owed on survivors.

        The replica's in-flight requests (:meth:`ServingEngine.
        export_inflight`: running lanes, mid-prefill, queued) are adopted by
        surviving replicas at the FRONT of their queues, least-loaded first,
        by decode replay: greedy lanes resume token-exact, sampled lanes
        re-seeded.  A request no survivor can fit (geometry
        refusal) is CANCELLED — its stream closes rather than hangs.  The
        dead engine parks behind the half-open circuit breaker; once the
        backoff expires, :meth:`_probe_breaker` revives and re-admits it."""
        if engine not in self.engines:
            return
        i = self.engines.index(engine)
        replica_id = self._ids[i]
        if self.policy == "disaggregated" and len(self.engines) > 1:
            # failover upgrade: lanes whose pages are still readable migrate
            # bit-identically; export_inflight below picks up only what the
            # migration pass could not move
            self._migrate_off(engine)
        exported = engine.export_inflight()
        del self.engines[i]
        del self._ids[i]
        self._draining.discard(replica_id)
        self._replicas_gauge.set(float(len(self.engines)))
        self._ejections += 1
        self._ejections_counter.inc()
        self.recorder.record(
            "serve/failover", replica_id=replica_id, error=repr(exc),
            inflight=len(exported), replicas_left=len(self.engines),
        )
        self._breaker[replica_id] = {
            "engine": engine,
            "failures": 0,
            "open_until": time.monotonic() + self.breaker_base_s,
        }
        # newest first: each appendleft lands in front of the previous one,
        # so per-survivor queue order ends up oldest-rid-first (FCFS intact)
        for req in reversed(exported):
            self._replay_one(req)

    def _replay_one(self, req: Request) -> None:
        pool = range(len(self.engines))
        if self.policy == "disaggregated":
            # replays prefill then decode on the adopting engine, so the
            # adopter must be decode-capable (decode-role replicas prefill
            # adopted replays: role shapes steady-state routing, not
            # recovery); prefill-only replicas can never finish the request
            capable = [i for i in pool
                       if self._decode_capable(self.engines[i])]
            pool = capable if capable else pool
        survivors = sorted(
            pool, key=lambda i: self._load(self.engines[i])
        )
        last_err: Optional[Exception] = None
        for i in survivors:
            try:
                self.engines[i].adopt(req)
            except AdmissionError as exc:
                last_err = exc
                continue
            req.replica = i
            req.replica_id = self._ids[i]
            self.recorder.record(
                "serve/replay", rid=req.rid, replica=i,
                generated=len(req.tokens),
            )
            return
        req.state = RequestState.CANCELLED
        req.deadline_exceeded = False
        if req.trace is not None:
            req.trace.annotate(
                "replay_failed",
                error=repr(last_err) if last_err is not None else "no survivors",
            )
            get_reqtrace().complete(req.trace, status="error")
        self.recorder.record(
            "serve/replay_failed", rid=req.rid,
            error=repr(last_err) if last_err is not None else "no survivors",
        )

    def _probe_breaker(self) -> None:
        """Half-open probe: for every ejected replica whose backoff expired,
        try ``revive()`` + one step.  Success re-admits it as a fresh replica
        (new stable id); failure doubles the backoff up to ``breaker_max_s``."""
        if not self._breaker:
            return
        now = time.monotonic()
        for replica_id in [r for r, b in self._breaker.items()
                           if now >= b["open_until"]]:
            entry = self._breaker[replica_id]
            engine = entry["engine"]
            try:
                engine.revive()
                engine.step()  # one idle probe step proves it can run
            except Exception as exc:
                entry["failures"] += 1
                entry["open_until"] = now + min(
                    self.breaker_max_s,
                    self.breaker_base_s * 2 ** entry["failures"],
                )
                self.recorder.record(
                    "serve/breaker_open", replica_id=replica_id,
                    failures=entry["failures"], error=repr(exc),
                )
                continue
            del self._breaker[replica_id]
            new_id = self.add_replica(engine)
            self.recorder.record(
                "serve/breaker_close", replica_id=replica_id, new_id=new_id,
                failures=entry["failures"],
            )

    # ----------------------------------------------------------------- drive
    @property
    def has_work(self) -> bool:
        # a due breaker probe is work: the drive loop must keep stepping so
        # an ejected replica gets its re-admission attempt even when idle
        if any(e.has_work for e in self.engines):
            return True
        now = time.monotonic()
        return any(now >= b["open_until"] for b in self._breaker.values())

    def step(self) -> None:
        """One iteration of every replica that has work (a round-robin drive
        on one thread: the front door's driver thread, tests and benches).
        Each replica runs its own depth-1 pipeline (``async_depth=1``): with
        a window in flight on replica A, the drive dispatches replica B's
        window while A's runs on the card; ``has_work`` holds until every
        replica's pipeline has drained (a window in flight is work).

        Supervision rides the same loop: a replica whose step raises — or
        that arrives already poisoned (:meth:`ServingEngine.kill`) — is
        ejected and its in-flight requests replay on survivors; ejected
        replicas re-admit through the half-open circuit breaker.  A
        tensor-parallel replica raises instead (:meth:`_step_mesh_replica`)."""
        if (faults.ACTIVE is not None and len(self.engines) > 1
                and faults.ACTIVE.fire("replica_kill")):
            # kill the busiest replica — the worst case for replay
            victim = max(self.engines, key=lambda e: int(e._active.sum()))
            victim.kill("injected replica kill")
        for engine in list(self.engines):
            if engine not in self.engines:
                continue  # ejected earlier this very step
            if engine.mesh is not None:
                self._step_mesh_replica(engine)
                continue
            if engine._poisoned is not None:
                self._eject_and_replay(engine, engine._poisoned)
                continue
            if not engine.has_work:
                continue
            try:
                engine.step()
            except Exception as exc:
                self._eject_and_replay(engine, exc)
        if self.policy == "disaggregated":
            # after the replicas stepped: any lane whose final prompt chunk
            # just landed on a prefill replica moves to a decode replica now,
            # so its first decode window dispatches next step
            self._sweep_handoffs()
        self._reap_drained()
        self._probe_breaker()

    def _step_mesh_replica(self, engine: ServingEngine) -> None:
        """Step a tensor-parallel replica alike on every rank: it steps when
        it has work (host state every rank shares, a parked error aside),
        and its plan exchange raises :class:`.scheduler.PlanDivergence` on
        every rank when one rank's plan, or an error parked on one rank,
        departs; that is re-raised.  Ejecting it, replaying its requests and
        re-admitting it on the breaker's clock would have to agree across
        the ranks: any other error raises ``NotImplementedError`` (ROADMAP
        Queue 1 item 9e-ii f), from the error."""
        if not engine.has_work:
            return
        try:
            engine.step()
        except PlanDivergence:
            raise
        except Exception as exc:
            raise NotImplementedError(
                f"tensor-parallel replica {self._ids[self.engines.index(engine)]} (ranks "
                f"{mesh_ranks(engine)}) failed with {exc!r}: failing a mesh replica over is "
                "not ported yet: ROADMAP Queue 1 item 9e-ii f") from exc

    def run(self, max_steps: Optional[int] = None) -> None:
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"router did not drain in {max_steps} steps")

    def serve(self, prompts: Sequence, configs=None) -> List[Request]:
        """Submit every prompt through the router, drain all replicas, return
        the requests in submission order."""
        reqs = []
        for i, p in enumerate(prompts):
            cfg = configs[i] if isinstance(configs, (list, tuple)) else configs
            reqs.append(self.submit(p, config=cfg))
        self.run()
        return reqs

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Sum of every replica's ``stats`` dict, plus router counters and a
        fleet-wide per-tenant rollup (each tenant's counters summed across
        replicas — failover replays land on the adopting engine, so only the
        cross-replica sum is the caller's true account)."""
        out: dict = {}
        for e in self.engines:
            for k, v in e.stats.items():
                out[k] = out.get(k, 0) + v
        out["routed"] = self._routed
        out["affinity_hits"] = self._affinity_hits
        tenants: dict = {}
        for e in self.engines:
            for tenant, counts in getattr(e, "_tenant_stats", {}).items():
                agg = tenants.setdefault(tenant, {})
                for k, v in counts.items():
                    agg[k] = agg.get(k, 0) + v
        if tenants:
            out["tenants"] = tenants
        return out

    def prefix_cache_stats(self) -> dict:
        """Aggregate prefix-cache health across replicas (token-weighted
        hit rate — the router A/B's headline number)."""
        hit = sum(e.stats["prefix_hit_tokens"] for e in self.engines)
        miss = sum(e.stats["prefix_miss_tokens"] for e in self.engines)
        covered = hit + miss
        return {
            "prefix_hit_tokens": hit,
            "prefix_miss_tokens": miss,
            "hit_rate": hit / covered if covered else 0.0,
            "per_replica": [e.prefix_cache_stats() for e in self.engines],
        }

    def health(self) -> dict:
        """One snapshot a front door can poll: per-replica queue/occupancy
        plus the router's routing counters."""
        now = time.monotonic()
        return {
            "replicas": len(self.engines),
            "policy": self.policy,
            "routed": self._routed,
            "affinity_hit_rate": (
                self._affinity_hits / self._routed if self._routed else 0.0
            ),
            "ejections": self._ejections,
            "breaker": [
                {
                    "replica_id": r,
                    "failures": b["failures"],
                    "retry_in_s": max(b["open_until"] - now, 0.0),
                }
                for r, b in self._breaker.items()
            ],
            "versions": self.versions(),
            "per_replica": [
                {
                    "replica_id": self._ids[i],
                    "queue_depth": e.scheduler.queue_depth,
                    "active_lanes": int(e._active.sum()),
                    "role": getattr(e, "role", "both"),
                    "tp_degree": e.tp_degree,
                    "has_work": e.has_work,
                    "draining": self._ids[i] in self._draining,
                    "admission_paused": e.admission_paused,
                    "weights_version": e.weights_version,
                }
                for i, e in enumerate(self.engines)
            ],
        }


__all__ = ["ReplicaRouter"]
