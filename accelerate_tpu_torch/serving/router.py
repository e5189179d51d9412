"""Prefix-affinity router over :class:`ServingEngine` replicas.

Port of :mod:`accelerate_tpu.serving.router`: N independent engines behind
one front door, on one card or several.  The routing decision is where a
fleet's win lands: each replica's prefix-cache radix tree holds the KV of
the prefixes *it* served, so a request routed to the replica that holds its
prefix reads cached KV instead of prefilling again, while a round-robin
placement scatters a shared prefix over every replica and pays its prefill
everywhere.

Across processes (the port runs one process a card, ``launchers.py``): the
replicas are tensor-parallel engines (``ServingEngine(mesh=)``) on one mesh
that every rank holds, or on disjoint rank groups
(:func:`~accelerate_tpu_torch.parallel.mesh.replica_meshes`: 2 x tp2 on
four ranks, or a tp2 mesh beside single-rank ones).  Every rank then builds
the same router over the same list of replicas, giving the engine of each
replica it serves and the mesh of each replica it does not
(:class:`~.remote.RemoteReplica` stands in for those), and makes the same
``submit``/``cancel``/``step``/``serve`` calls.  Each decision a host makes
is made on every rank from data every rank holds: a replica's lead rank
reports its affinity scores and load for a submit, and after each step its
load, its tokens, its finished and cancelled requests and its failure, over
the world's gloo group (:mod:`.remote`); the breaker reads the world's first
rank's clock.  So every rank routes alike, ejects the same replica at the
same step, replays its requests on the same survivors and re-admits it at
the same probe, and ``serve`` returns every request's tokens on every rank.
A lane moves between replicas on disjoint ranks through the host
(:meth:`.transfer.PageMigrator.migrate_across`).  A rank whose plan departs
from its replica's, or that alone holds an error, raises
:class:`~.scheduler.PlanDivergence` on every rank.

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
import torch.distributed as dist

from ..parallel.mesh import Mesh
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
from .remote import (
    RemoteReplica,
    World,
    apply_report,
    describe,
    mirror_request,
    replica_ranks,
    report_line,
    snapshot,
)
from .scheduler import PlanDivergence, Request, RequestState
from .transfer import MigrationError, PageMigrator, geometry_mismatch

_POLICIES = ("affinity", "round_robin", "disaggregated")

_TERMINAL = (RequestState.DONE, RequestState.CANCELLED)


def _over_processes(entries) -> bool:
    """Whether a router over ``entries`` spans processes: a process group
    of several ranks, and a replica on a mesh (or a mesh standing in for
    one that other ranks serve)."""
    if not any(isinstance(e, Mesh) or getattr(e, "mesh", None) is not None for e in entries):
        return False
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        if any(isinstance(e, Mesh) for e in entries):
            raise ValueError("a Mesh stands for a replica other ranks serve: a router over "
                             "processes needs a process group (launchers.py)")
        return False
    return True


class ReplicaRouter:
    """Route :meth:`submit` calls across N engine replicas; aggregate health.

    Parameters
    ----------
    engines: the replicas.  Each owns its KV pool, scheduler and prefix
        cache; the router reads only each replica's host-side radix tree and
        queue depths (a migration moves pages through the engines).  Over
        processes, every rank passes the same list in the same order: the
        engine of each replica this rank serves, the
        :class:`~accelerate_tpu_torch.parallel.mesh.Mesh` of each one it
        does not.
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
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        #: over processes: the world's host exchange (None in one process)
        self._world: Optional[World] = World() if _over_processes(engines) else None
        # over processes: each replica's description and its lead's last
        # snapshot (by stable id), every routed request still running (by
        # route id) and the replica it is on
        self._desc: Dict[int, dict] = {}
        self._snap: Dict[int, dict] = {}
        self._reqs: Dict[int, Request] = {}
        self._where: Dict[int, int] = {}
        self._seq = 0
        #: the world's first rank's clock, exchanged each step (over processes)
        self._world_now = 0.0
        entries = list(engines)
        if self._world is not None:
            entries, descs = self._attach_world(entries)
        if policy == "disaggregated":
            roles = [getattr(e, "role", "both") for e in entries]
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
            if not all(e.paged for e in entries):
                raise ValueError(
                    "disaggregated routing moves lanes between replicas as "
                    "KV pages; every replica needs paged=True"
                )
        self.engines: List[ServingEngine] = entries
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
        if self._world is not None:
            self._desc = dict(enumerate(descs))
            self._exchange_snapshots(list(self._ids))

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

    # ------------------------------------------------------ across processes
    def _attach_world(self, entries: list) -> tuple:
        """Check that every rank passed the same replicas (an engine where it
        serves one, its mesh elsewhere) and learn each replica's description
        from its lead; the entries with a :class:`RemoteReplica` in each
        other rank's replica's place.  Every rank raises alike."""
        me = self._world.rank
        ranks = [replica_ranks(e, me) for e in entries]
        kinds = ["mesh" if isinstance(e, Mesh) else "engine" for e in entries]
        descs = {i: describe(e) for i, e in enumerate(entries)
                 if kinds[i] == "engine" and ranks[i][0] == me}
        got = self._world.gather((ranks, kinds, descs))
        layout = got[0][0]
        if any(g[0] != layout for g in got):
            raise ValueError("the ranks passed different replicas to ReplicaRouter: "
                             f"{[g[0] for g in got]}")
        for r, (_, kind, _) in enumerate(got):
            for i, members in enumerate(layout):
                if (kind[i] == "engine") != (r in members):
                    raise ValueError(
                        f"rank {r} passed {'an engine' if kind[i] == 'engine' else 'a mesh'} "
                        f"for replica {i} on ranks {list(members)}: each rank passes the engine "
                        "of the replicas it serves and the mesh of the others")
        for i, a in enumerate(layout):
            for b in layout[i + 1:]:
                if a != b and set(a) & set(b):
                    raise ValueError(f"replicas on ranks {list(a)} and {list(b)} overlap: "
                                     "replicas share a mesh or are disjoint (replica_meshes)")
        merged = {}
        for _, _, d in got:
            merged.update(d)
        out = [RemoteReplica(layout[i], merged[i]) if kinds[i] == "mesh" else e
               for i, e in enumerate(entries)]
        return out, [merged[i] for i in range(len(entries))]

    def _local(self, engine) -> bool:
        return not isinstance(engine, RemoteReplica)

    def _lead(self, engine) -> int:
        return replica_ranks(engine, self._world.rank)[0]

    def _sid(self, engine) -> int:
        return self._ids[self.engines.index(engine)]

    def _owned(self, sid: int) -> Dict[int, Request]:
        return {rt: self._reqs[rt] for rt, where in sorted(self._where.items())
                if where == sid}

    def _agree(self, engine, fn: Callable[[Any], Any]) -> Any:
        """``fn(engine)`` on the ranks serving ``engine``; its result, or
        the :class:`AdmissionError` / :class:`MigrationError` it raised
        (anything else as a ``RuntimeError``), on every rank, as the
        replica's lead saw it.  Results must pickle."""
        out = None
        if self._local(engine):
            try:
                out = ("ok", fn(engine))
            except AdmissionError as exc:
                out = ("admission", str(exc), exc.queue_depth, exc.retry_after_s,
                       exc.retriable)
            except MigrationError as exc:
                out = ("migration", exc.reason, exc.retriable)
            except Exception as exc:  # noqa: BLE001 (re-raised on every rank)
                out = ("error", repr(exc))
        out = self._world.bcast(out, src=self._lead(engine))
        if out[0] == "admission":
            raise AdmissionError(out[1], queue_depth=out[2], retry_after_s=out[3],
                                 retriable=out[4])
        if out[0] == "migration":
            raise MigrationError(out[1], retriable=out[2])
        if out[0] == "error":
            raise RuntimeError(f"replica on ranks {list(replica_ranks(engine, 0))}: {out[1]}")
        return out[1]

    def _apply_snapshot(self, sid: int, snap: dict) -> None:
        """A lead's snapshot of replica ``sid``, on every rank: its state,
        and its requests' new tokens and states (mirrors take them)."""
        self._snap[sid] = snap
        engine = self.engines[self._ids.index(sid)]
        for rt, line in snap["reqs"].items():
            req = self._reqs.get(rt)
            if req is None:
                continue
            apply_report(req, line, self._local(engine))
            if req.state in _TERMINAL:
                del self._reqs[rt]
                del self._where[rt]

    def _exchange_snapshots(self, sids: Sequence[int]) -> None:
        """Every listed replica's lead snapshot, on every rank."""
        mine = {}
        for sid in sids:
            e = self.engines[self._ids.index(sid)]
            if self._local(e) and self._lead(e) == self._world.rank:
                mine[sid] = snapshot(e, self._owned(sid))
        for sid, snaps in self._world.merge(mine).items():
            self._apply_snapshot(sid, snaps[0])

    def _sync_tokens(self, engine, reqs: Sequence[Request]) -> None:
        """The tokens a replica's ranks hold of ``reqs`` beyond the last
        report (a source's drain lands some), on every rank."""
        lines = self._agree(engine, lambda e: {r.route_id: report_line(r) for r in reqs})
        for r in reqs:
            apply_report(r, lines[r.route_id], self._local(engine))
            if r.state in _TERMINAL:
                self._reqs.pop(r.route_id, None)
                self._where.pop(r.route_id, None)

    def _bump(self, engine, load: int) -> None:
        """The snapshot of a replica that just took (``load`` 1) or gave up
        (-1) a request: its load, and work that the next step must see."""
        snap = self._snap[self._sid(engine)]
        snap["load"] += load
        snap["queue_depth"] += max(load, 0)
        if load > 0:
            snap["has_work"], snap["drained"] = True, False

    def _running(self, engine) -> list:
        """``(slot, request)`` of each running lane of a replica."""
        if self._world is None:
            return [(s, r) for s, r in enumerate(engine._slot_req)
                    if r is not None and r.state is RequestState.RUNNING]
        return [(s, self._reqs[rt]) for s, rt in self._snap[self._sid(engine)]["running"]
                if rt in self._reqs]

    # ------------------------------------------------------------- placement
    def _load(self, engine: ServingEngine) -> int:
        """Host-side load proxy: queued + mid-prefill + active lanes.  Under
        the pipelined engine loop (``async_depth=1``) the active count lags
        a finishing lane by one drain — at most one step of load skew per
        replica, in the conservative (over-counting) direction.  Over
        processes, the lead's last report."""
        if self._world is not None:
            return self._snap[self._sid(engine)]["load"]
        return engine.scheduler.queue_depth + int(engine._active.sum())

    def _has_work(self, engine) -> bool:
        if self._world is not None:
            return self._snap[self._sid(engine)]["has_work"]
        return engine.has_work

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

    def _scores(self, prompt: np.ndarray, candidates: Sequence[int]) -> tuple:
        """``({index: affinity}, {index: load})`` over ``candidates``.  Over
        processes every rank serving a replica walks its tree (the walk
        touches the LRU, which its ranks keep alike) and the leads' numbers
        go round."""
        if self._world is None:
            scores = ({i: self._affinity(self.engines[i], prompt) for i in candidates}
                      if self.policy != "round_robin" else {i: 0 for i in candidates})
            return scores, {i: self._load(self.engines[i]) for i in candidates}
        me = self._world.rank
        mine = {}
        for i in candidates:
            e = self.engines[i]
            if self._local(e):
                score = self._affinity(e, prompt) if self.policy != "round_robin" else 0
                mine[i] = (me, score, e.scheduler.queue_depth + int(e._active.sum()))
        got = self._world.merge(mine)
        lead = {i: next(v for v in got[i] if v[0] == self._lead(self.engines[i]))
                for i in candidates}
        return {i: v[1] for i, v in lead.items()}, {i: v[2] for i, v in lead.items()}

    def _choose(self, candidates: Sequence[int], scores: dict, loads: dict) -> tuple:
        """``(replica_index, affinity_score)`` under the configured policy,
        restricted to ``candidates`` (admittable indices)."""
        if self.policy == "round_robin":
            i = candidates[self._rr_next % len(candidates)]
            self._rr_next += 1
            return i, 0
        best = max(scores.values())
        if best > 0:
            # highest score wins; load breaks ties among equals
            tied = [i for i, sc in scores.items() if sc == best]
            i = min(tied, key=lambda i: loads[i])
            return i, best
        i = min(candidates, key=lambda i: loads[i])
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
        label (the A/B knob); ``None`` routes across every version.  Over
        processes every rank gets a request: the engine's where this rank
        serves its replica, else a mirror that the steps fill in."""
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
        scores, loads = self._scores(prompt, candidates)
        idx, score = self._choose(candidates, scores, loads)
        # failover ladder: chosen replica first, then the rest by load
        order = [idx] + sorted((i for i in candidates if i != idx), key=lambda i: loads[i])
        last_err: Optional[Exception] = None
        for n_try, i in enumerate(order):
            engine = self.engines[i]
            try:
                req = self._submit_to(engine, prompt, config, on_token, kwargs)
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

    def _submit_to(self, engine, prompt, config, on_token, kwargs) -> Request:
        """One replica's ``submit``; over processes, agreed on every rank,
        with the request tracked by its route id."""
        if self._world is None:
            return engine.submit(prompt, config=config, on_token=on_token, **kwargs)
        box = {}

        def go(e):
            box["req"] = e.submit(prompt, config=config, on_token=on_token, **kwargs)
            return box["req"].rid

        rid = self._agree(engine, go)
        req = box.get("req") or mirror_request(rid, prompt, config, on_token, **kwargs)
        req.route_id = self._seq
        self._seq += 1
        self._reqs[req.route_id] = req
        self._where[req.route_id] = self._sid(engine)
        self._bump(engine, 1)
        return req

    def cancel(self, request) -> bool:
        """Cancel on whichever replica holds the request.  Resolution order:
        the stable ``replica_id`` (survives detach re-indexing; a request
        whose replica already detached is necessarily finished — drain waits
        for it — so that cancel is simply False), then the positional
        ``replica`` index, then a full scan.  Over processes: its route id,
        agreed on every rank."""
        if self._world is not None:
            rt = getattr(request, "route_id", None)
            if rt not in self._where:
                return False
            req = self._reqs[rt]
            engine = self.engines[self._ids.index(self._where[rt])]
            ok = self._agree(engine, lambda e: e.cancel(req))
            if ok and not self._local(engine):
                req.state = RequestState.CANCELLED
            return ok
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
        Returns its stable replica id.  Over processes every rank calls it:
        the ranks serving the new replica with its engine, the others with
        its mesh."""
        desc = None
        if self._world is not None:
            (engine,), (desc,) = self._attach_world([engine])
            taken = {r for e in self.engines for r in replica_ranks(e, self._world.rank)}
            if set(replica_ranks(engine, self._world.rank)) & taken:
                raise ValueError("the new replica's ranks serve an attached replica")
        return self._attach(engine, desc)

    def _attach(self, engine, desc: Optional[dict], snap: Optional[dict] = None) -> int:
        self.engines.append(engine)
        rid = self._next_id
        self._next_id += 1
        self._ids.append(rid)
        if self._world is not None:
            self._desc[rid] = desc
            if snap is None:
                self._exchange_snapshots([rid])
            else:
                self._snap[rid] = snap
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
        engine = self.engines[self._ids.index(replica_id)]
        depth = (self._snap[replica_id]["queue_depth"] if self._world is not None
                 else engine.scheduler.queue_depth)
        self.recorder.record("serve/replica_drain", replica_id=replica_id, queue_depth=depth)

    def detach_replica(self, replica_id: int) -> ServingEngine:
        """Remove an idle replica and return its engine (callers may keep it
        warm for re-attach).  Raises if it still has work — use
        :meth:`drain_replica` + the drive loop to get it idle first.  Over
        processes, a rank not serving it gets its :class:`RemoteReplica`."""
        if replica_id not in self._ids:
            raise ValueError(f"unknown replica id {replica_id}")
        i = self._ids.index(replica_id)
        engine = self.engines[i]
        if self._has_work(engine):
            depth = (self._snap[replica_id]["queue_depth"] if self._world is not None
                     else engine.scheduler.queue_depth)
            raise RuntimeError(
                f"replica {replica_id} still has work "
                f"(queue={depth}); drain it first"
            )
        del self.engines[i]
        del self._ids[i]
        self._draining.discard(replica_id)
        self._snap.pop(replica_id, None)
        self._desc.pop(replica_id, None)
        self._replicas_gauge.set(float(len(self.engines)))
        self.recorder.record(
            "serve/replica_detach", replica_id=replica_id,
            replicas=len(self.engines),
        )
        return engine

    def _reap_drained(self) -> None:
        """Detach every draining replica that has gone idle."""
        for rid in [r for r in self._ids if r in self._draining]:
            if not self._has_work(self.engines[self._ids.index(rid)]):
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
        Returns the number of replicas swapped.  Over processes every rank
        calls it with the full weights (each rank of a replica keeps its
        blocks; ``params`` is unused where this rank serves no replica)."""
        step_fn = step_fn if step_fn is not None else self.step
        swapped = 0
        for rid in list(self._ids):
            if rid not in self._ids or rid in self._draining:
                continue  # detached or draining mid-rollout: skip
            engine = self.engines[self._ids.index(rid)]
            if self._local(engine):
                engine.pause_admission()
            if self._world is not None:
                self._snap[rid]["admission_paused"] = True
            try:
                steps = 0
                while not self._drained(engine):
                    step_fn()
                    steps += 1
                    if steps > max_steps:
                        raise RuntimeError(
                            f"replica {rid} did not drain in {max_steps} steps"
                        )
                if self._world is None:
                    engine.swap_params(params, version=version)
                else:
                    self._agree(engine, lambda e: e.swap_params(params, version=version))
                    if version is not None:
                        engine.weights_version = str(version)
                        self._desc[rid]["weights_version"] = str(version)
                swapped += 1
            finally:
                if self._local(engine):
                    engine.resume_admission()
                if self._world is not None and rid in self._snap:
                    self._snap[rid]["admission_paused"] = False
        return swapped

    def _drained(self, engine) -> bool:
        if self._world is not None:
            return self._snap[self._sid(engine)]["drained"]
        return engine.drained

    def versions(self) -> dict:
        """``weights_version -> replica count`` over attached replicas (the
        ``/v1/models`` surface)."""
        out: dict = {}
        for e in self.engines:
            out[e.weights_version] = out.get(e.weights_version, 0) + 1
        return out

    # ------------------------------------------------------- lane migration
    def _compatible(self, src, dst) -> Optional[str]:
        if self._world is None:
            return self.migrator.compatible(src, dst)
        if src is dst:
            return "source and destination are the same engine"
        return geometry_mismatch(self._desc[self._sid(src)], self._desc[self._sid(dst)])

    def _pick_migration_dst(
        self, src: ServingEngine
    ) -> Optional[ServingEngine]:
        """Least-loaded decode-capable replica whose pool geometry matches
        ``src``'s, or None when nothing can receive a lane right now."""
        cands = [
            e for e in self.engines
            if e is not src and not self._poisoned(e)
            and self._decode_capable(e)
            and self._compatible(src, e) is None
        ]
        if not cands:
            return None
        return min(cands, key=self._load)

    def _poisoned(self, engine) -> bool:
        if self._world is not None:
            return self._snap[self._sid(engine)]["poisoned"]
        return engine._poisoned is not None

    def _move(self, src, dst, slot: int, req: Request, reason: str,
              handoff: bool = False) -> None:
        """Migrate ``req``'s lane in ``src`` slot ``slot`` to ``dst`` (a
        prefill handoff when ``handoff``); raises :class:`MigrationError`,
        on every rank alike over processes."""
        if self._world is None:
            if handoff:
                self.migrator.handoff(src, dst, slot)
            else:
                self.migrator.migrate(src, dst, slot, reason=reason)
        else:
            me = self._world.rank
            src_ranks, dst_ranks = replica_ranks(src, me), replica_ranks(dst, me)
            if src_ranks == dst_ranks:
                # engines of one mesh: each rank moves its own head shard
                def go(e):
                    try:
                        if handoff:
                            self.migrator.handoff(e, dst, slot)
                        else:
                            self.migrator.migrate(e, dst, slot, reason=reason)
                    except MigrationError:
                        raise
                    except Exception as exc:  # noqa: BLE001 (a refusal on every rank)
                        raise MigrationError(f"migration failed on the source: {exc!r}")
                    return req.rid, req.slot, e.kv.chunk_bytes(len(dst.kv.lane_pages(req.slot)))

                rid, new_slot, nbytes = self._agree(src, go)
                if not self._local(src):
                    self.migrator.count(nbytes, handoff)
            else:
                rid, new_slot = self.migrator.migrate_across(
                    src if self._local(src) else None, dst if self._local(dst) else None,
                    slot, req, self._world, src_ranks, dst_ranks, reason=reason,
                    handoff=handoff)
            if not self._local(dst):
                req.rid, req.slot, req.state = rid, new_slot, RequestState.RUNNING
            src_snap = self._snap[self._sid(src)]
            src_snap["running"] = [(s, rt) for s, rt in src_snap["running"] if s != slot]
            src_snap["load"] -= 1
            self._where[req.route_id] = self._sid(dst)
            self._bump(dst, 1)
        i = self.engines.index(dst)
        req.replica = i
        req.replica_id = self._ids[i]

    def _fallback_replay(self, src: ServingEngine, req: Request) -> None:
        """Migration's non-retriable fallback: retire the lane on ``src``
        and replay the request on a survivor by decode replay, the
        export/adopt path for one lane.  Greedy lanes stay token-exact;
        sampled lanes resume re-seeded.  A lane that finished while the
        source drained has nothing left to replay."""
        if self._world is not None:
            self._sync_tokens(src, [req])
        if req.state in _TERMINAL:
            return
        if self._local(src):
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
        if self._world is not None:
            self._where.pop(req.route_id, None)
            self._snap[self._sid(src)]["load"] -= 1
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
            for s, req in self._running(src):
                dst = self._pick_migration_dst(src)
                if dst is None:
                    return  # no decode capacity anywhere; retry next step
                try:
                    self._move(src, dst, s, req, "prefill_handoff", handoff=True)
                except MigrationError as exc:
                    if exc.retriable:
                        continue
                    self._fallback_replay(src, req)

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
        destination, or a retriable refusal worth retrying later).  Over
        processes every rank calls it alike; between replicas on disjoint
        ranks the pages go through the host."""
        if from_replica is not None:
            if from_replica not in self._ids:
                raise ValueError(f"unknown replica id {from_replica}")
            src = self.engines[self._ids.index(from_replica)]
        else:
            hot = [e for e in self.engines if self._running(e)]
            if not hot:
                return False
            src = max(hot, key=self._load)
        running = dict(self._running(src))
        if slot is None:
            if not running:
                return False
            slot = max(running.items(), key=lambda sr: sr[1].rid)[0]
        req = running.get(slot) if self._world is not None else src._slot_req[slot]
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
            self._move(src, dst, slot, req, reason)
        except MigrationError as exc:
            if exc.retriable:
                return False
            self._fallback_replay(src, req)
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
        for s, req in self._running(engine):
            dst = self._pick_migration_dst(engine)
            if dst is None:
                return
            try:
                self._move(engine, dst, s, req, "failover")
            except Exception as exc:
                # the dying replica could not be read coherently (or the
                # destination refused): record it and let the caller's
                # export/replay pass take everything still on the engine
                self.recorder.record(
                    "serve/migrate_failover_abort", slot=s, error=repr(exc),
                )
                return

    def _eject_and_replay(self, engine: ServingEngine, exc: BaseException) -> None:
        """Remove a dead replica and replay everything it owed on survivors.

        The replica's in-flight requests (:meth:`ServingEngine.
        export_inflight`: running lanes, mid-prefill, queued) are adopted by
        surviving replicas at the FRONT of their queues, least-loaded first,
        by decode replay: greedy lanes resume token-exact, sampled lanes
        re-seeded.  A request no survivor can fit (geometry
        refusal) is CANCELLED — its stream closes rather than hangs.  The
        dead engine parks behind the half-open circuit breaker; once the
        backoff expires, :meth:`_probe_breaker` revives and re-admits it.
        Over processes every rank ejects it at the same step, the requests
        it owed in route order."""
        if engine not in self.engines:
            return
        i = self.engines.index(engine)
        replica_id = self._ids[i]
        if self.policy == "disaggregated" and len(self.engines) > 1:
            # failover upgrade: lanes whose pages are still readable migrate
            # bit-identically; export_inflight below picks up only what the
            # migration pass could not move
            self._migrate_off(engine)
        if self._world is None:
            exported = engine.export_inflight()
        else:
            self._sync_tokens(engine, list(self._owned(replica_id).values()))
            if self._local(engine):
                engine.export_inflight()
            owned = self._owned(replica_id)
            exported = list(owned.values())
            for rt, req in owned.items():
                del self._where[rt]
                req.cache_nodes, req.cached_chunks, req.cache_chain_broken = [], 0, False
                req.chunks, req.next_chunk, req.slot = (), 0, None
                req.state = RequestState.QUEUED
            self._snap.pop(replica_id, None)
        i = self.engines.index(engine)
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
            "open_until": self._now() + self.breaker_base_s,
        }
        # newest first: each appendleft lands in front of the previous one,
        # so per-survivor queue order ends up oldest-rid-first (FCFS intact)
        for req in reversed(exported):
            self._replay_one(req)

    def _now(self) -> float:
        """The breaker's clock: this process's, or over processes the
        world's first rank's, as the last step exchanged it."""
        return self._world_now if self._world is not None else time.monotonic()

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
            engine = self.engines[i]
            try:
                if self._world is None:
                    engine.adopt(req)
                else:
                    rid = self._agree(engine, lambda e: e.adopt(req).rid)
                    if not self._local(engine):
                        req.rid, req.replay_decode = rid, True
                    self._where[req.route_id] = self._ids[i]
                    self._bump(engine, 1)
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
        if self._world is not None:
            self._reqs.pop(req.route_id, None)
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
        now = self._now()
        for replica_id in [r for r, b in self._breaker.items()
                           if now >= b["open_until"]]:
            entry = self._breaker[replica_id]
            engine = entry["engine"]
            snap = None
            try:
                if self._world is None:
                    engine.revive()
                    engine.step()  # one idle probe step proves it can run
                else:
                    snap = self._agree(engine, lambda e: (e.revive(), e.step(),
                                                          snapshot(e, {}))[2])
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
            desc = self._desc.pop(replica_id, None)
            new_id = self._attach(engine, desc, snap)
            self.recorder.record(
                "serve/breaker_close", replica_id=replica_id, new_id=new_id,
                failures=entry["failures"],
            )

    # ----------------------------------------------------------------- drive
    @property
    def has_work(self) -> bool:
        # a due breaker probe is work: the drive loop must keep stepping so
        # an ejected replica gets its re-admission attempt even when idle
        if any(self._has_work(e) for e in self.engines):
            return True
        now = self._now()
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
        replicas re-admit through the half-open circuit breaker.  Over
        processes the outcomes go round first (:meth:`_step_world`)."""
        if (faults.ACTIVE is not None and len(self.engines) > 1
                and faults.ACTIVE.fire("replica_kill")):
            # kill the busiest replica — the worst case for replay
            victim = max(self.engines, key=self._active_lanes)
            if self._local(victim):
                victim.kill("injected replica kill")
        if self._world is not None:
            self._step_world()
        else:
            for engine in list(self.engines):
                if engine not in self.engines:
                    continue  # ejected earlier this very step
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

    def _active_lanes(self, engine) -> int:
        if self._world is not None:
            return self._snap[self._sid(engine)]["active"]
        return int(engine._active.sum())

    def _step_world(self) -> None:
        """Over processes: each rank steps the replicas it serves, then the
        step's outcome goes round: each replica's ranks' errors and plan
        divergences, its lead's snapshot (:func:`.remote.snapshot`: load,
        tokens, finished requests) and the world's first rank's clock.  A
        divergence, or an error some ranks of a replica hold and others do
        not, raises :class:`PlanDivergence` on every rank; a replica whose
        every rank failed is ejected on every rank."""
        me = self._world.rank
        mine: Dict[Any, Any] = {}
        errors: Dict[int, BaseException] = {}
        for i, engine in enumerate(self.engines):
            if not self._local(engine):
                continue
            sid = self._ids[i]
            rep = {"rank": me, "fail": None, "div": None}
            if engine._sync is None and engine._poisoned is not None:
                rep["fail"] = repr(engine._poisoned)
                errors[sid] = engine._poisoned
            elif engine.has_work:
                try:
                    engine.step()
                except PlanDivergence as exc:
                    rep["div"] = str(exc)
                except Exception as exc:  # noqa: BLE001 (ejected on every rank)
                    rep["fail"] = repr(exc)
                    errors[sid] = exc
            elif engine._poisoned is not None:
                # idle and poisoned: no exchange of its own runs; the ranks'
                # reports must agree below
                rep["fail"] = repr(engine._poisoned)
                errors[sid] = engine._poisoned
            if self._lead(engine) == me:
                rep["snap"] = snapshot(engine, self._owned(sid))
            mine[sid] = rep
        if me == 0:
            mine["clock"] = time.monotonic()
        got = self._world.merge(mine)
        self._world_now = got["clock"][0]
        failed = []
        for sid in list(self._ids):
            reps = got.get(sid, [])
            div = next((r["div"] for r in reps if r["div"]), None)
            held = [r["rank"] for r in reps if r["fail"] is not None]
            if div is None and held and len(held) < len(reps):
                ranks = [r["rank"] for r in reps]
                div = (f"tensor-parallel ranks {ranks} planned different steps (ranks {held} "
                       "hold the error of an earlier step): every rank must make the same "
                       "submit/cancel/step calls, or their collectives would deadlock")
            if div is not None:
                raise PlanDivergence(div)
            if held:
                failed.append((sid, next(r["fail"] for r in reps if r["fail"] is not None)))
        for sid in list(self._ids):
            snap = next((r["snap"] for r in got.get(sid, []) if "snap" in r), None)
            if snap is not None:
                self._apply_snapshot(sid, snap)
        for sid, why in failed:
            engine = self.engines[self._ids.index(sid)]
            self._eject_and_replay(engine, errors.get(sid, RuntimeError(why)))

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
    def _stats_of(self, engine) -> dict:
        if self._world is not None:
            return self._snap[self._sid(engine)]["stats"]
        return engine.stats

    def stats(self) -> dict:
        """Sum of every replica's ``stats`` dict, plus router counters and a
        fleet-wide per-tenant rollup (each tenant's counters summed across
        replicas — failover replays land on the adopting engine, so only the
        cross-replica sum is the caller's true account).  Over processes,
        from each lead's last report."""
        out: dict = {}
        for e in self.engines:
            for k, v in self._stats_of(e).items():
                out[k] = out.get(k, 0) + v
        out["routed"] = self._routed
        out["affinity_hits"] = self._affinity_hits
        tenants: dict = {}
        for e in self.engines:
            books = (self._snap[self._sid(e)]["tenants"] if self._world is not None
                     else getattr(e, "_tenant_stats", {}))
            for tenant, counts in books.items():
                agg = tenants.setdefault(tenant, {})
                for k, v in counts.items():
                    agg[k] = agg.get(k, 0) + v
        if tenants:
            out["tenants"] = tenants
        return out

    def prefix_cache_stats(self) -> dict:
        """Aggregate prefix-cache health across replicas (token-weighted
        hit rate — the router A/B's headline number)."""
        hit = sum(self._stats_of(e)["prefix_hit_tokens"] for e in self.engines)
        miss = sum(self._stats_of(e)["prefix_miss_tokens"] for e in self.engines)
        covered = hit + miss
        return {
            "prefix_hit_tokens": hit,
            "prefix_miss_tokens": miss,
            "hit_rate": hit / covered if covered else 0.0,
            "per_replica": [self._snap[self._sid(e)]["prefix"] if self._world is not None
                            else e.prefix_cache_stats() for e in self.engines],
        }

    def health(self) -> dict:
        """One snapshot a front door can poll: per-replica queue/occupancy
        plus the router's routing counters."""
        now = self._now()
        per = []
        for i, e in enumerate(self.engines):
            if self._world is not None:
                snap = self._snap[self._ids[i]]
                state = {k: snap[k] for k in ("queue_depth", "active", "has_work",
                                              "admission_paused")}
            else:
                state = dict(queue_depth=e.scheduler.queue_depth, active=int(e._active.sum()),
                             has_work=e.has_work, admission_paused=e.admission_paused)
            per.append({
                "replica_id": self._ids[i],
                "queue_depth": state["queue_depth"],
                "active_lanes": state["active"],
                "role": getattr(e, "role", "both"),
                "tp_degree": e.tp_degree,
                "has_work": state["has_work"],
                "draining": self._ids[i] in self._draining,
                "admission_paused": state["admission_paused"],
                "weights_version": e.weights_version,
            })
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
            "per_replica": per,
        }


__all__ = ["ReplicaRouter"]
