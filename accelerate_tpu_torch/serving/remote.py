"""A :class:`~.router.ReplicaRouter` over processes: the replicas other
ranks serve, and the world's host exchange that keeps every rank's router
deciding alike.

The port serves one process a card (``launchers.py``).  Replicas on
disjoint rank groups (:func:`~accelerate_tpu_torch.parallel.mesh.
replica_meshes`, one mesh a replica, tensor-parallel or of one rank) sit
behind one router that every rank runs: each rank builds the engine of
the replica its rank belongs to and passes the other replicas' meshes in
their places; :class:`RemoteReplica` stands in for those.  A replica's
*lead* rank (its mesh's first) knows what only its engine knows (its
radix tree's affinity for a prompt, its load, the tokens it emitted, the
failures of its step) and reports it over the world's gloo group
(:func:`~accelerate_tpu_torch.parallel.mesh.world_host_group`), so that
every rank takes each decision from the same data.  A request routed to
a replica this rank does not serve is a mirror here (:func:`mirror_request`):
the same :class:`~.scheduler.Request` fields, its tokens appended (and its
``on_token`` called) as the lead reports them, which is what lets the
front door on rank 0 stream every replica's tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from ..models.generation import GenerationConfig
from ..parallel.mesh import Mesh, world_host_group
from .scheduler import Request, RequestState

__all__ = ["RemoteReplica", "World", "apply_report", "describe", "mirror_request",
           "replica_ranks", "report_line", "snapshot"]


class RemoteReplica:
    """A replica that other ranks serve: its ranks and what its lead
    described at attach time (role, weights label, tp degree, page
    geometry).  The router reads its state from the step exchange's
    snapshots and never calls into it."""

    mesh = None

    def __init__(self, ranks, desc: dict):
        self.ranks = tuple(int(r) for r in ranks)
        self.role = desc["role"]
        self.paged = desc["paged"]
        self.weights_version = desc["weights_version"]
        self.tp_degree = desc["tp_degree"]
        self.num_slots = desc["num_slots"]
        self.engine_id = desc["engine_id"]
        self.geometry = desc["geometry"]

    def __repr__(self):
        return f"RemoteReplica(ranks={list(self.ranks)}, role={self.role!r})"


def replica_ranks(entry, rank: int) -> tuple:
    """The ranks serving a router entry: a :class:`Mesh` placeholder's, an
    engine's mesh's, or this rank alone for an engine without a mesh."""
    if isinstance(entry, Mesh):
        return entry.ranks
    if isinstance(entry, RemoteReplica):
        return entry.ranks
    mesh = getattr(entry, "mesh", None)
    return (int(rank),) if mesh is None else mesh.ranks


def describe(engine) -> dict:
    """What the other ranks' routers need to know of a local engine."""
    geometry = None
    if engine.paged:
        kv = engine.kv
        geometry = dict(page_size=kv.page_size, pages_per_lane=kv.pages_per_lane,
                        storage_dtype=str(kv.storage_dtype), layers=int(kv.pages_k.shape[0]),
                        head_dim=int(kv.pages_k.shape[-1]),
                        kv_heads=int(kv.pages_k.shape[3]) * engine.tp_degree)
    return dict(mesh=engine.mesh is not None, role=engine.role, paged=engine.paged,
                weights_version=engine.weights_version,
                tp_degree=engine.tp_degree, num_slots=engine.num_slots,
                engine_id=engine.engine_id, geometry=geometry)


def snapshot(engine, owned: Dict[int, Request]) -> dict:
    """A local engine's state after its step, as its lead reports it:
    what the router's load, work, drain, stats and health reads take, the
    running lanes (slot, route id) of the requests ``owned`` (route id ->
    request) and, for each of those, the tokens every rank has not seen
    yet (past ``Request.reported``) and its state."""
    by_obj = {id(r): rt for rt, r in owned.items()}
    running = [(s, by_obj[id(r)]) for s, r in enumerate(engine._slot_req)
               if r is not None and r.state is RequestState.RUNNING and id(r) in by_obj]
    reqs = {rt: report_line(r) for rt, r in owned.items()}
    return dict(load=engine.scheduler.queue_depth + int(engine._active.sum()),
                queue_depth=engine.scheduler.queue_depth, active=int(engine._active.sum()),
                has_work=bool(engine.has_work), drained=bool(engine.drained),
                admission_paused=bool(engine.admission_paused),
                poisoned=engine._poisoned is not None, stats=dict(engine.stats),
                tenants={t: dict(v) for t, v in getattr(engine, "_tenant_stats", {}).items()},
                prefix=engine.prefix_cache_stats(), running=running,
                weights_version=engine.weights_version, reqs=reqs)


def mirror_request(rid: int, prompt: np.ndarray, config: Optional[GenerationConfig] = None,
                   on_token=None, cache_prefix: bool = True, speculate: bool = True,
                   deadline_s: Optional[float] = None, request_class: Optional[str] = None,
                   tenant: Optional[str] = None, **overrides) -> Request:
    """The request a replica on other ranks admitted, as
    :meth:`~.engine.ServingEngine.submit` built it there (``rid`` is the
    one its engine gave)."""
    gen = config or GenerationConfig()
    if overrides:
        gen = dataclasses.replace(gen, **overrides)
    return Request(rid=int(rid), prompt=prompt, config=gen, on_token=on_token,
                   cache_prefix=bool(cache_prefix), speculate=bool(speculate),
                   deadline_s=None if deadline_s is None else float(deadline_s),
                   request_class=request_class, tenant=tenant)


def report_line(req: Request) -> tuple:
    """What a lead reports of one request: the tokens past
    ``Request.reported``, its state, deadline flag, finish step and rid."""
    return (list(req.tokens[req.reported:]), req.state.value, bool(req.deadline_exceeded),
            int(req.finish_step), int(req.rid))


def apply_report(req: Request, report, local: bool) -> None:
    """One request's line of a lead's report, on a rank: a mirror takes
    the new tokens (its ``on_token`` called for each) and the state; every
    rank counts them as reported."""
    tail, state, exceeded, finish_step, rid = report
    if not local:
        for t in tail:
            req.emit(t)
        req.state = RequestState(state)
        req.deadline_exceeded = exceeded
        req.finish_step = finish_step
        req.rid = rid
    req.reported += len(tail)


class World:
    """The world's host exchange: every rank calls each method together,
    in the same order (``torch.distributed``'s object collectives over the
    gloo group of every rank)."""

    def __init__(self):
        self.group = world_host_group()
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def bcast(self, obj: Any, src: int) -> Any:
        """Rank ``src``'s ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def merge(self, mine: Dict[Any, Any]) -> Dict[Any, List[Any]]:
        """Each rank's ``{key: value}``; returns key -> the values of the
        ranks that sent one, in rank order."""
        out: Dict[Any, List[Any]] = {}
        for part in self.gather(mine):
            for k, v in part.items():
                out.setdefault(k, []).append(v)
        return out
