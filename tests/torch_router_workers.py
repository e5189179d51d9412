"""Rank functions of the router-over-processes tests (``test_torch_router_dist.py``).

Each runs in a process that ``accelerate_tpu_torch.launchers.debug_launcher``
spawned (``gloo`` over localhost, one CPU "device" a process).  This module
imports torch, numpy and the port only — never JAX, which the test file runs
in the pytest process — and takes numpy arrays; each rank writes what the
test compares into ``out_dir`` (``<tag>_rank<i>.pkl``).  Every rank runs
every case alike: the router over processes needs every rank to make the
same calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from torch_dist_workers import _dump, _follow, _gen_config, _serve_model, _setup

#: the reference's ``test_serving_mesh.py`` engine
MESH_KW = dict(num_slots=4, max_len=64, prefill_buckets=(8, 16), decode_window=4)
#: ``test_disagg.py``'s
SMALL_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                decode_window=2)


def _rank() -> int:
    return torch.distributed.get_rank()


def _engine(model, mesh, kw):
    from accelerate_tpu_torch.serving import ServingEngine
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    return ServingEngine(model, None, device="cpu", registry=MetricsRegistry(), mesh=mesh, **kw)


def _entries(meshes, make):
    """The router's list on this rank: the engine of the replica it serves
    (``make(mesh)``), the mesh of each other one."""
    return [make(m) if _rank() in m else m for m in meshes]


def _router(entries, policy="affinity", **kw):
    from accelerate_tpu_torch.serving import ReplicaRouter
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    return ReplicaRouter(entries, policy=policy, registry=MetricsRegistry(), **kw)


def _tp2x2():
    from accelerate_tpu_torch.parallel.mesh import replica_meshes

    return replica_meshes(2, {"tp": 2})


def _fleet(jparams, kw=None, policy="affinity", cfg=None, **router_kw):
    """2 x tp2 over the four ranks, each replica its own copy of the model."""
    kw = dict(MESH_KW, prefix_cache_mb=4.0, **(kw or {}))
    entries = _entries(_tp2x2(), lambda m: _engine(_serve_model(jparams, cfg), m, kw))
    return _router(entries, policy=policy, **router_kw)


def _local(router):
    from accelerate_tpu_torch.serving.remote import RemoteReplica

    return next(e for e in router.engines if not isinstance(e, RemoteReplica))


def _prompts(case):
    return [np.asarray(p, np.int32) for p in case["prompts"]]


# ----------------------------------------------------------------- the cases
def _serve(case, jp):
    """``TestRouterOverTpReplicas``: 2 x tp2 behind one router."""
    router = _fleet(jp[case.get("model", "llama")], case.get("kw"), cfg=case.get("cfg"))
    reqs = router.serve(_prompts(case), _gen_config(case["gen"]))
    return {"tokens": [list(r.tokens) for r in reqs], "replicas": [r.replica for r in reqs],
            "tp_degrees": [r["tp_degree"] for r in router.health()["per_replica"]],
            "local_tp": _local(router).tp_degree}


def _placement(case, jp):
    """``TestReplicaRouter``'s cases over processes, on 2 x tp2."""
    from accelerate_tpu_torch.telemetry import get_flight_recorder

    gen = _gen_config(dict(max_new_tokens=4))
    p = case["prompts"]
    out = {}
    router = _fleet(jp["llama"])
    first = router.submit(np.concatenate([p["common"], [5, 6]]).astype(np.int32), config=gen)
    router.run()
    later = []
    for sfx in ([7, 8], [9, 10, 11]):
        req = router.submit(np.concatenate([p["common"], sfx]).astype(np.int32), config=gen)
        router.run()
        later.append(req.replica)
    out["affinity"] = dict(warm=first.replica, later=later,
                           hit_rate=router.health()["affinity_hit_rate"])
    router = _fleet(jp["llama"])
    r0 = router.submit(p["cold"][0], config=gen)
    r1 = router.submit(p["cold"][1], config=gen)
    router.run()
    out["cold"] = [r0.replica, r1.replica]
    router = _fleet(jp["llama"], policy="round_robin")
    out["round_robin"] = [router.submit(x, config=gen).replica for x in p["rr"]]
    router.run()
    # failover when a replica refuses: replica 0 takes prompts of 8 tokens
    meshes = _tp2x2()
    small = dict(MESH_KW, max_len=16, max_prompt_len=8, prefill_buckets=(8,))
    entries = [_engine(_serve_model(jp["llama"]), m, small if i == 0 else MESH_KW)
               if _rank() in m else m for i, m in enumerate(meshes)]
    router = _router(entries)
    req = router.submit(p["long"], config=_gen_config(dict(max_new_tokens=8)))
    router.run()
    refused = None
    try:
        router.submit(p["longest"], config=_gen_config(dict(max_new_tokens=60)))
    except ValueError as e:
        refused = [type(e).__name__, bool(getattr(e, "retriable", True))]
    out["refuse"] = dict(replica=req.replica, tokens=len(req.tokens), refused=refused)
    # stats aggregation
    router = _fleet(jp["llama"])
    reqs = router.serve(p["stats"], gen)
    agg = router.stats()
    local = _local(router)
    health = router.health()
    out["stats"] = dict(
        tokens=[len(r.tokens) for r in reqs], routed=agg["routed"],
        agg={k: agg[k] for k in ("requests_completed", "decode_steps")},
        local={k: local.stats[k] for k in ("requests_completed", "decode_steps")},
        lead=_rank() == local.mesh.ranks[0], per_replica=len(router.prefix_cache_stats()
                                                             ["per_replica"]),
        hit_rate=router.prefix_cache_stats()["hit_rate"],
        gauge=router.metrics.gauge("serve/replicas").value, replicas=health["replicas"],
        idle=all(not r["has_work"] for r in health["per_replica"]))
    # route flight events
    router = _fleet(jp["llama"])
    req = router.submit(p["event"], config=gen)
    router.run()
    events = [e for e in get_flight_recorder().tail() if e.get("kind") == "serve/route"]
    out["event"] = dict(replica=req.replica, last=events[-1]["replica"] if events else None)
    # cancel on the owning replica
    router = _fleet(jp["llama"])
    req = router.submit(p["cancel"], config=_gen_config(dict(max_new_tokens=8)))
    out["cancel"] = dict(ok=router.cancel(req))
    router.run()
    out["cancel"]["tokens"] = len(req.tokens)
    out["cancel"]["state"] = req.state.value
    return out


def _migrate(case, jp):
    """Lanes moved between replicas on disjoint ranks mid-generation,
    greedy and sampled, against an unmoved baseline of the same
    composition: 2 x tp2 (equal tp, rank r to rank r) and tp2 beside two
    single-rank replicas (unequal tp, both ways)."""
    from accelerate_tpu_torch.parallel.mesh import replica_meshes

    kw = dict(SMALL_KW, paged=True, prefix_cache_mb=0.01, rng_seed=3)
    gens = [_gen_config(g) for g in case["gens"]]
    prompts = _prompts(case)
    out = {}
    for arm, moves in (("equal", case["equal"]), ("unequal", case["unequal"])):
        def fleet():
            if arm == "equal":
                meshes = _tp2x2()
            else:
                meshes = (replica_meshes(1, {"tp": 2}, devices=[0, 1])
                          + replica_meshes(2, None, devices=[2, 3]))
            return _router(_entries(meshes, lambda m: _engine(_serve_model(jp["llama"]), m,
                                                              kw)))

        base = fleet()
        breqs = [base.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
        base.run()
        router = fleet()
        reqs = [router.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
        while min(len(r.tokens) for r in reqs) < case["migrate_at"]:
            router.step()
        moved = []
        for req, to in zip(reqs, moves):
            src = req.replica_id
            moved.append([src, router.migrate_lane(from_replica=src, to_replica=to)])
            moved[-1].append(req.replica_id)
        router.run()
        out[arm] = {"baseline": [list(r.tokens) for r in breqs],
                    "migrated": [list(r.tokens) for r in reqs],
                    "placed": [r.replica for r in breqs], "moved": moved,
                    "migrations": router.migrator._migrations.value,
                    "tp": [r["tp_degree"] for r in router.health()["per_replica"]]}
    return out


def _handoff(case, jp):
    """The disaggregated pair on disjoint ranks: prefill on ranks 0-1,
    decode on ranks 2-3, every lane handed off through the host."""
    kw = dict(SMALL_KW, paged=True)
    meshes = _tp2x2()
    entries = [_engine(_serve_model(jp["llama"]), m, dict(kw, role=role)) if _rank() in m
               else m for m, role in zip(meshes, ("prefill", "decode"))]
    router = _router(entries, policy="disaggregated")
    reqs = router.serve(_prompts(case), _gen_config(case["gen"]))
    local = _local(router)
    return {"tokens": [list(r.tokens) for r in reqs], "role": local.role,
            "completed": local.stats["requests_completed"],
            "decode_steps": local.stats["decode_steps"],
            "handoffs": router.migrator._handoffs.value}


def _failover(case, jp):
    """A replica killed on every one of its ranks mid-serve: ejected at the
    same step everywhere, its requests replayed on the survivor; the
    breaker re-admits it at the first probe past its backoff."""
    gen = _gen_config(case["gen"])
    router = _fleet(jp["llama"], breaker_base_s=0.2)
    reqs = [router.submit(p.copy(), config=gen) for p in _prompts(case)]
    router.step()
    victim = router.engines[0]
    if router._local(victim):
        victim.kill("killed on every rank of replica 0")
    router.step()
    out = {"replicas_after_kill": router.health()["replicas"]}
    router.run()
    out.update(tokens=[list(r.tokens) for r in reqs], ejections=router.health()["ejections"],
               replayed=router.stats()["requests_replayed"])
    time.sleep(0.3)
    router.step()
    out["replicas_after_probe"] = router.health()["replicas"]
    out["breaker"] = router.health()["breaker"]
    reqs = router.serve([p.copy() for p in _prompts(case)], gen)
    out["again"] = [list(r.tokens) for r in reqs]
    out["ids"] = router.replica_ids()
    return out


def _elastic(case, jp):
    """``drain_replica``, ``detach_replica``, ``add_replica`` and
    ``hot_swap`` over processes: replica 0 drains while it serves, detaches
    at the step it goes idle, a fresh replica on its ranks is added, and
    both take the same weights under a new version label."""
    from accelerate_tpu_torch.weights import params_from_jax

    gen = _gen_config(case["gen"])
    prompts = _prompts(case)
    router = _fleet(jp["llama"])
    reqs = [router.submit(p.copy(), config=gen) for p in prompts]
    router.drain_replica(0)
    router.run()
    out = {"drained": [list(r.tokens) for r in reqs], "ids_after_drain": router.replica_ids()}
    mesh = _tp2x2()[0]
    kw = dict(MESH_KW, prefix_cache_mb=4.0)
    out["new_id"] = router.add_replica(
        _engine(_serve_model(jp["llama"]), mesh, kw) if _rank() in mesh else mesh)
    params = params_from_jax(jp["llama"], device="cpu")
    out["swapped"] = router.hot_swap(params, version="v2")
    out["versions"] = router.versions()
    out["labels"] = [r["weights_version"] for r in router.health()["per_replica"]]
    out["tokens"] = [list(r.tokens) for r in router.serve([p.copy() for p in prompts], gen)]
    out["replicas"] = sorted(router.replica_ids())
    return out


def _kill_one(case, jp):
    """A kill on one rank of a replica: every rank raises within the
    deadline instead of hanging in a collective."""
    gen = _gen_config(case["gen"])
    router = _fleet(jp["llama"])
    for p in _prompts(case):
        router.submit(p.copy(), config=gen)
    router.step()
    if _rank() == 0:
        router.engines[0].kill("killed on rank 0")
    t0 = time.perf_counter()
    try:
        router.run(max_steps=100)
        return None
    except Exception as e:  # noqa: BLE001 (the raise is what is recorded)
        return [type(e).__name__, str(e), time.perf_counter() - t0 < case["deadline_s"]]


def _frontdoor(case, jp):
    """The front door over 2 x tp2: rank 0 runs the HTTP server and the
    driver, the others follow; after an idle spell past the heartbeat
    interval, one more request; a rolling hot swap through the front door
    (each follower supplies its own weights), and one more request."""
    import http.client
    import json

    from accelerate_tpu_torch.serving.api import ApiServer, FrontDoor

    from accelerate_tpu_torch.weights import params_from_jax

    router = _fleet(jp["llama"])

    def supply(op, arg):
        # a follower's own copy of the full weights for the hot swap
        assert op == "hot_swap" and arg == "v2"
        return params_from_jax(jp["llama"], device="cpu")

    door = FrontDoor(router, heartbeat_interval_s=case["heartbeat_s"], supply=supply)
    if _rank() != 0:
        t0 = time.perf_counter()
        mirrored = _follow(door, router)
        return {"followed_s": time.perf_counter() - t0, "routed": router.stats()["routed"],
                "versions": router.versions(), "tokens": [list(r.tokens) for r in mirrored]}
    door.start()
    server = ApiServer(door, host="127.0.0.1", port=0)

    def complete(prompt):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120.0)
        try:
            conn.request("POST", "/v1/completions", json.dumps(
                {"prompt": [int(t) for t in prompt], "max_tokens": case["gen"]["max_new_tokens"],
                 "temperature": 0}), {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            return resp.status, body["choices"][0]["token_ids"]
        finally:
            conn.close()

    out = {"http": [complete(p) for p in _prompts(case)]}
    time.sleep(case["idle_s"])
    out["after_idle"] = complete(_prompts(case)[0])
    out["swapped"] = door.hot_swap(params_from_jax(jp["llama"], device="cpu"), version="v2")
    out["after_swap"] = complete(_prompts(case)[1])
    out["health"] = door.health()["replicas"]
    server.stop()
    door.stop()
    out["routed"] = router.stats()["routed"]
    out["versions"] = router.versions()
    return out


def router_dist_cases(out_dir, jparams_by_model, cases):
    """Every scenario of one world, in order; each case's result goes to
    ``<tag>``."""
    _setup()
    kinds = {"serve": _serve, "placement": _placement, "migrate": _migrate,
             "handoff": _handoff, "failover": _failover, "frontdoor": _frontdoor,
             "elastic": _elastic, "kill_one": _kill_one}
    for case in cases:
        _dump(out_dir, case["tag"], kinds[case.get("kind", "serve")](case, jparams_by_model))
