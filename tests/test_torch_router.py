"""Port parity: the replica router and live KV page migration against the
JAX package's (``tests/test_disagg.py`` and the router parts of
``tests/test_fault_tolerance.py``).

``TransformerConfig.tiny`` at f32, the same weights in both packages
(``params_from_jax``), each port engine on its own copy of them.  Held
against the JAX router on the same prompts:

* ``affinity`` and ``round_robin`` send every request to the same replica
  with the same affinity scores and the same
  ``serve/router_affinity_hit_rate``, and the greedy tokens are the JAX
  engines' (exact);
* ``disaggregated`` (a ``role="prefill"`` and a ``role="decode"``
  replica) serves the JAX fleet's greedy tokens, and its
  ``serve/prefill_handoffs_total``, ``serve/migrations_total`` and
  ``serve/migrate_bytes_total`` equal the JAX migrator's.

Held against the port's own unmigrated serve (JAX's threefry stream and the
port's counter stream differ, so sampled tokens are compared within the
port): a lane migrated mid-generation by either arm (d2d, host bounce), at
f32, bf16, int8 and fp8 pages, continues with the same greedy and sampled
tokens (exact), and the bounce carries the pages' scales bit for bit.  The
rest are the reference's contracts: ``MigrationError`` retriable for a full
destination and not for a geometry mismatch, the ``migrate_*`` faults
falling back to replay, failover upgraded to migration (and replay when
the pages cannot be read), the executable counts growing by exactly the
migration pair, prefix pins re-established on the destination, and
add/drain/detach, ``hot_swap`` and ``model_version`` pinning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGen
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ReplicaRouter as JRouter
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.telemetry import MetricsRegistry as JRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.serving import (
    MigrationError,
    PageMigrator,
    ReplicaRouter,
    ServingEngine,
    faults,
    transfer,
)
from accelerate_tpu_torch.telemetry import MetricsRegistry
from accelerate_tpu_torch.weights import params_from_jax

KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
          decode_window=2, prefix_cache_mb=0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64)
    jmodel = JTransformer(jcfg)
    jparams = [jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
               for seed in (0, 1)]
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, max_seq_len=64)
    port = [params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
            for p in jparams]
    return jmodel, jparams, cfg, port


def _engine(weights, seed=0, **kw):
    """A port engine on its own copy of the weights ``seed``."""
    _, _, cfg, port = weights
    own = {k: v.clone() for k, v in port[seed].items()}
    return ServingEngine(Transformer(cfg, device="meta"), own, device="cpu",
                         registry=MetricsRegistry(), **{**KW, **kw})


def _jengine(weights, **kw):
    jmodel, jparams, _, _ = weights
    return JEngine(jmodel, jparams[0], paged=True, registry=JRegistry(), **{**KW, **kw})


def _gen(mode, n=10, cls=GenerationConfig):
    if mode == "sampled":
        return cls(max_new_tokens=n, do_sample=True, temperature=0.8, top_k=50,
                   eos_token_id=None)
    return cls(max_new_tokens=n, do_sample=False, eos_token_id=None)


def _prompt(seed=7, n=8):
    return np.random.default_rng(seed).integers(1, 256, (n,)).astype(np.int32)


def _slot_of(engine, req):
    return next(s for s in range(engine.num_slots) if engine._slot_req[s] is req)


def _run_until(engine, req, n_tokens, max_steps=200):
    for _ in range(max_steps):
        if len(req.tokens) >= n_tokens:
            return
        engine.step()
    raise AssertionError("engine did not generate enough tokens")


def _baseline(weights, prompts, gens, rounds=1, **kw):
    """The workload served unmoved by one engine, ``rounds`` times in turn
    (a sampled request's stream follows its rid)."""
    base = _engine(weights, **kw)
    out = []
    for _ in range(rounds):
        reqs = [base.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
        base.run()
        out.append([list(r.tokens) for r in reqs])
    return out if rounds > 1 else out[0]


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()


# ------------------------------------------------------------ JAX parity
def _route_prompts(seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, (8,)).astype(np.int32)
    tail = lambda n: rng.integers(1, 256, (n,)).astype(np.int32)  # noqa: E731
    return [np.concatenate([prefix, tail(3)]), tail(11), np.concatenate([prefix, tail(5)]),
            tail(6), np.concatenate([prefix, tail(2)]), np.concatenate([prefix, tail(4)])]


def _drive_router(router, gen_cls, prompts, scores_of):
    """Submit one prompt at a time, each after the previous ran out (so
    the radix trees hold what the earlier ones prefilled); record the
    scores every replica had, the replica chosen and the tokens."""
    out = []
    for p in prompts:
        scores = [scores_of(router, e, p) for e in router.engines]
        req = router.submit(p.copy(), config=gen_cls(max_new_tokens=6))
        router.run()
        out.append((scores, req.replica, list(req.tokens)))
    return out


def test_routing_matches_jax(weights):
    """Both policies over the same two replicas of each package, one after
    the other (each with prompts of its own: what the first left in the
    radix trees is the same on both sides)."""
    score = lambda r, e, p: r._affinity(e, p)  # noqa: E731
    jengines = [_jengine(weights), _jengine(weights)]
    pengines = [_engine(weights), _engine(weights)]
    for seed, policy in ((3, "affinity"), (4, "round_robin")):
        prompts = _route_prompts(seed)
        jrouter = JRouter(jengines, policy=policy, registry=JRegistry())
        prouter = ReplicaRouter(pengines, policy=policy, registry=MetricsRegistry())
        want = _drive_router(jrouter, JGen, prompts, score)
        got = _drive_router(prouter, GenerationConfig, prompts, score)
        assert got == want, policy
        assert prouter.health()["affinity_hit_rate"] == jrouter.health()["affinity_hit_rate"]
        assert prouter.metrics.gauge("serve/router_affinity_hit_rate").value == \
            jrouter.metrics.gauge("serve/router_affinity_hit_rate").value
        assert [e.stats["prefix_hit_tokens"] for e in prouter.engines] == \
            [e.stats["prefix_hit_tokens"] for e in jrouter.engines]
        if policy == "affinity":
            assert prouter.stats()["affinity_hits"] >= 2  # the shared prefix was followed


def test_disaggregated_matches_jax_and_monolithic(weights):
    prompts = [_prompt(20 + i) for i in range(4)]
    jrouter = JRouter([_jengine(weights, role="prefill"),
                       _jengine(weights, role="decode", num_slots=4)],
                      policy="disaggregated", registry=JRegistry())
    jreqs = [jrouter.submit(p.copy(), config=_gen("greedy", cls=JGen)) for p in prompts]
    jrouter.run()
    pre = _engine(weights, role="prefill")
    dec = _engine(weights, role="decode", num_slots=4)
    router = ReplicaRouter([pre, dec], policy="disaggregated", registry=MetricsRegistry())
    gens = [_gen("greedy"), _gen("sampled"), _gen("greedy"), _gen("sampled")]
    reqs = [router.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
    router.run()
    # the greedy lanes are the JAX fleet's; every lane is a monolithic engine's
    assert [list(reqs[i].tokens) for i in (0, 2)] == [list(jreqs[i].tokens) for i in (0, 2)]
    assert [list(r.tokens) for r in reqs] == _baseline(weights, prompts, gens, num_slots=4)
    for name in ("serve/prefill_handoffs_total", "serve/migrations_total",
                 "serve/migrate_bytes_total"):
        assert router.metrics.counter(name).value == jrouter.metrics.counter(name).value, name
    assert router.metrics.counter("serve/prefill_handoffs_total").value == len(prompts)
    assert pre.stats["decode_steps"] == 0 and dec.stats["decode_steps"] > 0
    assert pre.metrics.gauge("serve/role").value == 1.0
    assert dec.metrics.gauge("serve/role").value == 2.0
    assert [p["role"] for p in router.health()["per_replica"]] == ["prefill", "decode"]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_disaggregated_quantized_pages_match_monolithic(weights, kv_dtype):
    """The prefill/decode split over quantized pages: a lane's codes and
    scales move with it, and the tokens (greedy and sampled) are a
    monolithic engine's; the prefill replica keeps one pending
    quantization error, not one a chunk."""
    prompts = [_prompt(30 + i, n=4 + 5 * i) for i in range(4)]
    gens = [_gen("greedy"), _gen("sampled")] * 2
    pre = _engine(weights, role="prefill", kv_dtype=kv_dtype)
    dec = _engine(weights, role="decode", num_slots=4, kv_dtype=kv_dtype)
    router = ReplicaRouter([pre, dec], policy="disaggregated", registry=MetricsRegistry())
    reqs = [router.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
    router.run()
    assert [list(r.tokens) for r in reqs] == _baseline(weights, prompts, gens, num_slots=4,
                                                        kv_dtype=kv_dtype)
    assert pre.stats["prefill_chunks"] > 1 and len(pre._pending_prefill_qerr) <= 1


# ------------------------------------------------- migration, held to itself
def _migrate_pair(weights, kv_dtype, arms, migrate_at=4):
    """Each arm in turn: the two-lane (greedy, sampled) workload migrated
    mid-generation from one engine to another, against the same workload
    served without a move, round for round (the engines are reused across
    the arms, and a sampled lane's stream follows its rid)."""
    prompts = [_prompt(11), _prompt(12)]
    gens = [_gen("greedy"), _gen("sampled")]
    baseline = _baseline(weights, prompts, gens, rounds=len(arms), kv_dtype=kv_dtype)
    src, dst = _engine(weights, kv_dtype=kv_dtype), _engine(weights, kv_dtype=kv_dtype)
    mig = PageMigrator(registry=MetricsRegistry())
    out = {}
    for arm in arms:
        reqs = [src.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
        for r in reqs:
            _run_until(src, r, migrate_at)
        for r in reqs:
            mig.migrate(src, dst, _slot_of(src, r), mode=arm)
        assert src._poisoned is None
        dst.run()
        out[arm] = [list(r.tokens) for r in reqs]
        src.run()
    return baseline, out, src, dst, mig


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8", "fp8"])
def test_migrated_lanes_continue_bit_identically(weights, kv_dtype):
    baseline, out, src, dst, mig = _migrate_pair(weights, kv_dtype, ("d2d", "bounce"))
    assert out == {"d2d": baseline[0], "bounce": baseline[1]}
    assert mig.metrics.counter("serve/migrations_total").value == 4
    # one program each, whatever the lanes' page counts
    assert src.compiled_executable_counts()["migrate_extract"] == 1
    assert dst.compiled_executable_counts()["migrate_install"] == 1


def test_bounce_carries_scales_bitwise(weights):
    src, dst = _engine(weights, kv_dtype="int8"), _engine(weights, kv_dtype="int8")
    req = src.submit(_prompt(), config=_gen("greedy"))
    _run_until(src, req, 4)
    slot = _slot_of(src, req)
    src._drain_inflight()
    old = src.kv.lane_pages(slot)
    want = [t[:, old].clone() for t in (src.kv.pages_k, src.kv.pages_v,
                                        src.kv.k_scales, src.kv.v_scales)]
    PageMigrator(registry=MetricsRegistry()).migrate(src, dst, slot, mode="bounce")
    new = dst.kv.lane_pages(req.slot)
    got = [t[:, new] for t in (dst.kv.pages_k, dst.kv.pages_v, dst.kv.k_scales,
                               dst.kv.v_scales)]
    assert len(new) == len(old)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_prefix_pins_drop_on_source_and_reestablish_on_destination(weights):
    src, dst = _engine(weights), _engine(weights)
    prompt = _prompt(n=8)
    req = src.submit(prompt.copy(), config=_gen("greedy"))
    _run_until(src, req, 6)
    slot = _slot_of(src, req)
    src._drain_inflight()
    lane_ids = set(src.kv.lane_pages(slot))
    PageMigrator(registry=MetricsRegistry()).migrate(src, dst, slot)
    cached = {p for n in src.prefix_cache._nodes if n.pages is not None for p in n.pages}
    for p in lane_ids:
        assert int(src.kv.allocator.refs[p]) == (1 if p in cached else 0), p
    hit = dst.prefix_cache.match(prompt, [(8, 8)])
    assert hit and set(hit[0].pages) <= set(dst.kv.lane_pages(req.slot))
    dst.run()
    again = dst.submit(prompt.copy(), config=_gen("greedy"))
    dst.run()
    assert dst.stats["prefix_hit_tokens"] >= 8
    assert list(again.tokens) == list(req.tokens)


def test_migration_behind_inflight_destination_window(weights):
    want = _baseline(weights, [_prompt(1), _prompt(2)], [_gen("greedy")] * 2)
    src, dst = _engine(weights), _engine(weights)
    r1 = src.submit(_prompt(1), config=_gen("greedy"))
    r2 = dst.submit(_prompt(2), config=_gen("greedy"))
    _run_until(src, r1, 4)
    _run_until(dst, r2, 2)
    assert dst._inflight is not None or dst._prev_handle is not None
    PageMigrator(registry=MetricsRegistry()).migrate(src, dst, _slot_of(src, r1))
    dst.run()
    assert [list(r1.tokens), list(r2.tokens)] == want


def test_compiled_counts_grow_by_exactly_the_migration_pair(weights):
    want = _baseline(weights, [_prompt()], [_gen("greedy")])
    src, dst, mono = _engine(weights), _engine(weights), _engine(weights)
    mono.serve([_prompt()], configs=_gen("greedy"))
    req = src.submit(_prompt(), config=_gen("greedy"))
    _run_until(src, req, 4)
    before = {id(e): e.compiled_executable_counts() for e in (src, dst)}
    assert not any(k.startswith("migrate_") for k in before[id(src)])
    PageMigrator(registry=MetricsRegistry()).migrate(src, dst, _slot_of(src, req))
    dst.run()
    assert [list(req.tokens)] == want
    for e in (src, dst):
        after = e.compiled_executable_counts()
        assert set(after) - set(before[id(e)]) == {"migrate_extract", "migrate_install"}
        assert all(v <= 1 for v in after.values()), after
    assert not any(k.startswith("migrate_") for k in mono.compiled_executable_counts())


def test_retriable_when_destination_full(weights):
    want = _baseline(weights, [_prompt(1)], [_gen("greedy")])
    src, dst = _engine(weights), _engine(weights)
    req = src.submit(_prompt(1), config=_gen("greedy"))
    d1 = dst.submit(_prompt(2), config=_gen("greedy", n=30))
    d2 = dst.submit(_prompt(3), config=_gen("greedy", n=30))
    _run_until(src, req, 4)
    _run_until(dst, d1, 1)
    _run_until(dst, d2, 1)
    with pytest.raises(MigrationError) as ei:
        PageMigrator(registry=MetricsRegistry()).migrate(src, dst, _slot_of(src, req))
    assert ei.value.retriable is True
    src.run()
    dst.run()
    assert [list(req.tokens)] == want  # nothing moved: the source finished it


def test_geometry_mismatch_not_retriable(weights):
    src, dst = _engine(weights), _engine(weights, max_len=32)
    req = src.submit(_prompt(), config=_gen("greedy"))
    _run_until(src, req, 2)
    with pytest.raises(MigrationError) as ei:
        PageMigrator(registry=MetricsRegistry()).migrate(src, dst, _slot_of(src, req))
    assert ei.value.retriable is False and "pages_per_lane" in ei.value.reason
    assert MigrationError("nope").retriable is False


@pytest.mark.parametrize("point", ["migrate_d2d", "migrate_bounce"])
def test_fault_mid_migration_falls_back_to_replay(weights, point, monkeypatch):
    if point == "migrate_bounce":
        monkeypatch.setattr(transfer.PageMigrator, "resolve_mode",
                            staticmethod(lambda s, d: "bounce"))
    want = _baseline(weights, [_prompt()], [_gen("greedy")])
    router = ReplicaRouter([_engine(weights), _engine(weights)], registry=MetricsRegistry())
    req = router.submit(_prompt(), config=_gen("greedy"))
    owner, other = router.engines[req.replica], router.engines[1 - req.replica]
    _run_until(owner, req, 4)
    faults.install(faults.FaultPlan(at={point: 1}), registry=MetricsRegistry())
    arm = point.split("_")[1]
    with pytest.raises(MigrationError) as ei:
        router.migrator.migrate(owner, other, _slot_of(owner, req), mode=arm)
    assert ei.value.retriable is False
    assert owner._poisoned is None and req.state.name == "RUNNING"
    faults.install(faults.FaultPlan(at={point: 1}), registry=MetricsRegistry())
    assert router.migrate_lane(reason="test") is True
    router.run()
    assert [list(req.tokens)] == want
    assert router.stats()["requests_replayed"] >= 1


@pytest.mark.parametrize("readable", [True, False])
def test_failover_upgrades_to_migration(weights, readable):
    """A killed replica's running lanes migrate bit-identically while its
    pages are readable (no replay); when the migration fails, ejection
    falls back to decode replay, token-exact under greedy."""
    want = _baseline(weights, [_prompt()], [_gen("greedy")])
    router = ReplicaRouter([_engine(weights), _engine(weights)], policy="disaggregated",
                           registry=MetricsRegistry())
    req = router.submit(_prompt(), config=_gen("greedy"))
    owner = router.engines[req.replica]
    _run_until(owner, req, 4)
    owner.kill("test kill")
    if not readable:
        faults.install(faults.FaultPlan(at={"migrate_d2d": 1, "migrate_bounce": 1}),
                       registry=MetricsRegistry())
    router.step()
    faults.clear()
    router.run()
    assert [list(req.tokens)] == want
    migrations = router.migrator.metrics.counter("serve/migrations_total").value
    if readable:
        assert router.stats()["requests_replayed"] == 0 and migrations >= 1
    else:
        assert router.stats()["requests_replayed"] >= 1 and migrations == 0


def test_migrate_lane_rebalances_and_idles_false(weights):
    want = _baseline(weights, [_prompt(1), _prompt(2)], [_gen("greedy")] * 2)
    router = ReplicaRouter([_engine(weights), _engine(weights)], policy="disaggregated",
                           registry=MetricsRegistry())
    assert router.migrate_lane() is False
    r1 = router.submit(_prompt(1), config=_gen("greedy"))
    r2 = router.submit(_prompt(2), config=_gen("greedy"))
    for _ in range(3):
        router.step()
    assert router.migrate_lane(reason="rebalance") is True
    router.run()
    assert [list(r1.tokens), list(r2.tokens)] == want


def test_role_and_policy_validation(weights):
    with pytest.raises(ValueError, match="role"):
        _engine(weights, role="decoder")
    with pytest.raises(ValueError, match="paged"):
        _engine(weights, role="prefill", paged=False, prefix_cache_mb=0.0)
    pre, dec = _engine(weights, role="prefill"), _engine(weights, role="decode")
    with pytest.raises(ValueError, match="decode-capable"):
        ReplicaRouter([pre], policy="disaggregated", registry=MetricsRegistry())
    with pytest.raises(ValueError, match="prefill-capable"):
        ReplicaRouter([dec], policy="disaggregated", registry=MetricsRegistry())
    with pytest.raises(ValueError, match="policy"):
        ReplicaRouter([dec], policy="random", registry=MetricsRegistry())
    assert pre.graphs is None and pre.compiled_executable_counts()["decode_window"] == 0


# ------------------------------------------------------------- elasticity
def test_add_drain_detach(weights):
    a = _engine(weights)
    router = ReplicaRouter([a], registry=MetricsRegistry())
    b = _engine(weights)
    rid = router.add_replica(b)
    assert router.replica_ids() == [0, rid] and router.health()["replicas"] == 2
    reqs = [router.submit(_prompt(i), config=_gen("greedy", n=6)) for i in range(4)]
    assert {r.replica_id for r in reqs} == {0, rid}  # least-loaded spreads them
    with pytest.raises(RuntimeError, match="still has work"):
        router.detach_replica(rid)
    router.drain_replica(rid)
    with pytest.raises(ValueError, match="last admitting"):
        router.drain_replica(0)
    late = router.submit(_prompt(9), config=_gen("greedy", n=6))
    assert late.replica_id == 0  # no new request lands on the draining replica
    router.run()
    assert all(r.done for r in reqs + [late])
    assert router.replica_ids() == [0]  # detached once idle
    assert router.cancel(reqs[[r.replica_id for r in reqs].index(rid)]) is False
    want = _baseline(weights, [_prompt(i) for i in range(4)], [_gen("greedy", n=6)] * 4)
    assert [list(r.tokens) for r in reqs] == want


def test_hot_swap_and_version_pinning(weights):
    """A rolling swap over replicas holding their own weights: zero failed
    requests, no graph captured again, the tokens after it a fresh engine's
    on the new weights; ``model_version`` pins requests while versions
    differ."""
    _, _, _, port = weights
    a, b = _engine(weights), _engine(weights)
    router = ReplicaRouter([a, b], registry=MetricsRegistry())
    inflight = [router.submit(_prompt(i), config=_gen("greedy", n=8)) for i in range(3)]
    while not all(r.state.name == "RUNNING" for r in inflight):
        router.step()
    captures = [e.stats["graph_captures"] for e in (a, b)]
    assert router.hot_swap(port[1], version="v1") == 2
    router.run()
    # every lane running at the swap finished on the weights it started on
    assert all(r.done and len(r.tokens) == 8 for r in inflight)
    assert [list(r.tokens) for r in inflight] == _baseline(
        weights, [_prompt(i) for i in range(3)], [_gen("greedy", n=8)] * 3)
    assert router.versions() == {"v1": 2}
    assert [e.stats["graph_captures"] for e in (a, b)] == captures
    after = router.serve([_prompt(5)], configs=_gen("greedy"))
    fresh = _engine(weights, seed=1)
    assert list(after[0].tokens) == list(fresh.serve([_prompt(5)],
                                                     configs=_gen("greedy"))[0].tokens)
    # one replica back on the first weights: pinning routes by version
    router.engines[0].swap_params({k: v.clone() for k, v in port[0].items()}, version="v0")
    pinned = [router.submit(_prompt(6), config=_gen("greedy"), model_version=v)
              for v in ("v0", "v1")]
    assert [r.replica for r in pinned] == [0, 1]
    with pytest.raises(Exception) as ei:
        router.submit(_prompt(6), config=_gen("greedy"), model_version="v9")
    assert ei.value.retriable is False
    router.run()


def test_shared_weights_refuse_the_swap(weights):
    """Replicas built on one weight set: the swap is refused before
    anything changes (each replica needs its own copy)."""
    _, _, cfg, port = weights
    own = {k: v.clone() for k, v in port[0].items()}
    model = Transformer(cfg, device="meta")
    model.load_state_dict(own, assign=True)
    a = ServingEngine(model, None, device="cpu", registry=MetricsRegistry(), **KW)
    b = ServingEngine(model, None, device="cpu", registry=MetricsRegistry(), **KW)
    router = ReplicaRouter([a, b], registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="same storage"):
        router.hot_swap(port[1], version="v1")
    assert router.versions() == {"v0": 2}
    assert not any(e.admission_paused for e in (a, b))
