"""Port parity: the engine's telemetry and fleet surface against the JAX
engine's.

``TransformerConfig.tiny`` at f32, the JAX ``ServingEngine(paged=True,
decode_kernel="pallas")`` (its kernels in interpret mode) and the port's
engine, each with a private ``MetricsRegistry``, serve the same workload
(six prompts, two sharing a 16-token prefix and one equal to it, two
tenants and two request classes):

* the registries hold the same metric names, except the port-only ones
  listed in :data:`PORT_ONLY` with their reasons; every ``serve/*_total``
  counter and every histogram's count are equal;
* the flight-recorder event kinds of each engine, the phase names of each
  request's waterfall, ``compiled_executable_counts()`` and the tenant and
  class books are equal.

Then the fleet methods: ``swap_params`` refuses an engine that is not
drained, a shape change and storage another engine serves; after a swap the
tokens equal a fresh port engine's on the new weights and the JAX engine's
after its own swap; an injected upload fault keeps the old weights.  A
failover (``kill`` at the same step on both, ``export_inflight``, ``adopt``
on a survivor) exports the same rids and effective prompts as the JAX
engine, the adopted tokens equal the uninterrupted serve and the JAX
survivor's, no token is streamed twice, and ``revive`` serves again.  The
remaining fault points (page exhaustion, a slow and a failed readback, a
failed dispatch, a failed promotion) keep every token.

JAX telemetry is on only inside this module, with private process-wide
recorders and trace registries (both packages'), restored afterwards, so
no other test finds a stale heartbeat.  No wall-clock age is read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGen
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry as JRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.serving import ServingEngine, faults
from accelerate_tpu_torch.serving.faults import FaultInjected
from accelerate_tpu_torch.telemetry import MetricsRegistry
from accelerate_tpu_torch.weights import params_from_jax

KW = dict(num_slots=2, max_len=64, prefill_buckets=(16,), decode_window=2)
NEW = 6
TENANTS = ("acme", "beta")
CLASSES = ("chat", "batch")

#: metric names only the port's registry holds, and why: running totals of
#: ``stats`` keys the reference does not count (host wall seconds of its
#: phases, the CUDA graphs captured and replayed, the verify forwards'
#: accounting, the prefix cache's transfer bytes and times, degraded
#: promotions and reclaim evictions)
PORT_ONLY = {f"serve/{k}_total" for k in (
    "prefill_s", "decode_s", "draft_s", "device_idle_s", "spill_s", "promote_s",
    "graph_captures", "graph_replays", "verify_forwards", "verify_lanes",
    "verify_committed", "spill_bytes", "promote_bytes", "promote_degraded",
    "reclaim_evictions")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _private_telemetry():
    """Telemetry on in both packages, each with a process-wide recorder and
    trace registry of this module's own; the originals come back after."""
    from accelerate_tpu.telemetry import flight_recorder as jfr
    from accelerate_tpu.telemetry import metrics as jmetrics
    from accelerate_tpu.telemetry import reqtrace as jrt
    from accelerate_tpu_torch.telemetry import flight_recorder as pfr
    from accelerate_tpu_torch.telemetry import reqtrace as prt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmetrics, "_ENABLED", True)
        for mod, fresh in ((jfr, jfr.FlightRecorder), (pfr, pfr.FlightRecorder),
                           (jrt, jrt.RequestTraceRegistry), (prt, prt.RequestTraceRegistry)):
            mp.setattr(mod, "_DEFAULT", fresh())
        yield


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64)
    jmodel = JTransformer(jcfg)
    jparams = [jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
               for seed in (0, 1)]
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=64)
    return jmodel, jparams, cfg


def _port_params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _engine(cfg, jparams, **kw):
    """A port engine on its own copy of the weights."""
    return ServingEngine(Transformer(cfg, device="cpu"), _port_params(jparams), device="cpu",
                         registry=MetricsRegistry(), **{**KW, **kw})


def _prompts():
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 256, (16,)).astype(np.int32)
    tail = lambda n: rng.integers(1, 256, (n,)).astype(np.int32)  # noqa: E731
    return [tail(5), np.concatenate([prefix, tail(4)]), tail(9), tail(30),
            np.concatenate([prefix, tail(7)]), prefix.copy()]


def _submit_all(engine, gen_cls, prompts):
    return [engine.submit(p.copy(), config=gen_cls(max_new_tokens=NEW),
                          tenant=TENANTS[i % 2], request_class=CLASSES[i % 2])
            for i, p in enumerate(prompts)]


def _kinds(engine):
    return {ev["kind"] for ev in engine.recorder.tail() if ev.get("engine") == engine.engine_id}


@pytest.fixture(scope="module")
def parity(weights):
    """The workload through both engines (each run once for the module)."""
    jmodel, jparams, cfg = weights
    prompts = _prompts()
    jeng = JServingEngine(jmodel, jparams[0], paged=True, decode_kernel="pallas",
                          registry=JRegistry(), **KW)
    jreqs = _submit_all(jeng, JGen, prompts)
    jeng.run()
    peng = _engine(cfg, jparams[0])
    preqs = _submit_all(peng, GenerationConfig, prompts)
    peng.run()
    return jeng, jreqs, peng, preqs


def test_same_tokens_counters_and_histograms(parity):
    jeng, jreqs, peng, preqs = parity
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    js, ps = jeng.metrics.snapshot(), peng.metrics.snapshot()
    assert set(ps) - set(js) == PORT_ONLY
    assert set(js) <= set(ps)
    for name in sorted(js):
        if name.endswith("_total"):
            assert ps[name] == js[name], name
        elif isinstance(js[name], dict):
            assert ps[name]["count"] == js[name]["count"], name
    # the workload reaches the prefix cache, its copy-on-write and reuse
    assert ps["serve/prefix_hit_tokens_total"] > 0 and ps["serve/cow_copies_total"] == 1
    assert ps["serve/slots_reused_total"] == 4 and ps["serve/ttft_s"]["count"] == 6
    assert ps["serve/requests_completed_total"] == 6


def test_same_event_kinds_waterfalls_and_books(parity):
    jeng, jreqs, peng, preqs = parity
    assert _kinds(peng) == _kinds(jeng)
    assert {"serve/submit", "serve/install", "serve/finish", "serve/step"} <= _kinds(peng)
    for p, j in zip(preqs, jreqs):
        assert [ph["phase"] for ph in p.trace.phases] == [ph["phase"] for ph in j.trace.phases]
        assert p.trace.finished and p.trace.status == j.trace.status == "done"
    assert peng.compiled_executable_counts() == jeng.compiled_executable_counts() == {
        "decode_window": 1, "lane_install": 1, "copy_page": 1, "prefill_16": 1}
    pst, jst = peng.stats(), jeng.stats()
    assert pst["tenants"] == jst["tenants"]
    for key in ("requests_submitted", "requests_completed", "tokens_generated"):
        assert sum(t[key] for t in pst["tenants"].values()) == pst[key]
    for cls in CLASSES:
        name = f"serve/ttft_s_class_{cls}"
        assert peng.metrics.get(name).count == jeng.metrics.get(name).count == 3
    assert (pst["requests"]["completed"], pst["requests"]["active"]) == (6, 0)


def test_cost_table_counts_the_formula(parity):
    """``analyze_costs``: the decode window's FLOPs are its formula exactly
    (2 per matrix weight a token, attention at the table's width), published
    per token; nothing records card memory on the CPU.  The JAX figure (an
    XLA heuristic) is printed beside it, not compared."""
    jeng, _, peng, _ = parity
    snap = peng.analyze_costs()
    cfg = peng.model.config
    hd, h, layers = cfg.resolved_head_dim, cfg.hidden_size, cfg.num_layers
    matrices = layers * (h * hd * 2 * (cfg.num_heads + cfg.num_kv_heads)
                         + 3 * h * cfg.intermediate_size) + h * cfg.vocab_size
    keys = peng.kv.pages_per_lane * peng.page_size
    per_token = 2 * matrices + 4 * hd * cfg.num_heads * layers * keys
    window = snap["serve/decode_window"]
    assert window["flops"] == per_token * KW["num_slots"] * KW["decode_window"]
    weights = sum(t.numel() * t.element_size() for t in peng.model.state_dict().values())
    kv = 2 * layers * KW["num_slots"] * keys * cfg.num_kv_heads * hd * 4
    assert window["bytes_accessed"] == KW["decode_window"] * (weights + kv)
    assert peng.metrics.get("serve/decode_flops_per_token").value == per_token
    assert window["hbm_peak_bytes"] is None and peng.cost_table.max_hbm_peak_bytes() is None
    assert set(snap) >= {"serve/decode_window", "serve/prefill_16", "serve/lane_install",
                         "serve/copy_page"}
    print("decode FLOPs a token: port", per_token, "JAX (XLA)",
          jeng.analyze_costs()["serve/decode_window"]["flops"] / 4)


def test_swap_params_refusals(weights):
    _, jparams, cfg = weights
    engine = _engine(cfg, jparams[0])
    engine.submit(_prompts()[0], max_new_tokens=NEW)
    engine.step()
    with pytest.raises(RuntimeError, match="drained"):
        engine.swap_params(_port_params(jparams[1]))
    engine.run()
    bad = _port_params(jparams[1])
    name = next(iter(bad))
    bad[name] = bad[name][..., :-1]
    with pytest.raises(ValueError, match=name):
        engine.swap_params(bad)
    # a second engine on the same tensors: swapping either would change both
    shared = _port_params(jparams[0])
    first = ServingEngine(Transformer(cfg, device="cpu"), shared, device="cpu",
                          registry=MetricsRegistry(), **KW)
    second = ServingEngine(Transformer(cfg, device="cpu"), shared, device="cpu",
                           registry=MetricsRegistry(), **KW)
    with pytest.raises(RuntimeError, match=second.engine_id):
        first.swap_params(_port_params(jparams[1]))
    assert engine.stats["hot_swaps"] == 0


@pytest.fixture(scope="module")
def swapped(weights):
    """A port and a JAX engine that served on weights A, swapped to B under
    paused admission, then served two requests; and a fresh port engine on B."""
    jmodel, jparams, cfg = weights
    prompts = _prompts()[:2]
    jeng = JServingEngine(jmodel, jparams[0], paged=True, decode_kernel="pallas",
                          registry=JRegistry(), **KW)
    jeng.serve([p.copy() for p in prompts], configs=JGen(max_new_tokens=NEW))
    jeng.pause_admission()
    jeng.swap_params(jparams[1], version="v1")
    jeng.resume_admission()
    jtoks = [r.tokens for r in jeng.serve([p.copy() for p in prompts],
                                          configs=JGen(max_new_tokens=NEW))]
    peng = _engine(cfg, jparams[0])
    before = [r.tokens for r in peng.serve([p.copy() for p in prompts],
                                           configs=GenerationConfig(max_new_tokens=NEW))]
    peng.pause_admission()
    queued = peng.submit(prompts[0].copy(), max_new_tokens=NEW)
    peng.step()
    assert peng.drained and queued.state.value == "queued"
    peng.swap_params(_port_params(jparams[1]), version="v1")
    peng.resume_admission()
    peng.run()
    ptoks = [r.tokens for r in peng.serve([p.copy() for p in prompts],
                                          configs=GenerationConfig(max_new_tokens=NEW))]
    fresh = _engine(cfg, jparams[1])
    ftoks = [r.tokens for r in fresh.serve([p.copy() for p in prompts],
                                           configs=GenerationConfig(max_new_tokens=NEW))]
    return jeng, jtoks, peng, ptoks, before, queued, fresh, ftoks


def test_swap_params_serves_the_new_weights(swapped):
    jeng, jtoks, peng, ptoks, before, queued, _, ftoks = swapped
    assert ptoks == ftoks == jtoks
    assert before != ptoks
    # the request queued across the swap decodes under the new weights
    assert queued.tokens == ftoks[0]
    assert peng.weights_version == "v1" and peng.stats["hot_swaps"] == 1
    assert "serve/hot_swap" in _kinds(peng)
    assert peng.prefix_cache.num_nodes == 0 or peng.stats["prefix_hit_tokens"] == 0


def test_swap_upload_fault_keeps_old_weights(weights):
    _, jparams, cfg = weights
    prompts = _prompts()[:2]
    engine = _engine(cfg, jparams[0])
    want = [r.tokens for r in engine.serve([p.copy() for p in prompts],
                                           configs=GenerationConfig(max_new_tokens=NEW))]
    faults.install("hot_swap_upload@1")
    try:
        with pytest.raises(FaultInjected):
            engine.swap_params(_port_params(jparams[1]), version="v1")
    finally:
        faults.clear()
    got = [r.tokens for r in engine.serve([p.copy() for p in prompts],
                                          configs=GenerationConfig(max_new_tokens=NEW))]
    assert got == want and engine.weights_version == "v0"
    assert engine.stats["hot_swaps"] == 0
    assert engine.stats["prefix_hit_tokens"] > 0  # the cache survived the refusal


KILL_STEP = 4


@pytest.fixture(scope="module")
def failover(weights, swapped):
    """Both packages: an engine on B killed at step ``KILL_STEP``, its
    requests exported and adopted by the swapped engine (also on B)."""
    jmodel, jparams, cfg = weights
    jeng_y, _, peng_y, _, _, _, fresh, _ = swapped
    prompts = _prompts()
    jx = JServingEngine(jmodel, jparams[1], paged=True, decode_kernel="pallas",
                        registry=JRegistry(), **KW)
    jreqs = [jx.submit(p.copy(), config=JGen(max_new_tokens=NEW)) for p in prompts]
    px = _engine(cfg, jparams[1])
    seen = []
    preqs = [px.submit(p.copy(), config=GenerationConfig(max_new_tokens=NEW),
                       on_token=lambda r, t: seen.append((id(r), len(r.tokens))))
             for p in prompts]
    for _ in range(KILL_STEP):
        jx.step()
        px.step()
    decoding = int(px._active.sum())
    queued = px.scheduler.queue_depth
    jx.kill()
    px.kill()
    with pytest.raises(FaultInjected):
        px.step()
    jexp, pexp = jx.export_inflight(), px.export_inflight()
    exported = [(r.rid, r.prefill_tokens.tolist()) for r in pexp]
    jexported = [(r.rid, r.prefill_tokens.tolist()) for r in jexp]
    for r in jexp:
        jeng_y.adopt(r)
    jeng_y.run()
    for r in pexp:
        peng_y.adopt(r)
    peng_y.run()
    uninterrupted = [r.tokens for r in fresh.serve(
        [p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=NEW))]
    return dict(jreqs=jreqs, preqs=preqs, exported=exported, jexported=jexported,
                decoding=decoding, queued=queued, seen=seen, px=px, py=peng_y,
                uninterrupted=uninterrupted, prompts=prompts)


def test_failover_exports_and_replays_like_the_reference(failover):
    f = failover
    assert f["decoding"] >= 2 and f["queued"] >= 1
    assert f["exported"] == f["jexported"]
    assert [r.tokens for r in f["preqs"]] == [r.tokens for r in f["jreqs"]] == f["uninterrupted"]
    # every token reached on_token once (adopt gave the requests new rids:
    # the stream is keyed by the request itself)
    for req in f["preqs"]:
        lengths = [n for key, n in f["seen"] if key == id(req)]
        assert lengths == list(range(1, NEW + 1))
    assert f["py"].stats["requests_replayed"] == len(f["exported"])
    assert any(ph["phase"] == "failover" for r in f["preqs"] for ph in r.trace.phases)
    assert {"serve/engine_poisoned", "serve/export_inflight"} <= _kinds(f["px"])
    assert "serve/adopt" in _kinds(f["py"])


def test_revive_serves_again(failover):
    f = failover
    px = f["px"]
    px.revive()
    assert px.drained and px._poisoned is None
    assert px.kv.allocator.free_count + px.prefix_cache.stats()["nodes"] == px.num_pages - 1
    toks = [r.tokens for r in px.serve([p.copy() for p in f["prompts"][:2]],
                                       configs=GenerationConfig(max_new_tokens=NEW))]
    assert toks == f["uninterrupted"][:2]
    assert "serve/revive" in _kinds(px)


@pytest.mark.parametrize("plan,poisons", [
    ("page_exhaustion@3", False), ("fetch_slow@2,slow_ms=1", False),
    ("decode_dispatch@3", True), ("fetch_fail@2", True), ("promote_h2d@1", False),
])
def test_fault_points_keep_every_token(weights, plan, poisons):
    """Each engine fault point: a forced preemption and a stalled readback
    keep the tokens; a failed dispatch or readback poisons the engine, whose
    export replays on a survivor to the same tokens; a failed promotion from
    the host tier prefills the chunk instead."""
    _, jparams, cfg = weights
    prompts = _prompts()
    host = dict(prefix_cache_mb=16 * 514 / 2**20, prefix_host_mb=1.0)
    want = [r.tokens for r in _engine(cfg, jparams[0], **host).serve(
        [p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=NEW))]
    engine = _engine(cfg, jparams[0], **host)
    faults.install(plan)
    try:
        reqs = [engine.submit(p.copy(), max_new_tokens=NEW) for p in prompts]
        try:
            engine.run()
        except FaultInjected:
            assert poisons
            survivor = _engine(cfg, jparams[0])
            for r in engine.export_inflight():
                survivor.adopt(r)
            survivor.run()
        fired = faults.ACTIVE.fired(plan.split("@")[0])
    finally:
        faults.clear()
    assert fired == 1
    assert [r.tokens for r in reqs] == want
    counts = engine.compiled_executable_counts()
    assert {"spill_16", "promote_16"} <= set(counts) and max(counts.values()) <= 1


@pytest.mark.parametrize("knobs", [dict(speculate_k=2), dict(interleave_prefill=True),
                                   dict(paged=False)])
def test_decode_replay_on_other_survivors(weights, knobs):
    """An adopted request replays its streamed tokens through decode
    windows on any survivor: one that speculates (the decode window runs
    while a lane replays), one that interleaves prefill, and the slab pool;
    the tokens equal an uninterrupted serve's and none streams twice."""
    _, jparams, cfg = weights
    prompts = _prompts()
    want = [r.tokens for r in _engine(cfg, jparams[1]).serve(
        [p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=NEW))]
    dead = _engine(cfg, jparams[1])
    seen = []
    reqs = [dead.submit(p.copy(), max_new_tokens=NEW,
                        on_token=lambda r, t: seen.append((id(r), len(r.tokens))))
            for p in prompts]
    while sum(1 for r in reqs if r.tokens and not r.done) < 2:
        dead.step()
    dead.kill()
    survivor = _engine(cfg, jparams[1], **knobs)
    exported = dead.export_inflight()
    streamed = sum(len(r.tokens) for r in exported)
    assert streamed > 0
    for r in exported:
        survivor.adopt(r)
    survivor.run()
    assert [r.tokens for r in reqs] == want
    for req in reqs:
        assert [n for key, n in seen if key == id(req)] == list(range(1, NEW + 1))
    # the survivor generated exactly what had not streamed
    assert survivor.stats["tokens_generated"] == NEW * len(exported) - streamed
