"""Port parity across processes: the router over replicas on disjoint rank groups.

The reference serves 2 x tp2 replicas behind one ``ReplicaRouter`` from one
program on four devices (``test_serving_mesh.py::TestRouterOverTpReplicas``);
the port runs one process a rank, every rank running the same router over
the engine of its own replica and the meshes of the others
(``serving/remote.py``).  One world of 4 ``gloo`` processes
(``debug_launcher``; rank functions in ``tests/torch_router_workers.py``)
runs every scenario below; the JAX engines and routers run here, in the
pytest process, on 4 of the conftest's CPU devices, on the same f32 weights
(``TransformerConfig.tiny``) and the same prompts from a numpy seed.  Tokens
are compared exactly (greedy f32: no logit tolerance enters).

* The headline composition: 2 x tp2, tokens equal to the JAX router's and
  to a one-device engine's; every rank returns every request's tokens.
* ``TestReplicaRouter``'s cases over processes (``test_serving_mesh.py:
  175-287``): affinity prefers the warm replica, the cold-cache least-loaded
  fallback, round robin, failover when a replica refuses, stats aggregation,
  the route flight event and cancel on the owning replica.
* Lanes migrated between disjoint groups mid-generation, greedy and sampled
  (equal tp, and tp2 beside single-rank replicas both ways), and the
  disaggregated prefill->decode handoff across groups (``test_disagg.py:
  170-222``).
* A replica killed on every rank mid-serve: its requests finish on the
  survivor with the uninterrupted tokens, the breaker re-admits it; a kill
  on one rank raises on every rank within the deadline.
* A replica drained and detached mid-serve, another added on its ranks,
  and a rolling ``hot_swap`` over both.
* The HTTP front door over 2 x tp2 (rank 0 serves, the others follow), with
  an idle spell past the heartbeat interval.
* int8, int4, fp8 and MoE models at tp2 against the JAX engine's tp2.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.ops.quantization import Int4Config as JInt4Config
from accelerate_tpu.ops.quantization import Int8Config as JInt8Config
from accelerate_tpu.ops.quantization import quantize_model_params as jquantize
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.parallel.mesh import replica_meshes as jreplica_meshes
from accelerate_tpu.serving import ReplicaRouter as JReplicaRouter
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry as JMetricsRegistry
from accelerate_tpu_torch.launchers import debug_launcher

import torch_dist_workers as dist_workers
import torch_router_workers as workers

WORLD = 4
VOCAB = 256
GREEDY = dict(max_new_tokens=8, do_sample=False)
MODELS = {"int8": dict(quantization=8), "int4": dict(quantization=4),
          "fp8": dict(use_fp8=True), "moe": dict(num_experts=4, num_experts_per_tok=2)}


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (n,)).astype(np.int32) for n in lengths]


def _jparams(seed=0, **kw):
    cfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64, **kw)
    model = JTransformer(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _jengine(model, params, mesh=None, **kw):
    return JServingEngine(model, params, registry=JMetricsRegistry(), mesh=mesh,
                          **dict(workers.MESH_KW, paged=True, **kw))


def _jtokens(engine, prompts, gen):
    return [list(r.tokens) for r in engine.serve([p.copy() for p in prompts],
                                                 JGenerationConfig(**gen))]


def _cases():
    common = _prompts(2, (16,))[0]
    return [
        dict(tag="serve", prompts=_prompts(10, (8, 12, 5, 9)), gen=GREEDY),
        dict(tag="placement", kind="placement", prompts=dict(
            common=common, cold=_prompts(3, (8, 8)), rr=_prompts(4, (8, 8, 8, 8)),
            long=_prompts(5, (12,))[0], longest=_prompts(6, (63,))[0],
            stats=_prompts(7, (8, 10, 6, 9)), event=_prompts(8, (8,))[0],
            cancel=_prompts(9, (8,))[0])),
        dict(tag="migrate", kind="migrate", prompts=[_prompts(11 + i, (8,))[0] for i in range(2)],
             gens=[dict(max_new_tokens=10), dict(max_new_tokens=10, do_sample=True,
                                                 temperature=0.8, top_k=50)],
             migrate_at=4, equal=[1, 0], unequal=[2, 0]),
        dict(tag="handoff", kind="handoff", prompts=_prompts(13, (6, 7, 8)),
             gen=dict(max_new_tokens=10)),
        dict(tag="failover", kind="failover", prompts=_prompts(10, (8, 12, 5, 9)), gen=GREEDY),
        dict(tag="elastic", kind="elastic", prompts=_prompts(10, (8, 12, 5, 9)), gen=GREEDY),
        dict(tag="frontdoor", kind="frontdoor", prompts=_prompts(10, (8, 12, 5, 9)), gen=GREEDY,
             heartbeat_s=0.5, idle_s=1.5),
        *[dict(tag=name, model=name, cfg=cfg, prompts=_prompts(20, (5, 9, 3, 12)), gen=GREEDY)
          for name, cfg in MODELS.items()],
        dict(tag="kill_one", kind="kill_one", prompts=_prompts(3, (6, 7)),
             gen=dict(max_new_tokens=6), deadline_s=60.0),
    ]


def _model_params():
    """Each model of :data:`MODELS`: the JAX model and its numpy params."""
    out = {}
    base_model, base = _jparams()
    for name, quant in (("int8", JInt8Config()), ("int4", JInt4Config())):
        q = jax.tree_util.tree_map(np.asarray, jquantize(base, quant))
        out[name] = (JTransformer(dataclasses.replace(base_model.config,
                                                      quantization=quant.bits)), q)
    out["fp8"] = _jparams(use_fp8=True)
    out["moe"] = _jparams(num_experts=4, num_experts_per_tok=2)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world in a thread while the JAX engines serve here."""
    out_dir = tmp_path_factory.mktemp("router_dist")
    jmodel, jparams = _jparams()
    models = _model_params()
    by_model = {"llama": jparams, **{name: p for name, (_, p) in models.items()}}
    cases = _cases()
    errors = []

    def port():
        try:
            debug_launcher(workers.router_dist_cases, (str(out_dir), by_model, cases),
                           num_processes=WORLD)
        except BaseException as e:  # noqa: BLE001 (re-raised in the test process)
            errors.append(e)

    thread = threading.Thread(target=port)
    thread.start()
    by_tag = {c["tag"]: c for c in cases}
    want = {}
    c = by_tag["serve"]
    want["tp1"] = _jtokens(_jengine(jmodel, jparams), c["prompts"], c["gen"])
    jrouter = JReplicaRouter([_jengine(jmodel, jparams, mesh=m, prefix_cache_mb=4.0)
                              for m in jreplica_meshes(2, {"tp": 2},
                                                       devices=jax.devices()[:4])],
                             registry=JMetricsRegistry())
    want["router"] = [list(r.tokens) for r in jrouter.serve(
        [p.copy() for p in c["prompts"]], JGenerationConfig(**c["gen"]))]
    small = workers.SMALL_KW
    c = by_tag["migrate"]
    want["migrate"] = _jtokens(JServingEngine(jmodel, jparams, registry=JMetricsRegistry(),
                                              paged=True, **small),
                               c["prompts"][:1], c["gens"][0])
    c = by_tag["handoff"]
    want["handoff"] = _jtokens(JServingEngine(jmodel, jparams, registry=JMetricsRegistry(),
                                              paged=True, **small), c["prompts"], c["gen"])
    mesh2 = jbuild_mesh({"tp": 2}, devices=jax.devices()[:2])
    for name, (model, params) in models.items():
        c = by_tag[name]
        want[name] = _jtokens(_jengine(model, params, mesh=mesh2), c["prompts"], c["gen"])
    thread.join()
    if errors:
        raise errors[0]
    got = {c["tag"]: dist_workers.load_ranks(out_dir, c["tag"], WORLD) for c in cases}
    return want, got


def _every_rank(got, tag, key=None):
    """The case's result (its ``key`` part), the same on every rank."""
    ranks = [r if key is None else r[key] for r in got[tag]]
    assert all(r == ranks[0] for r in ranks[1:]), f"{tag}: the ranks disagree"
    return ranks[0]


# ------------------------------------------------------------- composition
def test_router_over_tp2_replicas_equals_jax(runs):
    """2 x tp2 on four ranks: every rank returns every request's tokens,
    the JAX router's and the one-device engine's."""
    want, got = runs
    out = _every_rank(got, "serve")
    assert want["router"] == want["tp1"]
    assert out["tokens"] == want["router"]
    assert out["tp_degrees"] == [2, 2] and out["local_tp"] == 2
    assert sorted(set(out["replicas"])) == [0, 1]


# ------------------------------------------------------- TestReplicaRouter
def test_affinity_prefers_warm_replica(runs):
    _, got = runs
    out = _every_rank(got, "placement", "affinity")
    assert out["later"] == [out["warm"], out["warm"]]
    assert out["hit_rate"] > 0


def test_cold_cache_falls_back_least_loaded(runs):
    _, got = runs
    assert sorted(_every_rank(got, "placement", "cold")) == [0, 1]


def test_round_robin_cycles(runs):
    _, got = runs
    assert _every_rank(got, "placement", "round_robin") == [0, 1, 0, 1]


def test_failover_when_replica_refuses(runs):
    """The chosen replica refuses a 12-token prompt (``max_prompt_len`` 8):
    the request lands on the other; a prompt no replica takes raises the
    last refusal (``AdmissionError``, a ``ValueError``) on every rank."""
    _, got = runs
    out = _every_rank(got, "placement", "refuse")
    assert out["replica"] == 1 and out["tokens"] == 8
    assert out["refused"] == ["AdmissionError", False]


def test_cross_replica_stats_aggregation(runs):
    _, got = runs
    ranks = [r["stats"] for r in got["placement"]]
    out = ranks[0]
    assert all({k: v for k, v in r.items() if k not in ("local", "lead")}
               == {k: v for k, v in out.items() if k not in ("local", "lead")} for r in ranks)
    assert out["tokens"] == [4] * 4 and out["routed"] == 4
    leads = [r["local"] for r in ranks if r["lead"]]
    assert len(leads) == 2
    for key in ("requests_completed", "decode_steps"):
        assert out["agg"][key] == sum(lead[key] for lead in leads)
    assert out["agg"]["requests_completed"] == 4
    assert out["per_replica"] == 2 and 0.0 <= out["hit_rate"] <= 1.0
    assert out["gauge"] == 2.0 and out["replicas"] == 2 and out["idle"]


def test_route_flight_events(runs):
    _, got = runs
    out = _every_rank(got, "placement", "event")
    assert out["last"] == out["replica"]


def test_cancel_targets_owning_replica(runs):
    _, got = runs
    out = _every_rank(got, "placement", "cancel")
    assert out["ok"] and out["tokens"] < 8 and out["state"] == "cancelled"


# --------------------------------------------------------------- migration
@pytest.mark.parametrize("arm", ["equal", "unequal"])
def test_migration_between_disjoint_groups(runs, arm):
    """Each lane moved mid-generation to a replica on other ranks continues
    bit-identically, greedy and sampled; the greedy lane's tokens are the
    JAX engine's.  ``unequal``: tp2 on ranks 0-1 beside single-rank
    replicas on ranks 2 and 3 (a mesh replica beside single-card ones),
    one lane tp2 -> tp1, the other tp1 -> tp2."""
    want, got = runs
    out = _every_rank(got, "migrate")[arm]
    assert out["migrated"] == out["baseline"]
    assert out["baseline"][0] == want["migrate"][0]
    assert out["migrations"] == 2
    assert all(ok and src != dst for src, ok, dst in out["moved"])
    assert out["tp"] == ([2, 2] if arm == "equal" else [2, 1, 1])


def test_disaggregated_handoff_across_groups(runs):
    """Prefill on ranks 0-1, decode on ranks 2-3: every lane handed off
    through the host, the tokens the JAX engine's."""
    want, got = runs
    ranks = got["handoff"]
    assert all(r["tokens"] == want["handoff"] for r in ranks)
    assert all(r["handoffs"] == 3 for r in ranks)
    for r in ranks:
        if r["role"] == "decode":
            assert r["completed"] == 3
        else:
            assert r["completed"] == 0 and r["decode_steps"] == 0


# ---------------------------------------------------------------- failover
def test_killed_replica_fails_over_and_readmits(runs):
    want, got = runs
    out = _every_rank(got, "failover")
    assert out["tokens"] == want["tp1"]
    assert out["ejections"] == 1 and out["replicas_after_kill"] == 1
    assert out["replayed"] > 0
    assert out["replicas_after_probe"] == 2 and out["breaker"] == []
    assert out["again"] == want["tp1"]
    assert out["ids"] == [1, 2]


def test_drain_add_and_hot_swap_over_processes(runs):
    """Replica 0 drains mid-serve and detaches on every rank at the same
    step; a fresh replica on its ranks attaches with the next stable id;
    ``hot_swap`` rolls the same weights over both under label ``v2``; every
    serve gives the one-device engine's tokens, on every rank."""
    want, got = runs
    out = _every_rank(got, "elastic")
    assert out["drained"] == want["tp1"] and out["ids_after_drain"] == [1]
    assert out["new_id"] == 2 and out["replicas"] == [1, 2]
    assert out["swapped"] == 2 and out["versions"] == {"v2": 2}
    assert out["labels"] == ["v2", "v2"]
    assert out["tokens"] == want["tp1"]


def test_kill_on_one_rank_raises_everywhere(runs):
    """A kill on one rank of a replica: every rank raises the plan
    divergence (rank 0 holds an error rank 1 does not) within the deadline,
    no collective hangs."""
    _, got = runs
    err = _every_rank(got, "kill_one")
    assert err is not None, "the router drained instead of raising"
    assert err[0] == "PlanDivergence" and "hold the error of an earlier step" in err[1]
    assert err[2], "raised after the deadline"


# -------------------------------------------------------------- front door
def test_frontdoor_over_processes(runs):
    """Rank 0's HTTP server over 2 x tp2: every completion's tokens are the
    in-process serve's, also after an idle spell past the heartbeat
    interval and after a rolling hot swap whose weights each follower
    supplied; the followers applied every ticket (the same routed count and
    weights labels), their mirrors of rank 0's requests ended on the same
    tokens, and they returned when rank 0 stopped."""
    want, got = runs
    lead, *followers = got["frontdoor"]
    assert [status for status, _ in lead["http"]] == [200] * 4
    assert [tokens for _, tokens in lead["http"]] == want["tp1"]
    assert tuple(lead["after_idle"]) == (200, want["tp1"][0])
    assert lead["swapped"] == 2 and tuple(lead["after_swap"]) == (200, want["tp1"][1])
    assert lead["health"] == 2 and lead["routed"] == 6
    assert all(f["routed"] == 6 for f in followers)
    assert all(f["tokens"] == [*want["tp1"], want["tp1"][0], want["tp1"][1]]
               for f in followers)
    assert all(r["versions"] == {"v2": 2} for r in got["frontdoor"])


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("name", list(MODELS))
def test_quantized_fp8_moe_models_at_tp2(runs, name):
    """Weight-quantized (int8, int4) and fp8 projections kept whole on every
    rank, each rank's heads their block of the product; the MoE block whole
    on the gathered hidden state: the tokens are the JAX engine's at tp2."""
    want, got = runs
    out = _every_rank(got, name)
    assert out["tokens"] == want[name]
    assert out["local_tp"] == 2
