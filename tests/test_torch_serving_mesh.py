"""Port parity across processes: tensor-parallel serving, ``ServingEngine(mesh=, tp_axis=)``.

The reference serves one model over a ``tp`` mesh from one program (GSPMD);
the port runs one process a rank, each holding its column block of
q/k/v/gate/up/lm_head and its ``Hkv / tp`` kv heads of every page, with the
columns gathered where GSPMD gathers them.  One world of 2 ``gloo``
processes (``debug_launcher``; rank functions in
``tests/torch_dist_workers.py``) runs every scenario below on
``build_mesh({"tp": 2})``; the JAX engines run here, in the pytest process,
on 2 of the conftest's CPU devices, on the same f32 weights
(``TransformerConfig.tiny``) and the same prompts from a numpy seed.

* ``test_serving_mesh.py::TestShardedPoolGeometry``: the page pool holds
  half the kv heads, ``kv_pool_bytes`` is half the one-card engine's on both
  pools, ``serve/tp_degree`` reads 2, only the column-parallel projections
  are cut (``o_proj``/``down_proj`` whole) and indivisible heads raise the
  reference's ``ValueError``.
* ``TestTokenIdentity``: greedy on the slab and the paged pool, n-gram
  speculation, int8 pages and interleaved prefill give, on every rank, the
  JAX engine's tp=2 tokens, which are its tp=1 tokens.  Sampled lanes (Philox
  against threefry) equal the port's own one-process engine at one seed.
* The reference's other mesh compositions: the depth-1 pipeline against the
  synchronous loop (``test_serving_async.py:121``), the prefix tiers with a
  disk ring (``test_hier_cache.py:388``; each rank spills into its own
  directory), a draft-model tree verify (``test_tree_spec.py:410``) and a
  lane moved between two engines of one mesh, d2d, plus a prefill->decode
  handoff (``test_disagg.py:211-222``).
* ``swap_params`` with full weights (each rank keeps its block), an alibi
  model (each rank's heads take the global heads' slopes) against the JAX
  engine; weight-quantized, fp8 and MoE models, the front door over a tp
  engine's router and single-rank replicas on disjoint ranks, each against
  the JAX engine; overlapping replicas, and a mesh of two cards in
  one process, refused.
* A rank that submits one request more raises on every rank at the next
  step (the plan exchange), well inside the launcher's deadline; a mesh
  replica killed on both ranks fails over to the other.
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.ops.quantization import Int8Config as JInt8Config
from accelerate_tpu.ops.quantization import quantize_model_params as jquantize
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving.paging import PagedKVPool as JPagedKVPool
from accelerate_tpu.telemetry import MetricsRegistry as JMetricsRegistry
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.serving import ServingEngine

import torch_dist_workers as workers

WORLD = 2
VOCAB = 256
#: the reference's ``test_serving_mesh.py`` engine
MESH_KW = dict(num_slots=4, max_len=64, prefill_buckets=(8, 16), decode_window=4)
#: ``test_hier_cache.py``'s, ``test_tree_spec.py``'s and ``test_disagg.py``'s
SMALL_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                decode_window=2)
TREE_KW = dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16)
GREEDY = dict(max_new_tokens=12, do_sample=False)
SAMPLED = dict(max_new_tokens=12, do_sample=True, temperature=0.8)
#: the models a mesh engine refused before, each served at tp2
LIFTED = {"int8": dict(quantization=8), "fp8": dict(use_fp8=True),
          "moe": dict(num_experts=4, num_experts_per_tok=2)}


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """The JAX engines beat no heartbeat that a later ``/healthz`` check in
    this process could find stale."""
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


def _jmesh():
    return jbuild_mesh({"tp": 2}, devices=jax.devices()[:2])


def _jserve(model, params, prompts, gen, tp, **kw):
    eng = JServingEngine(model, params, registry=JMetricsRegistry(),
                         mesh=_jmesh() if tp == 2 else None, **kw)
    reqs = eng.serve([p.copy() for p in prompts], JGenerationConfig(**gen))
    return [list(r.tokens) for r in reqs], eng


def _cache_mb(kv_dtype=None, nodes=2.5):
    """``test_hier_cache.py::_cache_mb_for``: about two cached chunks."""
    pool = JPagedKVPool(JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32),
                        num_slots=2, max_len=64, page_size=4, num_pages=17,
                        registry=JMetricsRegistry(), kv_dtype=kv_dtype)
    return nodes * pool.chunk_bytes(2) / 2**20


def _shared_workload(seed=7, n=4, repeat=2):
    rng = np.random.default_rng(seed)
    base = [rng.integers(1, VOCAB, (8,)).astype(np.int32) for _ in range(n)]
    return [p.copy() for _ in range(repeat) for p in base]


def _tier_kw(disk_dir):
    return dict(SMALL_KW, paged=True, async_depth=1, prefix_cache_mb=_cache_mb(),
                prefix_host_mb=_cache_mb(nodes=1.5), prefix_disk_mb=_cache_mb(nodes=8.0),
                prefix_disk_dir=disk_dir)


def _cases(disk_dir):
    p = _prompts(1, (8, 12, 5))
    tree_prompts = _prompts(44, (9, 5, 12))
    mig_prompts = [_prompts(11 + i, (8,))[0] for i in range(2)]
    return [
        dict(tag="geometry", kind="geometry"),
        dict(tag="greedy_slab", kw=dict(MESH_KW, paged=False), prompts=p, gen=GREEDY),
        dict(tag="greedy_paged", kw=dict(MESH_KW, paged=True), prompts=p, gen=GREEDY),
        dict(tag="speculative", kw=dict(MESH_KW, paged=True, speculate_k=2), prompts=p,
             gen=GREEDY),
        dict(tag="int8", kw=dict(MESH_KW, paged=True, kv_dtype="int8"), prompts=p, gen=GREEDY),
        dict(tag="interleave", kw=dict(MESH_KW, paged=True, prefill_kernel="pallas",
                                       interleave_prefill=True), prompts=p, gen=GREEDY),
        dict(tag="sampled", kw=dict(MESH_KW, paged=True, rng_seed=7), prompts=p, gen=SAMPLED),
        dict(tag="sync", kw=dict(MESH_KW, paged=True, async_depth=0), prompts=p, gen=GREEDY),
        dict(tag="tiers", kw=_tier_kw(disk_dir), prompts=_shared_workload(),
             gen=dict(max_new_tokens=5)),
        dict(tag="tiers_off", kw=dict(_tier_kw(None), prefix_host_mb=0.0, prefix_disk_mb=0.0),
             prompts=_shared_workload(), gen=dict(max_new_tokens=5)),
        dict(tag="tree", kw=dict(SMALL_KW, paged=True, **TREE_KW), prompts=tree_prompts,
             gen=dict(max_new_tokens=10)),
        dict(tag="alibi", model="alibi", cfg=dict(positional="alibi"),
             kw=dict(MESH_KW, paged=True), prompts=p, gen=GREEDY),
        dict(tag="alibi_slab", model="alibi", cfg=dict(positional="alibi"),
             kw=dict(MESH_KW, paged=False), prompts=p, gen=GREEDY),
        dict(tag="swap", kind="swap", kw=dict(MESH_KW, paged=True), prompts=p, gen=GREEDY),
        dict(tag="migrate", kind="migrate", kw=dict(SMALL_KW, paged=True, prefix_cache_mb=0.01),
             prompts=mig_prompts, migrate_at=4,
             gens=[dict(max_new_tokens=10), dict(max_new_tokens=10, do_sample=True,
                                                 temperature=0.8, top_k=50)]),
        dict(tag="lifted", kind="lifted", kw=dict(SMALL_KW, paged=True), prompts=p,
             gen=dict(max_new_tokens=6), models=LIFTED),
        dict(tag="router_failures", kind="router_failures", kw=dict(SMALL_KW, paged=True),
             prompts=_prompts(3, (6, 7)), gen=dict(max_new_tokens=6), deadline_s=60.0),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world in a thread while the JAX engines serve here."""
    out_dir = tmp_path_factory.mktemp("serving_mesh")
    disk_dir = str(out_dir / "disk")
    os.makedirs(disk_dir)
    jmodel, jparams = _jparams()
    jalibi, jparams_alibi = _jparams(positional="alibi")
    _, jparams_swap = _jparams(seed=1)
    _, jparams_odd = _jparams(hidden_size=48, num_heads=6, num_kv_heads=3)
    lifted = {"int8": (JTransformer(dataclasses.replace(jmodel.config, quantization=8)),
                       jax.tree_util.tree_map(np.asarray, jquantize(jparams, JInt8Config()))),
              "fp8": _jparams(use_fp8=True), "moe": _jparams(**LIFTED["moe"])}
    by_model = {"llama": jparams, "alibi": jparams_alibi, "swap": jparams_swap,
                "odd": jparams_odd, **{name: p for name, (_, p) in lifted.items()}}
    cases = _cases(disk_dir)
    errors = []

    def port():
        try:
            debug_launcher(workers.serve_mesh_cases, (str(out_dir), by_model, cases),
                           num_processes=WORLD)
        except BaseException as e:  # noqa: BLE001 (re-raised in the test process)
            errors.append(e)

    thread = threading.Thread(target=port)
    thread.start()
    want = {}
    by_tag = {c["tag"]: c for c in cases}
    for tag in ("greedy_slab", "greedy_paged", "speculative", "int8"):
        c = by_tag[tag]
        want[tag] = {tp: _jserve(jmodel, jparams, c["prompts"], c["gen"], tp, **c["kw"])
                     for tp in (1, 2)}
    c = by_tag["interleave"]
    want["interleave"] = {
        1: _jserve(jmodel, jparams, c["prompts"], c["gen"], 1, **dict(MESH_KW, paged=True)),
        2: _jserve(jmodel, jparams, c["prompts"], c["gen"], 2, **c["kw"])}
    jdisk = str(out_dir / "jax_disk")
    os.makedirs(jdisk)
    c = by_tag["tiers"]
    want["tiers"] = {2: _jserve(jmodel, jparams, c["prompts"], c["gen"], 2,
                                **dict(c["kw"], prefix_disk_dir=jdisk))}
    c = by_tag["tree"]
    want["tree"] = {tp: _jserve(jmodel, jparams, c["prompts"], c["gen"], tp, **c["kw"])
                    for tp in (1, 2)}
    for tag in ("alibi", "alibi_slab"):
        c = by_tag[tag]
        want[tag] = {2: _jserve(jalibi, jparams_alibi, c["prompts"], c["gen"], 2, **c["kw"])}
    c = by_tag["swap"]
    want["swap"] = {w: _jserve(jmodel, params, c["prompts"], c["gen"], 1, **c["kw"])[0]
                    for w, params in (("before", jparams), ("after", jparams_swap))}
    c = by_tag["lifted"]
    # one device, the decode windows on the reference's Pallas kernel
    # (interpret mode), which K1 ports.  An fp8 window scales by the amax of
    # every lane's row, so a last-ulp difference can move one fp8 code: on
    # these prompts the JAX engine's own fp8 tokens differ between its XLA
    # attention program and the kernel, and between one device and its tp2
    # mesh (prompt 0's fifth token).  The port's tp2 is bitwise its tp1
    # (column slices), so it is held against the kernel on one device.
    want["lifted"] = {name: _jserve(model, params, c["prompts"], c["gen"], 1,
                                    decode_kernel="pallas", **c["kw"])[0]
                      for name, (model, params) in lifted.items()}
    want["lifted"]["llama"] = _jserve(jmodel, jparams, c["prompts"], c["gen"], 1, **c["kw"])[0]
    c = by_tag["migrate"]
    want["migrate"] = _jserve(jmodel, jparams, c["prompts"][:1], c["gens"][0], 1,
                              **c["kw"])[0]
    # the port's own one-process engine: the sampled streams' reference
    c = by_tag["sampled"]
    solo = ServingEngine(workers._serve_model(jparams), None, device="cpu", **c["kw"])
    want["sampled"] = [list(r.tokens) for r in solo.serve(
        [x.copy() for x in c["prompts"]], workers._gen_config(c["gen"]))]
    solo_bytes = {}
    for key, kw in ((False, dict(paged=False)), (True, dict(paged=True)),
                    ("int8", dict(paged=True, kv_dtype="int8"))):
        e1 = ServingEngine(workers._serve_model(jparams), None, device="cpu",
                           **dict(MESH_KW, **kw))
        solo_bytes[key] = e1.kv_pool_bytes()
        if key == "int8":
            e1.serve([x.copy() for x in by_tag["int8"]["prompts"]],
                     workers._gen_config(by_tag["int8"]["gen"]))
            want["solo_qerr"] = e1.stats["kv_quant_error"]
    want["solo_bytes"] = solo_bytes
    thread.join()
    if errors:
        raise errors[0]
    got = {c["tag"]: workers.load_ranks(out_dir, c["tag"], WORLD) for c in cases}
    return want, got


def _both_ranks(got, tag):
    """The case's result, the same on every rank."""
    ranks = got[tag]
    assert all(r == ranks[0] for r in ranks[1:]), f"{tag}: the ranks disagree"
    return ranks[0]


# ------------------------------------------------------------------ geometry
def test_paged_pool_head_sharded(runs):
    _, got = runs
    pool = _both_ranks(got, "geometry")["pool"]
    assert pool["pages"] == (2, 17, 8, 1, 16)          # Hkv 2 over tp 2
    assert pool["scales"] == (2, 17, 1)
    assert pool["tp_degree"] == 2
    assert pool["per_device"] == pool["kv_bytes"] // 2


@pytest.mark.parametrize("paged", [False, True])
def test_engine_reports_per_device_bytes(runs, paged):
    want, got = runs
    geo = _both_ranks(got, "geometry")
    assert geo[f"bytes_paged{paged}"] * 2 == want["solo_bytes"][paged]
    assert geo[f"tp_gauge_paged{paged}"] == 2.0


def test_indivisible_heads_rejected(runs):
    _, got = runs
    assert "tp=2" in _both_ranks(got, "geometry")["indivisible"]


def test_serving_rules_cut_columns_only(runs):
    """Column-parallel only (``SERVING_TP_RULES``): q/k/v, gate/up and the
    head hold a block, ``o_proj``/``down_proj`` and the embedding stay whole."""
    _, got = runs
    sharded = _both_ranks(got, "geometry")["sharded"]
    for name, cut in sharded.items():
        want = any(k in name for k in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                                       "lm_head"))
        assert cut == want, name


# ------------------------------------------------------------ token identity
@pytest.mark.parametrize("tag", ["greedy_slab", "greedy_paged", "speculative", "int8",
                                 "interleave"])
def test_tp2_tokens_equal_jax_tp2_and_tp1(runs, tag):
    want, got = runs
    out = _both_ranks(got, tag)
    (t1, _), (t2, j2) = want[tag][1], want[tag][2]
    assert t2 == t1
    assert out["tokens"] == t2
    assert out["tp_degree"] == 2
    for key in ("prefill_chunks", "decode_steps", "spec_drafted", "spec_accepted",
                "interleaved_chunks", "requests_completed"):
        assert out["stats"][key] == j2.stats[key], key
    if tag == "int8":
        assert out["kv_pool_bytes"] * 2 == want["solo_bytes"]["int8"]
        # each rank's error is the largest over the ranks' heads: the
        # one-process engine's
        assert out["stats"]["kv_quant_error"] == want["solo_qerr"] > 0


def test_sampled_tp2_equals_port_tp1(runs):
    want, got = runs
    assert _both_ranks(got, "sampled")["tokens"] == want["sampled"]


def test_pipeline_equals_sync_loop(runs):
    """``test_serving_async.py:121``: the depth-1 pipeline and the
    synchronous loop under tp=2 give the same tokens."""
    want, got = runs
    assert _both_ranks(got, "sync")["tokens"] == _both_ranks(got, "greedy_paged")["tokens"]
    assert _both_ranks(got, "sync")["tokens"] == want["greedy_paged"][2][0]


def test_prefix_tiers_with_disk_ring(runs):
    """``test_hier_cache.py:388`` with the disk ring behind the host ring:
    tokens equal the cache-off serve and the JAX engine's; the host and disk
    counters equal the JAX engine's; each rank wrote its own files."""
    want, got = runs
    ranks = got["tiers"]
    assert ranks[0]["tokens"] == ranks[1]["tokens"] == want["tiers"][2][0]
    assert ranks[0]["tokens"] == _both_ranks(got, "tiers_off")["tokens"]
    jeng = want["tiers"][2][1]
    jstats = jeng.prefix_cache_stats()
    for r, out in enumerate(ranks):
        assert out["stats"]["prefix_hit_tokens_host"] == jeng.stats["prefix_hit_tokens_host"] > 0
        for key in ("bytes", "nodes", "evictions", "host_bytes", "host_nodes",
                    "host_evictions", "disk_bytes", "disk_nodes", "spills", "promotions"):
            assert out["prefix"][key] == jstats[key], key
        assert out["prefix"]["disk_writes"] > 0
        # this rank's ring wrote under its own directory, and nothing else
        # lies in the one the engines were given
        assert out["disk_dir"] == f"tp_rank{r}"
        assert set(out["disk"]) == {"tp_rank0", "tp_rank1"}


def test_tree_verify_with_draft_model(runs):
    """``test_tree_spec.py:410``: the replicated draft, the sharded tree
    verify (K1's tree arm on each rank's heads on the card)."""
    want, got = runs
    out = _both_ranks(got, "tree")
    (t1, _), (t2, j2) = want["tree"][1], want["tree"][2]
    assert out["tokens"] == t2 == t1
    assert out["stats"]["spec_drafted"] == j2.stats["spec_drafted"] > 0
    assert out["stats"]["verify_forwards"] > 0


def test_migration_between_engines_of_one_mesh(runs):
    """``test_disagg.py:211-222``: lanes moved mid-generation between two
    engines of the mesh continue bit-identically, greedy and sampled; the
    greedy lane's tokens are the JAX engine's; a prefill->decode handoff
    through the router serves the same greedy tokens."""
    want, got = runs
    out = _both_ranks(got, "migrate")
    assert out["migrated"] == out["baseline"]
    assert out["baseline"][0] == want["migrate"][0]
    assert out["handoff"][0] == want["migrate"][0]
    assert out["handoffs"] == 2


def test_swap_params_reshards(runs):
    want, got = runs
    out = _both_ranks(got, "swap")
    assert out["before"] == want["swap"]["before"]
    assert out["after"] == want["swap"]["after"]
    assert out["version"] == "v1"


@pytest.mark.parametrize("tag", ["alibi", "alibi_slab"])
def test_alibi_heads_take_global_slopes(runs, tag):
    want, got = runs
    assert _both_ranks(got, tag)["tokens"] == want[tag][2][0]


@pytest.mark.parametrize("what,item", [
    ("int8", "9e-ii e-ii"), ("fp8", "9e-ii e-ii"), ("moe", "9e-ii e-ii"),
    ("frontdoor", "9e-ii e-ii"), ("mixed_router", "9e-ii f"), ("disjoint", "9e-ii f"),
])
def test_refusals_name_their_item(runs, what, item):
    """What raised ``NotImplementedError`` naming ROADMAP item ``item``
    (9e-ii e-ii: every model under a mesh and the front door; 9e-ii f: the
    router over processes) now serves, on both ranks, the JAX engine's
    tokens: weight-quantized (int8), fp8 and MoE models over ``{"tp": 2}``
    against the JAX engine on its Pallas decode kernel (the fixture says
    why on one device); the front door over a mesh engine's
    router (rank 0's streams and rank 1's mirrors), a single-rank mesh
    replica beside a mesh-less engine on the other rank and one single-rank
    replica a rank against the JAX engine on one device."""
    want, got = runs
    out = _both_ranks(got, "lifted")[what]
    assert out["tokens"] == want["lifted"][what if what in LIFTED else "llama"]
    assert out["served"] > 0
    if what == "disjoint":
        assert out["tp"] == [1, 1]


def test_overlapping_replicas_refused(runs):
    """A mesh-less engine on every rank beside a replica over both ranks:
    each rank describes its own replicas, so the ranks' lists differ and
    every rank raises the same ``ValueError``."""
    _, got = runs
    kind, msg = _both_ranks(got, "lifted")["overlap"]
    assert kind == "ValueError" and "different replicas" in msg


def test_mesh_of_several_cards_in_one_process_refused():
    """Without a process group a mesh of two ranks would be two cards in
    this process: the port runs one process a card, and says so."""
    from accelerate_tpu_torch.parallel.mesh import Mesh
    from accelerate_tpu_torch.parallel.tensor_parallel import serving_tp

    with pytest.raises(ValueError, match="launchers.py"):
        serving_tp(Mesh({"tp": 2}))
    assert serving_tp(Mesh({"tp": 1})) is None


@pytest.mark.parametrize("what,kind,says", [
    ("diverge", "PlanDivergence", "planned different steps"),
    ("kill_one", "PlanDivergence", "hold the error of an earlier step"),
])
def test_router_mesh_replica_failure_raises_on_every_rank(runs, what, kind, says):
    """A mesh replica's failing step under the router that the ranks do not
    share (a rank's extra submit, a kill on one rank) raises on every rank,
    the same error, within the deadline: no ejection, replay or breaker
    probe that one rank would run without the other."""
    _, got = runs
    err = _both_ranks(got, "router_failures")[what]
    assert isinstance(err, list), f"{what}: the router drained instead of raising"
    assert err[0] == kind and says in err[1]
    assert err[2], f"{what}: raised after the deadline"


def test_router_mesh_replica_killed_on_every_rank_fails_over(runs):
    """A kill on every rank of a mesh replica: ejected on both ranks at the
    same step, its requests replayed on the other replica of the mesh with
    the tokens of the same router's undisturbed run."""
    _, got = runs
    out = _both_ranks(got, "router_failures")["kill_all"]
    assert isinstance(out, dict), f"kill_all raised {out}"
    assert out["ejections"] == 1 and out["replayed"] > 0
    assert out["tokens"] == _both_ranks(got, "router_failures")["undisturbed"]


def test_divergent_rank_raises():
    """One rank submits a request more: the next step's plan exchange
    raises on every rank, and the launch fails fast (no collective hangs)."""
    _, jparams = _jparams()
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="planned different steps"):
        debug_launcher(workers.serve_mesh_diverge, (jparams, _prompts(3, (6, 7))),
                       num_processes=WORLD)
    assert time.perf_counter() - t0 < 120.0
