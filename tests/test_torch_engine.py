"""Port parity: the PyTorch paged ServingEngine vs the JAX paged engine.

Greedy tokens must be IDENTICAL to the JAX ``ServingEngine(paged=True,
decode_kernel="pallas", prefix_cache_mb=0)`` (Pallas kernels in interpret
mode) on the workload of ``tests/test_paged_attention.py``: prompts of 5, 9,
3, 12 and 7 tokens, buckets (4, 8), 2 slots, window 2, 8 new tokens; with
native pages and with ``kv_dtype="int8"`` and ``"fp8"`` pages, whose write
path matches the JAX one bit for bit.  Sampled
tokens cannot match JAX's threefry stream; they must be reproducible from the
seed and independent of which slot a request lands in.  Speculative decoding
(``speculate_k``: n-gram drafts and the linear verify; ``draft_model``: the
draft-model tree and the tree verify through K1's tree-mask arm) must give
greedy tokens identical to the JAX paged engine with the same knobs and to
the port's own tokens with speculation off, on a workload that accepts
drafts (24 new tokens: the tiny model's greedy streams fall into loops the
n-gram drafter finds; a draft of all the model's layers accepts nearly
everything).  The default loop is the depth-1 pipeline (``async_depth=1``)
in both packages; the speculation parity test runs both synchronous
(``async_depth=0``), and ``tests/test_torch_readback.py`` holds the
pipeline against the JAX one.  The speculation parity test and the
preemption replay under speculation are in ``tests/test_torch_engine_spec.py``
(this module's fixtures, split off to keep each file's time in the
multi-worker run short).  The remaining tests pin the host-side pieces
against their JAX counterparts and the port's import and device rules.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.generation import filter_logits_batched as jfilter
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import PageAllocator as JPageAllocator
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving import plan_chunks as jplan_chunks
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig, filter_logits_batched
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.parallel.mesh import Mesh
from accelerate_tpu_torch.serving import (
    AdmissionError,
    PageAllocator,
    ServingEngine,
    plan_chunks,
)
from accelerate_tpu_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2)
#: the port's engines here run without the prefix cache, as the JAX engines do
CACHE_OFF = dict(prefix_cache_mb=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """The JAX engine beats the process-wide flight recorder's heartbeat.
    With telemetry off it beats none, so a ``/healthz`` check that runs later
    in the same process does not find this module's heartbeat gone stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, max_seq_len=64)
    model = Transformer(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, (n,)).astype(np.int32) for n in lens]


def _serve(model, params, prompts, gen, **kw):
    engine = ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **CACHE_OFF, **kw})
    reqs = engine.serve([p.copy() for p in prompts], configs=gen)
    return engine, [r.tokens for r in reqs]


def test_greedy_tokens_identical_to_jax_engine(models):
    jmodel, jparams, model, params = models
    prompts = _prompts(20, (5, 9, 3, 12, 7))
    jeng = JServingEngine(jmodel, jparams, paged=True, decode_kernel="pallas",
                          prefix_cache_mb=0, registry=MetricsRegistry(), **ENGINE_KW)
    jreqs = jeng.serve([p.copy() for p in prompts],
                       configs=JGenerationConfig(max_new_tokens=8))
    engine, toks = _serve(model, params, prompts, GenerationConfig(max_new_tokens=8))
    assert toks == [r.tokens for r in jreqs]
    assert engine.stats["tokens_generated"] == 40
    assert engine.stats["decode_steps"] % 2 == 0 and engine.stats["prefill_chunks"] > 0
    # every page returns to the free list (null page excluded)
    assert engine.kv.allocator.free_count == engine.num_pages - 1


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_greedy_tokens_identical_to_jax_engine(models, fmt):
    """Quantized pages (``kv_dtype``): the same tokens as the JAX paged
    engine with the same format; the engine gauges a nonzero round-trip
    error, and its pool stores less than half the native bytes per token."""
    jmodel, jparams, model, params = models
    prompts = _prompts(20, (5, 9, 3, 12, 7))
    jeng = JServingEngine(jmodel, jparams, paged=True, decode_kernel="pallas",
                          prefix_cache_mb=0, kv_dtype=fmt, registry=MetricsRegistry(),
                          **ENGINE_KW)
    jreqs = jeng.serve([p.copy() for p in prompts],
                       configs=JGenerationConfig(max_new_tokens=8))
    engine, toks = _serve(model, params, prompts, GenerationConfig(max_new_tokens=8),
                          kv_dtype=fmt)
    assert engine.kv.pages_k.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[fmt]
    assert toks == [r.tokens for r in jreqs]
    assert engine.stats["kv_quant_error"] > 0.0
    native = ServingEngine(model, params, device="cpu", **ENGINE_KW)
    assert engine.kv.page_kv_bytes == jeng.kv.page_kv_bytes
    assert engine.stats["kv_bytes_per_token"] == jeng.kv.page_kv_bytes / jeng.kv.page_size
    assert engine.kv.page_kv_bytes < native.kv.page_kv_bytes / 2
    assert native.stats["kv_quant_error"] == 0.0
    assert engine.kv.allocator.free_count == engine.num_pages - 1


def test_quantized_preemption_replay_is_deterministic(models):
    """A page-starved int8 pool preempts and replays (the JAX package's
    ``test_preemption_replay_is_deterministic_under_int8``): every request
    lands its full output, two runs give the same tokens, and every page
    returns to the free list."""
    _, _, model, params = models
    prompts = _prompts(25, (12, 16, 9, 14))
    gen = GenerationConfig(max_new_tokens=28)
    runs = [_serve(model, params, prompts, gen, num_pages=17, kv_dtype="int8")
            for _ in range(2)]
    (eng1, toks1), (eng2, toks2) = runs
    assert eng1.stats["preemptions"] >= 1
    assert toks1 == toks2
    assert all(len(t) == 28 for t in toks1)
    for eng in (eng1, eng2):
        assert eng.kv.allocator.free_count == eng.num_pages - 1


def test_eos_stops_a_lane(models):
    _, _, model, params = models
    prompts = _prompts(20, (5, 9))
    _, toks = _serve(model, params, prompts, GenerationConfig(max_new_tokens=8))
    eos = toks[0][2]
    _, cut = _serve(model, params, prompts,
                    GenerationConfig(max_new_tokens=8, eos_token_id=eos))
    assert cut[0] == toks[0][:toks[0].index(eos) + 1]


def test_preemption_replay_is_token_exact(models):
    """A pool too small for both lanes preempts the youngest, which replays
    prompt + generated tokens; greedy outputs do not change."""
    _, _, model, params = models
    prompts = _prompts(7, (12, 11, 10))
    gen = GenerationConfig(max_new_tokens=40)
    _, ref = _serve(model, params, prompts, gen)
    engine, toks = _serve(model, params, prompts, gen, num_pages=17)
    assert engine.stats["preemptions"] > 0
    assert toks == ref


def test_sampling_reproducible_and_slot_independent(models):
    _, _, model, params = models
    prompts = _prompts(21, (6, 11, 9))
    gen = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=50)
    _, a = _serve(model, params, prompts, gen, rng_seed=3)
    _, b = _serve(model, params, prompts, gen, rng_seed=3)
    _, c = _serve(model, params, prompts, gen, rng_seed=3, slot_order=(1, 0))
    _, d = _serve(model, params, prompts[1:], gen, rng_seed=3)
    _, e = _serve(model, params, prompts, gen, rng_seed=4)
    assert a == b == c
    # request ids shift when the first prompt is dropped, so only the stream
    # per (seed, rid) is pinned: the same prompt under another rid differs
    assert d != a[1:]
    assert e != a


def test_filter_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
    temperature = np.asarray([1.0, 0.7, 1.3, 0.5], np.float32)
    top_k = np.asarray([0, 5, 20, 1], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.95], np.float32)
    ref = jfilter(jnp.asarray(logits), temperature=jnp.asarray(temperature),
                  top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p))
    out = filter_logits_batched(torch.from_numpy(logits),
                                temperature=torch.from_numpy(temperature),
                                top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.numpy() == np.finfo(np.float32).min,
                                  ref == np.finfo(np.float32).min)
    kept = ref > np.finfo(np.float32).min
    np.testing.assert_allclose(out.numpy()[kept], ref[kept], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 9, 12, 17, 100])
def test_plan_chunks_matches_jax(n):
    assert plan_chunks(n, (4, 8)) == jplan_chunks(n, (4, 8))


def test_page_allocator_matches_jax():
    ours, theirs = PageAllocator(9), JPageAllocator(9)
    for op, arg in [("alloc", 3), ("alloc", 2), ("deref", [1, 4]), ("alloc", 4),
                    ("deref", [2, 3, 4, 5]), ("alloc", 9), ("alloc", 1), ("deref", [0, 1])]:
        assert getattr(ours, op)(arg) == getattr(theirs, op)(arg)
        assert ours.free_count == theirs.free_count
        np.testing.assert_array_equal(ours.refs, theirs.refs)


def test_admission_refusals(models):
    _, _, model, params = models
    engine = ServingEngine(model, params, device="cpu", max_queue=1, **ENGINE_KW)
    with pytest.raises(AdmissionError) as too_long:
        engine.submit(np.arange(1, 60), max_new_tokens=8)
    assert not too_long.value.retriable
    engine.submit(np.arange(1, 5), max_new_tokens=2)
    with pytest.raises(AdmissionError) as full:
        engine.submit(np.arange(1, 5), max_new_tokens=2)
    assert full.value.retriable


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=Mesh({"tp": 2})), "9e"), (dict(role="prefill"), "8b"),
    (dict(tp_axis="model"), "9e"),
])
def test_unported_arguments_raise(models, kw, item):
    """The reference's keywords that the port has not ported raise
    ``NotImplementedError`` naming their item (``paged=False`` is ported:
    ``tests/test_torch_slab.py``; a checkpoint ``draft_model``:
    ``tests/test_torch_hf_compat.py``).  ``role`` (item 8b) is ported since:
    its case holds that a prefill replica builds, publishes its role and
    prefills without decoding (``tests/test_torch_router.py`` holds the
    rest).  ``mesh=`` and ``tp_axis=`` (item 9e-ii e) are ported since
    (``tests/test_torch_serving_mesh.py``, and the router over processes,
    item 9e-ii f, ``tests/test_torch_router_dist.py``): a mesh of two ranks
    with no process group up would be two cards in this process, and raises
    ``ValueError`` naming ``launchers.py`` (one process a card), and
    ``tp_axis`` without a mesh serves on one card, as the reference's
    engine does."""
    _, _, model, params = models
    if "mesh" in kw:
        with pytest.raises(ValueError, match="launchers.py"):
            ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **kw})
        return
    if "tp_axis" in kw:
        engine = ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **kw})
        assert engine.tp_degree == 1 and engine.tp_axis == "model"
        return
    if item == "8b":
        engine = ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **kw})
        assert engine.role == "prefill"
        assert engine.metrics.gauge("serve/role").value == 1.0
        req = engine.submit(np.arange(1, 6), max_new_tokens=2)
        for _ in range(3):
            engine.step()
        assert req.state.name == "RUNNING" and not req.tokens
        assert engine.stats["decode_steps"] == 0
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **kw})


def test_registry_argument_records_into_it(models):
    """``registry=``: the engine, its page pool and its prefix cache record
    into the caller's registry (the process registry is untouched)."""
    from accelerate_tpu_torch.telemetry import MetricsRegistry as PortRegistry
    from accelerate_tpu_torch.telemetry import get_registry

    _, _, model, params = models
    registry = PortRegistry()
    before = get_registry().snapshot().get("serve/requests_submitted_total", 0.0)
    engine = ServingEngine(model, params, device="cpu", registry=registry, **ENGINE_KW)
    engine.serve([np.arange(1, 6), np.arange(3, 12)], configs=GenerationConfig(max_new_tokens=3))
    snap = registry.snapshot()
    assert snap["serve/requests_completed_total"] == 2
    assert snap["serve/tokens_generated_total"] == 6 == engine.stats["tokens_generated"]
    assert snap["serve/ttft_s"]["count"] == 2
    assert "serve/kv_pages_free" in snap and "serve/prefix_cache_bytes" in snap
    assert get_registry().snapshot().get("serve/requests_submitted_total", 0.0) == before


def test_metrics_port_serves_the_engine(models, monkeypatch):
    """``metrics_port=0``: the debug server binds an ephemeral local port and
    serves the engine's registry (after ``analyze_costs``) over HTTP."""
    import urllib.request

    from accelerate_tpu_torch.telemetry import MetricsRegistry as PortRegistry
    from accelerate_tpu_torch.telemetry import stop_debug_server

    _, _, model, params = models
    monkeypatch.setenv("ATPU_METRICS_HOST", "127.0.0.1")
    try:
        engine = ServingEngine(model, params, device="cpu", registry=PortRegistry(),
                               metrics_port=0, **ENGINE_KW)
        assert engine.debug_server is not None and engine.debug_server.port > 0
        engine.serve([np.arange(1, 6)], configs=GenerationConfig(max_new_tokens=2))
        url = f"http://127.0.0.1:{engine.debug_server.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        # a counter named serve/<key>_total renders with the exposition's own suffix
        assert "atpu_serve_requests_completed_total_total 1" in text.splitlines()
        assert "atpu_serve_decode_flops_per_token" in text
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            assert resp.status == 200
    finally:
        stop_debug_server()


@pytest.mark.parametrize("kw", [dict(request_class="chat"), dict(tenant="acme")])
def test_submit_accounting_arguments(models, kw):
    """``submit(request_class=, tenant=)``: the reference's accounting labels
    ride the request into the per-class TTFT histogram and the per-tenant
    counters, which sum to the global ones."""
    from accelerate_tpu_torch.telemetry import MetricsRegistry as PortRegistry

    _, _, model, params = models
    registry = PortRegistry()
    engine = ServingEngine(model, params, device="cpu", registry=registry, **ENGINE_KW)
    req = engine.submit(np.arange(1, 5), max_new_tokens=2, **kw)
    engine.submit(np.arange(2, 9), max_new_tokens=2)
    engine.run()
    assert (req.request_class, req.tenant) == (kw.get("request_class"), kw.get("tenant"))
    snap = registry.snapshot()
    if "request_class" in kw:
        assert snap["serve/ttft_s_class_chat"]["count"] == 1
    else:
        assert engine.stats()["tenants"] == {"acme": {
            "requests_submitted": 1, "tokens_generated": 2, "requests_completed": 1}}
        assert snap["serve/tokens_generated_tenant_acme_total"] == 2
        assert snap["serve/ttft_s_tenant_acme"]["count"] == 1


def test_kernel_keywords_and_weights_version(models, monkeypatch):
    """``decode_kernel``/``prefill_kernel`` take the reference's values and
    refusals; ``"xla"`` routes the paged pool's attention to the kernels'
    plain versions (no wrapper of K1 or K2 is called) with the tokens of
    the default engine; ``weights_version`` is kept as a label."""
    from accelerate_tpu_torch.models import transformer

    _, _, model, params = models
    for kw in (dict(decode_kernel="triton"), dict(prefill_kernel="cuda")):
        with pytest.raises(ValueError, match="must be"):
            ServingEngine(model, params, device="cpu", **ENGINE_KW, **kw)
    calls = []
    for name in ("paged_attention", "paged_flash_prefill"):
        wrapped = getattr(transformer, name)
        monkeypatch.setattr(transformer, name,
                            lambda *a, _f=wrapped, _n=name, **k: calls.append(_n) or _f(*a, **k))
    prompts = _prompts(21, (5, 9, 3))
    _, tokens = _serve(model, params, prompts, GenerationConfig(max_new_tokens=6),
                       decode_kernel="pallas", weights_version="v7")
    assert set(calls) == {"paged_attention", "paged_flash_prefill"}
    calls.clear()
    engine, plain = _serve(model, params, prompts, GenerationConfig(max_new_tokens=6),
                           decode_kernel="xla")
    assert calls == [] and plain == tokens
    assert (engine.decode_kernel, engine.prefill_kernel) == ("xla", "xla")
    mixed = ServingEngine(model, params, device="cpu", prefill_kernel="xla", **ENGINE_KW)
    assert (mixed.decode_kernel, mixed.prefill_kernel, mixed.weights_version) == \
        ("pallas", "xla", "v0")


@pytest.mark.parametrize("depth", [2, -1])
def test_async_depth_out_of_range_raises(models, depth):
    """The reference's refusal: the loop is synchronous (0) or the depth-1
    pipeline (1), nothing else."""
    _, _, model, params = models
    with pytest.raises(ValueError, match="async_depth"):
        ServingEngine(model, params, device="cpu", async_depth=depth, **ENGINE_KW)


@pytest.mark.parametrize("knobs", [dict(speculate_k=2),
                                   dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16)])
def test_speculative_eos_and_opt_out(models, knobs):
    """An EOS the model emits inside a verify cuts the stream where plain
    decode does; ``submit(..., speculate=False)`` runs no verify at all."""
    _, _, model, params = models
    prompts = _prompts(20, (5, 9, 3, 12, 7))
    gen = GenerationConfig(max_new_tokens=24)
    _, plain = _serve(model, params, prompts, gen)
    eos = plain[0][9]
    cut = GenerationConfig(max_new_tokens=24, eos_token_id=eos)
    _, want = _serve(model, params, prompts, cut)
    _, got = _serve(model, params, prompts, cut, **knobs)
    assert got == want and got[0] == plain[0][:plain[0].index(eos) + 1]
    engine = ServingEngine(model, params, device="cpu", **ENGINE_KW, **knobs)
    reqs = [engine.submit(p, config=gen, speculate=False) for p in prompts]
    engine.run()
    assert [r.tokens for r in reqs] == plain
    assert engine.stats["spec_drafted"] == engine.stats["verify_forwards"] == 0


@pytest.mark.parametrize("knobs", [dict(speculate_k=2),
                                   dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16)])
def test_speculative_sampling_reproducible_and_in_vocab(models, knobs):
    _, _, model, params = models
    prompts = _prompts(21, (6, 11, 9))
    gen = GenerationConfig(max_new_tokens=16, do_sample=True, temperature=0.8, top_k=50)
    engine, a = _serve(model, params, prompts, gen, rng_seed=3, **knobs)
    _, b = _serve(model, params, prompts, gen, rng_seed=3, **knobs)
    _, c = _serve(model, params, prompts, gen, rng_seed=4, **knobs)
    assert a == b and a != c
    assert all(len(t) == 16 and all(0 <= x < 256 for x in t) for t in a)
    assert engine.stats["verify_forwards"] > 0


def test_speculation_refusals(models):
    """The reference's validation: ``tree_width > 1`` needs a draft model,
    a tree of more than 32 nodes does not fit K1's words, and the other
    knobs' ranges."""
    _, _, model, params = models
    with pytest.raises(ValueError, match="tree_width"):
        ServingEngine(model, params, device="cpu", tree_width=2, **ENGINE_KW)
    with pytest.raises(ValueError, match="32"):
        ServingEngine(model, params, device="cpu", draft_model=1, tree_width=8, tree_depth=4,
                      **ENGINE_KW)
    with pytest.raises(ValueError, match="speculate_k"):
        ServingEngine(model, params, device="cpu", speculate_k=-1, **ENGINE_KW)
    with pytest.raises(ValueError, match="draft_ctx"):
        ServingEngine(model, params, device="cpu", draft_model=1, draft_ctx=0, **ENGINE_KW)
    with pytest.raises(ValueError, match="out of range"):
        ServingEngine(model, params, device="cpu", draft_model=3, **ENGINE_KW)
    engine = ServingEngine(model, params, device="cpu", draft_model=1, tree_width=7,
                           tree_depth=1, **ENGINE_KW)
    assert engine.tree.nodes == 8 and engine.draft.lm_head.weight is not None


@pytest.mark.parametrize("knobs,new", [
    (dict(draft_model=1, tree_width=4, tree_depth=3), 44),   # span 13 nodes
    (dict(speculate_k=7), 49),                               # span K + 1 = 8
])
def test_admission_covers_the_speculation_span(models, knobs, new):
    """A request needs room for the widest pass a cycle writes at its
    frontier: max(decode_window, speculation span)."""
    _, _, model, params = models
    engine = ServingEngine(model, params, device="cpu", **ENGINE_KW, **knobs)
    with pytest.raises(AdmissionError, match="speculation span"):
        engine.submit(np.ones(8, np.int32), max_new_tokens=new)
    engine.submit(np.ones(8, np.int32), max_new_tokens=new - 1)


def _port_sources():
    return sorted((REPO / "accelerate_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """AST walk: neither the port nor chip_smoke.py imports jax, flax or the
    JAX package (importing any of its modules runs its __init__, which
    imports JAX)."""
    banned = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu")
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert len(_port_sources()) > 10
    assert offenders == []


def test_chip_smoke_refuses_without_card(tmp_path):
    """No CUDA device: non-zero exit and no result line, both in the repo and
    in a directory that holds chip_smoke.py and nothing else."""
    lonely = tmp_path / "chip_smoke.py"
    lonely.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lonely, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
