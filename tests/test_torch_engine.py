"""Port parity: the PyTorch paged ServingEngine vs the JAX paged engine.

Greedy tokens must be IDENTICAL to the JAX ``ServingEngine(paged=True,
decode_kernel="pallas", prefix_cache_mb=0)`` (Pallas kernels in interpret
mode) on the workload of ``tests/test_paged_attention.py``: prompts of 5, 9,
3, 12 and 7 tokens, buckets (4, 8), 2 slots, window 2, 8 new tokens.  Sampled
tokens cannot match JAX's threefry stream; they must be reproducible from the
seed and independent of which slot a request lands in.  The remaining tests
pin the host-side pieces against their JAX counterparts and the port's
import and device rules.
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
    engine = ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **kw})
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
    (dict(paged=False), "5"), (dict(async_depth=1), "5"), (dict(prefix_cache_mb=64.0), "6"),
    (dict(kv_dtype="int8"), "6"), (dict(speculate_k=2), "7"), (dict(draft_model=2), "7"),
    (dict(mesh=object()), "8"), (dict(role="prefill"), "8"),
])
def test_unported_arguments_raise(models, kw, item):
    _, _, model, params = models
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        ServingEngine(model, params, device="cpu", **{**ENGINE_KW, **kw})


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
