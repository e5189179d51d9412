"""Port parity: the serving engine over other model families.

The JAX ``ServingEngine`` and the port's, fed the same f32 params (through
``params_from_jax``; biases and norm parameters drawn nonzero) and the same prompts from a numpy seed, give identical
greedy tokens and identical scheduling counters on both pools
(``paged=True``, ``paged=False``) for four families:

* GPT-NeoX (LayerNorm with bias, partial rotate-half rotary, parallel
  residual with two norms, exact gelu, biases, untied head) — the port's
  paged pool runs the kernels' path (their plain versions on the CPU);
* the ``gpt2()`` preset (learned positions, tied head, tanh gelu) — the same;
* Mistral with a 16-token window, which the 22-token prompt and its decode
  overrun;
* BLOOM-style alibi (embedding LayerNorm, 6 heads: the non-power-of-2
  slopes).

Window and alibi models serve through the plain paged versions on the
paged pool, as the reference routes them.  The workload is the reference's
``tests/test_serving.py`` one: 2 slots, buckets (4, 8), a prefill budget of
8, window 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.weights import params_from_jax
from test_torch_families import affine_noise

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2, prefix_cache_mb=0)
COUNTERS = ("prefill_chunks", "decode_steps", "prefreed_lanes", "tokens_generated")
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=4, max_seq_len=64)
FAMILIES = {
    "gpt_neox": ("tiny", dict(norm_type="layernorm", rope_dim=4, parallel_residual=True,
                              use_bias=True, mlp_variant="gelu_exact")),
    "gpt2": ("gpt2", TINY),
    "mistral_window16": ("tiny", dict(sliding_window=16, num_kv_heads=2)),
    "bloom_alibi": ("tiny", dict(norm_type="layernorm", use_bias=True, positional="alibi",
                                 embed_norm=True, mlp_variant="gelu", tie_word_embeddings=True,
                                 hidden_size=48, num_heads=6, num_kv_heads=6)),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """As in ``test_torch_engine.py``: the JAX engine beats no heartbeat
    that a later ``/healthz`` check in the same process could find stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """``models(family)`` -> (JAX model, JAX params, port model), f32, biases
    and norm parameters drawn nonzero, each built once for the module."""
    built = {}

    def get(family):
        if family not in built:
            preset, sw = FAMILIES[family]
            sw = dict(sw, max_seq_len=64)
            jcfg = getattr(JConfig, preset)(dtype=jnp.float32, param_dtype=jnp.float32, **sw)
            jmodel = JTransformer(jcfg)
            jparams = affine_noise(jmodel.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32))["params"], seed=0)
            cfg = getattr(TransformerConfig, preset)(dtype=torch.float32, **sw)
            model = Transformer(cfg, device="cpu")
            model.load_state_dict(params_from_jax(jparams, device="cpu"), assign=True)
            jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
            built[family] = (jmodel, jparams, model)
        return built[family]

    return get


def _workload(seed=44):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in (3, 14, 5, 22, 9)]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_engine_matches_jax_engine(models, family, paged):
    jmodel, jparams, model = models(family)
    prompts = _workload()
    jeng = JServingEngine(jmodel, jparams, paged=paged, registry=MetricsRegistry(),
                          **ENGINE_KW)
    eng = ServingEngine(model, None, paged=paged, device="cpu", **ENGINE_KW)
    full = family in ("gpt_neox", "gpt2")
    assert eng.decode_kernel == ("pallas" if full else "xla")
    jreqs = jeng.serve([p.copy() for p in prompts], configs=JGenerationConfig(max_new_tokens=8))
    reqs = eng.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=8))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert all(r.done and len(r.tokens) == 8 for r in reqs)
    assert {k: eng.stats[k] for k in COUNTERS} == {k: jeng.stats[k] for k in COUNTERS}
    if paged:
        assert eng.kv.allocator.free_count == eng.num_pages - 1


@pytest.mark.parametrize("family", ["mistral_window16", "bloom_alibi"])
def test_ngram_verify_over_window_and_alibi_matches_jax(models, family):
    """n-gram speculation on the paged pool: each linear verify forward
    attends through the plain paged version with the window band or the
    alibi bias, and commits the tokens and counts the JAX engine does."""
    jmodel, jparams, model = models(family)
    prompts = _workload(45)
    knobs = dict(ENGINE_KW, speculate_k=2, async_depth=0)
    jeng = JServingEngine(jmodel, jparams, paged=True, registry=MetricsRegistry(), **knobs)
    eng = ServingEngine(model, None, paged=True, device="cpu", **knobs)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=JGenerationConfig(max_new_tokens=24))
    reqs = eng.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=24))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    spec = COUNTERS + ("spec_drafted", "spec_accepted")
    assert {k: eng.stats[k] for k in spec} == {k: jeng.stats[k] for k in spec}
    assert eng.stats["verify_forwards"] > 0 and eng.stats["spec_accepted"] > 0
