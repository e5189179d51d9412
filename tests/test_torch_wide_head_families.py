"""Port parity for the families whose heads are 256, 80 or 96 wide.

``chip_smoke.py`` serves Gemma-7B (16 heads of D 256) and Phi-2 (32 heads of
D 80) at their published widths on the card, from the literal ``config.json``
dicts ``hf_compat.GEMMA_7B`` and ``hf_compat.PHI_2``, and trains at Gemma's
widths through K3-K5.  Here, on the CPU, at narrow widths and 2 layers:

* both literals map to the JAX mapping's config, and hold plain values only
  (an AST check, as the card's machine reads them without ``transformers``);
* Gemma's recipe at D 256 (one kv head), Phi-2's at D 80 and Phi-3's (no
  window) at D 96, carried across from Flax-initialised weights with
  ``params_from_jax`` (biases and norm parameters drawn nonzero), serve
  through the port's paged ``ServingEngine`` (the kernels' path: their plain
  versions on the CPU) with greedy tokens and scheduling counters identical
  to the JAX engine's, in f32;
* a 2-layer train step at D 256 with ``attention_impl="pallas"`` (the flash
  path's plain versions) matches the JAX ``compile_train_step`` on its
  ``"xla"`` path, call by call: loss and grad norm within 2e-5 relative, the
  same f32 math summed in other orders (``test_torch_accelerator.py``'s
  bound), on batches of 8 rows for the JAX package's 8 virtual devices.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.data_loader import SimpleDataLoader as JSimpleDataLoader
from accelerate_tpu.models import hf_compat as jhf
from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SimpleDataLoader
from accelerate_tpu_torch.models import hf_compat
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    lm_loss_fn,
    state_dict_shapes,
)
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.weights import params_from_jax
from test_torch_families import affine_noise

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2, prefix_cache_mb=0)
COUNTERS = ("prefill_chunks", "decode_steps", "prefreed_lanes", "tokens_generated")
TINY = dict(vocab_size=256, intermediate_size=128, num_layers=2, max_seq_len=64)
#: each recipe at its published head dim, narrow: hidden and heads cut
WIDE = {
    # Gemma: (1 + scale) RMSNorm, embedding scale, geglu, tied head; 2 heads
    # of D 256 over one kv head (Gemma-2B's multi-query form)
    "gemma_d256": dict(TINY, hidden_size=64, num_heads=2, num_kv_heads=1, head_dim=256,
                       norm_unit_offset=True, embed_scale=True, mlp_variant="geglu",
                       tie_word_embeddings=True),
    # Phi-2: one shared LayerNorm, parallel residual, biases, rotary over 0.4
    # of each head (32 of 80)
    "phi_d80": dict(TINY, hidden_size=160, num_heads=2, num_kv_heads=2, norm_type="layernorm",
                    use_bias=True, lm_head_bias=True, mlp_variant="gelu",
                    parallel_residual=True, shared_norm=True, rope_dim=32),
    # Phi-3-mini without its window: the Llama recipe at D 96
    "phi3_d96": dict(TINY, hidden_size=192, num_heads=2, num_kv_heads=2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """The JAX engine and train step beat no heartbeat that a later
    ``/healthz`` check in the same process could find stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _fields(cfg) -> dict:
    """A config's fields other than the dtypes (torch against jnp)."""
    names = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype", "param_dtype"}
    return {n: getattr(cfg, n) for n in names}


@pytest.mark.parametrize("literal,head_dim,params", [
    ("GEMMA_7B", 256, (8.53e9, 8.55e9)),
    ("PHI_2", 80, (2.77e9, 2.79e9)),
])
def test_published_config_maps_as_jax(literal, head_dim, params):
    hf = getattr(hf_compat, literal)
    cfg = hf_compat.config_from_hf_dict(dict(hf))
    assert _fields(cfg) == _fields(jhf._config_from_hf_dict(dict(hf)))
    assert cfg.resolved_head_dim == head_dim and cfg.full_causal
    n = sum(int(np.prod(s)) for s in state_dict_shapes(cfg).values())
    assert params[0] < n < params[1]


def test_gemma_7b_reads_its_tanh_activation():
    """The published file names the activation twice: the legacy
    ``hidden_act`` "gelu" alone would be refused (the erf form, another gate
    function), so the literal keeps ``hidden_activation``."""
    hf = dict(hf_compat.GEMMA_7B)
    assert hf_compat.config_from_hf_dict(hf).mlp_variant == "geglu"
    del hf["hidden_activation"]
    with pytest.raises(NotImplementedError, match="activation"):
        hf_compat.config_from_hf_dict(hf)


def test_published_literals_hold_plain_values():
    """AST: each published ``config.json`` literal of ``hf_compat.py`` is a
    dict display of constants (``ast.literal_eval`` reads it), equal to the
    module's value: nothing computed, nothing imported."""
    path = Path(hf_compat.__file__)
    literals = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("PYTHIA_6_9B", "GEMMA_7B", "PHI_2"):
            literals[node.targets[0].id] = ast.literal_eval(node.value)
    assert sorted(literals) == ["GEMMA_7B", "PHI_2", "PYTHIA_6_9B"]
    for name, value in literals.items():
        assert value == getattr(hf_compat, name)


@pytest.fixture(scope="module")
def models():
    """``models(family)`` -> (JAX model, JAX params, port model), f32, biases
    and norm parameters drawn nonzero, each built once for the module."""
    built = {}

    def get(family):
        if family not in built:
            sw = WIDE[family]
            jmodel = JTransformer(JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **sw))
            jparams = affine_noise(jmodel.init(jax.random.PRNGKey(len(family)),
                                               jnp.zeros((1, 8), jnp.int32))["params"],
                                   seed=len(family))
            model = Transformer(TransformerConfig.tiny(dtype=torch.float32, **sw), device="cpu")
            model.load_state_dict(params_from_jax(jparams, device="cpu"))
            built[family] = (jmodel, jax.tree_util.tree_map(jnp.asarray, jparams), model)
        return built[family]

    return get


@pytest.mark.parametrize("family", list(WIDE))
def test_engine_tokens_match_jax_engine(models, family):
    jmodel, jparams, model = models(family)
    assert model.config.resolved_head_dim == int(family.split("_d")[1])
    rng = np.random.default_rng(46)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 14, 5, 22, 9)]
    jeng = JServingEngine(jmodel, jparams, paged=True, registry=MetricsRegistry(), **ENGINE_KW)
    eng = ServingEngine(model, None, paged=True, device="cpu", **ENGINE_KW)
    assert eng.decode_kernel == "pallas"  # the kernels' path (plain versions here)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=JGenerationConfig(max_new_tokens=8))
    reqs = eng.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=8))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert all(r.done and len(r.tokens) == 8 for r in reqs)
    assert {k: eng.stats[k] for k in COUNTERS} == {k: jeng.stats[k] for k in COUNTERS}
    assert eng.kv.allocator.free_count == eng.num_pages - 1


LR, B1, B2, EPS, WD = 1e-3, 0.9, 0.95, 1e-6, 0.1
ROWS, SEQ = 8, 16
TRAIN_RTOL = 2e-5


def test_train_step_at_d256_matches_jax(models):
    """Four calls at accumulation 2 (two applied steps) of the port's train
    step on the flash path against the JAX step, from the same weights on
    the same batches."""
    jmodel, jparams, _ = models("gemma_d256")
    ids = np.random.default_rng(3).integers(1, 256, (4 * ROWS, SEQ)).astype(np.int32)
    dataset = [{"input_ids": row} for row in ids]

    jacc = JAccelerator(gradient_accumulation_steps=2)
    jstate = jacc.create_train_state(
        params=jax.tree_util.tree_map(np.asarray, jparams),
        tx=optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD))
    jstep = jacc.compile_train_step(jlm_loss_fn(jmodel), max_grad_norm=0.5)
    want = []
    for batch in jacc.prepare(JSimpleDataLoader(dataset, batch_size=ROWS)):
        jstate, m = jstep(jstate, batch)
        want.append((float(m["loss"]), float(m["grad_norm"]), bool(m["applied"])))

    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 attention_impl="pallas", **WIDE["gemma_d256"])
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jparams), device="cpu"))
    acc = Accelerator(gradient_accumulation_steps=2, cpu=True)
    state = acc.create_train_state(
        params=model, tx=functools.partial(torch.optim.AdamW, lr=LR, betas=(B1, B2), eps=EPS,
                                           weight_decay=WD))
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=0.5)
    got = []
    for batch in acc.prepare(SimpleDataLoader(dataset, batch_size=ROWS)):
        state, m = step(state, batch)
        got.append((m["loss"].item(), m["grad_norm"].item(), bool(m["applied"])))

    assert [g[2] for g in got] == [w[2] for w in want] == [False, True, False, True]
    for (loss, norm, _), (jloss, jnorm, _) in zip(got, want):
        assert abs(loss - jloss) <= TRAIN_RTOL * abs(jloss)
        assert abs(norm - jnorm) <= TRAIN_RTOL * abs(jnorm)
