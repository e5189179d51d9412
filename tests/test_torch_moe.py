"""Port parity: Mixture-of-Experts (``parallel/moe.py``) and quantized MoE serving.

The same numpy inputs (a numpy seed) go through the JAX package and the port:

* ``top_k_dispatch``: dispatch and combine bit for bit, with capacity
  drops, all-tie rows (a uniform router: the lower index wins, as
  ``lax.top_k`` breaks ties) and two-way ties; the aux loss, a mean over
  the tokens, within ``AUX_ULPS`` (4) f32 ulps: XLA's CPU reduction order
  follows no fixed pattern torch could reproduce;
* ``MoEMLP`` and the MoE ``lm_loss_fn`` (loss and gradients) within
  ``REL_TOL`` (1e-5) of their scale, drop-free and dropping capacities,
  dense and int8/int4 experts: the two frameworks' f32 products summed in
  different orders;
* the quantized MoE tree: the port's ``quantize_model_params`` gives the
  layout the JAX quantized MoE *model* declares (per-expert ``qweight [E,
  K, N]`` and ``scales``, the router f32), bit for bit the JAX per-expert
  ``quantize`` stacked — not the JAX converter's output, which quantizes the
  router and skips the experts (a reference fault, ROADMAP Queue 3);
* greedy tokens and scheduling counters of ``tiny_moe`` with ``quantization=8``
  identical to the JAX ``ServingEngine``'s on the paged pool (K1/K2's plain
  versions on the CPU against the Pallas kernels in interpret mode) and the
  slab pool;
* a tiny HF-layout Mixtral checkpoint (built with ``transformers``) loads
  through ``hf_compat`` with logits within ``HF_ATOL`` of HF's, and
  quantizes on load.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu.parallel import moe as jmoe
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models import hf_compat
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.ops import quantization as q
from accelerate_tpu_torch.parallel import moe
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.weights import params_from_jax, state_dict_shapes
from test_torch_hf_compat import HF_ATOL, MIXTRAL, _build

REL_TOL = 1e-5
AUX_ULPS = 4
ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2, prefix_cache_mb=0)
COUNTERS = ("prefill_chunks", "decode_steps", "tokens_generated", "prefreed_lanes",
            "preemptions")


@pytest.fixture(scope="module", autouse=True)
def _quiet():
    """One torch thread (the tiny models gain nothing from more under the
    multi-worker run), and the JAX engine's telemetry off, as in
    ``test_torch_engine.py``."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    threads, was = torch.get_num_threads(), jax_metrics.enabled()
    torch.set_num_threads(1)
    jax_metrics.set_enabled(False)
    yield
    torch.set_num_threads(threads)
    jax_metrics.set_enabled(was)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _noisy(tree, seed=0):
    """Every bias drawn nonzero (Flax initialises them to zeros, under which
    a dropped one maps to the same function)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + rng.normal(0, 0.1, x.shape).astype(x.dtype)
        if getattr(p[-1], "key", "") == "bias" else x, tree)


def _jax_quantized_moe(tree, bits: int, block: int = 64):
    """The tree the JAX quantized MoE model declares, built as the module
    layout says: each 2-D projection kernel through JAX ``quantize``, each
    stacked expert kernel quantized per expert and stacked, the router, the
    head and the embeddings as they are."""
    cfg = jq.QuantizationConfig(bits=bits, block_size=block)

    def visit(node, path):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = visit(val, path + (key,))
                continue
            skip = any(p in ("router", "lm_head", "embed_tokens") for p in path)
            if key != "kernel" or skip:
                out[key] = val
                continue
            parts = ([jq.quantize(jnp.asarray(val), cfg)] if val.ndim == 2 else
                     [jq.quantize(jnp.asarray(v), cfg) for v in val])
            stack = (lambda xs: xs[0]) if val.ndim == 2 else np.stack
            out["qweight"] = stack([np.asarray(p.data) for p in parts])
            out["scales"] = stack([np.asarray(p.scales) for p in parts])
        return out

    return visit(tree, ())


# ------------------------------------------------------------------ routing
def _probs(seed, n, e):
    logits = np.random.default_rng(seed).normal(size=(n, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("case", ["random", "uniform", "pair_ties"])
@pytest.mark.parametrize("k,capacity", [(2, 8), (2, 24), (1, 4), (3, 40)])
def test_top_k_dispatch_bitwise(case, k, capacity):
    n, e = 40, 6
    probs = _probs(k * 100 + capacity, n, e)
    if case == "uniform":
        probs = np.full((n, e), 1.0 / e, np.float32)
    elif case == "pair_ties":
        probs[::3, 4] = probs[::3, 1]       # experts 1 and 4 tie on every third row
        probs[1::5, 2] = probs[1::5].max(axis=1)
    want = jmoe.top_k_dispatch(jnp.asarray(probs), k, capacity)
    got = moe.top_k_dispatch(torch.from_numpy(probs), k, capacity)
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the aux loss is a mean over the tokens: XLA's CPU reduction order
    # follows no fixed pattern torch could take, so it agrees to AUX_ULPS
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=AUX_ULPS * 2.0**-23)
    if case == "uniform":
        # every token's choices are the lowest indices: tokens past expert
        # 0's capacity drop
        assert got[0][:, k:].sum() == 0 and got[0][:, 0].sum() == min(n, capacity)


# ------------------------------------------------------------------ the layer
MOE_CASES = {
    "dropfree": dict(),
    "drops": dict(expert_capacity_factor=1.0),
    "drops_more": dict(expert_capacity_factor=0.5, num_experts_per_tok=1),
    "int8": dict(quantization=8),
    "int4_drops": dict(quantization=4, quantization_block_size=32, expert_capacity_factor=1.0),
    "gelu_bias": dict(mlp_variant="gelu", use_bias=True),
}


def _init(jcfg):
    """The JAX model's params, initialised under ``jit`` (one compile, not
    one per op)."""
    init = jax.jit(JTransformer(jcfg).init)
    return _np(init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@functools.lru_cache(maxsize=None)
def _cached_pair(case):
    return _pair(MOE_CASES[case])


def _pair(kw, layers=2):
    qkw = {k: kw[k] for k in ("quantization", "quantization_block_size") if k in kw}
    dense = {k: v for k, v in kw.items() if k not in qkw}
    jcfg = JConfig.tiny_moe(dtype=jnp.float32, param_dtype=jnp.float32, num_layers=layers,
                            max_seq_len=64, **dense)
    jparams = _noisy(_init(jcfg))
    if qkw:
        jcfg = dataclasses.replace(jcfg, **qkw)
        jparams = _jax_quantized_moe(jparams, qkw["quantization"],
                                     qkw.get("quantization_block_size", 64))
    cfg = TransformerConfig.tiny_moe(dtype=torch.float32, num_layers=layers, max_seq_len=64,
                                     **kw)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    return JTransformer(jcfg), jparams, model


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    """One ``MoEMLP`` on the same weights and inputs: its output and aux
    loss."""
    jmodel, jparams, model = _cached_pair(case)
    sub = jparams["layers_0"]["moe_mlp"]
    layer = model.layers[0].moe_mlp
    x = np.random.default_rng(3).normal(size=(3, 11, 64)).astype(np.float32)
    apply = jax.jit(functools.partial(jmoe.MoEMLP(jmodel.config).apply,
                                      mutable=["intermediates"]))
    ref, sown = apply({"params": sub}, jnp.asarray(x))
    with moe.collect_router_aux() as aux, torch.no_grad():
        out = layer(torch.from_numpy(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=REL_TOL * np.abs(ref).max())
    (jaux,) = sown["intermediates"]["router_aux_loss"]
    assert len(aux) == 1
    np.testing.assert_allclose(aux[0].item(), float(jaux), rtol=REL_TOL)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_transformer_logits_match_jax(case):
    jmodel, jparams, model = _cached_pair(case)
    ids = np.random.default_rng(4).integers(1, 256, (2, 13)).astype(np.int32)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(ids)))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("case", ["dropfree", "drops", "gelu_bias"])
def test_moe_loss_and_grads_match_jax(case):
    """``lm_loss_fn`` adds ``router_aux_loss_coef`` times the summed aux
    losses; loss and every gradient (router and stacked experts included)
    against ``jax.value_and_grad`` of the JAX one."""
    jmodel, jparams, model = _cached_pair(case)
    ids = np.random.default_rng(5).integers(1, 256, (2, 16)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jlm_loss_fn(jmodel)))(
        jparams, {"input_ids": jnp.asarray(ids)})
    model.zero_grad(set_to_none=True)
    params = dict(model.named_parameters())
    batch = {"input_ids": torch.from_numpy(ids).long()}
    loss = lm_loss_fn(model)(params, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    want = params_from_jax(_np(jgrads), device="cpu")
    assert want.keys() == params.keys()
    for name, p in params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=REL_TOL * np.abs(ref).max(),
                                   err_msg=name)
    # the aux term is in the loss: the cross entropy plus the coefficient
    # times the layers' collected aux losses
    with torch.no_grad(), moe.collect_router_aux() as sown:
        logits = model(batch["input_ids"])
    ce = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 256),
                                           batch["input_ids"][:, 1:].reshape(-1))
    assert len(sown) == model.config.num_layers
    np.testing.assert_allclose(loss.item(), (ce + moe.router_aux_loss(sown, 0.01)).item(),
                               rtol=1e-6)


def test_quantized_moe_tree_is_the_jax_model_layout():
    jcfg = JConfig.tiny_moe(dtype=jnp.float32, param_dtype=jnp.float32)
    jparams = _init(jcfg)
    for bits in (8, 4):
        declared = jax.eval_shape(
            JTransformer(dataclasses.replace(jcfg, quantization=bits)).init,
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        want = params_from_jax(_jax_quantized_moe(jparams, bits), device="cpu")
        got = q.quantize_model_params(params_from_jax(jparams, device="cpu"),
                                      q.QuantizationConfig(bits=bits))
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        shapes = {k: tuple(v.shape) for k, v in params_from_jax(
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), declared),
            device="cpu").items()}
        assert {k: tuple(v.shape) for k, v in got.items()} == shapes
        assert shapes == state_dict_shapes(TransformerConfig.tiny_moe(quantization=bits))
        assert got["layers.0.moe_mlp.router.weight"].dtype == torch.float32


def test_capacity_and_config_match_jax():
    for kw in (dict(), dict(expert_capacity_factor=1.0), dict(num_experts=8,
                                                               num_experts_per_tok=2,
                                                               expert_capacity_factor=4.0)):
        cfg, jcfg = TransformerConfig.tiny_moe(**kw), JConfig.tiny_moe(**kw)
        for n in (1, 7, 8, 13, 64, 4096):
            assert cfg.resolved_expert_capacity(n) == jcfg.resolved_expert_capacity(n)
    cfg = TransformerConfig(num_experts=8)
    assert (cfg.num_experts_per_tok, cfg.expert_capacity_factor,
            cfg.router_aux_loss_coef) == (2, 2.0, 0.01)
    mix = hf_compat.config_from_hf_dict(dict(hf_compat.MIXTRAL_8X7B))
    from accelerate_tpu.models import hf_compat as jhf
    jmix = jhf._config_from_hf_dict(dict(hf_compat.MIXTRAL_8X7B))
    for f in dataclasses.fields(TransformerConfig):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(mix, f.name) == getattr(jmix, f.name), f.name
    assert (mix.num_experts, mix.expert_capacity_factor, mix.num_kv_heads,
            mix.rope_theta) == (8, 4.0, 8, 1e6)
    n = sum(int(np.prod(s)) for s in state_dict_shapes(mix).values())
    assert 46.6e9 < n < 46.8e9


def test_shard_moe_params():
    params = {"w": torch.zeros(2)}
    assert moe.shard_moe_params(params, None) is params
    assert moe.shard_moe_params(params, {"dp": 4, "ep": 1}) is params
    # an ep mesh (ROADMAP 9e-ii c): the experts' block of this position
    # (rank 0 without a process group), other tensors untouched
    name = "layers.0.moe_mlp.experts.up_proj.weight"
    experts = {name: torch.arange(4 * 2 * 3.0).reshape(4, 2, 3), "w": params["w"]}
    placed = moe.shard_moe_params(experts, {"ep": 2})
    assert torch.equal(placed[name], experts[name][:2]) and placed["w"] is params["w"]
    assert tuple(placed[name].atpu_sharding.spec) == ("ep", None, None)


# ------------------------------------------------------------------ serving
def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("paged", [True, False])
def test_quantized_moe_engine_matches_jax(paged):
    """``tiny_moe`` with int8 experts and projections served by both
    engines: the same greedy tokens and scheduling counters."""
    jmodel, jparams, model = _cached_pair("int8")
    prompts = _prompts(20, (5, 9, 3, 12, 7))
    jkw = dict(paged=True, decode_kernel="pallas") if paged else dict(paged=False)
    jeng = JServingEngine(jmodel, jparams, registry=MetricsRegistry(), **jkw, **ENGINE_KW)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=JGenerationConfig(max_new_tokens=8))
    engine = ServingEngine(model, None, device="cpu", paged=paged, **ENGINE_KW)
    reqs = engine.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=8))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert {c: engine.stats[c] for c in COUNTERS} == {c: jeng.stats[c] for c in COUNTERS}
    if paged:
        assert engine.kv.allocator.free_count == engine.num_pages - 1


@pytest.mark.parametrize("knobs", [dict(speculate_k=2),
                                   dict(draft_model=1, tree_width=2, tree_depth=2, draft_ctx=16)])
def test_quantized_moe_engine_speculates_and_caches_prefixes(knobs):
    """The same quantized MoE model under speculation (n-gram drafts and the
    linear verify; a one-layer draft's tree and the tree verify) and with
    the prefix cache on: the greedy tokens of the plain engine, drafts
    accepted and prefix tokens hit.  Drop-free capacity: a token's experts
    do not depend on how many tokens share its forward."""
    _, _, model = _cached_pair("int8")
    shared = _prompts(30, (8,))[0]
    prompts = [np.concatenate([shared, p]) for p in _prompts(31, (3, 5, 2, 6))]
    gen = GenerationConfig(max_new_tokens=16)
    plain = ServingEngine(model, None, device="cpu", **ENGINE_KW).serve(
        [p.copy() for p in prompts], configs=gen)
    engine = ServingEngine(model, None, device="cpu", **{**ENGINE_KW, "prefix_cache_mb": 1},
                           **knobs)
    reqs = engine.serve([p.copy() for p in prompts], configs=gen)
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    assert engine.stats["verify_forwards"] > 0 and engine.stats["prefix_hit_tokens"] > 0


# ------------------------------------------------------------------ HF Mixtral
def test_hf_mixtral_loads_and_matches_hf(tmp_path):
    hf_model = _build(MIXTRAL, seed=23)
    hf_model.save_pretrained(str(tmp_path), safe_serialization=True)
    model, sd = hf_compat.load_hf_checkpoint(str(tmp_path), device="cpu",
                                             config_overrides=dict(dtype=torch.float32))
    assert model.config.expert_capacity_factor == 2.0
    ids = np.random.default_rng(2).integers(1, 128, (2, 21)).astype(np.int64)
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(ids)).logits.float()
        out = model(torch.from_numpy(ids))
    torch.testing.assert_close(out, ref, atol=HF_ATOL, rtol=HF_ATOL)
    qmodel, qsd = hf_compat.load_hf_checkpoint(
        str(tmp_path), device="cpu", config_overrides=dict(dtype=torch.float32, quantization=8))
    want = q.quantize_model_params(sd, q.QuantizationConfig(bits=8))
    assert sorted(qsd) == sorted(want) and all(torch.equal(qsd[k], want[k]) for k in want)
    with torch.no_grad():
        qout = qmodel(torch.from_numpy(ids))
    assert (qout - out).abs().max() < 0.05 * out.abs().max()
