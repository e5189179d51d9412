"""Port parity: the model families of the JAX config on the port.

* Every non-MoE model type that ``hf_compat`` maps (16 of its 17) has its
  switch set here at tiny widths (``FAMILIES``).  For each, the JAX
  ``Transformer`` is initialised from a seed, its biases and norm
  parameters get noise (``affine_noise``), its params go through
  ``params_from_jax`` into the port, and the same numpy token ids go through
  both: the no-cache f32 logits, a slab-cache prefill + decode (per-lane
  index, the slab serving pool's forward) and the plain paged path (a
  prefill chunk and decode steps over a page pool, the JAX ``"xla"`` paged
  reference, which carries windows and alibi) agree within ``ATOL``.  The
  port's state dict holds exactly the JAX tree's parameters, and
  ``init_params`` makes every one of them.
* ``blocked_causal_attention``, ``window=`` and ``bias=`` against the JAX
  functions; the alibi slopes against the JAX ones.
* The refusals: the config's (MoE, fp8, quantization, ring, unknown
  switches), the attention arms', the kernels' for window and alibi models
  and the engine's routing of those models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.transformer import KVCache as JKVCache
from accelerate_tpu.models.transformer import PagedKVCache as JPagedKVCache
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import alibi_slopes as jalibi_slopes
from accelerate_tpu.models.transformer import cached_attention as jcached_attention
from accelerate_tpu.ops.attention import blocked_causal_attention as jblocked
from accelerate_tpu.ops.attention import dot_product_attention as jdpa
from accelerate_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
    Transformer,
    TransformerConfig,
    alibi_slopes,
    cached_attention,
    state_dict_shapes,
)
from accelerate_tpu_torch.ops.attention import blocked_causal_attention, dot_product_attention
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.weights import init_params, params_from_jax

#: f32 forwards of two frameworks: the same products summed in other orders
ATOL = 1e-5

_GPT2 = dict(norm_type="layernorm", use_bias=True, positional="learned", mlp_variant="gelu",
             tie_word_embeddings=True)
_GPTJ = dict(norm_type="layernorm", rope_interleaved=True, parallel_residual=True,
             shared_norm=True, attn_bias=False, mlp_bias=True, lm_head_bias=True,
             mlp_variant="gelu")
#: each mapped model type's switches (``accelerate_tpu/models/hf_compat.py``
#: ``_config_from_hf_dict``) on ``TransformerConfig.tiny`` (hidden 64, 4
#: heads over 2 kv heads, head dim 16) unless the family fixes the heads
FAMILIES = {
    "llama": dict(attn_bias=True, mlp_bias=True),
    "gpt2": _GPT2,
    "opt": dict(_GPT2, pos_offset=2, mlp_variant="relu"),
    "gptj": dict(_GPTJ, rope_dim=8),
    "gpt_neox": dict(norm_type="layernorm", rope_dim=4, parallel_residual=True,
                     use_bias=True, mlp_variant="gelu_exact"),
    "mistral": dict(sliding_window=8),
    "qwen2": dict(qkv_bias=True),
    "gemma": dict(norm_unit_offset=True, embed_scale=True, mlp_variant="geglu",
                  tie_word_embeddings=True, head_dim=24, num_kv_heads=1),
    "phi3": dict(sliding_window=12),
    "falcon": dict(norm_type="layernorm", mlp_variant="gelu_exact", parallel_residual=True,
                   shared_norm=True, num_kv_heads=1, tie_word_embeddings=True),
    "stablelm": dict(norm_type="layernorm", rope_dim=4, qkv_bias=True),
    "gpt_bigcode": dict(_GPT2, num_kv_heads=1),
    "phi": dict(norm_type="layernorm", use_bias=True, lm_head_bias=True, mlp_variant="gelu",
                parallel_residual=True, shared_norm=True, rope_dim=8),
    "bloom": dict(norm_type="layernorm", use_bias=True, positional="alibi", embed_norm=True,
                  mlp_variant="gelu", tie_word_embeddings=True, hidden_size=48, num_heads=6,
                  num_kv_heads=6),
    "codegen": dict(_GPTJ, rope_dim=4, num_heads=8, num_kv_heads=8),
    "mpt": dict(norm_type="layernorm", norm_bias=False, positional="alibi",
                mlp_variant="gelu_exact", tie_word_embeddings=True, num_heads=8,
                num_kv_heads=8),
}
FULL_CAUSAL = [f for f, sw in FAMILIES.items()
               if "sliding_window" not in sw and sw.get("positional") != "alibi"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under the
    tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def affine_noise(jparams, seed):
    """Numpy params with normal(0.1) noise added to every 1-D leaf: each bias
    and each norm's scale and bias.  Flax draws those as zeros and ones,
    under which a swapped, dropped or misplaced bias or norm computes the
    same function."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        return a + rng.normal(0.0, 0.1, a.shape).astype(a.dtype) if a.ndim == 1 else a

    return jax.tree_util.tree_map(leaf, jparams)


@pytest.fixture(scope="module")
def pair():
    """``pair(family)`` -> (JAX model, JAX params, port model), f32, biases
    and norm parameters drawn nonzero, each built once for the module."""
    built = {}

    def get(family):
        if family not in built:
            sw = dict(FAMILIES[family], max_seq_len=64)
            jmodel = JTransformer(JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **sw))
            jparams = affine_noise(jmodel.init(jax.random.PRNGKey(len(family)),
                                               jnp.zeros((1, 8), jnp.int32))["params"],
                                   seed=len(family))
            model = Transformer(TransformerConfig.tiny(dtype=torch.float32, **sw), device="cpu")
            model.load_state_dict(params_from_jax(jparams, device="cpu"))
            built[family] = (jmodel, jparams, model)
        return built[family]

    return get


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape).astype(np.int32)


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_no_cache_logits_match_jax(pair, family):
    jmodel, jparams, model = pair(family)
    ids = _ids(1, (2, 21))  # past the Mistral and Phi-3 windows
    ref = jmodel.apply({"params": jparams}, jnp.asarray(ids))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_slab_decode_matches_jax(pair, family):
    """A two-lane prefill into a slab cache with per-lane indices (one lane
    starting 3 tokens later), then three decode steps, against the JAX model
    on its own per-lane ``KVCache``."""
    jmodel, jparams, model = pair(family)
    cfg = model.config
    jcache = JKVCache.create(jmodel.config, 2, 32, per_lane_index=True)
    jcache = jcache.replace(index=jnp.asarray([0, 3], jnp.int32))
    cache = KVCache.create(cfg, 2, 32)
    cache.index.copy_(torch.tensor([0, 3], dtype=torch.int32))
    feed = _ids(2, (2, 14))
    for step in range(4):
        ref, jcache = jmodel.apply({"params": jparams}, jnp.asarray(feed), cache=jcache)
        with torch.inference_mode():
            out, cache = model(torch.from_numpy(feed), cache=cache)
        _close(out.numpy(), ref)
        feed = _ids(10 + step, (2, 1))
    np.testing.assert_array_equal(cache.index.numpy(), np.asarray(jcache.index))
    _close(cache.k.numpy(), jcache.k)


def _pools(cfg, lanes, pages_per_lane, page):
    num_pages = lanes * pages_per_lane + 1
    shape = (cfg.num_layers, num_pages, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    tables = np.arange(1, num_pages).reshape(lanes, pages_per_lane).astype(np.int32)
    return np.zeros(shape, np.float32), np.ones(shape[:2] + shape[3:4], np.float32), tables


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_paged_path_matches_jax(pair, family):
    """A two-lane 12-token prefill chunk, then three decode steps, over a
    pool of 4-token pages through the port's plain paged versions, against
    the JAX model's ``paged_kernel="xla"`` reference path."""
    jmodel, jparams, model = pair(family)
    cfg = model.config
    pk, scales, tables = _pools(cfg, 2, 6, 4)
    jcache = JPagedKVCache(
        pages_k=jnp.asarray(pk), pages_v=jnp.asarray(pk), k_scales=jnp.asarray(scales),
        v_scales=jnp.asarray(scales), tables=jnp.asarray(tables),
        index=jnp.zeros(2, jnp.int32), active=jnp.ones(2, bool), quant_err=jnp.float32(0.0))
    cache = PagedKVCache(
        torch.from_numpy(pk.copy()), torch.from_numpy(pk.copy()), torch.from_numpy(scales),
        torch.from_numpy(scales), torch.from_numpy(tables), torch.zeros(2, dtype=torch.int32),
        torch.ones(2, dtype=torch.bool), kernel="prefill", plain=True)
    feed = _ids(3, (2, 12))
    for step in range(4):
        ref, jcache = jmodel.apply({"params": jparams}, jnp.asarray(feed), cache=jcache)
        with torch.inference_mode():
            out, cache = model(torch.from_numpy(feed), cache=cache)
        _close(out.numpy(), ref)
        cache.kernel = "decode"
        feed = _ids(20 + step, (2, 1))
    _close(cache.pages_k[:, 1:].numpy(), np.asarray(jcache.pages_k)[:, 1:])


@pytest.mark.parametrize("family", FULL_CAUSAL)
def test_kernel_paged_path_matches_no_cache_forward(pair, family):
    """The kernels' path (on the CPU their plain versions; on the card K1
    and K2): a prefill chunk at base 0, one at base 8, and two decode steps
    reproduce one no-cache forward over the same tokens."""
    _, _, model = pair(family)
    pk, scales, tables = _pools(model.config, 1, 6, 4)
    cache = PagedKVCache(
        torch.from_numpy(pk.copy()), torch.from_numpy(pk.copy()), torch.from_numpy(scales),
        torch.from_numpy(scales), torch.from_numpy(tables), torch.zeros(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), kernel="prefill")
    ids = torch.from_numpy(_ids(4, (1, 14)))
    with torch.inference_mode():
        ref = model(ids)
        parts = []
        for lo, hi, kernel in ((0, 8, "prefill"), (8, 12, "prefill"), (12, 13, "decode"),
                               (13, 14, "decode")):
            cache.kernel = kernel
            out, cache = model(ids[:, lo:hi], cache=cache)
            parts.append(out)
    torch.testing.assert_close(torch.cat(parts, dim=1), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_holds_the_jax_tree(pair, family):
    """``state_dict_shapes`` names exactly the parameters of the JAX tree
    (through ``params_from_jax``) at their shapes, the model holds the same,
    and ``init_params`` makes each: normal(0.02) matrices, zero biases, unit
    norm scales (zero for Gemma's unit offset)."""
    _, jparams, model = pair(family)
    cfg = model.config
    from_jax = params_from_jax(jparams, device="cpu")
    shapes = state_dict_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in from_jax.items()} == shapes
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    sd = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    for name, t in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        norm = name.rsplit(".", 2)[-2].endswith("norm")
        assert t.dtype == (torch.float32 if norm else torch.bfloat16), name
        if leaf == "scale":
            assert torch.all(t == (0.0 if cfg.norm_unit_offset else 1.0)), name
        elif leaf == "bias":
            assert not t.any(), name
        else:
            assert 0.015 < t.float().std().item() < 0.025, name


@pytest.mark.parametrize("preset", ["llama2_7b", "gpt2", "gpt2_xl_equiv"])
def test_presets_match_jax(preset):
    """Each full-width preset sets the JAX preset's fields; GPT-2's state
    dict holds its published 124,439,808 parameters (tied head)."""
    cfg, jcfg = getattr(TransformerConfig, preset)(), getattr(JConfig, preset)()
    names = {f.name for f in dataclasses.fields(TransformerConfig)} - {"dtype", "param_dtype"}
    assert {n: getattr(cfg, n) for n in names} == {n: getattr(jcfg, n) for n in names}
    if preset == "gpt2":
        assert sum(int(np.prod(s)) for s in state_dict_shapes(cfg).values()) == 124_439_808


def test_llama_draws_are_unchanged_by_the_switches():
    """The Llama recipe's random weights draw in the same order as before the
    family switches: the full-width chip lines stay comparable."""
    cfg = TransformerConfig.tiny(dtype=torch.float32)
    names = [n for n in state_dict_shapes(cfg) if not n.endswith(".scale")]
    assert names[:5] == ["embed_tokens.weight", "layers.0.attn.q_proj.weight",
                         "layers.0.attn.k_proj.weight", "layers.0.attn.v_proj.weight",
                         "layers.0.attn.o_proj.weight"]
    assert names[-1] == "lm_head.weight" and not any(n.endswith(".bias") for n in names)


# ----------------------------------------------------------- attention ops
def _qkv(seed, b, s, hq, hkv, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("s,hq,hkv,chunk,segmented", [
    (512, 4, 4, 256, False), (512, 8, 2, 256, False), (96, 4, 2, 32, True), (40, 4, 1, 64, False),
])
def test_blocked_causal_attention_matches_jax(s, hq, hkv, chunk, segmented):
    q, k, v = _qkv(s, 2, s, hq, hkv)
    seg = None
    if segmented:
        seg = np.repeat(np.arange(3), -(-s // 3))[None, :s].repeat(2, 0).astype(np.int32)
    ref = jblocked(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                   segment_ids=None if seg is None else jnp.asarray(seg))
    out = blocked_causal_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk,
                                   segment_ids=None if seg is None else torch.from_numpy(seg))
    _close(out.numpy(), ref)
    via = dot_product_attention(*map(torch.from_numpy, (q, k, v)), implementation="blocked",
                                segment_ids=None if seg is None else torch.from_numpy(seg))
    _close(via.numpy(), jdpa(*map(jnp.asarray, (q, k, v)), implementation="blocked",
                             segment_ids=None if seg is None else jnp.asarray(seg)))


def test_blocked_refuses_a_ragged_sequence_and_bidirectional_attention():
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 300, 4, 2))
    with pytest.raises(ValueError, match="divisible by chunk"):
        blocked_causal_attention(q, k, v)
    with pytest.raises(ValueError, match="causal-only"):
        dot_product_attention(q, k, v, causal=False, implementation="blocked")
    jq, jk, jv = map(jnp.asarray, _qkv(0, 1, 300, 4, 2))
    with pytest.raises(ValueError, match="divisible by chunk"):
        jblocked(jq, jk, jv)


@pytest.mark.parametrize("window,hkv,with_bias,segmented", [
    (3, 4, False, False), (7, 2, False, True), (None, 4, True, False), (5, 2, True, True),
])
def test_window_and_bias_match_jax(window, hkv, with_bias, segmented):
    s = 24
    q, k, v = _qkv(window or 0, 2, s, 4, hkv)
    seg = (np.arange(s)[None] // 10).repeat(2, 0).astype(np.int32) if segmented else None
    bias = None
    if with_bias:
        j = np.arange(s, dtype=np.float32)
        bias = (np.asarray(jalibi_slopes(4))[:, None, None] * j[None, None, :])[None]
    jkw = dict(window=window, bias=None if bias is None else jnp.asarray(bias),
               segment_ids=None if seg is None else jnp.asarray(seg))
    tkw = dict(window=window, bias=None if bias is None else torch.from_numpy(bias),
               segment_ids=None if seg is None else torch.from_numpy(seg))
    ref = jdpa(*map(jnp.asarray, (q, k, v)), **jkw)
    out = dot_product_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("n_heads", [1, 4, 6, 8, 12, 32, 71])
def test_alibi_slopes_match_jax(n_heads):
    np.testing.assert_array_equal(alibi_slopes(n_heads).numpy(),
                                  np.asarray(jalibi_slopes(n_heads)))


@pytest.mark.parametrize("window,alibi", [(4, False), (None, True), (6, True)])
def test_cached_attention_arms_match_jax(window, alibi):
    """The slab math's window band and its relative alibi bias
    ``slope * (j - q_pos)`` at ragged per-lane positions, GQA 4/2."""
    q, _, _ = _qkv(5, 2, 3, 4, 2)
    _, k, v = _qkv(6, 2, 20, 4, 2)
    pos = np.asarray([[2, 3, 4], [15, 16, 17]], np.int32)
    ref = jcached_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(pos), window=window,
                            alibi=alibi)
    out = cached_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(pos),
                           window=window, alibi=alibi)
    _close(out.numpy(), ref)


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,exc,match", [
    (dict(implementation="blocked", window=4), NotImplementedError, "'xla' only"),
    (dict(implementation="pallas", window=4), NotImplementedError, "'xla' only"),
    (dict(implementation="blocked", bias="alibi"), NotImplementedError, "'xla' only"),
    (dict(implementation="pallas", bias="alibi"), NotImplementedError, "'xla' only"),
    (dict(window=4, causal=False), ValueError, "requires causal=True"),
    (dict(implementation="ring"), ValueError, "needs the active mesh"),
])
def test_attention_refusals_match_jax(kw, exc, match):
    q, k, v = _qkv(0, 1, 8, 4, 2)
    tkw = dict(kw, bias=torch.zeros(1)) if "bias" in kw else kw
    if kw.get("implementation") == "ring":
        # the ring arm needs an active mesh: none in either package
        from accelerate_tpu.state import AcceleratorState as JAcceleratorState
        from accelerate_tpu_torch.state import AcceleratorState

        AcceleratorState._reset_state(reset_partial_state=True)
        JAcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(exc, match=match):
        dot_product_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    jkw = dict(kw, bias=jnp.zeros(1)) if "bias" in kw else kw
    with pytest.raises(exc, match=match):
        jdpa(*map(jnp.asarray, (q, k, v)), **jkw)


@pytest.mark.parametrize("window,alibi", [(4, False), (None, True)])
def test_tree_mask_refuses_window_and_alibi(window, alibi):
    q, k, v = (torch.zeros(1, 3, 4, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="full-causal"):
        cached_attention(q, k, v, torch.zeros(1, 3, dtype=torch.long), window=window,
                         alibi=alibi, tree_mask=np.tril(np.ones((3, 3), bool)))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(quantization=8, use_fp8=True), ValueError, "mutually exclusive"),
    (dict(quantization=3), ValueError, "quantization must be"),
    (dict(use_fp8=True, fp8_format="E5M2"), ValueError, "fp8_format"),
    (dict(ring_attention_layout="spiral"), ValueError, "ring_attention_layout"),
    (dict(norm_type="batchnorm"), ValueError, "norm_type"),
    (dict(positional="sinusoidal"), ValueError, "positional"),
    (dict(mlp_variant="swish"), ValueError, "mlp_variant"),
    (dict(sliding_window=0), ValueError, "sliding_window"),
])
def test_config_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        TransformerConfig.tiny(**kw)
    # the same switch values the JAX config refuses (its quantization and fp8
    # checks run when the model is built, not in the config)
    if exc is ValueError and not kw.keys() & {"quantization", "use_fp8"}:
        with pytest.raises(ValueError, match=match):
            JConfig.tiny(**kw)


@pytest.mark.parametrize("family", ["mistral", "bloom"])
def test_kernels_refuse_window_and_alibi_models(pair, family):
    """The kernels have no window or alibi arm: a paged forward that is not
    the plain one raises instead of dropping the mask or the bias."""
    _, _, model = pair(family)
    pk, scales, tables = _pools(model.config, 1, 2, 4)
    cache = PagedKVCache(
        torch.from_numpy(pk), torch.from_numpy(pk.copy()), torch.from_numpy(scales),
        torch.from_numpy(scales), torch.from_numpy(tables), torch.zeros(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), kernel="prefill")
    with pytest.raises(ValueError, match="plain versions"):
        model(torch.ones(1, 4, dtype=torch.long), cache=cache)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_routes_each_family_as_the_reference(pair, family):
    """Full-causal families keep the kernels by default; sliding-window and
    alibi models resolve ``decode_kernel=None`` to the plain versions, and
    an explicit ``"pallas"`` (decode or prefill) or a draft tree raises the
    reference's ``ValueError``."""
    _, _, model = pair(family)
    kw = dict(num_slots=2, max_len=32, prefill_buckets=(4, 8), device="cpu",
              prefix_cache_mb=0)
    engine = ServingEngine(model, None, **kw)
    full = family in FULL_CAUSAL
    assert engine.decode_kernel == engine.prefill_kernel == ("pallas" if full else "xla")
    if full:
        ServingEngine(model, None, decode_kernel="pallas", **kw)
        return
    for knob in ("decode_kernel", "prefill_kernel"):
        with pytest.raises(ValueError, match="full-causal"):
            ServingEngine(model, None, **{knob: "pallas"}, **kw)
    with pytest.raises(ValueError, match="full-causal"):
        ServingEngine(model, None, draft_model=1, **kw)
