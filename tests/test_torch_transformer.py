"""Port parity: the PyTorch Llama-recipe Transformer vs the JAX Transformer.

The JAX model's Flax params (``TransformerConfig.tiny``, f32) go through
``params_from_jax`` into the port; the same numpy token ids go through both.
f32 logits agree within 1e-5: the two frameworks sum the same f32 products
in different orders (measured differences are a few 1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.transformer import PagedKVCache as JPagedKVCache
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu_torch.models.transformer import (
    PagedKVCache,
    Transformer,
    TransformerConfig,
)
from accelerate_tpu_torch.weights import init_params, params_from_jax, state_dict_shapes

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                          device="cpu"))
    return jmodel, jparams, model


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape).astype(np.int32)


def test_no_cache_logits_match(pair):
    jmodel, jparams, model = pair
    ids = _ids(0, (2, 13))
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


def _caches(n_lanes, page, pages_per_lane, cfg_layers, hkv, hd):
    num_pages = n_lanes * pages_per_lane + 1
    shape = (cfg_layers, num_pages, page, hkv, hd)
    tables = np.arange(1, num_pages).reshape(n_lanes, pages_per_lane).astype(np.int32)
    pk = np.zeros(shape, np.float32)
    scales = np.ones((cfg_layers, num_pages, hkv), np.float32)
    return pk, scales, tables


def test_paged_prefill_then_decode_matches_jax(pair):
    """A two-lane prefill chunk through the prefill kernel's path, then three
    decode steps through the decode kernel's path, against the JAX model on
    its own PagedKVCache with the Pallas kernels (interpret mode)."""
    jmodel, jparams, model = pair
    cfg = model.config
    hd, hkv, L = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_layers
    pk, scales, tables = _caches(2, 4, 6, L, hkv, hd)
    prompt = _ids(1, (2, 8))
    jcfg = jmodel.config
    jpre = JTransformer(dataclasses.replace(jcfg, paged_kernel="flash_prefill"))
    jdec = JTransformer(dataclasses.replace(jcfg, paged_kernel="pallas"))
    jcache = JPagedKVCache(
        pages_k=jnp.asarray(pk), pages_v=jnp.asarray(pk), k_scales=jnp.asarray(scales),
        v_scales=jnp.asarray(scales), tables=jnp.asarray(tables),
        index=jnp.asarray([0, 0], jnp.int32), active=jnp.asarray([True, True]),
        quant_err=jnp.float32(0.0),
    )
    cache = PagedKVCache(
        pages_k=torch.from_numpy(pk.copy()), pages_v=torch.from_numpy(pk.copy()),
        k_scales=torch.from_numpy(scales), v_scales=torch.from_numpy(scales),
        tables=torch.from_numpy(tables), index=torch.zeros(2, dtype=torch.int32),
        active=torch.ones(2, dtype=torch.bool), kernel="prefill",
    )
    ref, jcache = jpre.apply({"params": jparams}, jnp.asarray(prompt), cache=jcache)
    with torch.inference_mode():
        out, cache = model(torch.from_numpy(prompt), cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    cache.kernel = "decode"
    for step in range(3):
        tok = _ids(10 + step, (2, 1))
        ref, jcache = jdec.apply({"params": jparams}, jnp.asarray(tok), cache=jcache)
        with torch.inference_mode():
            out, cache = model(torch.from_numpy(tok), cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(cache.index.numpy(), np.asarray(jcache.index))
    np.testing.assert_allclose(cache.pages_k.numpy(), np.asarray(jcache.pages_k), atol=ATOL)


def test_paged_forward_matches_no_cache_forward(pair):
    """Chunked prefill at a nonzero base plus decode reproduces the logits of
    one no-cache forward over the same tokens (the check chip_smoke.py runs
    at full width on the card)."""
    _, _, model = pair
    cfg = model.config
    pk, scales, tables = _caches(1, 4, 6, cfg.num_layers, cfg.num_kv_heads,
                                 cfg.resolved_head_dim)
    ids = _ids(2, (1, 14))
    cache = PagedKVCache(
        torch.from_numpy(pk.copy()), torch.from_numpy(pk.copy()), torch.from_numpy(scales),
        torch.from_numpy(scales), torch.from_numpy(tables), torch.zeros(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), kernel="prefill")
    with torch.inference_mode():
        ref = model(torch.from_numpy(ids))
        a, cache = model(torch.from_numpy(ids[:, :8]), cache=cache)
        b, cache = model(torch.from_numpy(ids[:, 8:12]), cache=cache)
        cache.kernel = "decode"
        c, cache = model(torch.from_numpy(ids[:, 12:13]), cache=cache)
        d, cache = model(torch.from_numpy(ids[:, 13:14]), cache=cache)
    got = torch.cat([a, b, c, d], dim=1)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("switch", [
    dict(norm_type="layernorm"), dict(positional="learned"), dict(mlp_variant="gelu"),
    dict(sliding_window=8), dict(parallel_residual=True), dict(tie_word_embeddings=True),
    dict(num_experts=4), dict(rope_interleaved=True), dict(use_bias=True),
])
def test_other_families_not_ported(switch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerConfig.tiny(**switch)


def test_llama2_7b_geometry():
    cfg = TransformerConfig.llama2_7b()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
            cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (
        32000, 4096, 11008, 32, 32, 32, 128)
    n = sum(int(np.prod(s)) for s in state_dict_shapes(cfg).values())
    assert 6.7e9 < n < 6.8e9


def test_init_params_matches_model_layout():
    cfg = TransformerConfig.tiny(dtype=torch.float32)
    sd = init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(sd, assign=True)
    assert sd["layers.0.attn.q_proj.weight"].dtype == torch.bfloat16
    assert sd["final_norm.scale"].dtype == torch.float32
    assert torch.equal(init_params(cfg, seed=3, device="cpu")["lm_head.weight"],
                       sd["lm_head.weight"])
    assert 0.015 < sd["lm_head.weight"].float().std().item() < 0.025


def test_entry_points_refuse_to_drift_to_cpu(monkeypatch):
    """Without ``device="cpu"`` and without a card, every entry point raises."""
    from accelerate_tpu_torch.serving import PagedKVPool, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVPool(cfg, 2, 16, 4, 9)
    model = Transformer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, None, num_slots=2, max_len=16, prefill_buckets=(4,))
