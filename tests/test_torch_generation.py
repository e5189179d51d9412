"""Port parity: the static decode loop (``models/generation.py``) and the
streamed one (``StreamingTransformer.generate``).

The JAX ``Transformer`` (``TransformerConfig.tiny``, f32) and the port's
model hold the same weights (``params_from_jax``); the same numpy token ids
go through both.  Greedy tokens are identical to the JAX ``generate`` and
the JAX ``StreamingTransformer.generate``, with EOS masked to the pad token
and on a warm cache; incremental logits (a prompt, then one token at a
time) are within ``ATOL`` of the full forward and of the JAX package's.
Sampled tokens match the JAX package in distribution only (threefry there,
Philox here), so sampling is held to its filters: top-k and top-p
membership, and temperature 0 being greedy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models import generation as jgen
from accelerate_tpu.models.transformer import KVCache as JKVCache
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu_torch import big_modeling as bm
from accelerate_tpu_torch.models import generation as gen
from accelerate_tpu_torch.models.transformer import KVCache, Transformer, TransformerConfig
from accelerate_tpu_torch.weights import params_from_jax

#: f32 logits of two frameworks summing the same products in other orders
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    sd = params_from_jax(jparams, device="cpu")
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    return jmodel, jparams, model, sd


def _placed(placed_and_loader):
    """``dispatch_params``' two results as ``StreamingTransformer`` keywords."""
    placed, loader = placed_and_loader
    return dict(params=placed, weights_loader=loader)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape).astype(np.int32)


def _jgenerate(jmodel, jparams, ids, cache=None, **kw):
    seqs, cache = jgen.generate(jmodel, jparams, jnp.asarray(ids), jgen.GenerationConfig(**kw),
                                cache=cache)
    return np.asarray(seqs), cache


def _generate(model, ids, params=None, cache=None, **kw):
    seqs, cache = gen.generate(model, params, torch.from_numpy(ids),
                               gen.GenerationConfig(**kw), cache=cache)
    return seqs.numpy(), cache


def test_greedy_tokens_match_jax(pair):
    jmodel, jparams, model, sd = pair
    ids = _ids(0, (3, 7))
    want, jcache = _jgenerate(jmodel, jparams, ids, max_new_tokens=9)
    got, cache = _generate(model, ids, max_new_tokens=9)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == ids.dtype and got.shape == (3, 16)
    # the final token is returned but never fed back
    assert cache.index.tolist() == [15] * 3 == [int(jcache.index)] * 3
    # the same through a state dict bound by functional_call
    np.testing.assert_array_equal(_generate(Transformer(model.config, device="meta"), ids,
                                            params=sd, cache=KVCache.create(
                                                model.config, 3, 16, device="cpu"),
                                            max_new_tokens=9)[0], want)


def test_eos_masks_to_pad_as_jax(pair):
    jmodel, jparams, model, _ = pair
    ids = _ids(1, (2, 5))
    probe, _ = _generate(model, ids, max_new_tokens=3)
    eos = int(probe[0, 5])  # lane 0's first token
    kw = dict(max_new_tokens=6, eos_token_id=eos, pad_token_id=7)
    want, _ = _jgenerate(jmodel, jparams, ids, **kw)
    got, _ = _generate(model, ids, **kw)
    np.testing.assert_array_equal(got, want)
    assert got[0, 5] == eos and (got[0, 6:] == 7).all()


def test_warm_cache_and_overflow_match_jax(pair):
    jmodel, jparams, model, _ = pair
    cfg = model.config
    ids, more = _ids(2, (2, 5)), _ids(3, (2, 2))
    jcache = JKVCache.create(jmodel.config, 2, 16)
    cache = KVCache.create(cfg, 2, 16, device="cpu")
    for chunk, n in ((ids, 3), (more, 4)):
        want, jcache = _jgenerate(jmodel, jparams, chunk, cache=jcache, max_new_tokens=n)
        got, cache = _generate(model, chunk, cache=cache, max_new_tokens=n)
        np.testing.assert_array_equal(got, want)
    assert cache.index.tolist() == [int(jcache.index)] * 2 == [12, 12]
    # the warm cache's room: 12 written + 2 + 3 > 16
    with pytest.raises(ValueError, match="already written"):
        _generate(model, more, cache=cache, max_new_tokens=3)
    # a fresh cache too small for prompt + new tokens
    with pytest.raises(ValueError, match="max_len"):
        _generate(model, ids, cache=KVCache.create(cfg, 2, 6, device="cpu"), max_new_tokens=6)


def test_incremental_logits_match_full_forward_and_jax(pair):
    """A 4-token prefill, then one token at a time: each step's logits
    within ``ATOL`` of the full forward's row and of the JAX package's
    incremental logits."""
    jmodel, jparams, model, _ = pair
    ids = _ids(4, (2, 10))
    with torch.no_grad():
        full = model(torch.from_numpy(ids)).numpy()
    jfull = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    np.testing.assert_allclose(full, jfull, atol=ATOL)
    cache = KVCache.create(model.config, 2, 10, device="cpu")
    prefill, decode = gen.make_prefill_step(model), gen.make_decode_step(model)
    jcache = JKVCache.create(jmodel.config, 2, 10)
    jprefill, jdecode = jgen.make_prefill_step(jmodel), jgen.make_decode_step(jmodel)
    logits, cache = prefill(None, torch.from_numpy(ids[:, :4]), cache)
    jlogits, jcache = jprefill(jparams, jnp.asarray(ids[:, :4]), jcache)
    np.testing.assert_allclose(logits.numpy(), full[:, :4], atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    for t in range(4, 10):
        logits, cache = decode(None, torch.from_numpy(ids[:, t]), cache)
        jlogits, jcache = jdecode(jparams, jnp.asarray(ids[:, t]), jcache)
        np.testing.assert_allclose(logits.numpy(), full[:, t], atol=ATOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    assert cache.index.tolist() == [10, 10]


def test_streaming_generate_matches_jax_and_resident(pair, tmp_path):
    """``StreamingTransformer.generate`` from host and ``.dat`` weights: the
    JAX streamer's tokens, the resident ``generate``'s, and its prefill
    logits bitwise the resident model's; EOS masked, a warm cache's room
    checked as the reference checks it."""
    jmodel, jparams, model, sd = pair
    ids = _ids(5, (2, 6))
    want = np.asarray(jbm.StreamingTransformer(jmodel.config, **_placed(jbm.cpu_offload(jparams)))
                      .generate(jnp.asarray(ids), max_new_tokens=7))
    resident, _ = _generate(model, ids, max_new_tokens=7)
    np.testing.assert_array_equal(resident, want)
    for st in (bm.StreamingTransformer(model.config, **_placed(bm.cpu_offload(sd, device="cpu")),
                                       exec_device="cpu"),
               bm.StreamingTransformer(model.config, **_placed(
                   bm.disk_offload(sd, str(tmp_path), device="cpu")),
                                       exec_device="cpu", layers_per_stage=2)):
        np.testing.assert_array_equal(st.generate(torch.from_numpy(ids), max_new_tokens=7)
                                      .numpy(), want)
        cache = st.init_cache(2, 6)
        logits, cache = st.forward_with_cache(torch.from_numpy(ids), cache)
        with torch.no_grad():
            ref, _ = model(torch.from_numpy(ids),
                           cache=KVCache.create(model.config, 2, 6, device="cpu"))
        assert torch.equal(logits, ref) and int(cache["index"]) == 6
    eos = int(want[0, 6])
    seqs = st.generate(torch.from_numpy(ids), max_new_tokens=5, eos_token_id=eos,
                       pad_token_id=0).numpy()
    assert seqs[0, 6] == eos and (seqs[0, 7:] == 0).all()
    with pytest.raises(ValueError, match="max_len"):
        st.generate(torch.from_numpy(ids), max_new_tokens=16, cache=st.init_cache(2, 10))


def test_streaming_per_lane_index_decodes_each_lane_at_its_position(pair):
    """``init_cache(per_lane_index=True)``: lanes at different positions
    decode in one call, each as the resident model decodes it alone."""
    _, _, model, sd = pair
    st = bm.StreamingTransformer(model.config, sd, exec_device="cpu")
    ids = _ids(6, (2, 8))
    cache = st.init_cache(2, 12, per_lane_index=True)
    cache["index"] = torch.tensor([3, 5], dtype=torch.int32)
    logits, cache = st.forward_with_cache(torch.from_numpy(ids[:, :1]), cache)
    assert cache["index"].tolist() == [4, 6]
    ref = KVCache.create(model.config, 2, 12, device="cpu")
    ref.index = torch.tensor([3, 5], dtype=torch.int32)
    with torch.no_grad():
        want, _ = model(torch.from_numpy(ids[:, :1]), cache=ref)
    assert torch.equal(logits, want)


# ------------------------------------------------------------- sampling
def _logits(seed=0, batch=512, vocab=64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, vocab)).astype(np.float32) * 3.0)


def test_greedy_and_temperature_zero_are_argmax():
    logits = _logits()
    want = logits.argmax(-1).to(torch.int32)
    assert torch.equal(gen.sample_tokens(logits), want)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(gen.sample_tokens(logits, g, do_sample=True, temperature=0.0), want)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jgen.sample_tokens(
        jnp.asarray(logits.numpy()))))
    with pytest.raises(ValueError, match="rng"):
        gen.sample_tokens(logits, do_sample=True)


def test_top_k_and_top_p_membership():
    logits = _logits(1)
    g = torch.Generator().manual_seed(1)
    toks = gen.sample_tokens(logits, g, do_sample=True, top_k=5).numpy()
    top5 = np.argsort(logits.numpy(), axis=-1)[:, -5:]
    assert all(t in row for t, row in zip(toks, top5))
    toks = gen.make_sampler(True, 1.0, None, 0.5)(logits, g).numpy()
    probs = torch.softmax(logits, -1).numpy()
    for b, t in enumerate(toks):
        order = np.argsort(-probs[b])
        nucleus = order[: int(np.searchsorted(np.cumsum(probs[b][order]), 0.5)) + 1]
        assert t in nucleus
    toks = gen.sample_tokens(torch.zeros(4, 8), g, do_sample=True, top_p=1.0)
    assert ((toks >= 0) & (toks < 8)).all()


def test_sampled_generation_is_reproducible(pair):
    _, _, model, _ = pair
    ids = torch.from_numpy(_ids(7, (2, 4)))
    cfg = gen.GenerationConfig(max_new_tokens=5, do_sample=True, temperature=0.7, top_k=16)

    def run(seed):
        return gen.generate(model, None, ids, cfg,
                            generator=torch.Generator().manual_seed(seed))[0]

    a, b = run(7), run(7)
    assert torch.equal(a, b) and a.shape == (2, 9)
    assert ((a[:, 4:] >= 0) & (a[:, 4:] < 256)).all()
