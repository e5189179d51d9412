"""Port parity: an fp8 model served by the engine, and the padded fp8 product.

* A ``use_fp8`` ``tiny`` model (dense, and with four experts), f32, served
  by the port's ``ServingEngine`` on the paged pool (K1/K2's plain
  versions and the fp8 products' plain quantize -> dequantize path on the
  CPU) and on the slab pool, and by the JAX ``ServingEngine`` on the same
  weights and pool (its Pallas kernels in interpret mode): the same greedy
  tokens and scheduling counters.  A decode window's projections have M =
  the lane count, which the card's ``_scaled_mm`` cannot take unpadded,
  and scale by the amax of every lane's row: an inactive lane's row (what
  it writes and reads back at its stale index) must be the reference's.
* ``fp8.scaled_mm`` at M, K and N that are not multiples of 16 (a window's
  4 lanes among them; the card's sizes are its own test there) equals its
  plain version, the dequantized codes' product, within the f32 summation
  bound ``K * 2^-24 * max(|a| @ |b|)`` (the same exact fp8 products summed
  in different orders); ``test_torch_fp8.py`` holds it bitwise where every
  sum is exact.  The zero padding adds nothing.
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
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.weights import params_from_jax

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2, prefix_cache_mb=0)
COUNTERS = ("prefill_chunks", "decode_steps", "tokens_generated", "prefreed_lanes",
            "preemptions")


@pytest.fixture(scope="module", autouse=True)
def _quiet():
    from accelerate_tpu.telemetry import metrics as jax_metrics

    threads, was = torch.get_num_threads(), jax_metrics.enabled()
    torch.set_num_threads(1)
    jax_metrics.set_enabled(False)
    yield
    torch.set_num_threads(threads)
    jax_metrics.set_enabled(was)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
@pytest.mark.parametrize("kw", [dict(), dict(num_experts=4)], ids=["dense", "moe"])
def test_fp8_model_engine_matches_jax(kw, paged):
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, use_fp8=True,
                        max_seq_len=64, **kw)
    jmodel = JTransformer(jcfg)
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, use_fp8=True,
                                               max_seq_len=64, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 9, 3, 12, 7)]
    jeng = JServingEngine(jmodel, jparams, registry=MetricsRegistry(), paged=paged,
                          **(dict(decode_kernel="pallas") if paged else {}), **ENGINE_KW)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=JGenerationConfig(max_new_tokens=8))
    engine = ServingEngine(model, None, device="cpu", paged=paged, **ENGINE_KW)
    reqs = engine.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=8))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert {c: engine.stats[c] for c in COUNTERS} == {c: jeng.stats[c] for c in COUNTERS}


def _codes(seed, shape, dtype=torch.float8_e4m3fn):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return fp8._codes(x, dtype, 0)


@pytest.mark.parametrize("m,k,n", [(4, 256, 344), (24, 512, 384), (5, 33, 7),
                                   (1, 16, 17), (16, 48, 16)])
def test_scaled_mm_pads_any_shape(m, k, n):
    a, a_inv = _codes(m, (m, k))
    b, b_inv = _codes(n, (k, n), torch.float8_e5m2 if n == 17 else torch.float8_e4m3fn)
    got = fp8.scaled_mm(a, a_inv, b, b_inv, torch.float32)
    da, db = a.float() * a_inv, b.float() * b_inv
    want = da @ db
    bound = k * 2.0**-24 * (da.abs() @ db.abs()).max().item()
    assert got.shape == (m, n)
    torch.testing.assert_close(got, want, rtol=0, atol=bound)
    # the transposed operands of the backward's products
    got_t = fp8.scaled_mm(b.t(), b_inv, a.t(), a_inv, torch.float32)
    torch.testing.assert_close(got_t, want.t(), rtol=0, atol=bound)


def test_scaled_mm_counts_one_launch_a_product():
    a, a_inv = _codes(0, (4, 40))
    b, b_inv = _codes(1, (40, 24))
    before = fp8.launches
    fp8.scaled_mm(a, a_inv, b, b_inv, torch.bfloat16)
    assert fp8.launches == before + 1
