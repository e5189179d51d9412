"""Port parity: weight-only int8/int4 quantization (``ops/quantization.py``).

The same numpy weights (a numpy seed) go through the JAX package's
``accelerate_tpu.ops.quantization`` and the port's:

* ``quantize`` / ``dequantize`` / the int4 nibble packing agree bit for bit,
  int8 and int4, with K a multiple of the block and not;
* ``quantize_model_params`` of a dense tiny Transformer's weights gives the
  JAX conversion's codes and scales bit for bit (through ``params_from_jax``,
  which carries ``qweight``/``scales`` across untransposed);
* the quantized Transformer's f32 logits agree with the JAX quantized
  model's within ``REL_TOL`` (1e-5) of the logits' scale: the same
  dequantized weights, the two frameworks' f32 products summed in different
  orders;
* ``QuantizedLinear`` is bitwise an ``nn.Linear`` holding the dequantized
  weight, and ``init_params`` of a quantized config is the dense draws
  quantized.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.ops import quantization as q
from accelerate_tpu_torch.weights import init_params, params_from_jax, state_dict_shapes

REL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weight(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.02, shape).astype(np.float32)
    w[..., 3] = 0.0           # an all-zero column: the scale floor
    return w


def _equal(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    return t.shape == a.shape and np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("bits,k,block", [(8, 64, 64), (8, 70, 64), (4, 128, 64),
                                          (4, 70, 64), (4, 96, 32)])
def test_quantize_and_dequantize_bitwise(bits, k, block):
    w = _weight(k + bits, (k, 24))
    jcfg = jq.QuantizationConfig(bits=bits, block_size=block)
    qt = q.quantize(torch.from_numpy(w), q.QuantizationConfig(bits=bits, block_size=block))
    jqt = jq.quantize(jnp.asarray(w), jcfg)
    assert _equal(qt.data, jqt.data) and _equal(qt.scales, jqt.scales)
    assert qt.data.dtype == (torch.int8 if bits == 8 else torch.uint8)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = q.dequantize(qt, dt)
        want = np.asarray(jq.dequantize(jqt, jdt).astype(jnp.float32))
        assert np.array_equal(got.float().numpy(), want)
        t = q.dequantize(qt, dt, transposed=True)
        assert t.is_contiguous() and torch.equal(t, got.t())
    assert qt.nbytes == jqt.nbytes


@pytest.mark.parametrize("k", [2, 8, 70])
def test_int4_pack_unpack_bitwise(k):
    vals = np.random.default_rng(k).integers(-8, 8, (k + k % 2, 5)).astype(np.int8)
    packed = q._pack_int4(torch.from_numpy(vals))
    assert _equal(packed, jq._pack_int4(jnp.asarray(vals)))
    assert _equal(q._unpack_int4(packed, k), jq._unpack_int4(jnp.asarray(np.asarray(packed)), k))
    assert torch.equal(q._unpack_int4(packed, k), torch.from_numpy(vals[:k]))


def test_stacked_experts_quantize_per_expert():
    """A ``[E, K, N]`` stack: each expert quantized on its own, as the
    reference's vmapped ``QuantizedDense`` declares it."""
    w = _weight(5, (3, 70, 16))
    for bits in (8, 4):
        cfg = q.QuantizationConfig(bits=bits, block_size=32)
        qt = q.quantize(torch.from_numpy(w), cfg)
        jqts = [jq.quantize(jnp.asarray(w[e]), jq.QuantizationConfig(bits=bits, block_size=32))
                for e in range(3)]
        assert _equal(qt.data, np.stack([np.asarray(j.data) for j in jqts]))
        assert _equal(qt.scales, np.stack([np.asarray(j.scales) for j in jqts]))
        deq = q.dequantize(qt, torch.float32)
        for e in range(3):
            assert np.array_equal(deq[e].numpy(), np.asarray(jq.dequantize(jqts[e],
                                                                          jnp.float32)))


def _dense_pair(**kw):
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    init = jax.jit(JTransformer(jcfg).init)
    jparams = init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jcfg, jax.tree_util.tree_map(np.asarray, jparams["params"])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_params_dense_bitwise(bits):
    _, jparams = _dense_pair()
    jconv = jq.quantize_model_params(jparams, jq.QuantizationConfig(bits=bits))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jconv), device="cpu")
    got = q.quantize_model_params(params_from_jax(jparams, device="cpu"),
                                  q.QuantizationConfig(bits=bits))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    cfg = TransformerConfig.tiny(quantization=bits)
    assert {k: tuple(v.shape) for k, v in got.items()} == state_dict_shapes(cfg)
    meta = q.quantize_model_params({k: torch.empty(v.shape, device="meta")
                                    for k, v in params_from_jax(jparams, device="cpu").items()},
                                   q.QuantizationConfig(bits=bits))
    assert {k: (v.shape, v.dtype) for k, v in meta.items() if k in got and v.dtype != torch.float32} \
        == {k: (v.shape, v.dtype) for k, v in got.items() if v.dtype != torch.float32}


@pytest.mark.parametrize("bits,kw", [(8, {}), (4, {}), (8, dict(use_bias=True)),
                                     (4, dict(quantization_block_size=32, intermediate_size=96))])
def test_quantized_transformer_logits_match_jax(bits, kw):
    jcfg, jparams = _dense_pair(**{k: v for k, v in kw.items()
                                   if k != "quantization_block_size"})
    if kw.get("use_bias"):  # nonzero biases, so a dropped one shows
        jparams = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.1 if getattr(p[-1], "key", "") == "bias" else x, jparams)
    block = kw.get("quantization_block_size", 64)
    jqcfg = dataclasses.replace(jcfg, quantization=bits, quantization_block_size=block)
    jconv = jq.quantize_model_params(jparams, jq.QuantizationConfig(bits=bits, block_size=block))
    ids = np.random.default_rng(bits).integers(1, 256, (2, 13)).astype(np.int32)
    ref = np.asarray(jax.jit(JTransformer(jqcfg).apply)({"params": jconv}, jnp.asarray(ids)))
    cfg = TransformerConfig.tiny(dtype=torch.float32, quantization=bits, **kw)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jconv),
                                          device="cpu"))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids)).numpy()
    assert isinstance(model.layers[0].attn.q_proj, q.QuantizedLinear)
    assert type(model.lm_head) is torch.nn.Linear
    np.testing.assert_allclose(out, ref, atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linear_is_linear_on_dequantized_weight(bits):
    w = torch.from_numpy(_weight(bits, (96, 40)))
    qt = q.quantize(w, q.QuantizationConfig(bits=bits, block_size=32))
    for dt in (torch.float32, torch.bfloat16):
        lin = q.QuantizedLinear(96, 40, bits=bits, block_size=32, bias=True, compute_dtype=dt)
        lin.load_state_dict({"qweight": qt.data, "scales": qt.scales,
                             "bias": torch.linspace(-1, 1, 40)})
        dense = torch.nn.Linear(96, 40, dtype=dt)
        with torch.no_grad():
            dense.weight.copy_(q.dequantize(qt, dt).t())
            dense.bias.copy_(torch.linspace(-1, 1, 40).to(dt))
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 5, 96)).astype(np.float32))
        with torch.no_grad():
            assert torch.equal(lin(x), dense(x.to(dt)))


def test_init_params_quantizes_the_dense_draws():
    for bits in (8, 4):
        cfg = TransformerConfig.tiny(quantization=bits)
        got = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
        dense = init_params(dataclasses.replace(cfg, quantization=None), seed=3, device="cpu",
                            dtype=torch.float32)
        want = q.quantize_model_params(dense, q.QuantizationConfig(bits=bits))
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(got)


def test_quantize_params_and_nbytes_match_jax():
    """The size-gated ``quantize_params`` and ``quantized_nbytes`` over the
    same tensors (the JAX tree's leaves as they are, by dotted path)."""
    _, jparams = _dense_pair()
    flat = {".".join(str(getattr(k, "key", k)) for k in path): torch.from_numpy(np.array(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    got = q.quantize_params(flat, q.QuantizationConfig(bits=8))
    jgot = jq.quantize_params(jparams, jq.QuantizationConfig(bits=8))
    assert q.quantized_nbytes(got) == jq.quantized_nbytes(jgot)
    jflat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_leaves_with_path(jgot, is_leaf=jq.is_quantized)}
    assert sorted(got) == sorted(jflat)
    for name, v in got.items():
        assert q.is_quantized(v) == jq.is_quantized(jflat[name]), name
        if q.is_quantized(v):
            assert _equal(v.data, jflat[name].data) and _equal(v.scales, jflat[name].scales)
    back = q.dequantize_params(got, torch.float32)
    assert all(not q.is_quantized(v) for v in back.values())


def test_config_refusals():
    assert TransformerConfig(quantization=8).quantization == 8
    assert TransformerConfig(quantization=4).quantization == 4
    with pytest.raises(ValueError, match="mutually exclusive"):
        TransformerConfig(quantization=8, use_fp8=True)
    with pytest.raises(ValueError, match="8- and 4-bit"):
        q.QuantizationConfig(bits=2)
    with pytest.raises(ValueError, match="even"):
        q.Int4Config(block_size=33)
