"""Port parity: fp8 products for training (``ops/fp8.py``).

The same numpy inputs (a numpy seed) go through the JAX package's
``accelerate_tpu.ops.fp8`` and the port's plain versions (the CPU path):

* ``compute_scale`` and ``quantize_dequantize`` agree bit for bit, e4m3 and
  e5m2, f32 and bf16 inputs, with a margin;
* the fp8 product's output and both gradients (``fp8_matmul`` against
  ``fp8_dot_general``, HYBRID and E4M3) agree within ``F32_TOL`` (1e-6) of
  their scale: the operands quantize to the same fp8 values, and the f32
  products sum them in different orders;
* ``DelayedScalingState``'s history, interval and ``most_recent`` refresh
  agree bit for bit over a run of observations;
* the fp8 Transformer's loss and gradients agree with the JAX fp8 model's
  within ``MODEL_TOL`` (1e-4, relative): the f32 products upstream of each
  fp8 cast differ in their last bits, which now and then moves a value
  across an fp8 rounding boundary, a step of 2^-4 relative on one element;
* ``Accelerator(mixed_precision="fp8").prepare(model)`` rebuilds the model
  with ``use_fp8`` on the same tensors, leaves an int-quantized model alone
  and warns, and its train step runs the fp8 products.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.utils.dataclasses import FP8RecipeKwargs as JRecipe
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.ops.fp8 import FP8Linear
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import FP8RecipeKwargs, PrecisionPolicy
from accelerate_tpu_torch.weights import init_params, params_from_jax

F32_TOL = 1e-6
MODEL_TOL = 1e-4

FORMATS = {"e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
           "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_state():
    yield
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("margin", [0, 2])
def test_quantize_dequantize_bitwise(fmt, dtype, margin):
    tdt, jdt = FORMATS[fmt]
    x = _x(1, (37, 19), scale=3.0)
    x[0, :4] = [0.0, 1e-30, -1e-30, 5e4]   # zero, below the format, the amax
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    amax = tx.float().abs().amax()
    scale = fp8.compute_scale(amax, tdt, margin)
    jscale = jfp8.compute_scale(jnp.max(jnp.abs(jx.astype(jnp.float32))), jdt, margin)
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    got = fp8.quantize_dequantize(tx, tdt, scale)
    want = jfp8.quantize_dequantize(jx, jdt, jscale)
    assert got.dtype == tx.dtype
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
@pytest.mark.parametrize("margin", [0, 1])
def test_fp8_product_and_gradients_match_jax(fmt, margin):
    x, w, g = _x(2, (24, 48)), _x(3, (48, 32), 0.05), _x(4, (24, 32), 1e-3)
    dot = jfp8.make_fp8_dot_general(JRecipe(margin=margin, fp8_format=fmt))
    dims = (((1,), (0,)), ((), ()))
    jout, vjp = jax.vjp(lambda a, b: dot(a, b, dims), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = fp8.fp8_matmul(tx, tw, margin=margin, bwd_dtype=fp8.bwd_dtype_of(fmt))
    out.backward(torch.from_numpy(g))
    for got, want in ((out.detach(), jout), (tx.grad, jdx), (tw.grad, jdw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL * np.abs(want).max())
    dx, dw = fp8.plain_fp8_grads(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g),
                                 margin, fp8.bwd_dtype_of(fmt))
    assert torch.equal(dx, tx.grad) and torch.equal(dw, tw.grad)


def test_fp8_linear_module():
    """``FP8Linear``: the product of the cast input and weight, the bias
    added after; ``make_fp8_linear`` the same function."""
    lin = FP8Linear(48, 32, bias=True, compute_dtype=torch.float32, margin=1)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(_x(5, (32, 48), 0.05)))
        lin.bias.copy_(torch.from_numpy(_x(6, (32,))))
    x = torch.from_numpy(_x(7, (2, 8, 48)))
    want = fp8.plain_fp8_linear(x, lin.weight, lin.bias, margin=1)
    assert torch.equal(lin(x), want)
    assert torch.equal(fp8.make_fp8_linear(FP8RecipeKwargs(margin=1))(x, lin.weight, lin.bias),
                       want)
    with pytest.raises(ValueError, match="fp8_format"):
        fp8.make_fp8_linear(FP8RecipeKwargs(fp8_format="E5M2"))


@pytest.mark.parametrize("algo,interval", [("max", 1), ("max", 3), ("most_recent", 2)])
def test_delayed_scaling_matches_jax(algo, interval):
    recipe = dict(margin=1, interval=interval, amax_history_len=4, amax_compute_algo=algo)
    state = fp8.DelayedScalingState.create(FP8RecipeKwargs(**recipe))
    jstate = jfp8.DelayedScalingState.create(JRecipe(**recipe))
    for i in range(7):
        x = _x(10 + i, (5, 6), scale=float(1 + (i * 7) % 5))
        w = _x(20 + i, (6, 3))
        assert np.array_equal(state.quantize(torch.from_numpy(x)).numpy(),
                              np.asarray(jstate.quantize(jnp.asarray(x))))
        wstate = fp8.DelayedScalingState.create(FP8RecipeKwargs(**recipe))
        jwstate = jfp8.DelayedScalingState.create(JRecipe(**recipe))
        out, _, _ = fp8.fp8_dot_general_delayed(torch.from_numpy(x), torch.from_numpy(w),
                                                state, wstate)
        jout, _, _ = jfp8.fp8_dot_general_delayed(jnp.asarray(x), jnp.asarray(w), jstate,
                                                  jwstate, (((1,), (0,)), ((), ())))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_TOL * 10)
        state, jstate = state.observe(torch.from_numpy(x)), jstate.observe(jnp.asarray(x))
        assert np.array_equal(state.scale.numpy(), np.asarray(jstate.scale))
        assert np.array_equal(state.history.numpy(), np.asarray(jstate.history))
        assert int(state.step) == int(jstate.step) == i + 1
    with pytest.raises(ValueError, match="amax_compute_algo"):
        fp8.DelayedScalingState.create(FP8RecipeKwargs(amax_compute_algo="mean"))


@pytest.mark.parametrize("kw", [dict(), dict(fp8_format="E4M3", fp8_margin=1),
                                dict(num_experts=4)])
def test_fp8_transformer_loss_and_grads_match_jax(kw):
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, use_fp8=True, **kw)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.default_rng(0).integers(1, 256, (2, 16)).astype(np.int32)
    # eager, not jitted: under jit XLA rewrites the quantize arithmetic, which
    # moves some values across an fp8 rounding boundary
    jloss, jgrads = jax.value_and_grad(jlm_loss_fn(jmodel))(jparams,
                                                           {"input_ids": jnp.asarray(ids)})
    cfg = TransformerConfig.tiny(dtype=torch.float32, use_fp8=True, **kw)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                          device="cpu"))
    params = dict(model.named_parameters())
    loss = lm_loss_fn(model)(params, {"input_ids": torch.from_numpy(ids).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=MODEL_TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    for name, p in params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=MODEL_TOL * np.abs(ref).max(),
                                   err_msg=name)


def test_prepare_flips_use_fp8_on_the_same_tensors():
    cfg = TransformerConfig.tiny(dtype=torch.float32)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, device="cpu", dtype=torch.float32))
    acc = Accelerator(mixed_precision="fp8", cpu=True,
                      kwargs_handlers=[FP8RecipeKwargs(margin=2, fp8_format="E4M3")])
    assert acc.policy.compute_dtype == torch.bfloat16
    assert PrecisionPolicy.from_mixed_precision("fp8").compute_dtype == torch.bfloat16
    fp8_model = acc.prepare(model)
    assert fp8_model is not model and fp8_model.config.use_fp8
    assert (fp8_model.config.fp8_margin, fp8_model.config.fp8_format) == (2, "E4M3")
    q = fp8_model.layers[0].attn.q_proj
    assert isinstance(q, FP8Linear) and q.margin == 2 and q.bwd_dtype == torch.float8_e4m3fn
    assert q.weight is model.layers[0].attn.q_proj.weight
    assert type(fp8_model.lm_head) is torch.nn.Linear
    assert dict(model.named_parameters()).keys() == dict(fp8_model.named_parameters()).keys()
    # the JAX package's rebuild, for the same recipe
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    from accelerate_tpu.accelerator import Accelerator as JAccelerator
    jacc = JAccelerator(mixed_precision="fp8", kwargs_handlers=[JRecipe(margin=2,
                                                                        fp8_format="E4M3")])
    jm = jacc.prepare(JTransformer(jcfg))
    assert (jm.config.use_fp8, jm.config.fp8_margin, jm.config.fp8_format) == (True, 2, "E4M3")


def test_prepare_leaves_quantized_and_configless_models_alone():
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    assert acc.fp8_recipe_handler == FP8RecipeKwargs()
    qmodel = Transformer(TransformerConfig.tiny(quantization=8), device="cpu")
    with pytest.warns(UserWarning, match="int-quantized"):
        assert acc.prepare(qmodel) is qmodel
    plain = torch.nn.Linear(4, 4)
    with pytest.warns(UserWarning, match="no fp8-capable config"):
        assert acc.prepare(plain) is plain
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bf16 = Accelerator(mixed_precision="bf16", cpu=True)
        model = Transformer(TransformerConfig.tiny(), device="cpu")
        assert bf16.prepare(model) is model


def test_fp8_train_step_runs_the_fp8_products():
    """``compile_train_step`` under fp8: the rebuilt model's loss equals
    ``lm_loss_fn`` on the bf16 compute params, and an optimizer step
    lands."""
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, device="cpu", dtype=torch.float32))
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    model = acc.prepare(model)
    state = acc.create_train_state(params=model, tx=lambda p: torch.optim.SGD(p, lr=0.1))
    before = model.layers[0].attn.q_proj.weight.detach().clone()
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(1).integers(1, 256, (2, 16))).long()}
    with torch.no_grad():
        want = lm_loss_fn(model)(acc._compute_params(model), batch)
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    state, metrics = step(state, batch)
    assert torch.equal(metrics["loss"], want.float()) and bool(metrics["applied"])
    assert not torch.equal(model.layers[0].attn.q_proj.weight, before)


def test_config_and_recipe_refusals():
    assert TransformerConfig(use_fp8=True).use_fp8
    with pytest.raises(ValueError, match="mutually exclusive"):
        TransformerConfig(use_fp8=True, quantization=4)
    with pytest.raises(ValueError, match="fp8_format"):
        FP8Linear(16, 16, fp8_format="E5M2")
    if torch.cuda.is_available():  # pragma: no cover - the card's own test covers it
        return
    # a shape _scaled_mm cannot take is zero-padded inside the product: the
    # result is the plain dequantized product (exact here: small integers
    # in fp8, sums exact in f32)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-4, 5, (24, 40)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (40, 24)).astype(np.float32))
    got = fp8.scaled_mm(a.to(torch.float8_e4m3fn), torch.full((), 0.5),
                        b.to(torch.float8_e4m3fn), torch.full((), 2.0), torch.float32)
    assert got.shape == (24, 24) and torch.equal(got, (a * 0.5) @ (b * 2.0))
    e5 = torch.zeros(32, 32, dtype=torch.float8_e5m2)
    with pytest.raises(ValueError, match="e5m2 x e5m2"):
        fp8.scaled_mm(e5, torch.ones(()), e5, torch.ones(()), torch.bfloat16)
