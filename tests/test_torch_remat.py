"""Port parity: remat (activation checkpointing) and ``CompilationConfig``.

The same numpy token batches and the same Flax-initialised weights
(``params_from_jax``) go through the JAX package and the port:

* **per layer** (``TransformerConfig(remat=True, remat_policy=...)``), each
  of the reference's five policies on ``tiny`` and ``tiny_moe`` (f32): the
  loss and every gradient within ``REL_TOL`` (1e-5 of the largest
  gradient entry) of the JAX ``Transformer(remat=True)``'s — the two
  frameworks sum the same f32 products in different orders — and
  **bitwise** the port's own without remat (a recompute repeats the same
  ops on the same values); the recompute really happens where the policy
  says (matrix products counted in the backward), and an MoE layer's aux
  term is sown once, not again by the recompute;
* **over the loss** (``Accelerator(compilation_config=CompilationConfig(
  remat_policy=...))`` and FSDP's ``activation_checkpointing``), through
  ``compile_train_step``, each of the six policies: losses within
  ``RTOL_METRIC`` (2e-5) and weights within ``ATOL_PARAM`` (2e-5, as in
  ``test_torch_accelerator.py``) of the JAX Accelerator with the same
  arguments after every applied step, and bitwise the port without remat;
* ``CompilationConfig.from_env`` and the FSDP plugin's environment, as the
  JAX package reads them;
* the serving path: a remat config serves the same tokens as one without.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import CompilationConfig as JCompilationConfig
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JFSDP
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.parallel.moe import collect_router_aux
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import (
    CompilationConfig,
    FullyShardedDataParallelPlugin,
)
from accelerate_tpu_torch.weights import params_from_jax

REL_TOL = 1e-5
RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
LAYER_POLICIES = ["full", "nothing_saveable", "dots_saveable",
                  "dots_with_no_batch_dims_saveable", "proj_saveable"]
LOSS_POLICIES = LAYER_POLICIES + ["everything_saveable"]
ROWS, SEQ = 8, 16


@pytest.fixture(scope="module", autouse=True)
def _quiet():
    from accelerate_tpu.telemetry import metrics as jax_metrics

    threads, was = torch.get_num_threads(), jax_metrics.enabled()
    torch.set_num_threads(1)
    jax_metrics.set_enabled(False)
    yield
    torch.set_num_threads(threads)
    jax_metrics.set_enabled(was)


@pytest.fixture(autouse=True)
def _reset():
    yield
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


def _jax_params(jcfg):
    jmodel = JTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _weights(moe: bool):
    factory = JConfig.tiny_moe if moe else JConfig.tiny
    return _jax_params(factory(dtype=jnp.float32, param_dtype=jnp.float32))


def _ids(seed=0, rows=2):
    return np.random.default_rng(seed).integers(1, 256, (rows, SEQ)).astype(np.int32)


def _port_loss_and_grads(cfg, jparams, ids):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    params = dict(model.named_parameters())
    loss = lm_loss_fn(model)(params, {"input_ids": torch.from_numpy(ids).long()})
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), model


class _CountProducts(TorchDispatchMode):
    """Matrix products dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("mm", "addmm", "bmm", "baddbmm"):
            self.n += 1
        return func(*args, **(kwargs or {}))


# --------------------------------------------------------------- per layer
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("policy", LAYER_POLICIES)
def test_layer_remat_matches_jax_and_the_plain_port(policy, moe):
    jparams = _weights(moe)
    factory, jfactory = ((TransformerConfig.tiny_moe, JConfig.tiny_moe) if moe
                         else (TransformerConfig.tiny, JConfig.tiny))
    jcfg = jfactory(dtype=jnp.float32, param_dtype=jnp.float32, remat=True, remat_policy=policy)
    ids = _ids()
    jloss, jgrads = jax.jit(jax.value_and_grad(jlm_loss_fn(JTransformer(jcfg))))(
        jparams, {"input_ids": jnp.asarray(ids)})
    cfg = factory(dtype=torch.float32)
    loss0, grads0, _ = _port_loss_and_grads(cfg, jparams, ids)
    loss, grads, _ = _port_loss_and_grads(
        dataclasses.replace(cfg, remat=True, remat_policy=policy), jparams, ids)
    assert torch.equal(loss, loss0)
    for name in grads:
        assert torch.equal(grads[name], grads0[name]), name
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL_TOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    for name, g in grads.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=REL_TOL * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


def _backward_products(cfg, jparams):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    params = dict(model.named_parameters())
    loss = lm_loss_fn(model)(params, {"input_ids": torch.from_numpy(_ids()).long()})
    with _CountProducts() as count:
        torch.autograd.grad(loss, list(params.values()))
    return count.n


def test_policies_recompute_what_they_do_not_save():
    """Products run by the backward: the plain backward's, plus under
    "full" every forward product a layer's backward needs again (q, k, v,
    o, gate, up and attention's two: the recompute stops once it has every
    saved tensor, so down_proj, whose output nothing saves, is not rerun);
    none again under "dots_saveable"; the batched (attention) products
    under "dots_with_no_batch_dims_saveable"; up_proj and attention under
    "proj_saveable"."""
    cfg = TransformerConfig.tiny(dtype=torch.float32)
    jparams = _weights(False)
    counts = {p: _backward_products(dataclasses.replace(cfg, remat=True, remat_policy=p),
                                    jparams) for p in LAYER_POLICIES}
    plain = _backward_products(cfg, jparams)
    layers = cfg.num_layers
    per_layer_2d, per_layer_attn = 6, 2  # q k v o gate up; scores and values
    assert counts["full"] == counts["nothing_saveable"] == plain + layers * (
        per_layer_2d + per_layer_attn)
    assert counts["dots_saveable"] == plain
    assert counts["dots_with_no_batch_dims_saveable"] == plain + layers * per_layer_attn
    assert counts["proj_saveable"] == plain + layers * (1 + per_layer_attn)


def test_moe_aux_is_sown_once_under_remat():
    """The recompute inside the backward sows no second aux term, even with
    a collector open around the backward; the aux gradient is the plain
    one (the loss test above holds every gradient bitwise)."""
    jparams = _weights(True)
    cfg = TransformerConfig.tiny_moe(dtype=torch.float32, remat=True)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    params = dict(model.named_parameters())
    with collect_router_aux() as outer:
        loss = lm_loss_fn(model)(params, {"input_ids": torch.from_numpy(_ids()).long()})
        assert outer == []  # the loss's own collector took the forward's terms
        loss.backward()
    assert outer == []
    with collect_router_aux() as sown:
        model(torch.from_numpy(_ids()).long())
    assert len(sown) == cfg.num_layers


def test_everything_saveable_is_no_layer_policy():
    """The reference's per-layer table has five policies; ``everything_
    saveable`` is an over-the-loss policy only, in both packages."""
    with pytest.raises(ValueError, match="remat_policy"):
        JConfig.tiny(remat=True, remat_policy="everything_saveable")
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerConfig.tiny(remat=True, remat_policy="everything_saveable")


# -------------------------------------------------------------- over the loss
def _dataset(n=ROWS * 4):
    ids = np.random.default_rng(3).integers(1, 256, (n, SEQ)).astype(np.int32)
    return [ids[i: i + ROWS] for i in range(0, n, ROWS)]


def _run_jax(jparams, **kw):
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)
    acc = JAccelerator(gradient_accumulation_steps=2, **kw)
    jmodel = JTransformer(JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32))
    state = acc.create_train_state(params=jparams, tx=optax.adamw(
        1e-3, b1=0.9, b2=0.95, eps=1e-6, weight_decay=0.1))
    step = acc.compile_train_step(jlm_loss_fn(jmodel), max_grad_norm=0.5)
    out = []
    for ids in _dataset():
        state, m = step(state, {"input_ids": jnp.asarray(ids)})
        params = ({k: v.numpy() for k, v in params_from_jax(
            jax.device_get(state.params), device="cpu").items()} if bool(m["applied"]) else None)
        out.append((float(m["loss"]), params))
    return out, acc.compilation_config.remat_policy


def _run_port(jparams, **kw):
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2, **kw)
    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, attention_impl="pallas"),
                        device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    state = acc.create_train_state(params=model, tx=functools.partial(
        torch.optim.AdamW, lr=1e-3, betas=(0.9, 0.95), eps=1e-6, weight_decay=0.1))
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=0.5)
    out = []
    for ids in _dataset():
        state, m = step(state, {"input_ids": torch.from_numpy(ids).long()})
        params = ({k: v.detach().numpy().copy() for k, v in state.params.items()}
                  if bool(m["applied"]) else None)
        out.append((m["loss"].item(), params))
    return out, acc.compilation_config.remat_policy


@functools.lru_cache(maxsize=None)
def _port_plain():
    return _run_port(_weights(False))[0]


@pytest.mark.parametrize("case", LOSS_POLICIES + ["fsdp_activation_checkpointing"])
def test_loss_remat_matches_jax_accelerator(case):
    jparams = _weights(False)
    if case == "fsdp_activation_checkpointing":
        kw = dict(sharding_strategy="NO_SHARD", activation_checkpointing=True)
        got, policy = _run_port(jparams, fsdp_plugin=FullyShardedDataParallelPlugin(**kw))
        want, jpolicy = _run_jax(jparams, fsdp_plugin=JFSDP(**kw))
    else:
        got, policy = _run_port(jparams, compilation_config=CompilationConfig(remat_policy=case))
        want, jpolicy = _run_jax(jparams, compilation_config=JCompilationConfig(
            remat_policy=case))
    assert policy == jpolicy
    plain = _port_plain()
    assert len(got) == len(want) == len(plain) == 4
    for (loss, params), (jloss, jp), (loss0, p0) in zip(got, want, plain):
        assert loss == loss0
        np.testing.assert_allclose(loss, jloss, rtol=RTOL_METRIC)
        assert (params is None) == (jp is None) == (p0 is None)
        if params is not None:
            for name in params:
                np.testing.assert_array_equal(params[name], p0[name], err_msg=name)
                np.testing.assert_allclose(params[name], jp[name], atol=ATOL_PARAM,
                                           err_msg=name)


def test_unknown_loss_policy_raises_as_the_reference_does():
    acc = Accelerator(cpu=True, compilation_config=CompilationConfig(remat_policy="bogus"))
    with pytest.raises(ValueError, match="Unknown remat_policy 'bogus'"):
        acc.compile_train_step(lambda p, b: 0.0)


# ------------------------------------------------------------ from the env
def test_from_env_matches_the_reference(monkeypatch):
    assert CompilationConfig.from_env().to_dict() == JCompilationConfig.from_env().to_dict()
    monkeypatch.setenv("ACCELERATE_REMAT_POLICY", "proj_saveable")
    monkeypatch.setenv("ACCELERATE_SCAN_LAYERS", "true")
    got, want = CompilationConfig.from_env(), JCompilationConfig.from_env()
    assert got.to_dict() == want.to_dict()
    assert (got.remat_policy, got.scan_layers) == ("proj_saveable", True)
    assert Accelerator(cpu=True).compilation_config.remat_policy == "proj_saveable"
    env = {"FSDP_SHARDING_STRATEGY": "SHARD_GRAD_OP", "FSDP_OFFLOAD_PARAMS": "1",
           "FSDP_ACTIVATION_CHECKPOINTING": "yes", "FSDP_OFFLOAD_OPTIMIZER": "true",
           "FSDP_OFFLOAD_UPDATE_CHUNK_MB": "64", "FSDP_OFFLOAD_UPDATE_OVERLAP": "2",
           "FSDP_NVME_PATH": "/nvme/opt", "FSDP_OFFLOAD_MASTER_WEIGHTS": "0",
           "FSDP_MIN_NUM_PARAMS": "77", "FSDP_STATE_DICT_TYPE": "FULL_STATE_DICT"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = FullyShardedDataParallelPlugin(), JFSDP()
    for f in dataclasses.fields(want):
        assert str(getattr(got, f.name)) == str(getattr(want, f.name)), f.name


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_serving_is_unchanged_under_remat(paged):
    jparams = _weights(False)
    prompts = [np.random.default_rng(i).integers(1, 256, (n,)).astype(np.int32)
               for i, n in enumerate((5, 9, 3))]
    tokens = []
    for remat in (False, True):
        model = Transformer(TransformerConfig.tiny(dtype=torch.float32, remat=remat),
                            device="cpu")
        model.load_state_dict(params_from_jax(jparams, device="cpu"))
        engine = ServingEngine(model, None, device="cpu", paged=paged, num_slots=2, max_len=64,
                               prefill_buckets=(4, 8), decode_window=2, prefix_cache_mb=0)
        reqs = engine.serve([p.copy() for p in prompts],
                            configs=GenerationConfig(max_new_tokens=6))
        tokens.append([r.tokens for r in reqs])
        # the no-cache forward under no_grad is the plain one too
        with torch.no_grad():
            logits = model(torch.from_numpy(prompts[1][None]).long())
        tokens[-1].append(logits)
    assert tokens[0][:-1] == tokens[1][:-1]
    assert torch.equal(tokens[0][-1], tokens[1][-1])


def test_layer_remat_recomputes_with_the_step_weights():
    """Under mixed precision the step runs the model through
    ``functional_call`` on bf16 casts of the f32 masters; the recompute in
    the backward, after that call, must run on those casts too: the train
    step's losses and weights bitwise the step without remat."""
    jparams = _weights(False)
    runs = []
    for remat in (False, True):
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(cpu=True, mixed_precision="bf16", gradient_accumulation_steps=2)
        model = Transformer(TransformerConfig.tiny(remat=remat, attention_impl="pallas"),
                            device="cpu")
        model.load_state_dict(params_from_jax(jparams, device="cpu"))
        state = acc.create_train_state(params=model, tx=functools.partial(
            torch.optim.AdamW, lr=1e-3))
        step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
        losses = [step(state, {"input_ids": torch.from_numpy(ids).long()})[1]["loss"].item()
                  for ids in _dataset()]
        runs.append((losses, {k: v.detach().clone() for k, v in model.named_parameters()}))
    (l0, w0), (l1, w1) = runs
    assert l0 == l1
    for name in w0:
        assert torch.equal(w0[name], w1[name]), name
