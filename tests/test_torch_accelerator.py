"""Port parity: the PyTorch ``Accelerator`` train step vs the JAX ``Accelerator.compile_train_step``.

Both packages train ``TransformerConfig.tiny`` from the same Flax-initialised
weights (carried across by ``params_from_jax``) on the same numpy token
batches: AdamW with every hyperparameter set explicitly (optax and torch
default differently), gradient accumulation 2, ``max_grad_norm``, and a
5-batch loader, so the last call is a sync forced by the end of the
dataloader with a count of 1.  The port runs ``attention_impl="pallas"``
(the flash path; its plain versions on the CPU), the JAX package its
``"xla"`` path: in f32 they compute the same math.  The JAX Accelerator
shards every batch over the 8 virtual CPU devices, so batches hold 8 rows.

Tolerances, f32:
* loss and grad_norm: 2e-5 relative — the same f32 math summed in another
  order (measured: 1.7e-7 and 1.3e-7);
* params after an applied step: 2e-5 absolute (measured 9.3e-7) — AdamW divides each moment by
  the root of its second moment, so the relative noise of a gradient entry
  reaches the update undamped (times lr 1e-3); eps 1e-6 keeps entries whose
  gradient is ~0 from turning that noise into full-size steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.data_loader import SimpleDataLoader as JSimpleDataLoader
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.utils.dataclasses import GradScalerKwargs as JGradScalerKwargs
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SimpleDataLoader, skip_first_batches
from accelerate_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    cross_entropy_loss,
    lm_loss_fn,
    shift_labels,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.train_state import DynamicLossScale, global_norm, tree_finite
from accelerate_tpu_torch.utils.dataclasses import GradScalerKwargs
from accelerate_tpu_torch.utils.random import set_seed
from accelerate_tpu_torch.weights import params_from_jax

LR, B1, B2, EPS, WD = 1e-3, 0.9, 0.95, 1e-6, 0.1
MAX_GRAD_NORM = 0.5
RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
ROWS, SEQ, N_BATCHES = 8, 16, 5


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """The JAX train step beats the process-wide flight recorder's heartbeat.
    With telemetry off it beats none, so a ``/healthz`` check that runs later
    in the same process does not find this module's heartbeat gone stale."""
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


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, jparams)


def _dataset(seed=0, n=ROWS * N_BATCHES):
    ids = np.random.default_rng(seed).integers(1, 256, (n, SEQ)).astype(np.int32)
    return [{"input_ids": ids[i]} for i in range(n)]


def _port_model(jparams, **cfg):
    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                               attention_impl="pallas", **cfg), device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    return model


def _flat_jax(params):
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(params), device="cpu").items()}


def _run_jax(jmodel, jparams, mixed_precision="no", handlers=None, lr=LR, dataset=None):
    acc = JAccelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=2,
                       kwargs_handlers=handlers)
    if callable(lr):
        lr = acc.prepare(lr)
    state = acc.create_train_state(
        params=jparams, tx=optax.adamw(lr, b1=B1, b2=B2, eps=EPS, weight_decay=WD))
    loader = acc.prepare(JSimpleDataLoader(dataset or _dataset(), batch_size=ROWS))
    step = acc.compile_train_step(jlm_loss_fn(jmodel), max_grad_norm=MAX_GRAD_NORM)
    records = []
    for batch in loader:
        state, m = step(state, batch)
        rec = {k: np.asarray(m[k]).item() for k in ("loss", "grad_norm", "applied", "overflow")}
        rec["sync"] = acc.sync_gradients
        rec["step"] = int(state.step)
        if state.loss_scale is not None:
            rec["scale"] = float(state.loss_scale.scale)
            rec["tracker"] = int(state.loss_scale.growth_tracker)
        rec["params"] = _flat_jax(state.params) if rec["applied"] else None
        records.append(rec)
    eval_loss = float(acc.compile_eval_step(jlm_loss_fn(jmodel))(
        state, {"input_ids": jnp.asarray(np.stack([d["input_ids"] for d in _dataset(9)[:ROWS]]))}))
    return records, eval_loss


def _run_port(model, mixed_precision="no", handlers=None, lr=LR, dataset=None):
    acc = Accelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=2, cpu=True,
                      kwargs_handlers=handlers)
    if callable(lr):
        acc.prepare(lr)
        lr = 0.0  # the prepared schedule sets it before every applied step
    state = acc.create_train_state(
        params=model, tx=functools.partial(torch.optim.AdamW, lr=lr, betas=(B1, B2), eps=EPS,
                                           weight_decay=WD))
    loader = acc.prepare(SimpleDataLoader(dataset or _dataset(), batch_size=ROWS))
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=MAX_GRAD_NORM)
    records = []
    for batch in loader:
        state, m = step(state, batch)
        assert all(isinstance(v, torch.Tensor) for v in m.values())
        rec = {k: m[k].item() for k in ("loss", "grad_norm", "applied", "overflow")}
        rec["sync"] = acc.sync_gradients
        rec["step"] = state.step
        rec["lr"] = state.optimizer.param_groups[0]["lr"]
        if state.loss_scale is not None:
            rec["scale"] = state.loss_scale.scale
            rec["tracker"] = state.loss_scale.growth_tracker
        rec["params"] = ({k: v.detach().numpy().copy() for k, v in state.params.items()}
                         if rec["applied"] else None)
        records.append(rec)
    eval_step = acc.compile_eval_step(lm_loss_fn(model))
    ids = torch.from_numpy(np.stack([d["input_ids"] for d in _dataset(9)[:ROWS]]))
    eval_loss = float(eval_step(state, {"input_ids": ids}))
    return records, eval_loss, acc, state


@pytest.fixture(scope="module")
def f32_runs(jax_model):
    jmodel, jparams = jax_model
    ref = _run_jax(jmodel, jparams)
    got = _run_port(_port_model(jparams))
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    return ref, got[:2]


def _assert_params_close(got, want, atol):
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], atol=atol, err_msg=name)


def test_metrics_match_jax_on_every_call(f32_runs):
    (ref, _), (got, _) = f32_runs
    assert len(got) == len(ref) == N_BATCHES
    for i, (g, r) in enumerate(zip(got, ref)):
        assert (g["applied"], g["overflow"]) == (r["applied"], r["overflow"]), i
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=RTOL_METRIC, err_msg=f"call {i}")
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=RTOL_METRIC,
                                   err_msg=f"call {i}")
    # accumulation 2 over 5 batches: syncs at calls 2 and 4, and the forced
    # end-of-dataloader sync at call 5 with a count of 1
    assert [g["applied"] for g in got] == [False, True, False, True, True]
    assert [g["step"] for g in got] == [r["step"] for r in ref] == [0, 1, 1, 2, 3]


def test_params_match_jax_after_every_applied_step(f32_runs):
    (ref, _), (got, _) = f32_runs
    for g, r in zip(got, ref):
        if g["applied"]:
            _assert_params_close(g["params"], r["params"], ATOL_PARAM)


def test_gradient_state_sync_flags_match_jax(f32_runs):
    (ref, _), (got, _) = f32_runs
    assert [g["sync"] for g in got] == [r["sync"] for r in ref] == [False, True, False, True, True]


def test_eval_step_matches_jax(f32_runs):
    (_, ref_eval), (_, got_eval) = f32_runs
    np.testing.assert_allclose(got_eval, ref_eval, rtol=RTOL_METRIC)


def test_bf16_policy_tracks_jax(jax_model):
    """bf16 compute, f32 masters.  The two frameworks round the bf16
    activations at different places: losses and norms agree within 1e-3
    relative (measured: 7e-7 and 3.2e-5), the applied/skip pattern exactly."""
    jmodel, jparams = jax_model
    ref, _ = _run_jax(jmodel, jparams, mixed_precision="bf16")
    got, _, _, state = _run_port(_port_model(jparams), mixed_precision="bf16")
    assert next(state.model.parameters()).dtype == torch.float32
    for g, r in zip(got, ref):
        assert g["applied"] == r["applied"]
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-3)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-3)


@pytest.mark.parametrize("init_scale,growth_interval", [(2.0**40, 2000), (1.0, 2)],
                         ids=["overflow", "growth"])
def test_fp16_loss_scale_matches_jax(jax_model, init_scale, growth_interval):
    """fp16: a 2**40 scale overflows every sync step — skipped, scale backed
    off by 0.5 each time; a scale of 1 stays finite and grows every second
    finite sync.  Scale, tracker, applied and overflow match JAX call by
    call."""
    jmodel, jparams = jax_model
    ref, _ = _run_jax(jmodel, jparams, mixed_precision="fp16", handlers=[
        JGradScalerKwargs(init_scale=init_scale, growth_interval=growth_interval)])
    got, _, acc, state = _run_port(_port_model(jparams), mixed_precision="fp16", handlers=[
        GradScalerKwargs(init_scale=init_scale, growth_interval=growth_interval)])
    for g, r in zip(got, ref):
        for key in ("applied", "overflow", "scale", "tracker", "step"):
            assert g[key] == r[key], (key, g[key], r[key])
    overflowed = init_scale > 1.0
    assert all(g["overflow"] == (overflowed and g["sync"]) for g in got)
    assert acc._optimizers[-1].step_was_skipped == overflowed
    if not overflowed:
        # fp16 compute weights: 2e-3 absolute (measured 1.2e-4)
        for g, r in zip(got, ref):
            if g["applied"]:
                _assert_params_close(g["params"], r["params"], 2e-3)


def test_scheduler_advances_on_applied_steps_only(jax_model):
    """A prepared schedule sets the learning rate from the count of applied
    steps: the micro-steps and the forced last sync use schedule(0),
    schedule(1), schedule(2) — and the params follow the JAX run whose optax
    transformation evaluates the same schedule."""
    jmodel, jparams = jax_model
    schedule = lambda count: LR * (1.0 + count)  # noqa: E731
    ref, _ = _run_jax(jmodel, jparams, lr=schedule)
    got, _, _, _ = _run_port(_port_model(jparams), lr=schedule)
    applied_lrs = [g["lr"] for g in got if g["applied"]]
    assert applied_lrs == [schedule(0), schedule(1), schedule(2)]
    for g, r in zip(got, ref):
        if g["applied"]:
            _assert_params_close(g["params"], r["params"], 2 * ATOL_PARAM)


def test_optimizer_state_dict_carries_the_accumulation_window(jax_model):
    """A snapshot taken mid-window restores the optimizer, the counters and
    the gradient buffer: the next (sync) call lands on the same params."""
    _, jparams = jax_model
    batches = [{"input_ids": torch.from_numpy(np.stack([d["input_ids"] for d in _dataset(s)[:ROWS]]))}
               for s in (1, 2)]
    finals = []
    snapshot = None
    for restore in (False, True):
        model = _port_model(jparams)
        acc = Accelerator(gradient_accumulation_steps=2, cpu=True)
        state = acc.create_train_state(params=model, tx=functools.partial(
            torch.optim.AdamW, lr=LR, betas=(B1, B2), eps=EPS, weight_decay=WD))
        step = acc.compile_train_step(lm_loss_fn(model))
        wrapper = acc._optimizers[-1]
        if restore:
            wrapper.load_state_dict(snapshot)
            assert state.micro_step == 1
        else:
            state, _ = step(state, batches[0])
            snapshot = wrapper.state_dict()
            assert snapshot["micro_step"] == 1 and snapshot["step"] == 0
        state, m = step(state, batches[1])
        assert bool(m["applied"])
        finals.append({k: v.detach().clone() for k, v in state.params.items()})
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)
    for name in finals[0]:
        assert torch.equal(finals[0][name], finals[1][name]), name


def test_zero_grad_restarts_the_window(jax_model):
    _, jparams = jax_model
    model = _port_model(jparams)
    acc = Accelerator(gradient_accumulation_steps=4, cpu=True)
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=0.1))
    step = acc.compile_train_step(lm_loss_fn(model))
    batch = {"input_ids": torch.from_numpy(np.stack([d["input_ids"] for d in _dataset()[:ROWS]]))}
    state, _ = step(state, batch)
    assert state.micro_step == 1 and model.lm_head.weight.grad is not None
    acc._optimizers[-1].zero_grad()
    assert state.micro_step == 0 and model.lm_head.weight.grad is None


def test_sync_each_batch_and_value_clipping(jax_model):
    _, jparams = jax_model
    from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin

    model = _port_model(jparams)
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=4, sync_each_batch=True))
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=1.0))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_value=1e-4)
    batch = {"input_ids": torch.from_numpy(np.stack([d["input_ids"] for d in _dataset()[:ROWS]]))}
    state, m = step(state, batch)
    assert bool(m["applied"]) and acc.sync_gradients and state.step == 1
    moved = max((state.params[k] - before[k]).abs().max().item() for k in before)
    # SGD lr 1: the update is the clipped gradient, up to the f32 rounding of
    # weights of size ~1 (1.2e-7)
    assert 0 < moved <= 1e-4 + 2.4e-7


def test_loss_helpers_match_jax():
    from accelerate_tpu.models.transformer import cross_entropy_loss as jce
    from accelerate_tpu.models.transformer import shift_labels as jshift

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 6)).astype(np.int32)
    labels = np.asarray(jshift({"input_ids": jnp.asarray(ids)}))
    got_labels = shift_labels({"input_ids": torch.from_numpy(ids)})
    np.testing.assert_array_equal(got_labels.numpy(), labels)
    for z in (0.0, 1e-3):
        ref = float(jce(jnp.asarray(logits), jnp.asarray(labels), z_loss=z))
        got = float(cross_entropy_loss(torch.from_numpy(logits), got_labels, z_loss=z))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_train_state_helpers():
    ls = DynamicLossScale.create(8.0, growth_interval=2)
    assert ls.update(True).growth_tracker == 1
    assert ls.update(True).update(True).scale == 16.0
    assert ls.update(False).scale == 4.0
    assert DynamicLossScale.create(1.0).update(False).scale == 1.0
    ts = [torch.tensor([3.0, 4.0]), None, torch.tensor([12.0], dtype=torch.bfloat16)]
    assert global_norm(ts).item() == pytest.approx(13.0)
    assert bool(tree_finite(ts)) and not bool(tree_finite([torch.tensor([float("inf")])]))


def test_data_loader_places_batches_and_flags_the_last_one():
    acc = Accelerator(cpu=True)
    loader = acc.prepare(SimpleDataLoader(_dataset(n=10), batch_size=4))
    flags, rows = [], []
    for batch in loader:
        assert isinstance(batch["input_ids"], torch.Tensor)
        flags.append(acc.gradient_state.end_of_dataloader)
        rows.append(acc.gather_for_metrics(batch["input_ids"]).shape[0])
    assert flags == [False, False, True] and rows == [4, 4, 2]
    assert acc.gradient_state.remainder == -1  # the loader has ended
    assert len(skip_first_batches(loader, 1)) == 2
    assert [b["input_ids"].shape[0] for b in skip_first_batches(loader, 1)] == [4, 2]


def test_accumulate_and_no_sync_flags():
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    seen = []
    for _ in range(4):
        with acc.accumulate():
            seen.append(acc.sync_gradients)
    assert seen == [False, True, False, True]
    with acc.no_sync():
        assert not acc.sync_gradients
    assert acc.sync_gradients


def test_accelerator_surface_on_cpu():
    set_seed(3)
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    assert acc.device == torch.device("cpu") and acc.num_processes == 1
    assert acc.is_main_process and acc.mixed_precision == "bf16"
    assert acc.policy.compute_dtype == torch.bfloat16
    model = torch.nn.Linear(2, 2)
    assert acc.unwrap_model(acc.prepare(model)) is model
    assert PartialState().device == torch.device("cpu")
    with pytest.raises(ValueError, match="mixed_precision"):
        Accelerator(cpu=True, mixed_precision="fp16")


def test_accelerator_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Accelerator()


@pytest.mark.parametrize("kw,item", [
    (dict(fsdp_plugin=object()), "item 9"),
    (dict(deepspeed_plugin=object()), "item 9"),
    (dict(megatron_lm_plugin=object()), "item 9"),
    (dict(mesh={"dp": 1}), "item 9"),
    (dict(compilation_config=object()), "item 9"),
    (dict(dynamo_backend="inductor"), "item 9"),
    (dict(log_with="tensorboard"), "item 10"),
    (dict(metrics_port=0), "item 8"),
    (dict(project_dir="runs"), "item 9"),
    (dict(kwargs_handlers=[object()]), "item 9"),
    (dict(mixed_precision="fp8"), "item 9"),
])
def test_unported_arguments_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        Accelerator(cpu=True, **kw)


@pytest.mark.parametrize("method", ["save_state", "load_state"])
def test_checkpoints_not_ported(method):
    with pytest.raises(NotImplementedError, match="checkpointing"):
        getattr(Accelerator(cpu=True), method)("ckpt")


def test_unported_attention_impls_raise():
    for impl, item in (("blocked", "item 3"), ("ring", "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            TransformerConfig.tiny(attention_impl=impl)
