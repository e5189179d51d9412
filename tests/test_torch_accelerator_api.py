"""Port parity: the ``Accelerator``'s single-process surface against the JAX package's.

The reference's unfused loop — ``compute_gradients`` then
``apply_gradients`` inside ``accumulate()`` — trains
``TransformerConfig.tiny`` in both packages from the same Flax-initialised
weights (``params_from_jax``) on the same numpy batches: AdamW with every
hyperparameter explicit, accumulation 2, ``max_grad_norm``, a 5-batch
loader (the last call a sync forced by the end of the dataloader, with a
count of 1).  The port runs ``attention_impl="pallas"`` (the flash path's
plain versions on the CPU), the JAX package its ``"xla"`` path; the JAX
Accelerator shards each 8-row batch over the 8 virtual CPU devices.

Tolerances, f32 (the same math summed in another order):
* losses 2e-5 relative (as ``test_torch_accelerator.py``; measured 1.7e-7);
* ``compute_gradients``' gradients: each tensor within 1e-5 of its own
  largest entry (measured 7.4e-7);
* params after an applied step 2e-5 absolute (as
  ``test_torch_accelerator.py``, measured 9.3e-7: AdamW passes the
  gradients' relative noise on undamped, times lr 1e-3).
The collectives, process helpers and clipping are held to the JAX values
exactly, or at f32 rounding where a norm is summed.
"""

import functools
import json
import os

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
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import GradScalerKwargs as JGradScalerKwargs
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SimpleDataLoader
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import GradScalerKwargs, ProjectConfiguration
from accelerate_tpu_torch.weights import params_from_jax

LR, B1, B2, EPS, WD = 1e-3, 0.9, 0.95, 1e-6, 0.1
MAX_GRAD_NORM = 0.5
RTOL_LOSS = 2e-5
GRAD_TOL = 1e-5  # of each gradient tensor's largest entry
ATOL_PARAM = 2e-5
ROWS, SEQ, N_BATCHES = 8, 16, 5


def _reset_port():
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _reset_jax():
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """With JAX telemetry off the JAX step beats no heartbeat, so a later
    ``/healthz`` check in the same process does not find it gone stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    _reset_port()


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, jparams)


def _dataset(seed=0, n=ROWS * N_BATCHES):
    ids = np.random.default_rng(seed).integers(1, 256, (n, SEQ)).astype(np.int32)
    return [{"input_ids": ids[i]} for i in range(n)]


def _port_model(jparams):
    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                               attention_impl="pallas"), device="cpu")
    model.load_state_dict(params_from_jax(jparams, device="cpu"))
    return model


def _to_port_names(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(tree), device="cpu").items()}


def _run_jax(jmodel, jparams, mixed_precision="no", handlers=None):
    acc = JAccelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=2,
                       kwargs_handlers=handlers)
    state = acc.create_train_state(
        params=jparams, tx=optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD))
    loader = acc.prepare(JSimpleDataLoader(_dataset(), batch_size=ROWS))
    loss_fn = jlm_loss_fn(jmodel)
    records = []
    for batch in loader:
        with acc.accumulate():
            grads, m = acc.compute_gradients(loss_fn, state, batch)
            before = int(state.step)
            state = acc.apply_gradients(state, grads, max_grad_norm=MAX_GRAD_NORM)
        rec = {"loss": float(m["loss"]), "sync": acc.sync_gradients, "step": int(state.step),
               "micro_step": int(state.micro_step), "applied": int(state.step) > before}
        if state.loss_scale is not None:
            rec["scale"] = float(state.loss_scale.scale)
            rec["tracker"] = int(state.loss_scale.growth_tracker)
        rec["grads"] = _to_port_names(grads) if not records else None
        rec["params"] = _to_port_names(state.params) if rec["applied"] else None
        records.append(rec)
    _reset_jax()
    return records


def _run_port(model, mixed_precision="no", handlers=None):
    acc = Accelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=2, cpu=True,
                      kwargs_handlers=handlers)
    state = acc.create_train_state(params=model, tx=functools.partial(
        torch.optim.AdamW, lr=LR, betas=(B1, B2), eps=EPS, weight_decay=WD))
    loader = acc.prepare(SimpleDataLoader(_dataset(), batch_size=ROWS))
    loss_fn = lm_loss_fn(model)
    records = []
    for batch in loader:
        with acc.accumulate():
            grads, m = acc.compute_gradients(loss_fn, state, batch)
            before = state.step
            returned = acc.apply_gradients(state, grads, max_grad_norm=MAX_GRAD_NORM)
        assert returned is state
        rec = {"loss": m["loss"].item(), "sync": acc.sync_gradients, "step": state.step,
               "micro_step": state.micro_step, "applied": state.step > before}
        if state.loss_scale is not None:
            rec["scale"] = state.loss_scale.scale
            rec["tracker"] = state.loss_scale.growth_tracker
        rec["grads"] = {k: v.numpy().copy() for k, v in grads.items()} if not records else None
        rec["params"] = ({k: v.detach().numpy().copy() for k, v in state.params.items()}
                         if rec["applied"] else None)
        records.append(rec)
    _reset_port()
    return records, acc


@pytest.fixture(scope="module")
def f32_loops(jax_model):
    jmodel, jparams = jax_model
    return _run_jax(jmodel, jparams), _run_port(_port_model(jparams))[0]


def test_compute_gradients_match_jax(f32_loops):
    ref, got = f32_loops
    want, have = ref[0]["grads"], got[0]["grads"]
    assert have.keys() == want.keys()
    for name in want:
        assert have[name].dtype == np.float32
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(have[name], want[name], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_loop_losses_and_windows_match_jax(f32_loops):
    ref, got = f32_loops
    assert len(got) == len(ref) == N_BATCHES
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=RTOL_LOSS, err_msg=f"call {i}")
        for key in ("sync", "step", "micro_step", "applied"):
            assert g[key] == r[key], (i, key, g[key], r[key])
    # accumulation 2 over 5 batches: syncs at calls 2 and 4, and the forced
    # end-of-dataloader sync at call 5 with a count of 1
    assert [g["applied"] for g in got] == [False, True, False, True, True]
    assert [g["micro_step"] for g in got] == [1, 0, 1, 0, 0]


def test_loop_params_match_jax_after_every_applied_step(f32_loops):
    ref, got = f32_loops
    for g, r in zip(got, ref):
        if g["applied"]:
            for name in r["params"]:
                np.testing.assert_allclose(g["params"][name], r["params"][name],
                                           atol=ATOL_PARAM, err_msg=name)


def test_bf16_policy_tracks_jax(jax_model):
    """bf16 compute, f32 masters and f32 gradients.  The frameworks round
    bf16 activations at different places: losses within 1e-3 relative, as
    ``test_torch_accelerator.py``'s bf16 case holds the fused step
    (measured 6.9e-7)."""
    jmodel, jparams = jax_model
    ref = _run_jax(jmodel, jparams, mixed_precision="bf16")
    got, _ = _run_port(_port_model(jparams), mixed_precision="bf16")
    assert all(v.dtype == np.float32 for v in got[0]["grads"].values())
    for g, r in zip(got, ref):
        assert (g["applied"], g["step"]) == (r["applied"], r["step"])
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-3)


@pytest.mark.parametrize("init_scale,growth_interval", [(2.0**40, 2000), (1.0, 2)],
                         ids=["overflow", "growth"])
def test_fp16_loss_scale_matches_jax(jax_model, init_scale, growth_interval):
    """fp16: a 2**40 scale overflows every sync call — skipped, the scale
    backed off; a scale of 1 stays finite and grows every second finite
    sync.  Scale, tracker, step and micro-step match JAX call by call, and
    the returned gradients are unscaled."""
    jmodel, jparams = jax_model
    ref = _run_jax(jmodel, jparams, mixed_precision="fp16", handlers=[
        JGradScalerKwargs(init_scale=init_scale, growth_interval=growth_interval)])
    got, acc = _run_port(_port_model(jparams), mixed_precision="fp16", handlers=[
        GradScalerKwargs(init_scale=init_scale, growth_interval=growth_interval)])
    for g, r in zip(got, ref):
        for key in ("applied", "scale", "tracker", "step", "micro_step"):
            assert g[key] == r[key], (key, g[key], r[key])
    overflowed = init_scale > 1.0
    assert acc._optimizers[-1].step_was_skipped == overflowed
    if not overflowed:
        # fp16 compute weights: 2e-3 absolute, as the fused step's case
        # (measured 1.2e-4)
        for g, r in zip(got, ref):
            if g["applied"]:
                for name in r["params"]:
                    np.testing.assert_allclose(g["params"][name], r["params"][name],
                                               atol=2e-3, err_msg=name)


def test_compute_gradients_leave_the_state_alone(jax_model):
    """Fresh f32 tensors, not the ``.grad`` buffer; ``has_aux`` returns the
    aux detached, and without it ``aux`` is ``()`` as in the reference."""
    _, jparams = jax_model
    model = _port_model(jparams)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=0.1))
    batch = {"input_ids": torch.from_numpy(np.stack([d["input_ids"] for d in _dataset()[:ROWS]]))}
    grads, m = acc.compute_gradients(lm_loss_fn(model), state, batch)
    assert m["aux"] == () and not m["loss"].requires_grad
    assert all(p.grad is None for p in model.parameters()) and state.micro_step == 0
    with acc.accumulate():  # the first call of a window of 2: accumulates
        acc.apply_gradients(state, grads)
    assert state.micro_step == 1 and state.step == 0
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, grads[name]) and p.grad.data_ptr() != grads[name].data_ptr()

    def with_aux(params, b):
        loss = lm_loss_fn(model)(params, b)
        return loss, {"twice": loss * 2}

    grads2, m2 = acc.compute_gradients(with_aux, state, batch, has_aux=True)
    assert not m2["aux"]["twice"].requires_grad
    assert torch.equal(m2["aux"]["twice"], m2["loss"] * 2)
    for name in grads:
        assert torch.equal(grads2[name], grads[name])
    with pytest.raises(ValueError, match="grads hold"):
        acc.apply_gradients(state, {"nope": grads2.popitem()[1], **grads2})


def test_backward_raises_with_guidance():
    with pytest.raises(RuntimeError, match="compile_train_step"):
        Accelerator(cpu=True).backward(None)


def _random_grads(seed=3):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32) * 3}}


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "leaves"])
def test_clip_grad_norm_matches_jax(max_norm):
    grads = _random_grads()
    jclipped, jnorm = JAccelerator().clip_grad_norm_(grads, max_norm)
    _reset_jax()
    acc = Accelerator(cpu=True)
    tgrads = {"a": torch.from_numpy(grads["a"]), "b": {"c": torch.from_numpy(grads["b"]["c"])}}
    clipped, norm = acc.clip_grad_norm_(tgrads, max_norm)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(clipped["a"].numpy(), np.asarray(jclipped["a"]), rtol=1e-6)
    np.testing.assert_allclose(clipped["b"]["c"].numpy(), np.asarray(jclipped["b"]["c"]),
                               rtol=1e-6)
    assert torch.equal(tgrads["a"], torch.from_numpy(grads["a"]))  # not modified
    with pytest.raises(NotImplementedError, match="L2"):
        acc.clip_grad_norm_(tgrads, max_norm, norm_type=1.0)


def test_clip_grad_value_matches_jax():
    grads = _random_grads()
    jclipped = JAccelerator().clip_grad_value_(grads, 0.7)
    _reset_jax()
    clipped = Accelerator(cpu=True).clip_grad_value_(
        {"a": torch.from_numpy(grads["a"]), "b": {"c": torch.from_numpy(grads["b"]["c"])}}, 0.7)
    np.testing.assert_array_equal(clipped["a"].numpy(), np.asarray(jclipped["a"]))
    np.testing.assert_array_equal(clipped["b"]["c"].numpy(), np.asarray(jclipped["b"]["c"]))


@pytest.mark.parametrize("reduction,scale", [("sum", 1.0), ("mean", 2.5), ("sum", 0.5)])
def test_reduce_matches_jax(reduction, scale):
    x = np.arange(12, dtype=np.float32).reshape(3, 4) - 5.0
    tree = {"x": x, "y": [x[:1] * 2]}
    want = JAccelerator().reduce(tree, reduction=reduction, scale=scale)
    _reset_jax()
    got = Accelerator(cpu=True).reduce(
        {"x": torch.from_numpy(x), "y": [torch.from_numpy(x[:1] * 2)]},
        reduction=reduction, scale=scale)
    assert isinstance(got["x"], torch.Tensor) and got["x"].device.type == "cpu"
    np.testing.assert_array_equal(got["x"].numpy(), want["x"])
    np.testing.assert_array_equal(got["y"][0].numpy(), want["y"][0])


@pytest.mark.parametrize("dim,pad_first", [(0, False), (1, True)])
def test_pad_across_processes_and_gather_object_match_jax(dim, pad_first):
    x = np.arange(6, dtype=np.int64).reshape(2, 3)
    jacc = JAccelerator()
    want = jacc.pad_across_processes({"x": x, "s": np.int64(4)}, dim=dim, pad_index=-1,
                                     pad_first=pad_first)
    from accelerate_tpu.utils.operations import gather_object as jgather_object
    want_objects = [jgather_object([1, 2]), jgather_object({"k": 3})]
    _reset_jax()
    from accelerate_tpu_torch.utils.operations import gather_object

    got = Accelerator(cpu=True).pad_across_processes(
        {"x": torch.from_numpy(x), "s": torch.tensor(4)}, dim=dim, pad_index=-1,
        pad_first=pad_first)
    np.testing.assert_array_equal(got["x"].numpy(), want["x"])
    assert got["s"].item() == int(want["s"])
    assert [gather_object([1, 2]), gather_object({"k": 3})] == want_objects


def _split_inputs(kind):
    values = list(range(7))
    if kind == "list":
        return values, values
    if kind == "tensor":
        return np.arange(14).reshape(7, 2), torch.arange(14).reshape(7, 2)
    return ({"a": values, "b": np.arange(7.0)},
            {"a": values, "b": torch.arange(7.0, dtype=torch.float64)})


def _as_numpy(x):
    if isinstance(x, dict):
        return {k: _as_numpy(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy().tolist()
    return np.asarray(x).tolist()


@pytest.mark.parametrize("kind", ["list", "tensor", "dict"])
@pytest.mark.parametrize("procs,index", [(1, 0), (3, 0), (3, 2), (4, 3)])
@pytest.mark.parametrize("apply_padding", [False, True])
def test_split_between_processes_matches_jax(monkeypatch, kind, procs, index, apply_padding):
    """One process gets the whole input; the slicing of several processes
    (set on both states' shared dicts) follows the JAX package, padding
    included."""
    jinputs, inputs = _split_inputs(kind)
    jacc = JAccelerator()
    for st in (jacc.state.partial_state,):
        monkeypatch.setattr(st, "num_processes", procs)
        monkeypatch.setattr(st, "process_index", index)
    with jacc.split_between_processes(jinputs, apply_padding=apply_padding) as part:
        want = _as_numpy(part)
    acc = Accelerator(cpu=True)
    monkeypatch.setattr(acc.state.partial_state, "num_processes", procs)
    monkeypatch.setattr(acc.state.partial_state, "process_index", index)
    with acc.split_between_processes(inputs, apply_padding=apply_padding) as part:
        if kind == "tensor":
            assert isinstance(part, torch.Tensor)
        got = _as_numpy(part)
    assert got == want


def test_process_helpers_match_jax():
    def drive(acc):
        calls = []
        for deco in (acc.on_main_process, acc.on_local_main_process, acc.on_last_process,
                     acc.on_process(process_index=0), acc.on_process(process_index=1)):
            calls.append(deco(lambda: len(calls))())
        with acc.main_process_first():
            calls.append("main_first")
        with acc.local_main_process_first():
            calls.append("local_first")
        return calls

    want = drive(JAccelerator())
    _reset_jax()
    got = drive(Accelerator(cpu=True))
    assert got == want == [0, 1, 2, 3, None, "main_first", "local_first"]


def test_trigger_scopes_and_properties():
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    assert not acc.check_trigger()
    acc.set_trigger()
    assert acc.check_trigger() and not acc.check_trigger()
    assert acc.even_batches is True and acc.use_seedable_sampler is False
    with acc.autocast(), acc.join_uneven_inputs([object()], even_batches=False):
        # a no-op scope: the policy is the step's, not an autocast context's
        assert not torch.is_autocast_enabled("cpu")
    acc.end_training()  # no trackers: log_with is not ported
    assert acc.trackers == []


def test_free_memory_drops_the_registries(jax_model):
    _, jparams = jax_model
    model = _port_model(jparams)
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=0.1))
    loader = acc.prepare(SimpleDataLoader(_dataset(), batch_size=ROWS))
    acc.prepare(lambda count: 0.1)
    assert (len(acc._models), len(acc._optimizers), len(acc._schedulers),
            len(acc._dataloaders), len(acc._states)) == (1, 1, 1, 1, 1)
    assert acc.free_memory(state, loader) == (state, loader)
    assert not (acc._models or acc._optimizers or acc._schedulers or acc._dataloaders
                or acc._states)
    acc.prepare(model)
    acc.clear()
    assert not acc._models


def test_get_state_dict_is_a_host_copy(jax_model):
    _, jparams = jax_model
    model = _port_model(jparams)
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=0.1))
    for source in (state, model, dict(model.named_parameters())):
        sd = acc.get_state_dict(source)
        assert list(sd) == list(model.state_dict())
        for name, p in model.named_parameters():
            assert torch.equal(sd[name], p) and sd[name].data_ptr() != p.data_ptr()
            assert not sd[name].requires_grad


def test_project_directories_are_accepted(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    assert acc.project_dir == acc.logging_dir == str(tmp_path)
    _reset_port()
    pc = ProjectConfiguration(project_dir=str(tmp_path / "p"), logging_dir=str(tmp_path / "l"),
                              automatic_checkpoint_naming=True, total_limit=3)
    acc = Accelerator(cpu=True, project_config=pc)
    assert acc.project_configuration is pc
    assert (acc.project_dir, acc.logging_dir) == (str(tmp_path / "p"), str(tmp_path / "l"))


def test_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    acc = Accelerator(cpu=True)
    with acc.profile(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (name,) = os.listdir(tmp_path / "trace")
    assert name.endswith(".pt.trace.json")
    events = json.load(open(tmp_path / "trace" / name))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # the default: <project_dir or .>/profile
    monkeypatch.chdir(tmp_path)
    with acc.profile():
        pass
    assert len(os.listdir(tmp_path / "profile")) == 1
