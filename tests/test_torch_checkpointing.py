"""The port's ``checkpointing.py`` against the JAX package's, and resumes against uninterrupted runs.

Mirrors ``tests/test_checkpointing.py`` (round trip, automatic naming and
rotation, custom objects, sampler state, single-file and sharded
``save_model``, target mismatch, ``parse_size``) without its sharding case,
which needs a mesh.  Then:
* a run saved mid-window (``micro_step > 0``) and resumed into a fresh
  accelerator and a state made from another seed ends bitwise equal to the
  uninterrupted run — losses, grad norms, params, optimizer moments and
  counters — through the reference loop (``compute_gradients`` +
  ``apply_gradients``) and through ``compile_train_step``, f32 and fp16;
* the checkpoint directory holds the same entries as the JAX package's for
  the same run, and the same ``sampler_*.json``, ``scheduler_*.json`` and
  ``accelerator_state.json``;
* the port's safetensors files load with the ``safetensors`` package, the
  package's and the JAX package's exports load with the port's reader, and
  the JAX export of the tiny model, mapped through ``params_from_jax``, is
  bitwise the port's export of the same weights.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import safetensors.torch
import torch
from torch import nn

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import SimpleDataLoader as JSimpleDataLoader
from accelerate_tpu.checkpointing import _unflatten_params
from accelerate_tpu.checkpointing import save_model as jsave_model
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils import ProjectConfiguration as JProjectConfiguration
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.checkpointing import (
    load_file,
    load_model_params,
    parse_size,
    save_file,
    save_model,
)
from accelerate_tpu_torch.data_loader import SimpleDataLoader
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import GradScalerKwargs, ProjectConfiguration
from accelerate_tpu_torch.weights import init_params, params_from_jax


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


# ------------------------------------------------------ the regression model
class Regression(nn.Module):
    """The reference test's ``{"w": [4, 2]}`` parameter tree."""

    def __init__(self, value=1.0):
        super().__init__()
        self.w = nn.Parameter(torch.full((4, 2), value))


def _loss(p, batch):
    return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()


def _jloss(p, batch):
    return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)


def _data(n=16):
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(4,)).astype(np.float32),
             "y": rng.normal(size=(2,)).astype(np.float32)} for _ in range(n)]


def _make(**kw):
    acc = Accelerator(cpu=True, **kw)
    state = acc.create_train_state(params=Regression(),
                                   tx=functools.partial(torch.optim.AdamW, lr=1e-2))
    return acc, state


class TestSaveLoadState:
    def test_round_trip(self, tmp_path):
        acc, state = _make()
        step = acc.compile_train_step(_loss)
        dl = acc.prepare(SimpleDataLoader(_data(), batch_size=8, shuffle=True))
        for b in dl:
            state, _ = step(state, b)
        out = acc.save_state(str(tmp_path / "ckpt"), state=state)
        assert out == str(tmp_path / "ckpt")
        state2 = acc.create_train_state(params=Regression(0.0),
                                        tx=functools.partial(torch.optim.AdamW, lr=1e-2))
        # load_kwargs reach torch.load
        assert acc.load_state(out, state=state2, load_kwargs={"mmap": True}) is state2
        assert state2.step == state.step == 2
        assert torch.equal(state2.model.w, state.model.w)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state2.optimizer.state[state2.model.w][key],
                               state.optimizer.state[state.model.w][key])

    def test_automatic_naming_and_rotation(self, tmp_path):
        acc, state = _make(project_config=ProjectConfiguration(
            project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=2))
        for i in range(3):
            state.step = i
            acc.save_state(state=state)
        base = tmp_path / "checkpoints"
        assert sorted(os.listdir(base)) == ["checkpoint_1", "checkpoint_2"]
        assert acc.project_configuration.iteration == 3
        state.step = 0
        acc.load_state(state=state)  # the newest
        assert state.step == 2
        acc.project_configuration.iteration = 2
        with pytest.raises(ValueError, match="already exists"):
            acc.save_state(state=state)

    def test_custom_objects_and_pre_hooks(self, tmp_path):
        acc, state = _make()

        class Obj:
            def __init__(self):
                self.v = 3

            def state_dict(self):
                return {"v": self.v}

            def load_state_dict(self, s):
                self.v = s["v"]

        o = Obj()
        acc.register_for_checkpointing(o)
        seen = []
        acc.register_save_state_pre_hook(lambda models, weights, d: seen.append(
            ("save", models, weights, d)))
        acc.register_load_state_pre_hook(lambda models, d: seen.append(("load", models, d)))
        out = acc.save_state(str(tmp_path / "c"), state=state)
        o.v = 0
        acc.load_state(out, state=state)
        assert o.v == 3
        assert seen == [("save", acc._models, [], out), ("load", acc._models, out)]
        assert seen[0][1] == [state.model]

    def test_register_invalid_object(self):
        acc, _ = _make()
        with pytest.raises(ValueError):
            acc.register_for_checkpointing(object())

    def test_sampler_state_round_trip(self, tmp_path):
        acc, state = _make()
        dl = acc.prepare(SimpleDataLoader(_data(), batch_size=4, shuffle=True, seed=5))
        first = [b["x"].clone() for b in dl]  # epoch 0; iteration -> 1
        out = acc.save_state(str(tmp_path / "c"), state=state)
        with open(os.path.join(out, "sampler_0.json")) as f:
            assert json.load(f) == {"iteration": 1, "sampler": {"seed": 5, "epoch": 0}}
        second = [b["x"].clone() for b in dl]  # epoch 1
        sampler = dl.base_dataloader.batch_sampler.sampler
        sampler.seed, dl.iteration = 9, 7
        acc.load_state(out, state=state)
        assert (sampler.seed, sampler.epoch, dl.iteration) == (5, 0, 1)
        again = [b["x"].clone() for b in dl]  # epoch 1 again, reshuffled the same
        assert all(torch.equal(a, b) for a, b in zip(again, second))
        assert not all(torch.equal(a, b) for a, b in zip(first, second))

    def test_random_states_round_trip(self, tmp_path):
        import random

        acc, state = _make()
        out = acc.save_state(str(tmp_path / "c"), state=state)
        want = (random.random(), np.random.rand(), torch.rand(()).item())
        acc.load_state(out, state=state)
        assert (random.random(), np.random.rand(), torch.rand(()).item()) == want


class TestSaveModel:
    def test_single_file(self, tmp_path):
        acc, state = _make()
        files = acc.save_model(state, str(tmp_path / "m"))
        assert [os.path.basename(f) for f in files] == ["model.safetensors"]
        back = load_model_params(str(tmp_path / "m"))
        assert torch.equal(back["w"], state.model.w.detach())

    def test_sharded_with_index(self, tmp_path):
        acc, _ = _make()
        params = {"a": torch.ones((64, 64)), "b": torch.ones((64, 64))}
        files = save_model(acc, params, str(tmp_path / "m"), max_shard_size=f"{64 * 64 * 4}B")
        assert len(files) == 2
        index = json.load(open(tmp_path / "m" / "model.safetensors.index.json"))
        assert set(index["weight_map"]) == {"a", "b"}
        assert index["metadata"]["total_size"] == 2 * 64 * 64 * 4
        back = load_model_params(str(tmp_path / "m"), target=params)
        assert torch.equal(back["a"], params["a"])

    def test_target_mismatch_raises(self, tmp_path):
        acc, state = _make()
        acc.save_model(state, str(tmp_path / "m"))
        with pytest.raises(ValueError, match="mismatch"):
            load_model_params(str(tmp_path / "m"), target={"other": torch.ones(2)})


def test_parse_size():
    assert parse_size("10GB") == 10 * 10**9
    assert parse_size("300B") == 300
    assert parse_size("1 kb") == 1000
    assert parse_size(5) == 5
    with pytest.raises(ValueError):
        parse_size("ten gigs")


# ------------------------------------------------------------- mid-window resume
ROWS, SEQ = 2, 16


def _tiny(seed):
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 attention_impl="pallas")
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, seed=seed, device="cpu", dtype=torch.float32))
    return model


def _batches(n=6):
    ids = np.random.default_rng(11).integers(1, 256, (n, ROWS, SEQ)).astype(np.int32)
    return [{"input_ids": torch.from_numpy(b)} for b in ids]


def _trainer(kind, mixed_precision, seed):
    """A fresh accelerator, model and state, and ``call(batch) -> (loss, grad_norm)``."""
    handlers = ([GradScalerKwargs(init_scale=2.0**4, growth_interval=1)]
                if mixed_precision == "fp16" else None)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2, mixed_precision=mixed_precision,
                      kwargs_handlers=handlers)
    acc.prepare(lambda count: 1e-3 * (1 + count))  # the lr follows the applied steps
    model = _tiny(seed)
    state = acc.create_train_state(params=model, tx=functools.partial(
        torch.optim.AdamW, lr=0.0, betas=(0.9, 0.95), eps=1e-6, weight_decay=0.1))
    loss_fn = lm_loss_fn(model)
    if kind == "compiled":
        step = acc.compile_train_step(loss_fn, max_grad_norm=0.5)

        def call(batch):
            _, m = step(state, batch)
            return m["loss"].item(), m["grad_norm"].item()
    else:
        def call(batch):
            with acc.accumulate():
                grads, m = acc.compute_gradients(loss_fn, state, batch)
                # the running average's norm, as the compiled step reports it
                count = state.micro_step + 1
                norm = torch.linalg.vector_norm(torch.stack([
                    torch.linalg.vector_norm(g if p.grad is None else p.grad + g)
                    for (name, g), p in zip(grads.items(), model.parameters())])) / count
                acc.apply_gradients(state, grads, max_grad_norm=0.5)
            return m["loss"].item(), norm.item()
    return acc, state, call


def _snapshot(state):
    opt = state.optimizer.state
    return {
        "params": {k: v.detach().clone() for k, v in state.params.items()},
        "moments": [(opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone(),
                     opt[p]["step"].clone()) for p in state.model.parameters()],
        "counters": (state.step, state.micro_step, state.loss_scale),
        "lr": state.optimizer.param_groups[0]["lr"],
    }


@pytest.mark.parametrize("kind,mixed_precision", [
    ("reference_loop", "no"), ("compiled", "no"), ("reference_loop", "fp16"),
    ("compiled", "fp16")])
def test_mid_window_resume_is_bitwise(tmp_path, kind, mixed_precision):
    batches = _batches()
    _, state, call = _trainer(kind, mixed_precision, seed=0)
    whole = [call(b) for b in batches]
    want = _snapshot(state)
    _reset_port()

    acc, state, call = _trainer(kind, mixed_precision, seed=0)
    first = [call(b) for b in batches[:3]]
    assert state.micro_step == 1 and state.step == 1
    out = acc.save_state(str(tmp_path / "ckpt"), state=state)
    _reset_port()

    # a new process: a fresh accelerator, and weights from another seed
    acc, state, call = _trainer(kind, mixed_precision, seed=1)
    acc.load_state(out, state=state)
    assert state.micro_step == 1 and all(p.grad is not None for p in state.model.parameters())
    rest = [call(b) for b in batches[3:]]
    assert first + rest == whole  # losses and grad norms, bitwise
    got = _snapshot(state)
    assert got["counters"] == want["counters"] and got["lr"] == want["lr"]
    for name in want["params"]:
        assert torch.equal(got["params"][name], want["params"][name]), name
    for g, w in zip(got["moments"], want["moments"]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
        assert g[2].device.type == "cpu"  # torch's own placement of the step count


def test_save_at_a_window_edge_clears_the_buffer(tmp_path):
    acc, state, call = _trainer("reference_loop", "no", seed=0)
    for b in _batches(2):
        call(b)
    assert state.micro_step == 0
    out = acc.save_state(str(tmp_path / "c"), state=state)
    assert "grad" not in torch.load(os.path.join(out, "train_state", "train_state.pt"),
                                    weights_only=True)
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    acc.load_state(out, state=state)
    assert all(p.grad is None for p in state.model.parameters())


# ---------------------------------------------------------- the same files as JAX
def test_same_files_and_json_as_jax(tmp_path):
    """The same run in both packages: a shuffled 4-batch loader,
    accumulation 2, a prepared schedule, a custom object."""

    class Obj:
        def state_dict(self):
            return {"v": 1}

        def load_state_dict(self, s):
            pass

    jacc = JAccelerator(gradient_accumulation_steps=2)
    jacc.prepare(lambda count: 1e-2)
    jstate = jacc.create_train_state(params={"w": np.ones((4, 2), np.float32)},
                                     tx=optax.adamw(1e-2), seed=0)
    jdl = jacc.prepare(JSimpleDataLoader(_data(), batch_size=4, shuffle=True, seed=3))
    jstep = jacc.compile_train_step(_jloss)
    for b in jdl:
        jstate, _ = jstep(jstate, b)
    jacc.register_for_checkpointing(Obj())
    jout = jacc.save_state(str(tmp_path / "jax"), state=jstate)
    _reset_jax()

    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    acc.prepare(lambda count: 1e-2)
    state = acc.create_train_state(params=Regression(),
                                   tx=functools.partial(torch.optim.AdamW, lr=1e-2))
    dl = acc.prepare(SimpleDataLoader(_data(), batch_size=4, shuffle=True, seed=3))
    step = acc.compile_train_step(_loss)
    for b in dl:
        state, _ = step(state, b)
    acc.register_for_checkpointing(Obj())
    out = acc.save_state(str(tmp_path / "port"), state=state)

    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == [
        "accelerator_state.json", "custom_checkpoint_0.pkl", "random_states_0.pkl",
        "sampler_0.json", "scheduler_0.json", "train_state"]
    for name in ("sampler_0.json", "scheduler_0.json", "accelerator_state.json"):
        with open(os.path.join(out, name)) as f, open(os.path.join(jout, name)) as g:
            assert json.load(f) == json.load(g), name
    with open(os.path.join(out, "accelerator_state.json")) as f:
        assert json.load(f)["step"] == 2


def test_automatic_names_match_jax(tmp_path):
    jacc = JAccelerator(project_config=JProjectConfiguration(
        project_dir=str(tmp_path / "jax"), automatic_checkpoint_naming=True, total_limit=2))
    jstate = jacc.create_train_state(params={"w": np.ones((4, 2), np.float32)},
                                     tx=optax.adamw(1e-2), seed=0)
    for _ in range(3):
        jacc.save_state(state=jstate)
    _reset_jax()
    acc, state = _make(project_config=ProjectConfiguration(
        project_dir=str(tmp_path / "port"), automatic_checkpoint_naming=True, total_limit=2))
    for _ in range(3):
        acc.save_state(state=state)
    assert (sorted(os.listdir(tmp_path / "port" / "checkpoints"))
            == sorted(os.listdir(tmp_path / "jax" / "checkpoints")))


# ------------------------------------------------------------------ safetensors
def _mixed_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
        "f16": torch.randn(2, 3, generator=g).to(torch.float16),
        "i32": torch.arange(-4, 5, dtype=torch.int32).reshape(3, 3),
        "i64": torch.tensor([2**40, -1]),
        "fp8": torch.randn(4, 2, generator=g).to(torch.float8_e4m3fn),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
    }


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_port_safetensors_round_trip_through_the_package(tmp_path):
    tensors = _mixed_tensors()
    save_file(tensors, str(tmp_path / "port.safetensors"))
    theirs = safetensors.torch.load_file(str(tmp_path / "port.safetensors"))
    ours = load_file(str(tmp_path / "port.safetensors"))
    safetensors.torch.save_file(tensors, str(tmp_path / "package.safetensors"))
    from_package = load_file(str(tmp_path / "package.safetensors"))
    for name, t in tensors.items():
        for got in (theirs[name], ours[name], from_package[name]):
            assert _bits_equal(got, t), name
    with pytest.raises(ValueError, match="float64"):
        save_file({"x": torch.ones(2, dtype=torch.float64)}, str(tmp_path / "x.safetensors"))


def test_bf16_export_read_by_the_package_is_the_masters_cast(tmp_path):
    model = _tiny(0)
    acc = Accelerator(cpu=True)
    files = acc.save_model(model, str(tmp_path / "m"), max_shard_size="100KB",
                           save_dtype=torch.bfloat16)
    assert len(files) >= 2
    back = load_model_params(str(tmp_path / "m"), target=model)
    seen = set()
    for f in files:
        for name, t in safetensors.torch.load_file(f).items():
            want = model.state_dict()[name].to(torch.bfloat16)
            assert _bits_equal(t, want) and _bits_equal(back[name], want), name
            seen.add(name)
    assert seen == set(model.state_dict())
    assert next(model.parameters()).dtype == torch.float32  # the masters stay


@pytest.fixture(scope="module")
def jax_params():
    """The Flax tiny model's param tree (its shapes by tracing, no compile),
    filled with numpy normals from a seed."""
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    shapes = jax.eval_shape(JTransformer(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("shard", [None, "100KB"], ids=["single", "sharded"])
def test_reference_export_read_by_port(tmp_path, jax_params, shard):
    kw = {} if shard is None else {"max_shard_size": shard}
    jacc = JAccelerator()
    jsave_model(jacc, jax_params, str(tmp_path / "jax"), **kw)
    jsave_model(jacc, jax_params, str(tmp_path / "jax_bf16"), save_dtype=jnp.bfloat16, **kw)
    _reset_jax()
    flat = load_model_params(str(tmp_path / "jax"))
    mapped = params_from_jax(_unflatten_params(flat), device="cpu")

    model = Transformer(TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(params_from_jax(jax_params, device="cpu"))
    acc = Accelerator(cpu=True)
    acc.save_model(model, str(tmp_path / "port"), **kw)
    ours = load_model_params(str(tmp_path / "port"), target=model)
    assert mapped.keys() == ours.keys()
    for name in ours:
        assert _bits_equal(mapped[name], ours[name]), name
    # bf16: the reference's BF16 bytes are the bits the port reads
    bf16 = load_model_params(str(tmp_path / "jax_bf16"))
    for key, t in bf16.items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.to(torch.float32), flat[key].to(torch.bfloat16).to(torch.float32))


def test_port_imports_no_safetensors_or_orbax():
    """The card's machine has neither: the port writes and reads the format itself."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    banned = ("safetensors", "orbax")
    for path in [*(root / "accelerate_tpu_torch").rglob("*.py"), root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in banned], path
