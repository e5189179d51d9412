"""Port parity across processes: sharded checkpoints, PowerSGD and the DeepSpeed-config shim.

Checkpoints: a world of 4 ``gloo`` processes (``dp=2 x fsdp=2``, ZeRO-3 and
ZeRO-2, which hold parameter blocks and optimizer-state blocks
respectively) trains three micro-steps at accumulation 2 — the window
open, so the gradient buffer is in the checkpoint — and ``save_state``
writes each rank's blocks.  A world of 2 (``fsdp=2``) and one process
(here) restore it, re-sharded, and every weight, optimizer-state tensor
and buffer, gathered whole, must equal the saved ones bit for bit (the
restore copies bytes).  A one-process checkpoint loads into the world of 2
the same way.  A world of 2 also resumes a run from a checkpoint with a
fresh Accelerator and state and must end where the uninterrupted run
ends (the same world computes the same sums: bit for bit), and
``save_model`` of a sharded state writes the safetensors a one-process
save of the same weights writes.

PowerSGD: ``compressed_pmean`` over ``dp=2`` (two processes) against the
JAX package's under ``shard_map`` on two CPU devices, both fed the JAX
package's state (its warm start comes from ``PRNGKey(0)``, which torch
cannot draw: the state is carried across like the weights), within 1e-5;
and the train step with the hook against the JAX Accelerator's, three
optimizer steps, within the f32 train tolerances (``RTOL_METRIC``,
``ATOL_PARAM`` of ``tests/test_torch_accelerator.py``).  The hook's
refusals are the reference's (``tests/test_compression.py:241-268``).

DeepSpeed configs: ``ZeroPlugin.from_deepspeed_config`` over every template
in ``examples/deepspeed_config_templates/`` and over configs with the keys
the shim warns about, against the JAX package's; ``torch_tx_from_ds_config``
against ``optax_from_ds_config``: the same updates within 1e-6 relative.
"""

import functools
import json
import os
import pickle
import warnings

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
from accelerate_tpu.parallel import compression as jcompression
from accelerate_tpu.parallel.mesh import shard_map as jshard_map
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import CollectiveKwargs as JCollectiveKwargs
from accelerate_tpu.utils.dataclasses import ZeroPlugin as JZeroPlugin
from accelerate_tpu.utils.ds_compat import optax_from_ds_config
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.checkpointing import load_file
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel import compression
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import CollectiveKwargs, ZeroPlugin
from accelerate_tpu_torch.utils.ds_compat import torch_tx_from_ds_config
from accelerate_tpu_torch.weights import params_from_jax

import torch_dist_workers as workers

RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
PMEAN_TOL = 1e-5
ROWS, SEQ, CALLS = 8, 16, 6
HYPER = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-6, wd=0.1, max_grad_norm=0.5)
TEMPLATES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "examples", "deepspeed_config_templates")
SAVES = {
    "zero3": dict(mesh={"dp": 2, "fsdp": 2}, zero=3),
    "zero2": dict(mesh={"dp": 2, "fsdp": 2}, zero=2),
}

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



@pytest.fixture(scope="module")
def jax_model():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, jparams)


def _dataset():
    return np.random.default_rng(0).integers(1, 256, (ROWS * CALLS, SEQ)).astype(np.int32)


def _load(out_dir, tag, world):
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{tag}_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _port_name(path) -> str:
    """The port's state-dict name of a Flax param path (as ``params_from_jax``
    names it)."""
    parts = [str(getattr(p, "key", p)) for p in path]
    if parts[0].startswith("layers_"):
        parts[0:1] = ["layers", parts[0][len("layers_"):]]
    if parts[-1] in ("kernel", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts)


def _reset_port():
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


# ------------------------------------------------------------------- worlds
def _jax_pmean_case():
    """Gradients of two replicas and a warm PowerSGD state (the JAX
    package's), and the JAX package's ``compressed_pmean`` of them."""
    rng = np.random.default_rng(3)
    shapes = {"w": (24, 16), "v": (8, 4, 12), "b": (16,), "small": (4, 4)}
    grads = {k: rng.standard_normal((2, *s)).astype(np.float32) for k, s in shapes.items()}
    params = {k: jnp.zeros(s) for k, s in shapes.items()}
    jstate = jcompression.powersgd_init(params, rank=3, min_compression_size=64, replicas=2)
    # a warm error buffer, as after earlier steps
    jstate = {k: None if v is None else {"q": v["q"], "error": jnp.asarray(
        rng.standard_normal(v["error"].shape).astype(np.float32) * 0.1)}
        for k, v in jstate.items()}
    ghat, new = _jax_pmean({k: jnp.asarray(v) for k, v in grads.items()}, jstate)
    np_state = {k: None if v is None else {"q": np.asarray(v["q"]),
                                           "error": np.asarray(v["error"])}
                for k, v in jstate.items()}
    return dict(shapes=shapes, grads=grads, params=params, jstate=jstate, np_state=np_state,
                ghat=ghat, new=new)


@pytest.fixture(scope="module")
def worlds(jax_model, tmp_path_factory):
    """Every process world of this file: one of 4 (the sharded saves), one
    of 2 (the restores, the resumed run, PowerSGD), and the one-process
    saves and restores here."""
    jmodel, jparams = jax_model
    root = tmp_path_factory.mktemp("dist_ckpt")
    out = str(root / "out")
    os.makedirs(out)
    ids = _dataset()
    pmean = _jax_pmean_case()
    comm, powersgd_want = _jax_powersgd_run(jmodel, jparams, rank=4)
    comm22, powersgd22_want = _jax_powersgd_run(jmodel, jparams, rank=4,
                                                mesh={"dp": 2, "fsdp": 2},
                                                strategy="SHARD_GRAD_OP")
    powersgd22 = dict(tag="powersgd_fsdp", mesh={"dp": 2, "fsdp": 2}, powersgd=4,
                      fsdp=dict(sharding_strategy="SHARD_GRAD_OP"), comm_state=comm22)
    debug_launcher(workers.sequence, ([
        ("ckpt_save", (out, dict(tag=f"save_{tag}", **case), jparams, ids, ROWS, HYPER, 3,
                       str(root / tag))) for tag, case in SAVES.items()]
        + [("train_cases", (out, [powersgd22], jparams, ids, ROWS, HYPER))],),
        num_processes=4)
    # a one-process checkpoint, the format a single card writes
    _reset_port()
    try:
        acc = workers.make_accelerator({"mesh": None})
        model = workers.make_model(jparams)
        state = acc.create_train_state(params=model, tx=workers._adamw(HYPER))
        state = workers._train(acc, state, model, ids, ROWS, HYPER, 3)
        acc.save_state(str(root / "single"), state=state)
        single = workers._full_state(acc, state)
    finally:
        _reset_port()
    loads = [(f"load_{tag}", {"mesh": {"fsdp": 2}, "fsdp": {"sharding_strategy": "FULL_SHARD"}},
              str(root / tag)) for tag in SAVES]
    loads.append(("load_single", {"mesh": {"fsdp": 2}, "zero": 2}, str(root / "single")))
    powersgd = dict(tag="powersgd", mesh={"dp": 2}, powersgd=4, comm_state=comm)
    debug_launcher(workers.sequence, ([
        ("ckpt_load", (out, loads, jparams, HYPER)),
        ("ckpt_resume", (out, dict(tag="resume", mesh={"dp": 2}), jparams, ids, ROWS, HYPER,
                         CALLS, 3, str(root / "resume"), str(root / "model"))),
        ("powersgd_pmean", (out, pmean["grads"], pmean["np_state"])),
        ("train_cases", (out, [powersgd], jparams, ids, ROWS, HYPER)),
    ],), num_processes=2)
    # the world-of-one restores
    one = {}
    for tag in SAVES:
        _reset_port()
        try:
            acc = workers.make_accelerator({"mesh": None})
            model = workers.make_model(jparams)
            state = acc.create_train_state(params=model, tx=workers._adamw(HYPER))
            acc.load_state(str(root / tag), state=state)
            one[tag] = workers._full_state(acc, state)
        finally:
            _reset_port()
    return {"root": root, "out": out, "single": single, "one": one, "pmean": pmean,
            "comm": comm, "powersgd_want": powersgd_want, "powersgd_fsdp_want": powersgd22_want}


@pytest.fixture(scope="module")
def checkpoints(worlds):
    return worlds


def _assert_same_state(got, want):
    assert (got["step"], got["micro_step"]) == (want["step"], want["micro_step"])
    assert got["params"].keys() == want["params"].keys()
    for name in want["params"]:
        np.testing.assert_array_equal(got["params"][name], want["params"][name], err_msg=name)
        assert got["opt"][name].keys() == want["opt"][name].keys(), name
        for key in want["opt"][name]:
            np.testing.assert_array_equal(got["opt"][name][key], want["opt"][name][key],
                                          err_msg=f"{name}.{key}")
    assert got["grads"].keys() == want["grads"].keys()
    for name in want["grads"]:
        np.testing.assert_array_equal(got["grads"][name], want["grads"][name], err_msg=name)


@pytest.mark.parametrize("tag", list(SAVES))
def test_sharded_save_restores_at_world_two_bitwise(checkpoints, tag):
    saved = _load(checkpoints["out"], f"save_{tag}", 4)[0]
    assert saved["micro_step"] == 1 and saved["step"] == 1 and saved["grads"]
    for got in _load(checkpoints["out"], f"load_{tag}", 2):
        _assert_same_state(got, saved)


@pytest.mark.parametrize("tag", list(SAVES))
def test_sharded_save_restores_in_one_process_bitwise(checkpoints, tag):
    saved = _load(checkpoints["out"], f"save_{tag}", 4)[0]
    _assert_same_state(checkpoints["one"][tag], saved)


def test_each_rank_writes_its_own_blocks(checkpoints):
    base = checkpoints["root"] / "zero3"
    files = sorted(os.listdir(base / "train_state"))
    assert files == [f"rank_{i}.pt" for i in range(4)]
    meta = json.loads((base / "accelerator_state.json").read_text())
    assert meta["num_processes"] == 4 and meta["step"] == 1
    assert sorted(f for f in os.listdir(base) if f.startswith("random_states")) == \
        [f"random_states_{i}.pkl" for i in range(4)]
    tree = torch.load(base / "train_state" / "rank_1.pt", weights_only=True)
    # rank 1 is (dp 0, fsdp 1): the second half of the out features
    piece = tree["pieces"]["layers.0.mlp.up_proj.weight"]
    assert piece["param"].shape == (64, 64) and piece["box"] == [(64, 128), (0, 64)]


def test_one_process_checkpoint_loads_across_processes(checkpoints):
    for got in _load(checkpoints["out"], "load_single", 2):
        _assert_same_state(got, checkpoints["single"])


def test_resumed_run_ends_where_the_uninterrupted_one_does(checkpoints):
    for out in _load(checkpoints["out"], "resume", 2):
        whole, resumed = out["whole"], out["resumed"]
        assert (resumed["step"], resumed["micro_step"]) == (whole["step"], whole["micro_step"])
        for name in whole["params"]:
            np.testing.assert_array_equal(resumed["params"][name], whole["params"][name],
                                          err_msg=name)


def test_save_model_of_a_sharded_state_is_the_one_process_file(checkpoints, jax_model):
    root = checkpoints["root"]
    saved = load_file(str(root / "model" / "model.safetensors"))
    whole = _load(checkpoints["out"], "resume", 2)[0]["whole"]["params"]
    assert saved.keys() == whole.keys()
    for name, t in saved.items():
        np.testing.assert_array_equal(t.numpy(), whole[name])
    # the bytes of a one-process save of the same weights
    _reset_port()
    try:
        acc = Accelerator(cpu=True)
        model = workers.make_model(jax_model[1])
        model.load_state_dict({k: torch.from_numpy(v) for k, v in whole.items()})
        acc.save_model(model, str(root / "model_one"))
    finally:
        _reset_port()
    assert (root / "model" / "model.safetensors").read_bytes() == \
        (root / "model_one" / "model.safetensors").read_bytes()


# ---------------------------------------------------------------- PowerSGD
def _jax_pmean(grads, state):
    """The JAX package's compressed_pmean under shard_map over dp=2 (grads and
    errors carry a leading replica axis)."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    is_entry = lambda x: x is None or (isinstance(x, dict) and "q" in x)  # noqa: E731
    g_specs = jax.tree_util.tree_map(lambda _: P("dp"), grads)
    s_specs = jax.tree_util.tree_map(lambda x: None if x is None else {"q": P(), "error": P("dp")},
                                     state, is_leaf=is_entry)

    def run(g, s):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        s = jax.tree_util.tree_map(
            lambda e: None if e is None else {"q": e["q"], "error": e["error"][0]}, s,
            is_leaf=is_entry)
        ghat, ns = jcompression.compressed_pmean(g, s, "dp")
        ns = jax.tree_util.tree_map(
            lambda e: None if e is None else {"q": e["q"], "error": e["error"][None]}, ns,
            is_leaf=is_entry)
        return ghat, ns

    return jax.jit(jshard_map(run, mesh=mesh, in_specs=(g_specs, s_specs),
                              out_specs=(jax.tree_util.tree_map(lambda _: P(), grads), s_specs),
                              check_vma=False))(grads, state)


def test_compressed_pmean_over_two_processes_matches_jax(worlds):
    case = worlds["pmean"]
    ghat, new = case["ghat"], case["new"]
    for rank, out in enumerate(_load(worlds["out"], "pmean", 2)):
        for k in case["shapes"]:
            np.testing.assert_allclose(out["ghat"][k], np.asarray(ghat[k]), rtol=PMEAN_TOL,
                                       atol=PMEAN_TOL, err_msg=k)
            if new[k] is None:
                assert out["state"][k] is None
                continue
            np.testing.assert_allclose(out["state"][k]["q"], np.asarray(new[k]["q"]),
                                       rtol=PMEAN_TOL, atol=PMEAN_TOL)
            np.testing.assert_allclose(out["state"][k]["error"],
                                       np.asarray(new[k]["error"])[rank], rtol=PMEAN_TOL,
                                       atol=PMEAN_TOL)
        assert out["stats"] == jcompression.compression_stats(case["params"], case["jstate"])


def test_compression_core_matches_jax():
    for shape, rank, size in (((64, 64), 2, 16), ((64,), 2, 16), ((4, 4), 2, 4096),
                              ((2, 3, 8), 2, 8)):
        assert compression.is_compressible(shape, rank, size) == \
            jcompression.is_compressible(shape, rank, size)
    params = {"w": torch.zeros(256, 256), "b": torch.zeros(256)}
    state = compression.powersgd_init(params, rank=4, min_compression_size=1)
    stats = compression.compression_stats(params, state)
    assert stats == jcompression.compression_stats(
        {"w": jnp.zeros((256, 256)), "b": jnp.zeros((256,))},
        jcompression.powersgd_init({"w": jnp.zeros((256, 256)), "b": jnp.zeros((256,))},
                                   rank=4, min_compression_size=1))
    assert state["b"] is None and state["w"]["q"].shape == (256, 4)
    # full rank reproduces the exact mean (one process: the mean of one)
    g = {"w": torch.randn(12, 8, generator=torch.Generator().manual_seed(1))}
    full = compression.powersgd_init({"w": g["w"]}, rank=8, min_compression_size=1)
    ghat, _ = compression.compressed_pmean(g, full, None)
    torch.testing.assert_close(ghat["w"], g["w"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh={"dp": 1, "tp": 1}, comm_hook="topk"), "Unknown"),
    (dict(mesh={"fsdp": 1}, comm_hook="powersgd", mixed_precision="fp16"), "loss scaling"),
])
def test_powersgd_refuses_what_the_reference_refuses(kw, match):
    """One process: the refusals that do not need several processes (an
    unknown hook, fp16); ``dp/fsdp``-only meshes are held in the world
    (``test_powersgd_train_step_matches_jax``)."""
    _reset_port()
    try:
        acc = Accelerator(cpu=True, mixed_precision=kw.get("mixed_precision"), mesh=kw["mesh"],
                          kwargs_handlers=[CollectiveKwargs(comm_hook=kw["comm_hook"])])
        with pytest.raises(ValueError, match=match):
            acc.create_train_state(params=torch.nn.Linear(16, 32),
                                   tx=functools.partial(torch.optim.SGD, lr=0.1))
    finally:
        _reset_port()


def _jax_powersgd_run(jmodel, jparams, rank, mesh=None, strategy=None):
    from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JFSDP

    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)
    try:
        kw = {} if strategy is None else dict(fsdp_plugin=JFSDP(sharding_strategy=strategy))
        acc = JAccelerator(gradient_accumulation_steps=2, mesh=mesh or {"dp": 2},
                           kwargs_handlers=[JCollectiveKwargs(comm_hook="powersgd",
                                                              powersgd_rank=rank)], **kw)
        state = acc.create_train_state(params=jparams, tx=optax.adamw(
            HYPER["lr"], b1=HYPER["betas"][0], b2=HYPER["betas"][1], eps=HYPER["eps"],
            weight_decay=HYPER["wd"]))
        comm = {}
        for (path, leaf) in jax.tree_util.tree_flatten_with_path(
                state.comm_state, is_leaf=lambda x: x is None or (isinstance(x, dict)
                                                                   and "q" in x))[0]:
            comm[_port_name(path)] = None if leaf is None else {
                "q": np.asarray(leaf["q"]), "error": np.asarray(leaf["error"])}
        loader = acc.prepare(JSimpleDataLoader([{"input_ids": r} for r in _dataset()],
                                               batch_size=ROWS))
        step = acc.compile_train_step(jlm_loss_fn(jmodel), max_grad_norm=HYPER["max_grad_norm"])
        records = []
        for batch in loader:
            state, m = step(state, batch)
            rec = {k: float(np.asarray(m[k])) for k in ("loss", "grad_norm")}
            rec["applied"] = bool(np.asarray(m["applied"]))
            if rec["applied"]:
                rec["params"] = {k: v.numpy() for k, v in params_from_jax(
                    jax.device_get(state.params), device="cpu").items()}
            records.append(rec)
        return comm, records
    finally:
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)


@pytest.mark.parametrize("tag,world", [("powersgd", 2), ("powersgd_fsdp", 4)])
def test_powersgd_train_step_matches_jax(worlds, tag, world):
    """The step with ``CollectiveKwargs(comm_hook="powersgd")`` over ``dp=2``
    processes (and over ``dp=2 x fsdp=2`` under SHARD_GRAD_OP: whole
    matrices compressed over dp, each replica's gradient first summed over
    its fsdp ranks, the reference's partial-auto composition), started from
    the JAX package's PowerSGD state, against the JAX Accelerator's: losses,
    grad norms and parameters."""
    want = worlds[f"{tag}_want"]
    assert sum(v is not None for v in worlds["comm"].values()) > 0
    for out in _load(worlds["out"], tag, world):
        got = out["records"]
        assert len(got) == len(want) == CALLS
        for g, w in zip(got, want):
            assert g["applied"] == w["applied"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL_METRIC)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL_METRIC)
            if w["applied"]:
                for name in w["params"]:
                    np.testing.assert_allclose(g["params"][name], w["params"][name], rtol=0,
                                               atol=ATOL_PARAM, err_msg=name)


# ---------------------------------------------------------- DeepSpeed shim
def _plugin_fields(p):
    return {k: getattr(p, k) for k in (
        "zero_stage", "gradient_accumulation_steps", "gradient_clipping",
        "offload_optimizer_device", "offload_param_device", "nvme_path",
        "zero3_save_16bit_model", "train_micro_batch_size_per_gpu", "offload_update_chunk_mb",
        "offload_update_overlap", "inferred_mixed_precision")}


def _from_config(cls, path):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p = cls.from_deepspeed_config(path)
    return p, [str(w.message) for w in caught]


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(TEMPLATES) if f.endswith(".json")))
def test_zero_plugin_from_every_template_matches_jax(name):
    path = os.path.join(TEMPLATES, name)
    got, got_warnings = _from_config(ZeroPlugin, path)
    want, want_warnings = _from_config(JZeroPlugin, path)
    assert _plugin_fields(got) == _plugin_fields(want)
    assert len(got_warnings) == len(want_warnings) == 0
    a, b = got.to_fsdp_plugin(), want.to_fsdp_plugin()
    for attr in ("shards_params", "shards_opt_state", "shards_grads", "cpu_offload",
                 "offload_optimizer", "offload_optimizer_nvme_path", "min_weight_size",
                 "offload_update_chunk_mb"):
        assert getattr(a, attr) == getattr(b, attr), attr


@pytest.mark.parametrize("config", [
    {"zero_optimization": {"stage": 2, "reduce_bucket_size": 5e8,
                           "offload_param": {"device": "nvme", "pin_memory": True}},
     "optimizer": {"type": "AdamW"}, "fp16": {"enabled": "auto"}},
    {"zero_optimization": {"stage": "auto", "offload_optimizer": {"device": "cpu"},
                           "sub_group_size": 1e12}, "gradient_clipping": "auto",
     "fp16": {"enabled": True}},
])
def test_zero_plugin_warns_as_the_reference_does(config, tmp_path):
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(config))
    got, got_warnings = _from_config(ZeroPlugin, str(path))
    want, want_warnings = _from_config(JZeroPlugin, str(path))
    assert _plugin_fields(got) == _plugin_fields(want)
    assert len(got_warnings) == len(want_warnings)
    for g, w in zip(got_warnings, want_warnings):
        # the same keys named (the remedy names each package's own optimizer function)
        assert g.split("(ignored): ")[-1].split(".")[0] == w.split("(ignored): ")[-1].split(".")[0]


@pytest.mark.parametrize("config,kw", [
    ({"optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "betas": [0.8, 0.9], "eps": 1e-7,
                                                "weight_decay": 0.05}}}, {}),
    ({"optimizer": {"type": "Adam", "params": {"lr": "auto", "weight_decay": 0.01}},
      "scheduler": {"type": "WarmupDecayLR", "params": {"warmup_num_steps": 3,
                                                        "total_num_steps": "auto"}}},
     dict(lr=2e-3, total_num_steps=8)),
    ({"optimizer": {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                               "adam_w_mode": False}},
      "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2,
                                                   "warmup_max_lr": 1e-3}}}, {}),
    ({"optimizer": {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9,
                                              "weight_decay": 1e-3}},
      "scheduler": {"type": "WarmupCosineLR", "params": {"warmup_num_steps": 2,
                                                         "total_num_steps": 7,
                                                         "warmup_min_ratio": 0.1,
                                                         "cos_min_ratio": 0.2}}}, {}),
])
def test_torch_tx_from_ds_config_matches_optax(config, kw):
    """Six updates of the same parameters by the same gradients: the torch
    optimizer (with the schedule set before each step, as the accelerator's
    prepared schedule does) against the optax transform of the same file."""
    tx, schedule = torch_tx_from_ds_config(config, **kw)
    otx = optax_from_ds_config(config, **kw)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(6)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tx([param])
    jp = jnp.asarray(p0)
    ostate = otx.init(jp)
    for step, g in enumerate(grads):
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = float(schedule(step))
        param.grad = torch.from_numpy(g)
        opt.step()
        updates, ostate = otx.update(jnp.asarray(g), ostate, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_torch_tx_from_ds_config_refuses_as_the_reference_does():
    for config, match in (({"optimizer": {"type": "AdamW", "params": {"lr": "auto"}}}, "lr"),
                          ({"optimizer": {"type": "Adagrad", "params": {"lr": 1e-3}}},
                           "Unsupported"),
                          ({"optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                            "scheduler": {"type": "OneCycle"}}, "Unsupported")):
        with pytest.raises(ValueError, match=match):
            torch_tx_from_ds_config(config)
        with pytest.raises(ValueError, match=match):
            optax_from_ds_config(config)
    with pytest.raises(ValueError, match="Lamb"):
        torch_tx_from_ds_config({"optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}})


def test_explicit_mixed_precision_env_beats_the_configs(monkeypatch):
    """The launcher's ``ACCELERATE_MIXED_PRECISION`` wins over a DeepSpeed
    config's bf16 section, as in the reference."""
    monkeypatch.setenv("ACCELERATE_DEEPSPEED_CONFIG_FILE",
                       os.path.join(TEMPLATES, "zero_stage2_config.json"))
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "no")
    _reset_port()
    try:
        acc = Accelerator(cpu=True)
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)
        assert acc.mixed_precision == JAccelerator().mixed_precision == "no"
    finally:
        _reset_port()
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)


def test_accelerator_takes_the_config_as_the_reference_does(tmp_path, monkeypatch):
    path = os.path.join(TEMPLATES, "zero_stage2_config.json")
    monkeypatch.setenv("ACCELERATE_DEEPSPEED_CONFIG_FILE", path)
    monkeypatch.delenv("ACCELERATE_MIXED_PRECISION", raising=False)
    _reset_port()
    try:
        acc = Accelerator(cpu=True)
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)
        ref = JAccelerator()
        assert acc.mixed_precision == ref.mixed_precision == "bf16"
        assert acc.distributed_type == ref.distributed_type == "ZERO"
        assert acc.gradient_accumulation_steps == ref.gradient_accumulation_steps
        assert acc.state.zero_plugin.gradient_clipping == ref.state.zero_plugin.gradient_clipping
    finally:
        _reset_port()
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)
