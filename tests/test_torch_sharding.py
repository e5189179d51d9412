"""Port parity across processes: the sharding rules, and the Accelerator's train step on meshes.

The rules (``parallel/sharding.py``, ``parallel/tensor_parallel.py``) are
pure functions of shapes and names: they are held against the JAX
package's on the same shapes, the port's torch-layout spec mapped back to
the JAX logical dims (an ``nn.Linear`` weight is the transposed kernel, so
a square projection must shard dim 1 of the torch weight).

The train step runs in worlds of ``gloo`` processes spawned through the
port's ``debug_launcher`` (one world of 2 and one of 4, each running every
case in turn; ``tests/torch_dist_workers.py`` holds the rank functions).
The JAX package trains the same Flax-initialised ``TransformerConfig.tiny``
on the same token batches in the pytest process, on the conftest's 8 CPU
devices with the same mesh axes (a mesh covers a prefix of them): AdamW,
accumulation 2, three optimizer steps, ``max_grad_norm``.  The port's ranks
compute their data shards' rows and the JAX package the global batch over
its mesh, so losses and gradients agree up to summation order.

Tolerances, f32, those of ``tests/test_torch_accelerator.py``: loss and
grad norm within ``RTOL_METRIC = 2e-5`` relative; the gathered parameters
after each applied step within ``ATOL_PARAM = 2e-5`` absolute.  ZeRO-1
against ZeRO-2 of the port within rtol 1e-5, as the JAX package's
``tests/test_sharding.py`` holds its two stages.
"""

import threading

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
from accelerate_tpu.parallel import sharding as jsharding
from accelerate_tpu.parallel import tensor_parallel as jtp
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JFSDP
from accelerate_tpu.utils.dataclasses import ModelParallelPlugin as JModelParallelPlugin
from accelerate_tpu.utils.dataclasses import ZeroPlugin as JZeroPlugin
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel import sharding, tensor_parallel
from accelerate_tpu_torch.parallel.mesh import Mesh
from accelerate_tpu_torch.utils.dataclasses import (
    FullyShardedDataParallelPlugin,
    ModelParallelPlugin,
    ZeroPlugin,
)
from accelerate_tpu_torch.weights import params_from_jax

import torch_dist_workers as workers

RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
ROWS, SEQ, CALLS = 8, 16, 6
HYPER = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-6, wd=0.1, max_grad_norm=0.5)

MESH22 = {"dp": 2, "fsdp": 2}
STRATEGIES = ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD", "HYBRID_SHARD_ZERO2"]
CASES = {
    "dp2": dict(world=2, mesh={"dp": 2}),
    **{f"zero{k}": dict(world=4, mesh=MESH22, zero=k) for k in range(4)},
    **{s.lower(): dict(world=4, mesh=MESH22, fsdp=dict(sharding_strategy=s, min_weight_size=2**12))
       for s in STRATEGIES},
    "fsdp2_tp2": dict(world=4, mesh={"fsdp": 2, "tp": 2}, tp=2,
                      fsdp=dict(sharding_strategy="FULL_SHARD")),
    # each rank streams its own shard of the optimizer state through the
    # chunked update (1 MB chunks: several of them)
    "fsdp2_offload": dict(world=2, mesh={"fsdp": 2},
                          fsdp=dict(sharding_strategy="FULL_SHARD", offload_optimizer=True,
                                    offload_update_chunk_mb=1)),
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



# ------------------------------------------------------------------- rules
@pytest.mark.parametrize("shape,size,min_size", [
    ((128, 64), 8, 0), ((64, 128), 8, 0), ((4, 4), 8, 2**12), ((10, 64), 8, 0),
    ((7, 9), 8, 0), ((128, 64), 1, 0), ((64, 64), 2, 0), ((256, 64), 4, 2**12),
    ((8, 32, 64), 2, 0), ((3,), 2, 0), ((), 2, 0),
])
def test_fsdp_partition_spec_matches_jax(shape, size, min_size):
    want = tuple(jsharding.fsdp_partition_spec(shape, size, min_size))
    assert tuple(sharding.fsdp_partition_spec(shape, size, min_size)) == want


@pytest.mark.parametrize("shape,ep,fsdp", [
    ((4, 64, 128), 2, 2), ((4, 64, 128), 4, 1), ((3, 64, 128), 2, 2), ((2, 4, 64, 128), 2, 2),
    ((4, 8, 8), 2, 2), ((64, 128), 2, 2),
])
def test_expert_partition_spec_matches_jax(shape, ep, fsdp):
    want = tuple(jsharding.expert_partition_spec(shape, ep, fsdp))
    assert tuple(sharding.expert_partition_spec(shape, ep, fsdp)) == want


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, jparams)


def _jax_specs(jparams, rule_of):
    """Port name -> the JAX spec of that parameter, by walking the Flax tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        spec = tuple(rule_of(path, leaf).spec)
        spec = spec + (None,) * (np.ndim(leaf) - len(spec))
        keys = [str(getattr(p, "key", p)) for p in path]
        name = jtp.path_to_str(path)
        out[name] = (spec, keys)
    return out


@pytest.mark.parametrize("strategy", ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD"])
@pytest.mark.parametrize("for_opt", [False, True])
@pytest.mark.parametrize("axes", [{"fsdp": 2, "tp": 2}, {"dp": 2, "fsdp": 2}, {"tp": 4},
                                  {"tp": 3}])
def test_rules_match_jax_on_the_tiny_model(jax_model, strategy, for_opt, axes):
    """Every parameter of the tiny model: the port's placement (torch
    layout) mapped back to the JAX dims is the JAX package's, square
    projections included (their ``in`` features: torch dim 1)."""
    _, jparams = jax_model
    jmesh = jbuild_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    mesh = Mesh(dict(jmesh.shape))
    jplugin, plugin = JFSDP(sharding_strategy=strategy), FullyShardedDataParallelPlugin(
        sharding_strategy=strategy)
    if "tp" in axes:
        jrule = jtp.make_tp_sharding_fn(jmesh, jplugin, for_opt_state=for_opt)
        rule = tensor_parallel.make_tp_sharding_fn(mesh, plugin, for_opt_state=for_opt)
    else:
        jbase = (jsharding.make_opt_sharding_fn if for_opt
                 else jsharding.make_param_sharding_fn)(jmesh, jplugin)
        base = (sharding.make_opt_sharding_fn if for_opt
                else sharding.make_param_sharding_fn)(mesh, plugin)
        jrule = lambda path, x: jbase(x)  # noqa: E731
        rule = lambda name, x: base(x, name)  # noqa: E731
    want = _jax_specs(jparams, jrule)
    port = params_from_jax(jparams, device="cpu")
    checked = 0
    for name, t in port.items():
        got = sharding.to_logical_spec(name, rule(name, t).spec, t.ndim)
        path = tensor_parallel.path_to_str(name)
        assert path in want, (name, path)
        assert tuple(got) == want[path][0], (name, tuple(got), want[path][0])
        checked += 1
    assert checked == len(want)
    if strategy == "FULL_SHARD" and axes == {"dp": 2, "fsdp": 2}:
        # a square projection: the JAX kernel's dim 0 (in), the torch weight's dim 1
        assert tuple(rule("layers.0.attn.o_proj.weight",
                          port["layers.0.attn.o_proj.weight"]).spec) == (None, "fsdp")


def test_placements_blocks_and_shardings_of_a_layout():
    """The DTensor placements of a layout, each rank's block of a tensor (the
    block JAX places on the same mesh position), and ``sharding_of``."""
    from torch.distributed.tensor import Replicate, Shard

    from accelerate_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec, local_slice

    mesh = Mesh({"dp": 1, "fsdp": 2, "tp": 2})
    assert NamedSharding(mesh, PartitionSpec("tp", "fsdp")).placements == \
        [Replicate(), Shard(1), Shard(0)]
    assert NamedSharding(mesh, PartitionSpec(("fsdp", "tp"), None)).placements == \
        [Replicate(), Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="mesh order"):
        NamedSharding(mesh, PartitionSpec(("tp", "fsdp"), None)).placements
    # each position's block against the JAX array's shard on that device
    jmesh = jbuild_mesh({"dp": 1, "fsdp": 2, "tp": 2}, devices=jax.devices()[:4])
    value = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for spec in (("tp", "fsdp"), (("tp", "fsdp"), None), (None, "tp")):
        from jax.sharding import NamedSharding as JNamedSharding
        from jax.sharding import PartitionSpec as JPartitionSpec

        arr = jax.device_put(value, JNamedSharding(jmesh, JPartitionSpec(*spec)))
        for shard in arr.addressable_shards:
            pos = np.argwhere(np.asarray(jmesh.devices) == shard.device)[0]
            coord = dict(zip(jmesh.axis_names, (int(i) for i in pos)))
            block = value[local_slice(mesh, PartitionSpec(*spec), value.shape, coord)]
            np.testing.assert_array_equal(block, np.asarray(shard.data))
    blocks, shardings = sharding.shard_pytree(
        {"w": torch.arange(8.0 * 4).reshape(8, 4)},
        sharding.make_param_sharding_fn(Mesh({"fsdp": 2}), FullyShardedDataParallelPlugin(
            min_weight_size=0)))
    assert tuple(shardings["w"].spec) == ("fsdp", None) and blocks["w"].shape == (4, 4)
    t = torch.zeros(2)
    t.atpu_sharding = shardings["w"]
    assert sharding.sharding_of({"a": t, "b": [torch.zeros(1)]}) == \
        {"a": shardings["w"], "b": [None]}


def test_path_to_str_is_the_reference_path(jax_model):
    _, jparams = jax_model
    want = {jtp.path_to_str(path) for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {tensor_parallel.path_to_str(n) for n in params_from_jax(jparams, device="cpu")} == want


def test_zero_stages_lower_as_the_reference():
    for stage in range(4):
        got, want = ZeroPlugin(zero_stage=stage).to_fsdp_plugin(), \
            JZeroPlugin(zero_stage=stage).to_fsdp_plugin()
        for attr in ("shards_params", "shards_opt_state", "shards_grads", "hybrid",
                     "min_weight_size", "cpu_offload", "offload_optimizer"):
            assert getattr(got, attr) == getattr(want, attr), (stage, attr)
        assert got.sharding_strategy.value == want.sharding_strategy.value
    with pytest.raises(ValueError):
        ZeroPlugin(zero_stage=5)
    for strategy in STRATEGIES:
        got, want = FullyShardedDataParallelPlugin(sharding_strategy=strategy), \
            JFSDP(sharding_strategy=strategy)
        assert (got.shards_params, got.shards_opt_state, got.shards_grads, got.hybrid) == \
            (want.shards_params, want.shards_opt_state, want.shards_grads, want.hybrid)


def test_later_model_parallel_degrees_raise():
    # pp, sp and ep are ported (ROADMAP 9e-ii a-c): each degree is taken as
    # the JAX plugin takes it
    for kw in (dict(pp_degree=2), dict(sp_degree=2), dict(expert_parallel_degree=2),
               dict(tp_degree=2), dict(pp_degree=2, sp_degree=2, num_micro_batches=4)):
        got, want = ModelParallelPlugin(**kw), JModelParallelPlugin(**kw)
        assert got.model_parallel_size == want.model_parallel_size
        assert got.num_micro_batches == want.num_micro_batches


# -------------------------------------------------------------- train parity
def _dataset():
    return np.random.default_rng(0).integers(1, 256, (ROWS * CALLS, SEQ)).astype(np.int32)


def _jax_case(jmodel, jparams, case):
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)
    kw = {}
    if case.get("fsdp"):
        kw["fsdp_plugin"] = JFSDP(**case["fsdp"])
    if case.get("zero") is not None:
        kw["deepspeed_plugin"] = JZeroPlugin(zero_stage=case["zero"])
    if case.get("tp"):
        kw["megatron_lm_plugin"] = JModelParallelPlugin(tp_degree=case["tp"])
    acc = JAccelerator(gradient_accumulation_steps=2, mesh=dict(case["mesh"]), **kw)
    try:
        state = acc.create_train_state(params=jparams, tx=optax.adamw(
            HYPER["lr"], b1=HYPER["betas"][0], b2=HYPER["betas"][1], eps=HYPER["eps"],
            weight_decay=HYPER["wd"]))
        ids = _dataset()
        loader = acc.prepare(JSimpleDataLoader([{"input_ids": r} for r in ids],
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
        eval_loss = float(acc.compile_eval_step(jlm_loss_fn(jmodel))(
            state, {"input_ids": ids[:ROWS]}))
        return records, eval_loss
    finally:
        JGradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)


def _load(out_dir, tag, world):
    import pickle

    out = []
    for r in range(world):
        with open(out_dir / f"{tag}_rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(jax_model, tmp_path_factory):
    """Both packages over every case: the port's two worlds in a thread
    (their ranks are processes) while the JAX package runs here."""
    jmodel, jparams = jax_model
    out_dir = tmp_path_factory.mktemp("sharding")
    ids = _dataset()
    errors = []

    def port():
        try:
            for world in (2, 4):
                cases = [dict(tag=tag, **{k: v for k, v in c.items() if k != "world"})
                         for tag, c in CASES.items() if c["world"] == world]
                debug_launcher(workers.train_cases,
                               (str(out_dir), cases, jparams, ids, ROWS, HYPER),
                               num_processes=world)
        except BaseException as e:  # noqa: BLE001 (re-raised in the test process)
            errors.append(e)

    thread = threading.Thread(target=port)
    thread.start()
    jax_runs, jax_evals = {}, {}
    for tag, case in CASES.items():
        jax_runs[tag], jax_evals[tag] = _jax_case(jmodel, jparams, case)
    thread.join()
    if errors:
        raise errors[0]
    port_runs = {tag: _load(out_dir, tag, case["world"]) for tag, case in CASES.items()}
    return jax_runs, port_runs, jax_evals


@pytest.mark.parametrize("tag", list(CASES))
def test_losses_and_grad_norms_match_jax(runs, tag):
    jax_runs, port_runs, _ = runs
    want = jax_runs[tag]
    for rank_out in port_runs[tag]:
        got = rank_out["records"]
        assert len(got) == len(want) == CALLS
        for g, w in zip(got, want):
            assert g["applied"] == w["applied"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL_METRIC)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL_METRIC)
    assert sum(r["applied"] for r in want) == CALLS // 2


@pytest.mark.parametrize("tag", list(CASES))
def test_params_match_jax_after_every_applied_step(runs, tag):
    jax_runs, port_runs, _ = runs
    want = [r["params"] for r in jax_runs[tag] if r["applied"]]
    for rank_out in port_runs[tag]:
        got = [r["params"] for r in rank_out["records"] if r["applied"]]
        assert len(got) == len(want) == CALLS // 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for name in w:
                np.testing.assert_allclose(g[name], w[name], rtol=0, atol=ATOL_PARAM,
                                           err_msg=f"{tag}: {name}")


@pytest.mark.parametrize("tag", list(CASES))
def test_eval_step_matches_jax(runs, tag):
    """``compile_eval_step`` on the trained sharded state (its blocks
    gathered as the train step gathers them), each rank on its rows, the
    ranks' losses averaged: the JAX eval step's loss of the global batch."""
    _, port_runs, jax_evals = runs
    for rank_out in port_runs[tag]:
        np.testing.assert_allclose(rank_out["eval_loss"], jax_evals[tag], rtol=RTOL_METRIC)


@pytest.mark.parametrize("tag", list(CASES))
def test_each_rank_computes_its_mesh_positions_rows(runs, tag):
    """Rank ``i`` of ``n`` data shards gets rows ``[i b, (i + 1) b)`` of each
    global batch, the rows the reference places on mesh position ``i``;
    ranks that differ on ``tp`` only get the same rows."""
    _, port_runs, _ = runs
    ids = _dataset()
    case = CASES[tag]
    mesh = case["mesh"]
    n_data = mesh.get("dp", 1) * mesh.get("fsdp", 1)
    rows = ROWS // n_data
    for rank, rank_out in enumerate(port_runs[tag]):
        shard = rank // mesh.get("tp", 1)
        for call, rec in enumerate(rank_out["records"]):
            lo = call * ROWS + shard * rows
            np.testing.assert_array_equal(rec["rows"], ids[lo:lo + rows, 0])
        assert rank_out["mesh"] == {k: v for k, v in mesh.items() if v != 1 or k == "dp"}


def test_placements_follow_the_strategy(runs):
    """FULL_SHARD holds parameter blocks, SHARD_GRAD_OP and ZeRO-1/2 whole
    parameters with sharded optimizer state (masters), NO_SHARD and ZeRO-0
    nothing sharded; distributed_type is the reference's promotion."""
    _, port_runs, _ = runs
    name = "layers.0.mlp.up_proj.weight"
    full = port_runs["full_shard"][0]
    # the kernel [64, 128] shards its larger dim, out: the torch weight's dim 0
    assert full["shardings"][name] == ((64, 64), ("fsdp", None))
    assert not any(full["masters"].values())
    for tag in ("shard_grad_op", "zero1", "zero2"):
        out = port_runs[tag][0]
        assert out["shardings"][name] == ((128, 64), (None, None))
        assert out["masters"][name]
    for tag in ("no_shard", "zero0", "dp2"):
        out = port_runs[tag][0]
        assert all(spec == (None,) * len(shape) for shape, spec in out["shardings"].values())
        assert not any(out["masters"].values())
    tp = port_runs["fsdp2_tp2"][0]["shardings"]
    assert tp["layers.0.attn.q_proj.weight"] == ((32, 32), ("tp", "fsdp"))
    assert tp["layers.0.attn.o_proj.weight"] == ((32, 32), ("fsdp", "tp"))
    assert tp["embed_tokens.weight"] == ((64, 64), (("tp", "fsdp"), None))
    assert port_runs["zero2"][0]["distributed_type"] == "ZERO"
    assert port_runs["full_shard"][0]["distributed_type"] == "FSDP"
    assert port_runs["dp2"][0]["distributed_type"] == "MULTI_CPU"
    assert port_runs["fsdp2_tp2"][0]["distributed_type"] == "FSDP"


def test_offloaded_optimizer_streams_each_ranks_shard(runs):
    _, port_runs, _ = runs
    for out in port_runs["fsdp2_offload"]:
        assert out["optimizer"] == "ChunkedOptimizer" and out["chunks"] >= 1
        assert out["shardings"]["layers.0.mlp.up_proj.weight"] == ((64, 64), ("fsdp", None))


def test_zero1_and_zero2_agree(runs):
    _, port_runs, _ = runs
    one, two = port_runs["zero1"][0]["records"], port_runs["zero2"][0]["records"]
    np.testing.assert_allclose([r["loss"] for r in one], [r["loss"] for r in two], rtol=1e-5)
    for a, b in zip(one, two):
        if a["applied"]:
            for name in a["params"]:
                np.testing.assert_allclose(a["params"][name], b["params"][name], rtol=1e-5,
                                           atol=1e-7)
