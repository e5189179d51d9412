"""Port parity across processes: Mixture-of-Experts over ``ep`` (expert parallelism).

``ep`` is not a data axis: every ``ep`` rank routes the same tokens, and the
stacked experts' leading dim is cut over ``ep`` (``expert_partition_spec``,
composed with ``fsdp``).  One world of 4 ``gloo`` processes
(``debug_launcher``; rank functions in ``tests/torch_dist_workers.py``) trains
``TransformerConfig.tiny_moe`` (f32) through the ``Accelerator`` on
``{"dp": 2, "ep": 2}`` and ``{"fsdp": 2, "ep": 2}`` (FULL_SHARD), and a
3-expert model whose experts do not split over ``ep`` (they stay whole, as
``tests/test_moe.py::test_indivisible_experts_falls_back`` has the JAX
package keep them); the JAX Accelerator trains the same weights on the same
batches here, on the conftest's CPU devices with the same axes.  Losses and
grad norms within ``RTOL_METRIC = 2e-5``, weights after each applied step
within ``ATOL_PARAM = 2e-5`` (the f32 train tolerances of
``tests/test_torch_accelerator.py``).  The placement of every expert block
is the JAX package's; a checkpoint saved mid-window under ``ep = 2``
restores in one process, and the reverse, bit for bit.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.data_loader import SimpleDataLoader as JSimpleDataLoader
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from accelerate_tpu.parallel import moe as jmoe
from accelerate_tpu.parallel import tensor_parallel as jtp
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JFSDP
from accelerate_tpu.utils.dataclasses import ModelParallelPlugin as JModelParallelPlugin
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel import moe, sharding
from accelerate_tpu_torch.parallel.mesh import Mesh, local_slice
from accelerate_tpu_torch.weights import params_from_jax

import torch_dist_workers as workers

RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
ROWS, SEQ, CALLS = 8, 16, 4
HYPER = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-6, wd=0.1, max_grad_norm=0.5)
WORLD = 4
MOE = dict(num_experts=4, num_experts_per_tok=2)
MOE3 = dict(num_experts=3, num_experts_per_tok=2)
FSDP = dict(sharding_strategy="FULL_SHARD", min_weight_size=2**10)
TRAIN_CASES = {
    "ep2_dp2": dict(mesh={"dp": 2, "ep": 2}, mp=dict(expert_parallel_degree=2), model="moe",
                    cfg=MOE),
    "ep2_fsdp2": dict(mesh={"fsdp": 2, "ep": 2}, mp=dict(expert_parallel_degree=2),
                      model="moe", cfg=MOE, fsdp=FSDP),
    "ep2_indivisible": dict(mesh={"dp": 2, "ep": 2}, mp=dict(expert_parallel_degree=2),
                            model="moe3", cfg=MOE3),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """The JAX train step beats the process-wide flight recorder's heartbeat;
    with telemetry off a later ``/healthz`` check in this process does not
    find it stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


def _dataset():
    return np.random.default_rng(0).integers(1, 256, (ROWS * CALLS, SEQ)).astype(np.int32)


def _jmesh(axes):
    return jbuild_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _reset_jax():
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


@pytest.fixture(scope="module")
def jparams_by_model():
    out = {}
    for name, kw in (("moe", MOE), ("moe3", MOE3)):
        cfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
        params = JTransformer(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        out[name] = jax.tree_util.tree_map(np.asarray, params["params"])
    return out


def _jax_train(jparams, case):
    _reset_jax()
    try:
        model = JTransformer(JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                          **case["cfg"]))
        kw = {"fsdp_plugin": JFSDP(**case["fsdp"])} if case.get("fsdp") else {}
        acc = JAccelerator(gradient_accumulation_steps=2, mesh=dict(case["mesh"]),
                           megatron_lm_plugin=JModelParallelPlugin(**case["mp"]), **kw)
        state = acc.create_train_state(params=jparams, tx=optax.adamw(
            HYPER["lr"], b1=HYPER["betas"][0], b2=HYPER["betas"][1], eps=HYPER["eps"],
            weight_decay=HYPER["wd"]))
        loader = acc.prepare(JSimpleDataLoader([{"input_ids": r} for r in _dataset()],
                                               batch_size=ROWS))
        step = acc.compile_train_step(jlm_loss_fn(model), max_grad_norm=HYPER["max_grad_norm"])
        records = []
        for batch in loader:
            state, m = step(state, batch)
            rec = {k: float(np.asarray(m[k])) for k in ("loss", "grad_norm")}
            rec["applied"] = bool(np.asarray(m["applied"]))
            if rec["applied"]:
                rec["params"] = {k: v.numpy() for k, v in params_from_jax(
                    jax.device_get(state.params), device="cpu").items()}
            records.append(rec)
        specs = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            specs[jtp.path_to_str(path)] = tuple(leaf.sharding.spec)
        return records, specs
    finally:
        _reset_jax()


@pytest.fixture(scope="module")
def runs(jparams_by_model, tmp_path_factory):
    """A one-process checkpoint (here), the port's world in a thread while
    the JAX package trains here, then the world's ``ep`` checkpoint restored
    here."""
    out_dir = tmp_path_factory.mktemp("moe_ep")
    ids = _dataset()
    ckpt_single, ckpt_ep = str(out_dir / "ckpt_single"), str(out_dir / "ckpt_ep")
    single = workers.train_single(jparams_by_model["moe"], MOE, ids, ROWS, HYPER, 3,
                                  save=ckpt_single)
    train = [dict(tag=t, **c) for t, c in TRAIN_CASES.items()]
    train += [dict(tag="save_ep", calls=3, save=ckpt_ep, **TRAIN_CASES["ep2_dp2"]),
              dict(tag="load_ep", load=ckpt_single, **TRAIN_CASES["ep2_dp2"])]
    errors = []

    def port():
        try:
            debug_launcher(workers.mp_train_cases,
                           (str(out_dir), train, jparams_by_model, ids, ROWS, HYPER),
                           num_processes=WORLD)
        except BaseException as e:  # noqa: BLE001 (re-raised in the test process)
            errors.append(e)

    thread = threading.Thread(target=port)
    thread.start()
    want = {t: _jax_train(jparams_by_model[c["model"]], c) for t, c in TRAIN_CASES.items()}
    thread.join()
    if errors:
        raise errors[0]
    got = {t: workers.load_ranks(out_dir, t, WORLD)
           for t in [*TRAIN_CASES, "save_ep", "load_ep"]}
    restored = workers.restore_single(jparams_by_model["moe"], MOE, HYPER, ckpt_ep)
    return want, got, single, restored


@pytest.mark.parametrize("tag", list(TRAIN_CASES))
def test_expert_parallel_step_matches_jax(runs, tag):
    want, got, _, _ = runs
    records, _ = want[tag]
    for rank_out in got[tag]:
        recs = rank_out["records"]
        assert len(recs) == len(records) == CALLS
        for g, w in zip(recs, records):
            assert g["applied"] == w["applied"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL_METRIC)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL_METRIC)
            if w["applied"]:
                for name in w["params"]:
                    np.testing.assert_allclose(g["params"][name], w["params"][name], rtol=0,
                                               atol=ATOL_PARAM, err_msg=f"{tag}: {name}")


@pytest.mark.parametrize("tag", list(TRAIN_CASES))
def test_expert_blocks_are_the_jax_placement(runs, tag):
    """Each parameter's placement, mapped to the JAX dims, is the JAX train
    state's; the experts are cut over ``ep`` (their MoE layer marked to
    compute its own) unless they do not divide."""
    want, got, _, _ = runs
    _, specs = want[tag]
    indivisible = tag == "ep2_indivisible"
    for rank_out in got[tag]:
        for name, (shape, spec) in rank_out["shardings"].items():
            path = workers_path(name)
            jspec = specs[path] + (None,) * (len(shape) - len(specs[path]))
            logical = sharding.to_logical_spec(name, spec, len(shape))
            assert tuple(logical) == jspec, (name, logical, jspec)
        cut = rank_out["experts_cut"]
        assert cut and all(v != indivisible for v in cut.values()), cut


def workers_path(name):
    from accelerate_tpu_torch.parallel.tensor_parallel import path_to_str

    return path_to_str(name)


def test_checkpoints_restore_across_ep_bitwise(runs):
    """An ``ep = 2`` checkpoint (each rank writing its experts' block)
    restored in one process, and a one-process checkpoint restored under
    ``ep = 2``: every weight, optimizer-state tensor and buffer bit for bit."""
    _, got, single, restored = runs
    union = {"params": {}, "opt": {}, "grads": {}}
    for rank_out in got["save_ep"]:
        for key in union:
            union[key].update(rank_out["held"][key])
    assert union["params"].keys() == restored["params"].keys()
    for name in restored["params"]:
        assert np.array_equal(union["params"][name], restored["params"][name]), name
        for k in restored["opt"][name]:
            assert np.array_equal(union["opt"][name][k], restored["opt"][name][k]), (name, k)
        if name in restored["grads"]:
            assert np.array_equal(union["grads"][name], restored["grads"][name]), name
    for rank_out in got["load_ep"]:
        held = rank_out["held"]
        for name in held["params"]:
            assert np.array_equal(held["params"][name], single["params"][name]), name
            for k in held["opt"][name]:
                assert np.array_equal(held["opt"][name][k], single["opt"][name][k]), (name, k)


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 2}, {"fsdp": 2, "ep": 2}, {"ep": 4},
                                  {"ep": 1, "dp": 4}])
def test_shard_moe_params_places_as_jax(jparams_by_model, axes):
    """``shard_moe_params`` on a name -> tensor dict: each expert tensor's
    block and spec at every mesh position are the JAX package's placement of
    the same leaf; other tensors are left as they are."""
    jparams = jparams_by_model["moe"]
    jmesh = _jmesh(axes)
    placed = jmoe.shard_moe_params(jparams, jmesh)
    port = params_from_jax(jparams, device="cpu")
    mesh = Mesh(dict(jmesh.shape))
    got = moe.shard_moe_params(port, mesh)
    jspecs = {jtp.path_to_str(p): leaf
              for p, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]}
    for name, t in port.items():
        leaf = jspecs[workers_path(name)]
        if "experts" not in name.split(".") or mesh.shape.get("ep", 1) <= 1:
            assert got[name] is t
            continue
        spec = tuple(got[name].atpu_sharding.spec)
        assert spec + (None,) * (t.ndim - len(spec)) == \
            tuple(leaf.sharding.spec) + (None,) * (t.ndim - len(leaf.sharding.spec))
        assert spec[0] == "ep"
        for shard in leaf.addressable_shards:
            pos = np.argwhere(np.asarray(jmesh.devices) == shard.device)[0]
            coord = dict(zip(jmesh.axis_names, (int(i) for i in pos)))
            block = t[local_slice(mesh, got[name].atpu_sharding.spec, t.shape, coord)]
            np.testing.assert_array_equal(block.numpy(), np.asarray(shard.data))
