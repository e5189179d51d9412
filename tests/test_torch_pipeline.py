"""Port parity across processes: pipeline parallelism over ``pp`` (GPipe and 1F1B).

One world of 4 ``gloo`` processes (``debug_launcher``; the rank functions
are ``tests/torch_dist_workers.py``'s) runs every case in turn over
``{"pp": 4}`` or ``{"dp": 2, "pp": 2}``; the JAX package runs the same here
on the conftest's CPU devices with the same axes, on the same numpy inputs
from a seed and the same Flax-initialised weights (f32):

* ``pipeline_apply`` (``tanh(h @ w)`` layers) at 4 and 2 stages: outputs and
  the gradients of ``sum(out * dout)`` within ``ATOL = RTOL = 2e-5``;
* ``pipeline_lm_loss_fn``, GPipe and 1F1B, at 4 and 2 stages, against the
  JAX package's GPipe loss (its 1F1B computes the same function): the loss
  within ``RTOL_METRIC = 2e-5``, the gradients (each stage's part, summed
  over the stages) within ``ATOL = RTOL = 2e-5``; tied embeddings, an MoE model's aux
  term, a ragged batch (6 rows in 4 micro-batches, both schedules) with
  ``prepare_pipeline``'s logits; 1F1B's stash within ``2(pp - 1 - s) + 1``;
* the ``Accelerator`` with ``ModelParallelPlugin(pp_degree=2)`` on
  ``{"dp": 2, "pp": 2}``, both schedules, against the JAX Accelerator's
  GPipe step (the schedules compute the same function): losses and grad
  norms within ``RTOL_METRIC``, the weights after each applied step within
  ``ATOL_PARAM = 2e-5``; each rank holds only its stage's layers;
* a checkpoint saved mid-window under ``pp = 2`` restores in one process
  (here), and one saved in one process restores under ``pp = 2``, bit for
  bit;
* the reference's refusals, with its exception types.
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
from accelerate_tpu.parallel import pipeline as jpipeline
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import ModelParallelPlugin as JModelParallelPlugin
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.parallel import pipeline
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.weights import params_from_jax

import torch_dist_workers as workers

ATOL = RTOL = 2e-5
RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
ROWS, SEQ, CALLS = 8, 16, 4
HYPER = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-6, wd=0.1, max_grad_norm=0.5)
WORLD = 4
PP4, DP2_PP2 = {"pp": 4}, {"dp": 2, "pp": 2}

MODELS = {
    "dense": dict(),
    "dense4": dict(num_layers=4),
    "tied4": dict(num_layers=4, tie_word_embeddings=True),
    "moe4": dict(num_layers=4, num_experts=4, num_experts_per_tok=2),
}
APPLY_CASES = {"apply_pp4": PP4, "apply_pp2": DP2_PP2}
LOSS_CASES = {
    f"{schedule}_{model}_{tag}": dict(mesh=mesh, schedule=schedule, model=model,
                                      cfg=MODELS[model], micro=micro, arrays=arrays,
                                      forward=arrays == "ragged" and schedule == "gpipe")
    for schedule, model, tag, mesh, micro, arrays in (
        ("gpipe", "dense4", "pp4", PP4, 4, "ids"), ("1f1b", "dense4", "pp4", PP4, 4, "ids"),
        ("1f1b", "moe4", "pp2", DP2_PP2, 2, "ids"),
        # tied embeddings on a ragged batch
        ("gpipe", "tied4", "ragged", DP2_PP2, 4, "ragged"),
        ("1f1b", "tied4", "ragged", DP2_PP2, 4, "ragged"))
}
#: both schedules compute the same function: each is held to the JAX
#: package's GPipe step
TRAIN_CASES = {
    f"step_{schedule}": dict(mesh=DP2_PP2, mp=dict(pp_degree=2, num_micro_batches=2),
                             schedule=schedule)
    for schedule in ("gpipe", "1f1b")
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


def _arrays():
    rng = np.random.default_rng(1)
    return {
        "apply": {"w": (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32),
                  "mbs": rng.standard_normal((8, 2, 16)).astype(np.float32),
                  "dout": rng.standard_normal((8, 2, 16)).astype(np.float32)},
        "ids": {"ids": rng.integers(1, 256, (8, SEQ)).astype(np.int64)},
        "ragged": {"ids": rng.integers(1, 256, (6, SEQ)).astype(np.int64)},
    }


def _jmesh(axes):
    return jbuild_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _reset_jax():
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


def _reset_port():
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _jax_apply(mesh_axes, a):
    def stage_fn(local, x):
        def body(h, layer):
            return jnp.tanh(h @ layer), None

        return jax.lax.scan(body, x, local["w"])[0]

    # the port's data ranks repeat the whole micro-batches; JAX runs the pipeline alone
    mesh = _jmesh({"pp": mesh_axes["pp"]})
    out, vjp = jax.vjp(lambda w, mbs: jpipeline.pipeline_apply(stage_fn, {"w": w}, mbs,
                                                               mesh=mesh),
                       jnp.asarray(a["w"]), jnp.asarray(a["mbs"]))
    dw, dmbs = vjp(jnp.asarray(a["dout"]))
    return {"out": np.asarray(out), "dw": np.asarray(dw), "dmbs": np.asarray(dmbs)}


def _jax_loss(case, jparams_by_model, arrays):
    """The JAX package's GPipe loss and gradients for the case: its 1F1B
    computes the same function (``tests/test_pipeline.py``'s
    ``Test1F1B``), and is not compiled again here."""
    cfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **MODELS[case["model"]])
    model = JTransformer(cfg)
    # the port's data ranks repeat the whole batch (the function splits no
    # data axis): JAX runs the pipeline alone, so an MoE's router statistics
    # and capacity are the whole micro-batch's on both sides
    mesh = _jmesh({"pp": case["mesh"]["pp"]})
    batch = {"input_ids": jnp.asarray(arrays[case["arrays"]]["ids"], jnp.int32)}
    loss_fn = jpipeline.pipeline_lm_loss_fn(model, mesh=mesh, num_microbatches=case["micro"])
    loss, grads = jax.value_and_grad(lambda p: loss_fn(p, batch))(jparams_by_model[case["model"]])
    out = {"loss": float(loss), "grads": {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(grads), device="cpu").items()}}
    if case["arrays"] == "ragged":
        fwd = jpipeline.prepare_pipeline(model, None, mesh=mesh, num_microbatches=case["micro"])
        out["logits"] = np.asarray(fwd(jparams_by_model[case["model"]], batch["input_ids"]))
    return out


def _jax_train(jparams, case):
    _reset_jax()
    try:
        model = JTransformer(JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32))
        acc = JAccelerator(gradient_accumulation_steps=2, mesh=dict(case["mesh"]),
                           megatron_lm_plugin=JModelParallelPlugin(**case["mp"]))
        state = acc.create_train_state(params=jparams, tx=optax.adamw(
            HYPER["lr"], b1=HYPER["betas"][0], b2=HYPER["betas"][1], eps=HYPER["eps"],
            weight_decay=HYPER["wd"]))
        loader = acc.prepare(JSimpleDataLoader([{"input_ids": r} for r in _dataset()],
                                               batch_size=ROWS))
        step = acc.compile_train_step(jpipeline.pipeline_lm_loss_fn(
            model, schedule=case["schedule"]), max_grad_norm=HYPER["max_grad_norm"])
        records = []
        for batch in loader:
            state, m = step(state, batch)
            rec = {k: float(np.asarray(m[k])) for k in ("loss", "grad_norm")}
            rec["applied"] = bool(np.asarray(m["applied"]))
            if rec["applied"]:
                rec["params"] = {k: v.numpy() for k, v in params_from_jax(
                    jax.device_get(state.params), device="cpu").items()}
            records.append(rec)
        return records
    finally:
        _reset_jax()


@pytest.fixture(scope="module")
def jparams_by_model():
    out = {}
    for name, kw in MODELS.items():
        cfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
        params = JTransformer(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        out[name] = jax.tree_util.tree_map(np.asarray, params["params"])
    return out


@pytest.fixture(scope="module")
def runs(jparams_by_model, tmp_path_factory):
    """A one-process checkpoint first (here), then the port's world in a
    thread while the JAX package computes the same here; after the world,
    its pipeline checkpoint restored here."""
    out_dir = tmp_path_factory.mktemp("pipeline")
    arrays = _arrays()
    ids = _dataset()
    ckpt_single, ckpt_pp = str(out_dir / "ckpt_single"), str(out_dir / "ckpt_pp")
    single = workers.train_single(jparams_by_model["dense"], None, ids, ROWS, HYPER, 3,
                                  save=ckpt_single)
    cases = [dict(tag=t, mesh=m, kind="apply", arrays="apply") for t, m in APPLY_CASES.items()]
    cases += [dict(tag=t, kind="loss", **c) for t, c in LOSS_CASES.items()]
    train = [dict(tag=t, **c) for t, c in TRAIN_CASES.items()]
    train += [dict(tag="save_pp", mesh=DP2_PP2, mp=dict(pp_degree=2, num_micro_batches=2),
                   schedule="gpipe", calls=3, save=ckpt_pp),
              dict(tag="load_pp", mesh=DP2_PP2, mp=dict(pp_degree=2, num_micro_batches=2),
                   schedule="gpipe", load=ckpt_single)]
    errors = []

    def port():
        try:
            steps = [("pipeline_fn_cases", (str(out_dir), cases, arrays, jparams_by_model)),
                     ("mp_train_cases", (str(out_dir), train, jparams_by_model, ids, ROWS,
                                         HYPER)),
                     ("pipeline_refusals", (str(out_dir),))]
            debug_launcher(workers.sequence, (steps,), num_processes=WORLD)
        except BaseException as e:  # noqa: BLE001 (re-raised in the test process)
            errors.append(e)

    thread = threading.Thread(target=port)
    thread.start()
    want = {t: _jax_apply(m, arrays["apply"]) for t, m in APPLY_CASES.items()}
    jax_losses = {}
    for t, c in LOSS_CASES.items():
        key = (c["model"], c["mesh"]["pp"], c["micro"], c["arrays"])
        if key not in jax_losses:
            jax_losses[key] = _jax_loss(c, jparams_by_model, arrays)
        want[t] = jax_losses[key]
    jax_step = _jax_train(jparams_by_model["dense"], TRAIN_CASES["step_gpipe"])
    want.update({t: jax_step for t in TRAIN_CASES})
    thread.join()
    if errors:
        raise errors[0]
    got = {t: workers.load_ranks(out_dir, t, WORLD)
           for t in [*APPLY_CASES, *LOSS_CASES, *TRAIN_CASES, "save_pp", "load_pp",
                     "refusals"]}
    restored = workers.restore_single(jparams_by_model["dense"], None, HYPER, ckpt_pp)
    return want, got, single, restored


def _coordinate(rank, mesh):
    """A rank's ``{axis: index}`` on a mesh laid over ranks in row-major order."""
    out = {}
    for axis, size in reversed(list(mesh.items())):
        out[axis] = rank % size
        rank //= size
    return out


# ------------------------------------------------------------ the functions
@pytest.mark.parametrize("tag", list(APPLY_CASES))
def test_pipeline_apply_matches_jax(runs, tag):
    """Every rank returns the whole output; each stage's gradients are its
    part (its layers', and the first stage's of the micro-batches): summed
    over one pipeline's stages, the JAX package's."""
    want, got, _, _ = runs
    mesh = APPLY_CASES[tag]
    for rank_out in got[tag]:
        np.testing.assert_allclose(rank_out["out"], want[tag]["out"], rtol=RTOL, atol=ATOL)
    stages = [r for i, r in enumerate(got[tag]) if _coordinate(i, mesh).get("dp", 0) == 0]
    for key in ("dw", "dmbs"):
        np.testing.assert_allclose(sum(r[key] for r in stages), want[tag][key], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag}: {key}")
    per = 8 // mesh["pp"]
    for s, rank_out in enumerate(stages):
        held = np.flatnonzero(np.abs(rank_out["dw"]).sum(axis=(1, 2)))
        assert set(held) == set(range(s * per, (s + 1) * per)), (s, held)


@pytest.mark.parametrize("tag", list(LOSS_CASES))
def test_pipelined_loss_and_gradients_match_jax(runs, tag):
    """Every rank reports the loss; the gradients of one pipeline (the ranks
    of one ``dp`` index), each stage its layers' and its part of the
    embedding's and the head's, summed, are the JAX package's."""
    want, got, _, _ = runs
    case = LOSS_CASES[tag]
    for rank_out in got[tag]:
        np.testing.assert_allclose(rank_out["loss"], want[tag]["loss"], rtol=RTOL_METRIC)
    stages = [r for i, r in enumerate(got[tag]) if _coordinate(i, case["mesh"]).get("dp", 0) == 0]
    total = {}
    for rank_out in stages:
        for name, g in rank_out["grads"].items():
            total[name] = total.get(name, 0) + g
    assert total.keys() == want[tag]["grads"].keys()
    for name, g in want[tag]["grads"].items():
        np.testing.assert_allclose(total[name], g, rtol=RTOL, atol=ATOL, err_msg=f"{tag}: {name}")
    # each stage differentiates only its own layers
    n = case["mesh"]["pp"]
    for s, rank_out in enumerate(stages):
        layers = {int(k.split(".")[1]) for k in rank_out["grads"] if k.startswith("layers.")}
        per = 4 // n
        assert layers == set(range(s * per, (s + 1) * per)), (s, layers)
    if case["forward"]:
        for rank_out in got[tag]:
            np.testing.assert_allclose(rank_out["logits"], want[tag]["logits"], rtol=RTOL,
                                       atol=ATOL)
    if case["schedule"] == "1f1b":
        for s, rank_out in enumerate(stages):
            assert 1 <= rank_out["stash_peak"] <= 2 * (n - 1 - s) + 1, (s, rank_out["stash_peak"])


@pytest.mark.parametrize("pp", [1, 2, 4, 8])
@pytest.mark.parametrize("micro", [1, 2, 4, 8])
def test_schedule_slots_match_jax(pp, micro):
    for schedule in ("gpipe", "1f1b"):
        assert pipeline.schedule_slots(schedule, micro, pp) == \
            jpipeline.schedule_slots(schedule, micro, pp)


def test_stack_layer_params_matches_jax(jparams_by_model):
    jparams = jparams_by_model["dense4"]
    want = jpipeline.stack_layer_params(jparams, 4)
    got = pipeline.stack_layer_params(params_from_jax(jparams, device="cpu"), 4)
    np.testing.assert_array_equal(got["attn.q_proj.weight"].numpy(),
                                  np.swapaxes(np.asarray(want["attn"]["q_proj"]["kernel"]), 1, 2))
    assert got["input_norm.scale"].shape == (4, 64)


# -------------------------------------------------------------- the trainer
@pytest.mark.parametrize("tag", list(TRAIN_CASES))
def test_pipelined_train_step_matches_jax(runs, tag):
    want, got, _, _ = runs
    for rank, rank_out in enumerate(got[tag]):
        recs = rank_out["records"]
        assert len(recs) == len(want[tag]) == CALLS
        for g, w in zip(recs, want[tag]):
            assert g["applied"] == w["applied"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL_METRIC)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL_METRIC)
            if w["applied"]:
                for name in w["params"]:
                    np.testing.assert_allclose(g["params"][name], w["params"][name], rtol=0,
                                               atol=ATOL_PARAM, err_msg=f"{tag}: {name}")
        # each rank holds its stage's layer and the replicated rest
        stage = _coordinate(rank, DP2_PP2)["pp"]
        held = {n for n, (shape, _) in rank_out["shardings"].items() if np.prod(shape) > 0}
        assert {n for n in held if n.startswith("layers.")} == \
            {n for n in rank_out["shardings"] if n.startswith(f"layers.{stage}.")}
        assert "embed_tokens.weight" in held and "lm_head.weight" in held


# ------------------------------------------------------------- checkpoints
def _same(a, b, names):
    for name in names:
        assert np.array_equal(a["params"][name], b["params"][name]), name
        assert a["opt"][name].keys() == b["opt"][name].keys(), name
        for k in a["opt"][name]:
            assert np.array_equal(a["opt"][name][k], b["opt"][name][k]), (name, k)
        assert (name in a["grads"]) == (name in b["grads"]), name
        if name in a["grads"]:
            assert np.array_equal(a["grads"][name], b["grads"][name]), name


def test_checkpoints_restore_across_pp_bitwise(runs):
    """A pp = 2 checkpoint (each stage writing its own layers) restored in
    one process, and a one-process checkpoint restored under pp = 2: every
    weight, optimizer-state tensor and gradient buffer bit for bit."""
    _, got, single, restored = runs
    saved = got["save_pp"]
    union = {"params": {}, "opt": {}, "grads": {}}
    for rank_out in saved:
        for key in union:
            union[key].update(rank_out["held"][key])
    assert union["params"].keys() == restored["params"].keys()
    _same(union, restored, list(restored["params"]))
    assert restored["micro_step"] == 1 and restored["step"] == 1
    for rank_out in got["load_pp"]:
        held = rank_out["held"]
        assert held["micro_step"] == single["micro_step"] == 1
        _same(held, single, list(held["params"]))


# ---------------------------------------------------------------- refusals
def test_refusals_match_jax(jparams_by_model):
    for kw in (dict(embed_norm=True), dict(positional="learned")):
        with pytest.raises(NotImplementedError, match="embed_norm / learned-position"):
            pipeline.pipeline_lm_loss_fn(Transformer(TransformerConfig.tiny(**kw),
                                                     device="meta"))
        with pytest.raises(NotImplementedError, match="embed_norm / learned-position"):
            jpipeline.pipeline_lm_loss_fn(JTransformer(JConfig.tiny(**kw)))
    model = Transformer(TransformerConfig.tiny(), device="meta")
    with pytest.raises(ValueError, match="Unknown pipeline schedule"):
        pipeline.pipeline_lm_loss_fn(model, schedule="zb")
    with pytest.raises(ValueError, match="Unknown pipeline schedule"):
        jpipeline.pipeline_lm_loss_fn(JTransformer(JConfig.tiny()), schedule="zb")
    # one stage: 1f1b has nothing to interleave
    _reset_port()
    try:
        Accelerator(cpu=True)
        dense = workers.make_model(jparams_by_model["dense"])
        ids = {"input_ids": torch.ones(4, 8, dtype=torch.long)}
        with pytest.raises(ValueError, match="needs a pp axis of size > 1"):
            pipeline.pipeline_lm_loss_fn(dense, schedule="1f1b", num_microbatches=2)(
                dict(dense.named_parameters()), ids)
    finally:
        _reset_port()
    with pytest.raises(ValueError, match="needs a pp axis of size > 1"):
        jpipeline.pipeline_lm_loss_fn(JTransformer(JConfig.tiny()), mesh=_jmesh({"pp": 1}),
                                      num_microbatches=2, schedule="1f1b")(
            jparams_by_model["dense"], {"input_ids": jnp.ones((4, 8), jnp.int32)})


def test_refusals_across_processes_match_jax(runs, jparams_by_model):
    """Layers that do not split into the stages raise ``ValueError`` (the
    loss and ``pipeline_apply``), and so does ``compile_train_step`` for a
    loss not marked ``_pp_aware``, as in the JAX package."""
    _, got, _, _ = runs
    ref = got["refusals"][0]
    mesh = _jmesh({"pp": 4})
    with pytest.raises(ValueError) as jerr:
        jpipeline.pipeline_lm_loss_fn(JTransformer(JConfig.tiny()), mesh=mesh,
                                      num_microbatches=2)(
            jparams_by_model["dense"], {"input_ids": jnp.ones((4, 8), jnp.int32)})
    assert ref["loss_layers"] == ("ValueError", str(jerr.value))
    with pytest.raises(ValueError) as jerr:
        jpipeline.pipeline_apply(lambda p, x: x, {"w": jnp.zeros((6, 2))}, jnp.zeros((2, 1, 2)),
                                 mesh=mesh)
    assert ref["apply_layers"] == ("ValueError", str(jerr.value))
    assert ref["guard"][0] == "ValueError" and "pp axis of size 2" in ref["guard"][1]


def test_1f1b_ignores_remat_with_a_warning(caplog):
    """``remat_policy`` around a 1F1B loss is ignored with a warning: the
    loss recomputes each stage already (``accelerate_tpu/accelerator.py:
    1236-1243``)."""
    import logging

    from accelerate_tpu_torch.utils.dataclasses import CompilationConfig

    _reset_port()
    try:
        acc = Accelerator(cpu=True, compilation_config=CompilationConfig(remat_policy="full"))

        def loss_fn(params, batch):
            return torch.zeros(())

        loss_fn._pp_aware = True
        loss_fn._pipeline_schedule = "1f1b"
        with caplog.at_level(logging.WARNING):
            assert acc._maybe_remat(loss_fn) is loss_fn
        assert "remat_policy is ignored for schedule='1f1b'" in caplog.text
    finally:
        _reset_port()
