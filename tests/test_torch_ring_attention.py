"""Port parity across processes: ring attention over ``sp`` and a ring model's train step.

The port's ``ring_attention_sharded`` runs in one world of 4 ``gloo``
processes spawned through ``debug_launcher`` (``tests/torch_dist_workers.py``
holds the rank functions), over ``{"sp": 4}`` and ``{"dp": 2, "sp": 2}``
meshes; the JAX package's runs here on the conftest's CPU devices with the
same axes.  Both take the same numpy inputs from a seed (f32): contiguous
and zig-zag layouts, causal and not, GQA, segment ids, remat; the output
and the gradients of ``sum(out * dout)`` (``jax.vjp``) agree within
``ATOL = RTOL = 2e-5`` (each chunk pair's flash output merged by its
logsumexp against the reference's ``(m, l, pv)`` merge: summation order).
A ring model (``TransformerConfig(attention_impl="ring")``, both layouts)
trains through the ``Accelerator`` on ``{"dp": 2, "sp": 2}`` against the JAX
Accelerator's zig-zag ring on the same mesh (the layouts compute the same
function): losses and grad norms within ``RTOL_METRIC = 2e-5``,
weights after each applied step within ``ATOL_PARAM = 2e-5`` (the f32
train tolerances of ``tests/test_torch_accelerator.py``).  The refusals are
the reference's, with its exception types.  The plain versions'
``kv_segment_ids`` are held to a numpy formula, and ``chip_smoke.py``'s
one-process ring decomposition (the card's ``dist_sp2`` noise reference) to
the JAX package's attention.
"""

import importlib
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
from accelerate_tpu.ops.attention import dot_product_attention as jdpa
from accelerate_tpu.parallel.mesh import build_mesh as jbuild_mesh
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils.dataclasses import ModelParallelPlugin as JModelParallelPlugin
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.models.transformer import TransformerConfig
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops.attention import dot_product_attention
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.weights import params_from_jax

import torch_dist_workers as workers

# the modules (each package's parallel/__init__ exports a function of the name)
jring = importlib.import_module("accelerate_tpu.parallel.ring_attention")
ring = importlib.import_module("accelerate_tpu_torch.parallel.ring_attention")

ATOL = RTOL = 2e-5
RTOL_METRIC = 2e-5
ATOL_PARAM = 2e-5
ROWS, SEQ, CALLS = 4, 16, 4
HYPER = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-6, wd=0.1, max_grad_norm=0.5)
WORLD = 4

SP4, DP2_SP2 = {"sp": 4}, {"dp": 2, "sp": 2}
RING_CASES = {
    "sp4_contiguous_causal_seg": dict(mesh=SP4, layout="contiguous", causal=True,
                                      arrays="mha", seg=True),
    "sp4_zigzag_gqa_seg": dict(mesh=SP4, layout="zigzag", causal=True, arrays="gqa", seg=True),
    "sp4_full_seg": dict(mesh=SP4, layout="contiguous", causal=False, arrays="gqa", seg=True),
    "sp4_zigzag_remat": dict(mesh=SP4, layout="zigzag", causal=True, arrays="gqa", remat=True),
    "sp2_zigzag_gqa_seg": dict(mesh=DP2_SP2, layout="zigzag", causal=True, arrays="gqa",
                               seg=True),
}
#: both layouts, with and without per-layer remat, compute the same
#: function: each is held to the JAX package's zig-zag step
TRAIN_CASES = {
    "ring_zigzag": dict(mesh=DP2_SP2, mp=dict(sp_degree=2),
                        cfg=dict(attention_impl="ring", ring_attention_layout="zigzag")),
    "ring_contiguous": dict(mesh=DP2_SP2, mp=dict(sp_degree=2),
                            cfg=dict(attention_impl="ring")),
    # each layer's recompute runs the ring again in the backward
    "ring_zigzag_remat": dict(mesh=DP2_SP2, mp=dict(sp_degree=2),
                              cfg=dict(attention_impl="ring", ring_attention_layout="zigzag",
                                       remat=True)),
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


def _arrays():
    rng = np.random.default_rng(0)
    out = {}
    for name, hkv in (("mha", 4), ("gqa", 2)):
        b, s, h, d = 2, SEQ, 4, 16
        out[name] = {
            "q": rng.standard_normal((b, s, h, d)).astype(np.float32),
            "k": rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            "v": rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            "dout": rng.standard_normal((b, s, h, d)).astype(np.float32),
            "seg": np.array([[0] * 5 + [1] * 6 + [2] * 5, [0] * 9 + [1] * 7], np.int32),
        }
    return out


def _dataset():
    return np.random.default_rng(0).integers(1, 256, (ROWS * CALLS, SEQ)).astype(np.int32)


def _jmesh(axes):
    return jbuild_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _jax_ring(case, arrays):
    a = arrays[case["arrays"]]
    mesh = _jmesh(case["mesh"])
    seg = jnp.asarray(a["seg"]) if case.get("seg") else None

    def f(q, k, v):
        return jring.ring_attention_sharded(q, k, v, mesh, causal=case["causal"],
                                           segment_ids=seg, layout=case["layout"],
                                           remat=case.get("remat", False))

    out, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in ("q", "k", "v")))
    dq, dk, dv = vjp(jnp.asarray(a["dout"]))
    return {k: np.asarray(v) for k, v in dict(out=out, dq=dq, dk=dk, dv=dv).items()}


def _reset_jax():
    JGradientState._reset_state()
    JAcceleratorState._reset_state(reset_partial_state=True)


def _reset_port():
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _jax_train(jparams, case):
    _reset_jax()
    try:
        jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **case["cfg"])
        model = JTransformer(jcfg)
        acc = JAccelerator(gradient_accumulation_steps=2, mesh=dict(case["mesh"]),
                           megatron_lm_plugin=JModelParallelPlugin(**case["mp"]))
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
        return records
    finally:
        _reset_jax()


@pytest.fixture(scope="module")
def jparams():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32)
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def runs(jparams, tmp_path_factory):
    """The port's world runs every case (its ranks are processes) in a
    thread while the JAX package computes the same here."""
    out_dir = tmp_path_factory.mktemp("ring")
    arrays = _arrays()
    errors = []

    def port():
        try:
            steps = [
                ("ring_cases", (str(out_dir), [dict(tag=t, **c) for t, c in RING_CASES.items()],
                                arrays)),
                ("mp_train_cases", (str(out_dir), [dict(tag=t, **c)
                                                   for t, c in TRAIN_CASES.items()],
                                    {"dense": jparams}, _dataset(), ROWS, HYPER)),
                ("ring_refusals", (str(out_dir),)),
            ]
            debug_launcher(workers.sequence, (steps,), num_processes=WORLD)
        except BaseException as e:  # noqa: BLE001 (re-raised in the test process)
            errors.append(e)

    thread = threading.Thread(target=port)
    thread.start()
    want = {tag: _jax_ring(case, arrays) for tag, case in RING_CASES.items()}
    jax_step = _jax_train(jparams, TRAIN_CASES["ring_zigzag"])
    want_train = {tag: jax_step for tag in TRAIN_CASES}
    thread.join()
    if errors:
        raise errors[0]
    return want, want_train, {t: workers.load_ranks(out_dir, t, WORLD)
                              for t in [*RING_CASES, *TRAIN_CASES, "refusals"]}


# ------------------------------------------------------------------ the ring
@pytest.mark.parametrize("tag", list(RING_CASES))
def test_ring_output_and_gradients_match_jax(runs, tag):
    """Every rank returns the whole output and the whole gradients."""
    want, _, got = runs
    for rank_out in got[tag]:
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(rank_out[key], want[tag][key], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag}: {key}")


@pytest.mark.parametrize("n,seq", [(2, 16), (4, 16), (4, 24), (3, 12)])
def test_zigzag_permutations_match_jax(n, seq):
    np.testing.assert_array_equal(ring.zigzag_permutation(seq, n),
                                  np.asarray(jring.zigzag_permutation(seq, n)))
    np.testing.assert_array_equal(ring.inverse_zigzag_permutation(seq, n),
                                  np.asarray(jring.inverse_zigzag_permutation(seq, n)))
    local = seq // n
    got = np.concatenate([ring.shard_positions(seq, n, r, "zigzag") for r in range(n)])
    np.testing.assert_array_equal(got, ring.zigzag_permutation(seq, n))
    assert list(ring.shard_positions(seq, n, 1, "contiguous")) == list(range(local, 2 * local))
    with pytest.raises(ValueError, match="zig-zag"):
        ring.zigzag_permutation(seq + 2, n)
    with pytest.raises(ValueError, match="zig-zag"):
        jring.zigzag_permutation(seq + 2, n)


# ------------------------------------------------------------ the train step
@pytest.mark.parametrize("tag", list(TRAIN_CASES))
def test_ring_train_step_matches_jax(runs, tag):
    """The ring model's loss is the global token mean on every rank; its
    weights after every applied step are the JAX step's."""
    _, want_train, got = runs
    want = want_train[tag]
    for rank_out in got[tag]:
        recs = rank_out["records"]
        assert len(recs) == len(want) == CALLS
        for g, w in zip(recs, want):
            assert g["applied"] == w["applied"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL_METRIC)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL_METRIC)
            if w["applied"]:
                for name in w["params"]:
                    np.testing.assert_allclose(g["params"][name], w["params"][name], rtol=0,
                                               atol=ATOL_PARAM, err_msg=f"{tag}: {name}")
        assert rank_out["mesh"] == DP2_SP2


# ------------------------------------------------------------------ refusals
def test_refusals_across_processes_are_the_references(runs):
    """On a ``dp=2 x sp=2`` mesh: attention over a whole sequence that does
    not split over sp raises ``ValueError``, as the JAX package's does; a
    whole-sequence batch-1 forward warns and computes unsharded (the flash
    arm: a ring of one); a whole-sequence forward that splits runs the ring
    unwarned and matches the JAX package's (``ring_attention_sharded`` in
    both); a zig-zag ring loss on a sequence not divisible by ``2 sp``
    raises; a loss not marked ``_sp_aware`` is refused by
    ``compile_train_step``."""
    _, _, got = runs
    ref = got["refusals"][0]
    _reset_jax()
    try:
        jacc = JAccelerator(mesh=dict(DP2_SP2), megatron_lm_plugin=JModelParallelPlugin(
            sp_degree=2))
        q = jnp.zeros((2, 15, 4, 16))
        with pytest.raises(ValueError, match="requires seq") as jerr:
            jdpa(q, q, q, implementation="ring")
        jwhole = np.asarray(jdpa(*map(jnp.asarray, workers.ring_whole_inputs()),
                                 implementation="ring", ring_layout="zigzag"))
        jmodel = JTransformer(JConfig.tiny())
        with pytest.raises(ValueError, match="sp axis") as jguard:
            jacc.compile_train_step(lambda p, b: 0.0)
        del jmodel
    finally:
        _reset_jax()
    assert ref["indivisible_seq"] == ("ValueError", str(jerr.value))
    assert ref["guard"][0] == "ValueError" and "sp axis of size 2" in ref["guard"][1]
    assert ref["zigzag_seq"][0] == "ValueError" and "2*sp" in ref["zigzag_seq"][1]
    assert ref["batch1_warned"] and ref["batch1_close"]
    for rank_out in got["refusals"]:
        assert not rank_out["whole_seq_warned"]
        np.testing.assert_allclose(rank_out["whole_seq"], jwhole, rtol=RTOL, atol=ATOL)
    assert "sp axis of size 2" in str(jguard.value)


def test_no_active_mesh_raises_as_jax():
    _reset_port()
    _reset_jax()
    q = np.zeros((1, 8, 4, 16), np.float32)
    with pytest.raises(ValueError, match="needs the active mesh") as err:
        dot_product_attention(*(torch.from_numpy(q),) * 3, implementation="ring")
    with pytest.raises(ValueError, match="needs the active mesh") as jerr:
        jdpa(*(jnp.asarray(q),) * 3, implementation="ring")
    assert str(err.value) == str(jerr.value)


def test_ring_without_an_sp_axis_is_the_xla_math():
    """On a one-process mesh the ring arm is a ring of one, its diagonal
    pair: the flash kernels' arm (their plain versions on the CPU), which
    computes the reference's fall-through to XLA attention."""
    from accelerate_tpu_torch.accelerator import Accelerator

    _reset_port()
    try:
        Accelerator(cpu=True)
        rng = np.random.default_rng(3)
        arrays = [rng.standard_normal((2, 8, 4, 16)).astype(np.float32) for _ in range(3)]
        q, k, v = map(torch.from_numpy, arrays)
        got = dot_product_attention(q, k, v, implementation="ring")
        assert torch.equal(got, dot_product_attention(q, k, v, implementation="pallas"))
        want = jdpa(*map(jnp.asarray, arrays), implementation="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    finally:
        _reset_port()


def test_config_refusals_match_jax():
    assert TransformerConfig.tiny(attention_impl="ring").attention_impl == "ring"
    with pytest.raises(ValueError, match="ring_attention_layout"):
        TransformerConfig.tiny(ring_attention_layout="spiral")
    with pytest.raises(ValueError, match="ring_attention_layout"):
        JConfig.tiny(ring_attention_layout="spiral")
    with pytest.raises(NotImplementedError, match="'xla' only"):
        dot_product_attention(*(torch.zeros(1, 4, 2, 16),) * 3, implementation="ring",
                              window=2)


# -------------------------------------------------------- kv segment ids
def _numpy_attention(q, k, v, qs, ks, causal, scale):
    """Dense attention with the keys' own segment ids, in float64: the
    output and each row's logsumexp over the keys it sees."""
    b, sq, h, d = q.shape
    rep = h // k.shape[2]
    kk, vv = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    keep = qs[:, None, :, None] == ks[:, None, None, :]
    if causal:
        keep = keep & np.tril(np.ones((sq, k.shape[1]), bool))[None, None]
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    lse = (m + np.log(p.sum(-1, keepdims=True)))[..., 0]
    out = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vv)
    return out, lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
def test_kv_segment_ids_plain_versions_match_numpy(causal, hkv):
    """The keys' own ids: every query sees the keys of its id (and, causal,
    no later one); the plain K3 against a float64 numpy formula, the plain
    K4/K5 against autograd of a dense torch formula; without
    ``kv_segment_ids`` the queries' ids serve both, bitwise as before."""
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 12, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    qs = np.array([[0] * 4 + [1] * 4 + [2] * 4, [0] * 6 + [1] * 6], np.int32)
    # every query sees a key of its id, causal too
    ks = np.array([[0] * 2 + [1] * 3 + [2] * 7, [0] * 3 + [1] * 9], np.int32)
    scale = d ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    kw = dict(causal=causal, segment_ids=torch.from_numpy(qs),
              kv_segment_ids=torch.from_numpy(ks))
    out, lse = fa.flash_attention_reference(tq, tk, tv, **kw)
    want_out, want_lse = _numpy_attention(q.astype(np.float64), k.astype(np.float64),
                                          v.astype(np.float64), qs, ks, causal, scale)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    # gradients: autograd through a dense masked softmax
    xq, xk, xv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    rep = h // hkv
    sc = torch.einsum("bqhd,bkhd->bhqk", xq, xk.repeat_interleave(rep, 2)) * scale
    keep = torch.from_numpy(qs)[:, None, :, None] == torch.from_numpy(ks)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(torch.where(keep, sc, -torch.inf), dim=-1)
    dense = torch.einsum("bhqk,bkhd->bqhd", p, xv.repeat_interleave(rep, 2))
    dense.backward(tdo)
    delta = fa.flash_delta(out, tdo)
    dq = fa.flash_dq_reference(tq, tk, tv, tdo, lse, delta, **kw)
    dk, dv = fa.flash_dkv_reference(tq, tk, tv, tdo, lse, delta, **kw)
    for got, want in ((dq, xq.grad), (dk, xk.grad), (dv, xv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    same = dict(causal=causal, segment_ids=torch.from_numpy(qs))
    a = fa.flash_attention_reference(tq, tk, tv, **same)
    b2 = fa.flash_attention_reference(tq, tk, tv, **same, kv_segment_ids=torch.from_numpy(qs))
    assert torch.equal(a[0], b2[0]) and torch.equal(a[1], b2[1])


# ------------------------------------------- the card check's noise reference
@pytest.mark.parametrize("n,hkv", [(2, 4), (2, 2), (4, 4)])
def test_harness_ring_decomposition_is_causal_attention(n, hkv):
    """``chip_smoke.zigzag_ring_plain_attention`` — the one-process ring
    decomposition the card's ``dist_sp2`` line takes its noise from, written
    without the port's ring code — computes causal attention: its output and
    the gradients of ``sum(out * dout)`` against the JAX package's XLA
    attention and ``jax.vjp`` (f32, ``ATOL = RTOL = 2e-5``)."""
    import chip_smoke

    rng = np.random.default_rng(9)
    b, s, h, d = 2, 16 * n, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jdpa(*a, implementation="xla"),
                        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = chip_smoke.zigzag_ring_plain_attention(*xs, n)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for x, g in zip(xs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL)
