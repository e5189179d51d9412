"""Port parity: interleaved prefill, cancel and deadlines on the paged engine.

* Interleave: the JAX ``ServingEngine(paged=True, decode_kernel="pallas",
  interleave_prefill=True)`` (Pallas kernels in interpret mode) and the
  port with the same knobs give identical greedy tokens and identical
  ``prefill_chunks``, ``interleaved_chunks``, ``prefix_hit_tokens``,
  ``preemptions``, ``decode_steps`` and ``prefreed_lanes``, and the same
  ``kv_quant_error`` (the JAX engine's ``serve/kv_quant_error`` gauge,
  within a relative 1e-4: the quantizers are bit-identical, their inputs
  come from two frameworks' f32 forwards), for
  native, int8 and fp8 pages, the prefix cache off and on, and a
  page-starved int8 pool that preempts.  The prompt mix keeps two prefills
  open at once (checked), and the same tokens come out with interleave
  off.  Sampled tokens are compared with the port's own interleave-off run.
* Scheduler: the port's ``Scheduler`` and the JAX one run the same seeded
  random sequences of submit, start, take, finish, cancel and step
  operations with ``max_prefills > 1``; every pick and every queue state
  is identical.
* Cancel: queued, running with a window in flight, mid-prefill, done and
  unknown, each answered as the JAX engine answers, with the same tokens
  for every request, no token of a cancelled lane streamed after its
  cancel, and every page free at the end; a cancelled queued request
  releases its pinned prefix-cache nodes.
* Deadlines, under a fake clock swapped into both engine modules (no real
  sleep): the admission shed and its ``retry_after_s``, and the sweeps of
  running and queued requests, against the JAX engine driven by the same
  clock.

The workloads are the reference's ``tests/test_serving.py`` ones: 2 slots,
buckets (4, 8), a prefill budget of 8, window 2; f32 weights.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving import engine as jengine_mod
from accelerate_tpu.serving.errors import AdmissionError as JAdmissionError
from accelerate_tpu.serving.scheduler import Request as JRequest
from accelerate_tpu.serving.scheduler import Scheduler as JScheduler
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.serving import AdmissionError, Request, RequestState, ServingEngine
from accelerate_tpu_torch.serving import Scheduler
from accelerate_tpu_torch.serving import engine as engine_mod
from accelerate_tpu_torch.weights import params_from_jax

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2)
#: ``kv_quant_error`` against the JAX engine's: the K/V values quantized
#: come from two frameworks' f32 forwards, equal to their last bits only
QERR_REL_TOL = 1e-4
COUNTERS = ("prefill_chunks", "interleaved_chunks", "prefix_hit_tokens", "preemptions",
            "decode_steps", "prefreed_lanes")


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """As in ``test_torch_engine.py``: the JAX engine beats no heartbeat
    that a later ``/healthz`` check in the same process could find stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, max_seq_len=64)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                          device="cpu"), assign=True)
    return jmodel, jparams, model


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, (n,)).astype(np.int32) for n in lens]


def _mixed_workload(seed=44):
    """The reference's interleave workload (prompts of 3, 14, 5, 22 and 9
    tokens) and its prefix-cache one (an 8-token shared prefix with tails
    of 3, 5 and 2 tokens between cold prompts of 5 and 14)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 256, 8).astype(np.int32)
    warm = [np.concatenate([shared, rng.integers(1, 256, n).astype(np.int32)])
            for n in (3, 5, 2)]
    cold = _prompts(seed + 1, (3, 14, 5, 22, 9))
    return cold[:2] + [warm[0]] + cold[2:4] + [warm[1], cold[4], warm[2]]


class _LastValue:
    """Stands in for the JAX engine's ``serve/kv_quant_error`` gauge, which
    records nothing while JAX telemetry is off: keeps the last value set."""

    value = 0.0

    def set(self, value) -> None:
        self.value = float(value)


def _jax_engine(jmodel, jparams, **kw):
    """The JAX paged engine on Pallas kernels (interpret mode) and the
    recorder of its ``kv_quant_error`` gauge (quantized pools only)."""
    eng = JServingEngine(jmodel, jparams, paged=True, decode_kernel="pallas",
                         registry=MetricsRegistry(), **{**ENGINE_KW, **kw})
    gauge = _LastValue()
    if eng._kv_quant_gauge is not None:
        eng._kv_quant_gauge = gauge
    return eng, gauge


def _port_engine(model, **kw):
    return ServingEngine(model, None, device="cpu", **{**ENGINE_KW, **kw})


def _open_prefills_watch(engine):
    """Record how many prefills are open at every chunk pick."""
    seen = []
    take = engine.scheduler.take_chunk

    def watched(*args, **kwargs):
        seen.append(len(engine.scheduler.prefills))
        return take(*args, **kwargs)

    engine.scheduler.take_chunk = watched
    return seen


INTERLEAVE_CASES = {
    f"{kv or 'native'}-cache{'on' if cache else 'off'}": dict(kv_dtype=kv, prefix_cache_mb=cache)
    for kv in (None, "int8", "fp8") for cache in (0, 16)
}
INTERLEAVE_CASES["int8-preempt"] = dict(kv_dtype="int8", prefix_cache_mb=0, num_pages=17)


@pytest.mark.parametrize("case", list(INTERLEAVE_CASES))
def test_interleaved_engine_matches_jax_engine(models, case):
    """Greedy tokens and the scheduling counters of the interleaved port
    equal the interleaved JAX engine's; so does ``kv_quant_error``; two
    prefills are open at once; the tokens equal the port's interleave-off
    serve; every page is free after a flush."""
    jmodel, jparams, model = models
    knobs = INTERLEAVE_CASES[case]
    prompts = _mixed_workload()
    new = 24 if "num_pages" in knobs else 8
    jeng, gauge = _jax_engine(jmodel, jparams, interleave_prefill=True, **knobs)
    jreqs = jeng.serve([p.copy() for p in prompts],
                       configs=JGenerationConfig(max_new_tokens=new, eos_token_id=None))
    engine = _port_engine(model, interleave_prefill=True, **knobs)
    assert engine.scheduler.max_prefills == engine.num_slots
    seen = _open_prefills_watch(engine)
    reqs = engine.serve([p.copy() for p in prompts], configs=GenerationConfig(max_new_tokens=new))
    toks = [r.tokens for r in reqs]
    assert toks == [r.tokens for r in jreqs]
    assert {k: engine.stats[k] for k in COUNTERS} == {k: jeng.stats[k] for k in COUNTERS}
    assert max(seen) >= 2
    assert engine.stats["interleaved_chunks"] > 0
    if knobs["kv_dtype"] is not None:
        # the quantizers are bit-identical, but their inputs come from two
        # frameworks' f32 matmuls, whose last bits differ
        assert gauge.value > 0.0
        assert engine.stats["kv_quant_error"] == pytest.approx(gauge.value, rel=QERR_REL_TOL)
    if knobs["prefix_cache_mb"]:
        assert engine.stats["prefix_hit_tokens"] > 0
    if "num_pages" in knobs:
        assert engine.stats["preemptions"] > 0
    off = _port_engine(model, **knobs)
    assert off.scheduler.max_prefills == 1
    assert [r.tokens for r in off.serve([p.copy() for p in prompts],
                                        configs=GenerationConfig(max_new_tokens=new))] == toks
    assert off.stats["interleaved_chunks"] == 0
    engine.flush_prefix_cache()
    assert engine.kv.allocator.free_count == engine.num_pages - 1


@pytest.mark.parametrize("async_depth", [0, 1])
def test_interleaved_sampled_tokens_equal_interleave_off(models, async_depth):
    """A sampled lane's draws come from its own key and counter, so the
    decode-first ordering changes no sampled token."""
    _, _, model = models
    prompts = _mixed_workload(seed=41)
    gen = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=50)
    out = []
    for interleave in (False, True):
        engine = _port_engine(model, rng_seed=3, async_depth=async_depth, prefix_cache_mb=0,
                              interleave_prefill=interleave)
        out.append([r.tokens for r in engine.serve([p.copy() for p in prompts], configs=gen)])
    assert out[0] == out[1]


def test_interleave_knob_validation(models):
    """The reference's refusal: interleave needs the paged pool."""
    _, _, model = models
    with pytest.raises(ValueError, match="interleave_prefill needs the paged pool"):
        _port_engine(model, paged=False, interleave_prefill=True)


# ------------------------------------------------------------------ scheduler
def _scheduler_pair(max_prefills, budget):
    return (Scheduler((4, 8), budget, max_prefills=max_prefills),
            JScheduler((4, 8), budget, max_prefills=max_prefills))


def _state(sched):
    return ([r.rid for r in sched.queue], [r.rid for r in sched.prefills],
            [(r.rid, r.next_chunk, r.state.value, r.slot) for r in sched.prefills],
            sched.queue_depth, sched.has_queued,
            None if sched.prefilling is None else sched.prefilling.rid)


OPS = hst.lists(hst.tuples(hst.sampled_from(["submit", "start", "take", "finish", "cancel",
                                             "step"]),
                           hst.integers(0, 40)), min_size=1, max_size=60)


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(ops=OPS, max_prefills=hst.integers(2, 4), budget=hst.sampled_from([4, 8, 12, 16]))
def test_scheduler_matches_jax_scheduler(ops, max_prefills, budget):
    """The same operation sequence on both schedulers: every return value
    (request picked, bucket, valid length, start, cached) and every queue
    state after it is identical.  The ``ready`` gate refuses a request on
    a step-dependent pattern, as page pressure would."""
    port, ref = _scheduler_pair(max_prefills, budget)
    requests = {}
    left = {}
    for step, (op, arg) in enumerate(ops):
        if op == "submit":
            rid = len(requests)
            prompt = np.arange(1, 2 + arg, dtype=np.int32)
            requests[rid] = (Request(rid=rid, prompt=prompt, config=GenerationConfig()),
                             JRequest(rid=rid, prompt=prompt, config=JGenerationConfig()))
            port.submit(requests[rid][0])
            ref.submit(requests[rid][1])
            out = (None, None)
        elif op == "start":
            out = tuple(None if r is None else r.rid
                        for r in (port.start_next(arg % 4), ref.start_next(arg % 4)))
        elif op == "step":
            left = {"port": port.begin_step(arg), "ref": ref.begin_step(arg)}
            out = (left["port"], left["ref"])
        elif op == "take":
            def gate(req):
                return (req.rid + step) % 3 != 0 or arg % 2 == 0

            picks = []
            for name, sched in (("port", port), ("ref", ref)):
                took = sched.take_chunk(left.get(name, budget), ready=gate)
                if took is not None:
                    left[name] = left.get(name, budget) - took[1]
                    took = (took[0].rid, *took[1:])
                picks.append(took)
            out = tuple(picks)
        elif op == "finish":
            out = tuple(None if r is None else r.rid
                        for r in (port.finish_prefill(), ref.finish_prefill()))
        else:
            out = tuple(None if r is None else (r.rid, r.state.value)
                        for r in (port.cancel(arg), ref.cancel(arg)))
        assert out[0] == out[1], (step, op, arg)
        assert _state(port) == _state(ref), (step, op, arg)


def test_scheduler_refuses_no_prefills():
    with pytest.raises(ValueError, match="max_prefills"):
        Scheduler((4, 8), 8, max_prefills=0)


# --------------------------------------------------------------------- cancel
def _both(models, **kw):
    jmodel, jparams, model = models
    return _jax_engine(jmodel, jparams, **kw)[0], _port_engine(model, **kw)


def _answers(jeng, eng, call):
    """``call(engine, jax)`` on both engines: the answers must agree."""
    got, want = call(eng, False), call(jeng, True)
    assert got == want
    return got


def _gen(jax_side, n):
    return (JGenerationConfig if jax_side else GenerationConfig)(max_new_tokens=n)


@pytest.mark.parametrize("interleave", [False, True])
def test_cancel_queued_and_unknown(models, interleave):
    """The reference's ``test_cancel_queued_request``: a queued request
    cancels (by handle) before any prefill; the others serve; an unknown
    rid answers False; the ``cancelled`` counters agree."""
    jeng, eng = _both(models, num_slots=1, decode_window=1, prefix_cache_mb=0,
                      interleave_prefill=interleave)
    prompts = _prompts(26, (4, 5, 4))
    handles = {}
    for e, j in ((eng, False), (jeng, True)):
        handles[j] = [e.submit(p.copy(), config=_gen(j, 3)) for p in prompts]
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][2])) is True
    assert _answers(jeng, eng, lambda e, j: e.cancel(999)) is False
    eng.run()
    jeng.run()
    assert handles[False][2].state is RequestState.CANCELLED and handles[False][2].tokens == []
    assert [r.tokens for r in handles[False]] == [r.tokens for r in handles[True]]
    for key in ("cancelled", "requests_completed"):
        assert eng.stats[key] == jeng.stats[key]
    assert eng.stats["cancelled"] == 1
    assert eng.kv.allocator.free_count == eng.num_pages - 1


@pytest.mark.parametrize("interleave", [False, True])
def test_cancel_running_mid_prefill_and_done(models, interleave):
    """Under the pipeline: a request still mid-prefill answers False; a
    running lane whose window is in flight cancels (its later tokens never
    stream, its pages wait for that window's drain); a done request
    answers False.  Every answer, every token list and the counters equal
    the JAX engine's; every page is free at the end."""
    jeng, eng = _both(models, prefix_cache_mb=0, prefill_token_budget=4,
                      interleave_prefill=interleave)
    prompts = _prompts(27, (4, 22, 5))
    handles, streamed = {}, {}
    for e, j in ((eng, False), (jeng, True)):
        streamed[j] = []
        handles[j] = [e.submit(p.copy(), config=_gen(j, 10),
                               on_token=lambda r, t, s=streamed[j]: s.append(r.rid))
                      for p in prompts]
    eng.step()
    jeng.step()
    # the 22-token prompt has four chunks: under a 4-token budget it is
    # still mid-prefill here
    assert handles[False][1].state is RequestState.PREFILL
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][1].rid)) is False
    while not (eng._inflight is not None and eng._inflight.lane_live(handles[False][0].slot)):
        eng.step()
        jeng.step()
    assert handles[False][0].state is RequestState.RUNNING
    slot = handles[False][0].slot
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][0])) is True
    assert eng._inflight.deferred_pages and not eng._active[slot]
    before = len(handles[False][0].tokens)
    eng.run()
    jeng.run()
    assert len(handles[False][0].tokens) == before
    assert handles[False][0].state is RequestState.CANCELLED
    assert [r.tokens for r in handles[False]] == [r.tokens for r in handles[True]]
    assert streamed[False] == streamed[True]
    assert handles[False][2].done
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][2])) is False
    for key in ("cancelled", "requests_completed", "prefill_chunks", "decode_steps"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.kv.allocator.free_count == eng.num_pages - 1


def test_cancel_releases_pinned_prefix_nodes(models):
    """The reference's test: a queued request pins its matched prefix node;
    cancelling it releases the pin, in both engines."""
    jeng, eng = _both(models, prefix_cache_mb=16)
    shared = _prompts(28, (8,))[0]
    nodes = {}
    for e, j in ((eng, False), (jeng, True)):
        e.serve([shared.copy()], _gen(j, 2))
        (nodes[j],) = e.prefix_cache._nodes
        assert nodes[j].refs == 0
    reqs = {j: e.submit(np.concatenate([shared, shared[:3]]), max_new_tokens=2)
            for e, j in ((eng, False), (jeng, True))}
    assert nodes[False].refs == nodes[True].refs == 1
    assert _answers(jeng, eng, lambda e, j: e.cancel(reqs[j])) is True
    assert nodes[False].refs == nodes[True].refs == 0
    assert reqs[False].cache_nodes == []


# ------------------------------------------------------------------ deadlines
class FakeClock:
    """A clock that moves only when the test moves it."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def fake_clock(monkeypatch):
    """One fake clock in both engine modules: the port's ``clock`` and the
    JAX engine's ``time.perf_counter`` (its only clock)."""
    fake = FakeClock()
    monkeypatch.setattr(engine_mod, "clock", fake)
    monkeypatch.setattr(jengine_mod, "time", types.SimpleNamespace(perf_counter=fake,
                                                                   sleep=lambda s: None))
    return fake


@pytest.mark.parametrize("interleave", [False, True])
def test_deadline_admission_shed(models, fake_clock, interleave):
    """Before any completion the estimate is 0 and every deadline admits.
    One request served in 2.0 fake seconds sets the service average to
    2.0; with three requests queued a deadline of 5.0 (estimate 6.0) is
    shed, retriably, with ``retry_after_s`` 1.0, and one of 7.0 admits;
    ``deadline_shed`` counts one."""
    jeng, eng = _both(models, num_slots=1, prefix_cache_mb=0, interleave_prefill=interleave)
    prompts = _prompts(30, (5, 6, 7, 4, 5))
    for e, j in ((eng, False), (jeng, True)):
        first = e.submit(prompts[0].copy(), config=_gen(j, 4))
        fake_clock.t += 2.0
        e.run()
        assert first.done
        for p in prompts[1:4]:
            e.submit(p.copy(), config=_gen(j, 4))
    errors = {}
    for e, j in ((eng, False), (jeng, True)):
        with pytest.raises(JAdmissionError if j else AdmissionError) as info:
            e.submit(prompts[4].copy(), config=_gen(j, 4), deadline_s=5.0)
        errors[j] = info.value
        e.submit(prompts[4].copy(), config=_gen(j, 4), deadline_s=7.0)
    assert errors[False].retriable and errors[True].retriable
    assert errors[False].retry_after_s == errors[True].retry_after_s == pytest.approx(1.0)
    assert errors[False].queue_depth == errors[True].queue_depth == 3
    assert eng.stats["deadline_shed"] == jeng.stats["deadline_shed"] == 1
    assert eng._service_ema == jeng._service_ema == 2.0


@pytest.mark.parametrize("interleave", [False, True])
def test_deadline_sweeps_running_and_queued(models, fake_clock, interleave):
    """A running lane and a queued request past their budgets are cancelled
    by the next step's sweep (``deadline_exceeded`` set, no later token
    streamed); a request without a deadline and one within its budget
    finish.  Tokens, states and counters equal the JAX engine's under the
    same clock; every page is free at the end."""
    jeng, eng = _both(models, prefix_cache_mb=0, interleave_prefill=interleave)
    prompts = _prompts(31, (5, 9, 6, 7))
    handles = {}
    for e, j in ((eng, False), (jeng, True)):
        handles[j] = [
            e.submit(prompts[0].copy(), config=_gen(j, 12), deadline_s=1.0),   # runs, blown
            e.submit(prompts[1].copy(), config=_gen(j, 12)),                   # runs
            e.submit(prompts[2].copy(), config=_gen(j, 6), deadline_s=1.0),    # queued, blown
            e.submit(prompts[3].copy(), config=_gen(j, 6), deadline_s=50.0),   # queued, kept
        ]
    for _ in range(3):
        eng.step()
        jeng.step()
    assert [r.state.value for r in handles[False]] == [r.state.value for r in handles[True]]
    assert handles[False][0].state is RequestState.RUNNING
    assert handles[False][2].state is RequestState.QUEUED
    assert eng._has_deadlines
    fake_clock.t += 1.5
    eng.step()
    jeng.step()
    seen = len(handles[False][0].tokens)
    for r in (handles[False][0], handles[False][2]):
        assert r.state is RequestState.CANCELLED and r.deadline_exceeded
    eng.run()
    jeng.run()
    assert len(handles[False][0].tokens) == seen
    assert handles[False][2].tokens == []
    assert handles[False][1].done and handles[False][3].done
    assert [r.tokens for r in handles[False]] == [r.tokens for r in handles[True]]
    assert [r.deadline_exceeded for r in handles[False]] == \
        [r.deadline_exceeded for r in handles[True]]
    for key in ("deadline_shed", "cancelled", "requests_completed"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["deadline_shed"] == 2
    assert eng._has_deadlines == jeng._has_deadlines
    assert eng.kv.allocator.free_count == eng.num_pages - 1
