"""Port parity: the slab serving pool, ``ServingEngine(paged=False)``.

* Engine: the JAX ``ServingEngine(paged=False)`` (the reference's default
  pool) and the port's, fed the same f32 params and the same prompts from a
  numpy seed, give identical greedy tokens and identical ``prefill_chunks``,
  ``prefix_hit_tokens``, ``decode_steps``, ``prefreed_lanes``,
  ``spec_drafted``, ``spec_accepted``, ``cancelled`` and ``deadline_shed``:
  in both loops (``async_depth`` 0 and 1) with the prefix cache off and on
  (a shared 8-token prefix that hits), EOS lanes on more requests than slots
  with ``slot_order`` permuted; with n-gram drafts and with a draft-model
  tree (24 new tokens: the tiny model's greedy streams fall into loops that
  accept drafts); a cache budget that evicts, ``cancel``, and
  ``deadline_s`` under one fake clock swapped into both engine modules.
* The clamped edge: with ``prompt + max_new_tokens + decode_window ==
  max_len``, an EOS lane (never pre-freed) runs one pipelined window past
  its last token and writes past its slab's end.  The reference's
  ``dynamic_update_slice`` clamps that write; the port's slab write clamps
  the same way (torch indexing would fail).  The edge is reached (checked),
  and the tokens equal the JAX engine's and the port's own with room to
  spare: the overflowing window's tokens are never emitted.
* Programs: each slab window (decode, linear verify, tree verify with its
  ``_compact`` commit), the scratch prefill, the insert and the cached-chunk
  copy, against the JAX executables on the same slab contents: tokens equal,
  the slabs within 1e-5 (two frameworks' f32 forwards).
* Refusals: the reference's ``ValueError`` for every knob it refuses with
  ``paged=False``, and its admission refusal of a prompt whose padded chunks
  overrun the scratch.
* Sampled lanes (their RNG streams cannot match JAX's): reproducible from the
  seed and independent of the slot a request lands in, and the slab decode
  draw over 3000 lanes held against the filtered distribution by a
  chi-square test (p above 1e-3).

The workloads are the reference's ``tests/test_serving.py`` ones: 2 slots,
buckets (4, 8), a prefill budget of 8, window 2; f32 weights.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import KVCache as JKVCache
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving import engine as jengine_mod
from accelerate_tpu.serving import pool as jpool
from accelerate_tpu.serving.errors import AdmissionError as JAdmissionError
from accelerate_tpu.serving.spec_exec import TreeSpec as JTreeSpec
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import (
    GenerationConfig,
    filter_logits_batched,
    lane_key,
)
from accelerate_tpu_torch.models.transformer import KVCache, Transformer, TransformerConfig
from accelerate_tpu_torch.ops import paged_attention as tpa
from accelerate_tpu_torch.serving import AdmissionError, LaneState, RequestState, ServingEngine
from accelerate_tpu_torch.serving import engine as engine_mod
from accelerate_tpu_torch.serving.pool import (
    copy_chunk,
    slab_decode_window,
    slab_insert,
    slab_prefill_chunk,
    slab_tree_verify_window,
    slab_verify_window,
)
from accelerate_tpu_torch.serving.spec_exec import TreeSpec
from accelerate_tpu_torch.weights import params_from_jax

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2)
COUNTERS = ("prefill_chunks", "prefix_hit_tokens", "decode_steps", "prefreed_lanes",
            "spec_drafted", "spec_accepted", "cancelled", "deadline_shed")
#: the slabs of the two frameworks' f32 forwards agree to their last bits only
KV_ATOL = 1e-5
#: the p-value a chi-square test of the sampler must exceed
CHI2_P_MIN = 1e-3


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


def _workload(seed=44):
    """Cold prompts of 3, 14, 5, 22 and 9 tokens between three that share an
    8-token prefix (one full chunk of bucket 8) before tails of 3, 5 and 2
    tokens: the reference's prefix-cache workload."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 256, 8).astype(np.int32)
    warm = [np.concatenate([shared, rng.integers(1, 256, n).astype(np.int32)])
            for n in (3, 5, 2)]
    cold = _prompts(seed + 1, (3, 14, 5, 22, 9))
    return cold[:2] + [warm[0]] + cold[2:4] + [warm[1], cold[4], warm[2]]


def _jax_engine(models, **kw):
    jmodel, jparams, _ = models
    return JServingEngine(jmodel, jparams, paged=False, registry=MetricsRegistry(),
                          **{**ENGINE_KW, **kw})


def _port_engine(models, **kw):
    return ServingEngine(models[2], None, paged=False, device="cpu", **{**ENGINE_KW, **kw})


def _both(models, **kw):
    return _jax_engine(models, **kw), _port_engine(models, **kw)


def _gen(jax_side, n, **kw):
    return (JGenerationConfig if jax_side else GenerationConfig)(max_new_tokens=n, **kw)


def _counters(engine) -> dict:
    return {k: engine.stats[k] for k in COUNTERS}


SPEC = {"plain": {}, "ngram": dict(speculate_k=2),
        "tree": dict(draft_model=2, tree_width=2, tree_depth=3, draft_ctx=16)}
#: every loop and cache setting without speculation (with EOS lanes and the
#: slots taken in the order (1, 0)); each speculation arm under the pipeline,
#: one with the cache and one without (a speculative cycle drains the window
#: in flight first, so the pipeline is the loop that can differ; the JAX tree
#: engine compiles slowly)
CASES = {f"{spec}-async{depth}-cache{'on' if cache else 'off'}":
         dict(async_depth=depth, prefix_cache_mb=cache, **SPEC[spec])
         for spec, depth, cache in [("plain", 0, 0), ("plain", 0, 16), ("plain", 1, 0),
                                    ("plain", 1, 16), ("ngram", 1, 16), ("tree", 1, 0)]}


@pytest.mark.parametrize("case", list(CASES))
def test_slab_engine_matches_jax_engine(models, case):
    """Greedy tokens and every counter of ``COUNTERS`` equal the JAX slab
    engine's; speculation accepts drafts; the cache hits the shared prefix.
    Without speculation the lanes stop at an EOS id the workload emits (a
    probe serve picks it), more requests than slots reuse slots taken in
    the order (1, 0), and the requests that met their EOS end with it."""
    knobs = CASES[case]
    prompts = _workload()
    if "plain" in case:
        new = 8
        probe = _port_engine(models, prefix_cache_mb=0).serve([p.copy() for p in prompts],
                                                             configs=_gen(False, new))
        extra = dict(eos_token_id=int(probe[1].tokens[3]))
        knobs = dict(knobs, slot_order=(1, 0))
    else:
        new, extra = 24, {}
    jeng, eng = _both(models, **knobs)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=_gen(True, new, **extra))
    reqs = eng.serve([p.copy() for p in prompts], configs=_gen(False, new, **extra))
    toks = [r.tokens for r in reqs]
    assert toks == [r.tokens for r in jreqs]
    assert all(r.done for r in reqs)
    assert _counters(eng) == _counters(jeng)
    assert eng.pool.k.shape == jeng.pool.k.shape and eng.scratch.k.shape == jeng.scratch.k.shape
    if "plain" in case:
        ended = [t for t in toks if len(t) < new]
        assert ended and all(t[-1] == extra["eos_token_id"] for t in ended)
        assert any(len(t) == new for t in toks) and reqs[0].slot == 1
    else:
        assert all(len(t) == new for t in toks) and eng.stats["spec_accepted"] > 0
    if knobs["prefix_cache_mb"]:
        assert eng.stats["prefix_hit_tokens"] > 0
        ours, theirs = eng.prefix_cache_stats(), jeng.prefix_cache_stats()
        for key in ("bytes", "nodes", "evictions", "prefix_hit_tokens", "prefix_miss_tokens"):
            assert ours[key] == theirs[key], key


def test_slab_prefix_cache_evicts_under_its_budget(models):
    """A budget of one and a half chunks (each node a ``[L, 1, 8, Hkv, D]``
    f32 slab for K and one for V): nodes evict LRU, and the hits, misses,
    bytes and evictions equal the JAX engine's, as do the tokens."""
    cfg = models[2].config
    chunk = 2 * cfg.num_layers * 8 * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    budget = 1.5 * chunk / 2**20
    rng = np.random.default_rng(45)
    shared = rng.integers(1, 256, 8).astype(np.int32)
    cold = _prompts(46, (22, 14))
    # a hit, then cold chunks that evict the shared one, then a miss on it
    prompts = [np.concatenate([shared, rng.integers(1, 256, n).astype(np.int32)])
               for n in (3, 5)] + cold + [np.concatenate([shared, [7, 9]])]
    jeng, eng = _both(models, prefix_cache_mb=budget)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=_gen(True, 6))
    reqs = eng.serve([p.copy() for p in prompts], configs=_gen(False, 6))
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    ours, theirs = eng.prefix_cache_stats(), jeng.prefix_cache_stats()
    for key in ("bytes", "nodes", "evictions", "prefix_hit_tokens", "prefix_miss_tokens"):
        assert ours[key] == theirs[key], key
    assert ours["evictions"] > 0 and ours["prefix_hit_tokens"] > 0
    assert ours["bytes"] == ours["nodes"] * chunk <= budget * 2**20
    assert all(n.k.shape == (cfg.num_layers, 1, 8, cfg.num_kv_heads, cfg.resolved_head_dim)
               for n in eng.prefix_cache._nodes)


def test_slab_clamped_edge_matches_jax_and_the_roomy_pool(models):
    """``prompt + max_new_tokens + decode_window == max_len`` with an EOS id
    no lane emits, under the pipeline: the window dispatched while a lane's
    last tokens are in flight writes past the slab's end (recorded at each
    upload).  The reference clamps the write; the port clamps the same way,
    so nothing fails, and the tokens equal the JAX engine's and those of a
    pool with room to spare."""
    prompts = _prompts(47, (6, 6))
    new, window = 10, 4
    max_len = 6 + new + window
    probe = _port_engine(models, decode_window=window, prefix_cache_mb=0).serve(
        [p.copy() for p in prompts], configs=_gen(False, new))
    eos = next(t for t in range(1, 256) if all(t not in r.tokens for r in probe))
    knobs = dict(decode_window=window, prefix_cache_mb=0, async_depth=1)
    jeng = _jax_engine(models, max_len=max_len, max_prompt_len=8, **knobs)
    eng = _port_engine(models, max_len=max_len, max_prompt_len=8, **knobs)
    reach = []
    upload = eng._upload_pool

    def watched():
        upload()
        reach.append(int(eng._lane_len[eng._active].max()) + window)

    eng._upload_pool = watched
    jreqs = jeng.serve([p.copy() for p in prompts], configs=_gen(True, new, eos_token_id=eos))
    reqs = eng.serve([p.copy() for p in prompts], configs=_gen(False, new, eos_token_id=eos))
    assert max(reach) > max_len
    toks = [r.tokens for r in reqs]
    assert toks == [r.tokens for r in jreqs]
    assert toks == [r.tokens for r in probe]
    assert _counters(eng) == _counters(jeng)


# ------------------------------------------------------------------- programs
def _slab_pair(models, lens, seed):
    """The same prompts prefilled chunk by chunk into each framework's
    scratch and inserted into slots 0.. of a 3-slot pool of 40 positions;
    returns both pools, the prompts and the write indices."""
    jmodel, jparams, model = models
    cfg = model.config
    prompts = _prompts(seed, lens)
    jprefill = jpool.make_prefill_chunk(jmodel, 8)
    jinsert = jpool.make_insert()
    jcfg = jmodel.config
    jp = JKVCache.create(jcfg, 3, 40, per_lane_index=True)
    tp = KVCache.create(cfg, 3, 40, device="cpu")
    for slot, prompt in enumerate(prompts):
        js = JKVCache.create(jcfg, 1, 16)
        ts = KVCache.create(cfg, 1, 16, device="cpu")
        for start in range(0, len(prompt), 8):
            chunk = np.zeros(8, np.int32)
            piece = prompt[start:start + 8]
            chunk[:len(piece)] = piece
            js = jprefill(jparams, chunk[None], js)
            slab_prefill_chunk(model, torch.from_numpy(chunk[None]), ts.k, ts.v, start)
        jp = jinsert(jp, js.k, js.v, jnp.int32(slot), jnp.int32(len(prompt) - 1))
        slab_insert(tp.k, tp.v, ts.k, ts.v, slot)
    np.testing.assert_allclose(tp.k.numpy(), np.asarray(jp.k), atol=KV_ATOL)
    index = np.asarray([len(p) - 1 for p in prompts], np.int32)
    return jp.replace(index=jnp.asarray(index)), tp, prompts, index


def _lanes(prompts):
    lanes = LaneState.create(len(prompts), "cpu")
    for s, p in enumerate(prompts):
        lanes.install(s, int(p[-1]), -1, 1.0, 0, 1.0, None)
    return lanes


def _jax_lane_args(prompts):
    n = len(prompts)
    return (jnp.ones(n, bool), jnp.full(n, -1, jnp.int32), jnp.zeros(n, bool),
            jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.float32),
            jnp.zeros(n, jnp.int32), jax.random.split(jax.random.PRNGKey(0), n))


@pytest.mark.parametrize("kind", ["decode", "verify", "tree"])
def test_slab_windows_match_the_jax_executables(models, kind):
    """On the same slab contents (three lanes of 5, 12 and 9 prompt tokens,
    prefilled and inserted by each framework), one slab window of each kind
    gives the JAX executable's tokens and commits, and leaves the slab
    within ``KV_ATOL`` of the JAX one: the decode scan's writes, the verify's
    rows and the tree verify's compacted winning path."""
    jmodel, jparams, model = models
    jcache, tcache, prompts, index = _slab_pair(models, (5, 12, 9), seed=48)
    lanes = _lanes(prompts)
    pending = np.asarray([p[-1] for p in prompts], np.int32)
    jlanes = _jax_lane_args(prompts)
    tindex = torch.from_numpy(index)
    if kind == "decode":
        jcache, jtoks, _, _ = jpool.make_decode_window(jmodel, 3)(
            jparams, jcache, jnp.asarray(pending), *jlanes)
        toks, _ = slab_decode_window(model, 3, tcache.k, tcache.v, tindex, lanes, 0)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    else:
        rng = np.random.default_rng(49)
        if kind == "verify":
            drafts = rng.integers(1, 256, (3, 3)).astype(np.int32)
            tokens = np.concatenate([pending[:, None], drafts], axis=1)
            win = jpool.make_verify_window(jmodel, 3)
            out, n_commit, _ = slab_verify_window(model, tcache.k, tcache.v, tindex,
                                                  torch.from_numpy(tokens), lanes, 0)
        else:
            tree = TreeSpec(2, 3)
            tokens = rng.integers(1, 256, (3, tree.nodes)).astype(np.int32)
            tokens[:, 0] = pending
            win = jpool.make_tree_verify_window(jmodel, JTreeSpec(2, 3))
            out, n_commit, _ = slab_tree_verify_window(
                model, tree, tpa.TreeMask(tree.anc), tcache.k, tcache.v, tindex,
                torch.from_numpy(tokens), lanes, 0)
        jcache, jout, jn, _, _ = win(jparams, jcache, jnp.asarray(tokens), *jlanes)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(n_commit.numpy(), np.asarray(jn))
        # rows up to each lane's new frontier are the committed history
        for s, n in enumerate(np.asarray(jn)):
            end = int(index[s] + n)
            np.testing.assert_allclose(tcache.k[:, s, :end].numpy(),
                                       np.asarray(jcache.k)[:, s, :end], atol=KV_ATOL)
            np.testing.assert_allclose(tcache.v[:, s, :end].numpy(),
                                       np.asarray(jcache.v)[:, s, :end], atol=KV_ATOL)
        return
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=KV_ATOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=KV_ATOL)


def test_copy_chunk_matches_the_jax_executable(models):
    """A cached chunk replayed into the scratch at its start: the scratch
    equals the JAX copy executable's."""
    jmodel, _, model = models
    cfg = model.config
    rng = np.random.default_rng(50)
    shape = (cfg.num_layers, 1, 16, cfg.num_kv_heads, cfg.resolved_head_dim)
    base = rng.standard_normal(shape).astype(np.float32)
    node = rng.standard_normal((*shape[:2], 8, *shape[3:])).astype(np.float32)
    js = JKVCache(k=jnp.asarray(base), v=jnp.asarray(-base), index=jnp.int32(8))
    js = jpool.make_copy_chunk(8)(js, jnp.asarray(node), jnp.asarray(-node))
    tk, tv = torch.from_numpy(base.copy()), torch.from_numpy(-base)
    copy_chunk(tk, tv, torch.from_numpy(node), torch.from_numpy(-node), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(js.k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(js.v))
    assert int(js.index) == 16


# -------------------------------------------------------------- cancel, deadlines
def _answers(jeng, eng, call):
    got, want = call(eng, False), call(jeng, True)
    assert got == want
    return got


@pytest.mark.parametrize("async_depth", [0, 1])
def test_slab_cancel(models, async_depth):
    """A queued request cancels; a request mid-prefill answers False; a
    running lane cancels (with its window in flight under the pipeline: no
    later token of it streams); a done request and an unknown rid answer
    False.  Answers, tokens and counters equal the JAX engine's."""
    jeng, eng = _both(models, prefix_cache_mb=0, prefill_token_budget=4,
                      async_depth=async_depth)
    prompts = _prompts(51, (4, 22, 5, 6))
    handles, streamed = {}, {}
    for e, j in ((eng, False), (jeng, True)):
        streamed[j] = []
        handles[j] = [e.submit(p.copy(), config=_gen(j, 10),
                               on_token=lambda r, t, s=streamed[j]: s.append(r.rid))
                      for p in prompts]
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][3])) is True
    eng.step()
    jeng.step()
    assert handles[False][1].state is RequestState.PREFILL
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][1].rid)) is False
    while handles[False][0].state is not RequestState.RUNNING or not handles[False][0].tokens:
        eng.step()
        jeng.step()
    if async_depth:
        assert eng._inflight is not None and eng._inflight.lane_live(handles[False][0].slot)
    seen = len(streamed[False])
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][0])) is True
    eng.run()
    jeng.run()
    assert handles[False][0].rid not in streamed[False][seen:]
    assert handles[False][0].state is RequestState.CANCELLED
    assert _answers(jeng, eng, lambda e, j: e.cancel(handles[j][2])) is False
    assert _answers(jeng, eng, lambda e, j: e.cancel(999)) is False
    assert [r.tokens for r in handles[False]] == [r.tokens for r in handles[True]]
    assert [r.state.value for r in handles[False]] == [r.state.value for r in handles[True]]
    assert _counters(eng) == _counters(jeng)
    assert eng.stats["cancelled"] == 2


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


def test_slab_deadline_shed_and_sweeps(models, fake_clock):
    """Admission sheds a deadline the queue cannot meet (retriably, with the
    same ``retry_after_s``); the sweep cancels a running lane and a queued
    request past their budgets; tokens, states and counters equal the JAX
    engine's under the same clock."""
    jeng, eng = _both(models, prefix_cache_mb=0)
    prompts = _prompts(52, (5, 9, 6, 7, 4))
    for e, j in ((eng, False), (jeng, True)):
        first = e.submit(prompts[4].copy(), config=_gen(j, 4))
        fake_clock.t += 2.0
        e.run()
        assert first.done
    handles = {}
    for e, j in ((eng, False), (jeng, True)):
        handles[j] = [
            e.submit(prompts[0].copy(), config=_gen(j, 12), deadline_s=1.0),   # runs, blown
            e.submit(prompts[1].copy(), config=_gen(j, 12)),                   # runs
            e.submit(prompts[2].copy(), config=_gen(j, 6), deadline_s=5.0),    # queued, blown
            e.submit(prompts[3].copy(), config=_gen(j, 6), deadline_s=50.0),   # queued, kept
        ]
    errors = {}
    for e, j in ((eng, False), (jeng, True)):
        with pytest.raises(JAdmissionError if j else AdmissionError) as info:
            e.submit(prompts[4].copy(), config=_gen(j, 4), deadline_s=3.0)
        errors[j] = info.value
    assert errors[False].retriable and errors[True].retriable
    assert errors[False].retry_after_s == errors[True].retry_after_s
    for _ in range(3):
        eng.step()
        jeng.step()
    assert handles[False][0].state is RequestState.RUNNING
    fake_clock.t += 5.5
    eng.step()
    jeng.step()
    for r in (handles[False][0], handles[False][2]):
        assert r.state is RequestState.CANCELLED and r.deadline_exceeded
    eng.run()
    jeng.run()
    assert handles[False][1].done and handles[False][3].done
    assert [r.tokens for r in handles[False]] == [r.tokens for r in handles[True]]
    assert [r.deadline_exceeded for r in handles[False]] == \
        [r.deadline_exceeded for r in handles[True]]
    assert _counters(eng) == _counters(jeng)
    assert eng.stats["deadline_shed"] == 3


# ------------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,match", [
    (dict(decode_kernel="pallas"), "act on the paged KV pool"),
    (dict(prefill_kernel="pallas"), "act on the paged KV pool"),
    (dict(kv_dtype="int8"), "act on the paged KV pool"),
    (dict(interleave_prefill=True), "interleave_prefill needs the paged pool"),
    (dict(role="decode"), "requires paged=True"),
    (dict(prefix_host_mb=8.0), "prefix_host_mb"),
])
def test_slab_refusals_match_the_reference(models, kw, match):
    """Every knob the reference refuses with ``paged=False`` raises its
    ``ValueError`` in both engines; ``decode_kernel="xla"`` (the reference's
    default) is taken."""
    with pytest.raises(ValueError, match=match):
        _jax_engine(models, **kw)
    with pytest.raises(ValueError, match=match):
        _port_engine(models, **kw)
    eng = _port_engine(models, decode_kernel="xla", prefix_cache_mb=0)
    assert eng.pool is not None and eng.kv is None


def test_slab_admission_caps_padding_at_the_scratch(models):
    """A 9-token prompt pads to 12 under buckets (4, 8): past a 10-token
    scratch the slab engines refuse it (not retriable), as the reference
    does, while the paged port, whose cap is ``max_len``, admits it."""
    prompt = _prompts(53, (9,))[0]
    jeng, eng = _both(models, max_prompt_len=10, prefix_cache_mb=0)
    with pytest.raises(JAdmissionError) as theirs:
        jeng.submit(prompt.copy(), max_new_tokens=4)
    with pytest.raises(AdmissionError, match="exceeding capacity 10") as ours:
        eng.submit(prompt.copy(), max_new_tokens=4)
    assert not ours.value.retriable and not theirs.value.retriable
    paged = ServingEngine(models[2], None, device="cpu", max_prompt_len=10, prefix_cache_mb=0,
                          **ENGINE_KW)
    assert paged.serve([prompt.copy()], configs=_gen(False, 4))[0].done


# -------------------------------------------------------------------- sampling
def test_slab_sampling_reproducible_and_slot_independent(models):
    """Sampled lanes on the slab pool: two serves give the same tokens, and
    a request's tokens do not depend on the slot it lands in."""
    prompts = _prompts(54, (5, 9, 3))
    gen = GenerationConfig(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=40)
    runs = [[r.tokens for r in _port_engine(models, rng_seed=3, slot_order=order,
                                            prefix_cache_mb=0).serve(
        [p.copy() for p in prompts], configs=gen)] for order in ((0, 1), (0, 1), (1, 0))]
    assert runs[0] == runs[1] == runs[2]
    assert all(0 <= t < 256 for toks in runs[0] for t in toks)


def test_slab_decode_draw_follows_the_filtered_distribution(models):
    """3000 sampled lanes, each its own key, their slabs holding one
    prompt's KV: the slab decode window's draw lies in the filtered support
    and passes a chi-square test against the filtered distribution."""
    model = models[2]
    cfg = model.config
    lanes_n, prompt = 3000, np.asarray([17, 3, 99, 4, 250, 8, 31, 77, 5, 64, 12], np.int32)
    temperature, top_k = 1.3, 6
    scratch = KVCache.create(cfg, 1, 16, device="cpu")
    chunk = np.zeros(16, np.int32)
    chunk[:len(prompt)] = prompt
    slab_prefill_chunk(model, torch.from_numpy(chunk[None]), scratch.k, scratch.v, 0)
    k = scratch.k.expand(-1, lanes_n, -1, -1, -1).contiguous()
    v = scratch.v.expand(-1, lanes_n, -1, -1, -1).contiguous()
    lanes = LaneState.create(lanes_n, "cpu")
    for lane in range(lanes_n):
        lanes.install(lane, int(prompt[-1]), -1, temperature, top_k, 1.0, lane_key(11, lane))
    index = torch.full((lanes_n,), len(prompt) - 1, dtype=torch.int32)
    out, _ = slab_decode_window(model, 1, k, v, index, lanes, 0)
    with torch.inference_mode():
        logits = model(torch.from_numpy(prompt[None]))[:, -1]
    filt = filter_logits_batched(logits, temperature=torch.tensor([temperature]),
                                 top_k=torch.tensor([top_k], dtype=torch.int32),
                                 top_p=torch.tensor([1.0]))
    p = torch.softmax(filt, dim=-1)[0].double().numpy()
    first = out[:, 0].numpy()
    support = np.nonzero(p > 0)[0]
    assert len(support) == top_k and np.isin(first, support).all()
    counts = np.bincount(first, minlength=len(p))[support]
    _, pvalue = scipy.stats.chisquare(counts, lanes_n * p[support] / p[support].sum())
    assert pvalue > CHI2_P_MIN, (counts.tolist(), (lanes_n * p[support]).round(1).tolist())
