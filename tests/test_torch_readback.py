"""Port parity: the pipelined serve loop and the sampler on device keys.

* The depth-1 pipeline (``ServingEngine(async_depth=1)``, the default of
  both packages): the port's greedy tokens equal the JAX paged engine's
  (``decode_kernel="pallas"`` in interpret mode, ``prefix_cache_mb=0``,
  ``async_depth=1``) with native, int8 and fp8 pages, under preemption,
  with EOS lanes and with both speculation arms, on more requests than
  slots (so slots are pre-freed and reused); the scheduling counters
  (decode steps, prefill chunks, preemptions, pre-freed lanes, drafted and
  accepted tokens) equal the JAX engine's too, and the tokens equal the
  port's own synchronous loop (``async_depth=0``).  Every page returns to
  the free list, and no page a window in flight may still write is handed
  out before that window's drain (an instrumented allocator).
* The sampler (:mod:`accelerate_tpu_torch.models.generation`): uniforms
  from ``(seed, counter)`` keys, reproducible and shift-consistent; every
  inverse-CDF draw inside the filtered support; and the sampled token
  distribution of the decode draw and of both verify arms' first committed
  token held against the filtered distribution by a chi-square test over
  3000 lanes (each lane its own key, all reading the same pages).  The
  tolerance: the test's p-value must exceed 1e-3 (the draws are
  deterministic, so the test is too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import (
    GenerationConfig,
    filter_logits_batched,
    lane_key,
    sample_filtered,
    uniforms,
)
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.ops import paged_attention as tpa
from accelerate_tpu_torch.serving import LaneState, PagedKVPool, ServingEngine
from accelerate_tpu_torch.serving.pool import (
    decode_window,
    prefill_chunk,
    tree_verify_window,
    verify_window,
)
from accelerate_tpu_torch.serving.spec_exec import TreeSpec
from accelerate_tpu_torch.weights import params_from_jax

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2)
#: the port's engines here run without the prefix cache, as the JAX engines do
CACHE_OFF = dict(prefix_cache_mb=0)
#: the p-value a chi-square test of the sampler must exceed
CHI2_P_MIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _serve(model, prompts, configs, **kw):
    engine = ServingEngine(model, None, device="cpu", **{**ENGINE_KW, **CACHE_OFF, **kw})
    reqs = engine.serve([p.copy() for p in prompts], configs=configs)
    return engine, [r.tokens for r in reqs]


PIPELINE_CASES = {
    "native_eos": dict(),
    "int8_preempt": dict(kv_dtype="int8", num_pages=17),
    "fp8": dict(kv_dtype="fp8"),
    "linear_spec": dict(speculate_k=2),
    "tree_spec": dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16),
}
COUNTERS = ("decode_steps", "prefill_chunks", "preemptions", "prefreed_lanes", "spec_drafted",
            "spec_accepted")


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_pipelined_loop_matches_jax_engine(models, case):
    """Five requests through two slots: greedy tokens and the scheduling
    counters of the port's pipeline equal the JAX pipeline's; its tokens
    equal the port's synchronous loop's; no page leaks.  ``native_eos``
    gives two requests an EOS their stream emits (those lanes keep the
    one-window lag, the others are pre-freed); ``int8_preempt`` runs a pool
    of 16 pages that must preempt."""
    jmodel, jparams, model = models
    knobs = PIPELINE_CASES[case]
    prompts = _prompts(20, (5, 9, 3, 12, 7))
    new = 40 if "num_pages" in knobs else 24
    configs = [GenerationConfig(max_new_tokens=new)] * len(prompts)
    jconfigs = [JGenerationConfig(max_new_tokens=new)] * len(prompts)
    if case == "native_eos":
        _, plain = _serve(model, prompts, configs, async_depth=0)
        for i in (0, 3):
            eos = plain[i][5]
            configs[i] = GenerationConfig(max_new_tokens=new, eos_token_id=eos)
            jconfigs[i] = JGenerationConfig(max_new_tokens=new, eos_token_id=eos)
    jeng = JServingEngine(jmodel, jparams, paged=True, decode_kernel="pallas",
                          prefix_cache_mb=0, async_depth=1, registry=MetricsRegistry(),
                          **ENGINE_KW, **knobs)
    jreqs = jeng.serve([p.copy() for p in prompts], configs=jconfigs)
    engine, toks = _serve(model, prompts, configs, **knobs)
    assert engine.async_depth == 1
    assert toks == [r.tokens for r in jreqs]
    assert {k: engine.stats[k] for k in COUNTERS} == {k: jeng.stats[k] for k in COUNTERS}
    _, sync = _serve(model, prompts, configs, async_depth=0, **knobs)
    assert toks == sync
    assert engine.kv.allocator.free_count == engine.num_pages - 1
    if case == "native_eos":
        assert any(len(t) < new for t in toks) and engine.stats["prefreed_lanes"] > 0
    if case == "int8_preempt":
        assert engine.stats["preemptions"] > 0
    assert engine.stats["graph_captures"] == engine.stats["graph_replays"] == 0


def test_deferred_pages_wait_for_their_window(models):
    """An allocator that checks every page it hands out against the pages
    the window in flight holds back: none is handed out before that
    window's drain.  The workload (no EOS, a pool of 16 pages) pre-frees
    lanes and preempts, so pages are deferred; the free count returns to
    idle."""
    _, _, model = models
    engine = ServingEngine(model, None, device="cpu", num_pages=17, **ENGINE_KW, **CACHE_OFF)
    allocator, kv = engine.kv.allocator, engine.kv
    handed, deferred = [], []
    alloc, detach = allocator.alloc, kv.lane_detach

    def checked_alloc(n):
        ids = alloc(n)
        held = engine._inflight.deferred_pages if engine._inflight is not None else []
        assert not set(ids or ()) & set(held), "a deferred page was handed out"
        handed.extend(ids or ())
        return ids

    def counted_detach(slot):
        ids = detach(slot)
        if engine._inflight is not None and engine._inflight.lane_live(slot):
            deferred.extend(ids)
        return ids

    allocator.alloc, kv.lane_detach = checked_alloc, counted_detach
    prompts = _prompts(25, (12, 16, 9, 14, 6))
    reqs = engine.serve(prompts, configs=GenerationConfig(max_new_tokens=28))
    assert all(len(r.tokens) == 28 for r in reqs)
    st = engine.stats
    assert st["prefreed_lanes"] > 0 and st["preemptions"] > 0 and deferred and handed
    assert allocator.free_count == engine.num_pages - 1
    assert engine._inflight is None
    # pipeline accounting: every drain waited on nothing (the CPU runs a
    # window at dispatch), so the overlap ratio is a share in [0, 1]
    assert 0.0 <= st["host_overlap_ratio"] <= 1.0 and st["device_idle_s"] >= 0.0


def test_sampled_tokens_same_in_both_loops(models):
    """A sampled request's draws come from its own key and counter, so the
    pipeline changes no sampled token; another seed changes them."""
    _, _, model = models
    prompts = _prompts(21, (6, 11, 9, 4))
    gen = GenerationConfig(max_new_tokens=10, do_sample=True, temperature=0.9, top_p=0.9)
    _, piped = _serve(model, prompts, gen, rng_seed=5)
    _, sync = _serve(model, prompts, gen, rng_seed=5, async_depth=0)
    _, other = _serve(model, prompts, gen, rng_seed=6)
    assert piped == sync and piped != other


# ------------------------------------------------------------------ sampler
def test_uniforms_are_counter_based():
    """Draw ``j`` of a lane depends only on its seed and its counter plus
    ``j``: the same keys give the same bits, a counter advanced by 2 gives
    the same stream two draws on, and the values lie in [0, 1)."""
    seeds = [lane_key(3, rid) for rid in range(4)]
    keys = torch.tensor([[s, 0] for s in seeds], dtype=torch.int64)
    u = uniforms(keys, 5)
    assert u.shape == (4, 5) and u.dtype == torch.float32
    assert torch.equal(u, uniforms(keys.clone(), 5))
    shifted = keys.clone()
    shifted[:, 1] += 2
    assert torch.equal(u[:, 2:], uniforms(shifted, 3))
    big = uniforms(keys, 20000)
    assert float(big.min()) >= 0.0 and float(big.max()) < 1.0
    assert abs(float(big.mean()) - 0.5) < 0.01
    assert len({lane_key(3, rid) for rid in range(100)}) == 100
    assert all(0 <= lane_key(7, rid) < 2**63 for rid in range(10))


def test_inverse_cdf_draws_stay_in_the_support():
    """Filtered rows (top-k, top-p, a point mass) drawn at uniforms that
    include 0 and the largest below 1: every token has nonzero filtered
    probability."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32) * 2)
    filt = filter_logits_batched(
        logits, temperature=torch.tensor([1.0, 0.7, 1.5, 1.0, 0.3, 2.0]),
        top_k=torch.tensor([5, 0, 40, 1, 0, 3], dtype=torch.int32),
        top_p=torch.tensor([1.0, 0.8, 0.5, 1.0, 0.95, 1.0]))
    support = torch.softmax(filt, dim=-1) > 0
    for u in (torch.zeros(6), torch.full((6,), 1.0 - 2.0**-24), torch.rand(6)):
        tok = sample_filtered(filt, u).long()
        assert support.gather(1, tok[:, None]).all()
    assert sample_filtered(filt[3:4], torch.tensor([0.999])).item() == int(filt[3].argmax())


LANES, PAGE = 3000, 8
PROMPT = np.asarray([17, 3, 99, 4, 250, 8, 31, 77, 5, 64, 12], np.int32)
TEMPERATURE, TOP_K = 1.3, 6


def _many_lanes(model):
    """``LANES`` sampled lanes, each its own key, all reading one prompt's
    pages (one block table row for all), with the prompt's last token
    pending: every lane sees the same next-token distribution."""
    cfg = model.config
    pool = PagedKVPool(cfg, LANES, 64, PAGE, 17, device="cpu")
    pool.tables[:, :8] = np.arange(1, 9)
    padded = np.zeros(16, np.int32)
    padded[:len(PROMPT)] = PROMPT
    prefill_chunk(model, torch.from_numpy(padded[None]), pool.pages_k, pool.pages_v,
                  pool.k_scales, pool.v_scales, torch.from_numpy(pool.tables[0].copy()), 0)
    lanes = LaneState.create(LANES, "cpu")
    for lane in range(LANES):
        lanes.install(lane, int(PROMPT[-1]), -1, TEMPERATURE, TOP_K, 1.0, lane_key(11, lane))
    index = torch.full((LANES,), len(PROMPT) - 1, dtype=torch.int32)
    kv = (pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales,
          torch.from_numpy(pool.tables.copy()), index)
    with torch.inference_mode():
        logits = model(torch.from_numpy(PROMPT[None]))[:, -1]
    filt = filter_logits_batched(logits, temperature=torch.tensor([TEMPERATURE]),
                                 top_k=torch.tensor([TOP_K], dtype=torch.int32),
                                 top_p=torch.tensor([1.0]))
    return kv, lanes, torch.softmax(filt, dim=-1)[0].double().numpy()


@pytest.mark.parametrize("kind", ["decode", "linear", "tree"])
def test_sampled_draws_follow_the_filtered_distribution(models, kind):
    """The decode draw, and the first committed token of a linear verify
    (drafts: the two likeliest tokens) and of a tree verify (siblings: the
    two likeliest first tokens), over 3000 lanes: every token in the
    filtered support, and a chi-square test against the filtered
    distribution with p above ``CHI2_P_MIN``."""
    _, _, model = models
    kv, lanes, p = _many_lanes(model)
    top = np.argsort(-p)[:2].astype(np.int32)
    pending = np.full((LANES, 1), PROMPT[-1], np.int32)
    if kind == "decode":
        out, _ = decode_window(model, 1, *kv, lanes, 0)
    elif kind == "linear":
        tokens = np.concatenate([pending, np.tile(top, (LANES, 1))], axis=1)
        out, _, _ = verify_window(model, *kv, torch.from_numpy(tokens), lanes, 0)
    else:
        tree = TreeSpec(2, 2)
        tokens = np.zeros((LANES, tree.nodes), np.int32)
        tokens[:, 0] = PROMPT[-1]
        for b in range(tree.width):
            tokens[:, tree.paths[b, 1:]] = top[b]
        out, _, _ = tree_verify_window(model, tree, tpa.TreeMask(tree.anc), *kv,
                                       torch.from_numpy(tokens), lanes, 0)
    first = out[:, 0].numpy()
    support = np.nonzero(p > 0)[0]
    assert len(support) == TOP_K and np.isin(first, support).all()
    counts = np.bincount(first, minlength=len(p))[support]
    _, pvalue = scipy.stats.chisquare(counts, LANES * p[support] / p[support].sum())
    assert pvalue > CHI2_P_MIN, (counts.tolist(), (LANES * p[support]).round(1).tolist())
