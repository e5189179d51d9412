"""Port parity: the PyTorch paged ServingEngine's speculation vs the JAX
paged engine, on the workload and fixtures of ``tests/test_torch_engine.py``
(split from it to keep each file's time in the multi-worker run short).

Greedy tokens with n-gram drafts and the linear verify (``speculate_k``) or
the draft-model tree and the tree verify through K1's tree-mask arm
(``draft_model``) must be identical to the JAX paged engine with the same
knobs, on a workload that accepts drafts; a page-starved pool preempts and
replays under speculation with the spec-off engine's tokens.
"""

import pytest

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig
from test_torch_engine import (  # noqa: F401  (fixtures)
    ENGINE_KW,
    _jax_telemetry_off,
    _one_torch_thread,
    _prompts,
    _serve,
    models,
)


SPEC_KNOBS = [
    dict(speculate_k=2),
    dict(speculate_k=3, speculate_ngram=2),
    dict(draft_model=2, tree_width=2, tree_depth=3, draft_ctx=64),
    dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16),
    dict(draft_model=2, tree_width=3, tree_depth=2, draft_ctx=64, kv_dtype="int8"),
]


@pytest.mark.parametrize("knobs", SPEC_KNOBS, ids=lambda k: "-".join(f"{a}{b}" for a, b in
                                                                     k.items()))
def test_speculative_greedy_tokens_identical_to_jax_engine(models, knobs):
    """Greedy tokens with speculation: identical to the JAX paged engine
    with the same knobs and the port's synchronous loop (``async_depth=0``),
    on a workload where both accept drafts, with the same counts of drafted
    and accepted tokens.  With native pages they are also the port's tokens
    with speculation off.  Quantized pages are not: a page is requantized at
    every insert, so a verify's writes leave other codes than decode steps
    do (the JAX package's own identity test of this needs a page of one
    token).  Every page returns to the free list."""
    jmodel, jparams, model, params = models
    prompts = _prompts(20, (5, 9, 3, 12, 7))
    jeng = JServingEngine(jmodel, jparams, paged=True, decode_kernel="pallas",
                          prefix_cache_mb=0, async_depth=0, registry=MetricsRegistry(),
                          **ENGINE_KW, **knobs)
    jreqs = jeng.serve([p.copy() for p in prompts],
                       configs=JGenerationConfig(max_new_tokens=24))
    gen = GenerationConfig(max_new_tokens=24)
    engine, toks = _serve(model, params, prompts, gen, async_depth=0, **knobs)
    assert toks == [r.tokens for r in jreqs]
    if "kv_dtype" not in knobs:
        _, plain = _serve(model, params, prompts, gen)
        assert toks == plain
    st = engine.stats
    assert st["spec_accepted"] > 0 and st["verify_forwards"] > 0
    assert (st["spec_drafted"], st["spec_accepted"]) == (jeng.stats["spec_drafted"],
                                                         jeng.stats["spec_accepted"])
    assert st["tokens_generated"] == 5 * 24
    assert engine.kv.allocator.free_count == engine.num_pages - 1


def test_speculation_survives_preemption(models):
    """A page-starved pool preempts and replays under tree and linear
    speculation (the drafters' per-lane state retires and restarts with the
    lane): the tokens are those of the spec-off engine without preemption."""
    _, _, model, params = models
    prompts = _prompts(7, (12, 11, 10))
    gen = GenerationConfig(max_new_tokens=36)
    _, ref = _serve(model, params, prompts, gen)
    for knobs in (dict(speculate_k=3), dict(draft_model=1, tree_width=2, tree_depth=3,
                                            draft_ctx=16)):
        engine, toks = _serve(model, params, prompts, gen, num_pages=17, **knobs)
        assert engine.stats["preemptions"] > 0 and engine.stats["verify_forwards"] > 0
        assert toks == ref
        assert engine.kv.allocator.free_count == engine.num_pages - 1
