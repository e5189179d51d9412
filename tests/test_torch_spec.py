"""Port parity: speculative decoding, the PyTorch port against the JAX package.

The same numpy inputs (prompts, drafts, pages) and the same f32 weights
(``TransformerConfig.tiny``, carried by ``params_from_jax``) go through both
packages:

* the host pieces — ``TreeSpec``, the n-gram drafting (``propose_ngram_draft``,
  ``NgramIndex``, ``NgramDrafter``) and ``DraftContextWindow`` — must be
  equal to the JAX ones;
* the draft model — ``build_draft``'s slicing, and the draft forward's
  ``[N, nodes]`` tokens identical to JAX ``make_draft_forward``;
* the verify windows on the same pages — the port's ``verify_window``
  against JAX ``make_paged_verify_window(direct=True)`` and its
  ``tree_verify_window`` against ``make_paged_tree_verify_window(direct=
  True)`` (JAX's Pallas kernel in interpret mode): ``out``, ``n_commit`` and
  the pending tokens identical; the pages within 1e-5 for f32 pages (the
  two frameworks' projections differ by rounding), within one code step
  for int8 pages (a value on a rounding edge may take the neighbouring
  code), and ``quant_err`` within 1e-6;
* sampled lanes — reproducible from the seed and in vocabulary (JAX's
  threefry stream and the port's counter hash differ, so no token parity);
* the windows over static buffers — each window called through buffers the
  caller writes in place (as the engine's CUDA graphs read them) gives the
  outputs and pages of a direct call.

The engine-level parity (greedy tokens identical to the JAX engine and to
the port's spec-off tokens) is in ``tests/test_torch_engine.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving.paging import DraftContextWindow as JDraftContextWindow
from accelerate_tpu.serving.pool import make_paged_tree_verify_window, make_paged_verify_window
from accelerate_tpu.serving.spec import NgramIndex as JNgramIndex
from accelerate_tpu.serving.spec import propose_ngram_draft as jpropose
from accelerate_tpu.serving.spec_exec import NgramDrafter as JNgramDrafter
from accelerate_tpu.serving.spec_exec import TreeSpec as JTreeSpec
from accelerate_tpu.serving.spec_exec import build_draft as jbuild_draft
from accelerate_tpu.serving.spec_exec import make_draft_forward as jmake_draft_forward
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.ops import paged_attention as tpa
from accelerate_tpu_torch.serving import LaneState, PagedKVPool
from accelerate_tpu_torch.serving.paging import DraftContextWindow
from accelerate_tpu_torch.serving.pool import (
    decode_window,
    prefill_chunk,
    tree_verify_window,
    verify_window,
)
from accelerate_tpu_torch.serving.spec import NgramIndex, propose_ngram_draft
from accelerate_tpu_torch.serving.spec_exec import (
    NgramDrafter,
    TreeSpec,
    build_draft,
    default_draft_layers,
    draft_transformer,
    make_draft_forward,
)
from accelerate_tpu_torch.models.generation import lane_key
from accelerate_tpu_torch.weights import params_from_jax

PAGE, SLOTS, MAX_LEN = 8, 2, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ------------------------------------------------------------------ host pieces
@pytest.mark.parametrize("width,depth", [(1, 1), (1, 5), (2, 3), (3, 2), (2, 4), (31, 1)])
def test_tree_spec_matches_jax(width, depth):
    ours, theirs = TreeSpec(width, depth), JTreeSpec(width, depth)
    assert ours.nodes == theirs.nodes == 1 + width * depth
    for name in ("parent", "depth_arr", "anc", "paths"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))


def test_tree_spec_rejects_degenerate_shapes():
    for bad in ((0, 3), (2, 0)):
        with pytest.raises(ValueError):
            TreeSpec(*bad)


def _contexts(seed, n=60, vocab=5):
    """A context from a small vocabulary, so that n-grams recur, with a
    stretch that repeats a period."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, vocab, n).astype(np.int32)
    ctx[30:42] = np.tile(ctx[20:24], 3)
    return ctx


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafts_match_jax_over_growing_context(seed, max_ngram, min_ngram):
    """Every prefix of a growing context: the rescan and the incremental
    index of both packages propose the same draft (or none), at k 1 .. 5."""
    ctx = _contexts(seed)
    ours, theirs = NgramIndex(max_ngram, min_ngram), JNgramIndex(max_ngram, min_ngram)
    drafted = 0
    for end in range(len(ctx) + 1):
        if end:
            ours.append(int(ctx[end - 1]))
            theirs.append(int(ctx[end - 1]))
        for k in range(1, 6):
            want = jpropose(ctx[:end], k, max_ngram, min_ngram)
            for got in (propose_ngram_draft(ctx[:end], k, max_ngram, min_ngram),
                        ours.propose(k), theirs.propose(k)):
                assert (got is None) == (want is None)
                if want is not None:
                    assert got.tolist() == want.tolist()
                    drafted += 1
    assert drafted > 0 and len(ours) == len(ctx)


def test_ngram_index_rejects_bad_sizes():
    with pytest.raises(ValueError):
        NgramIndex(1, 2)
    with pytest.raises(ValueError):
        NgramIndex(3, 0)


def test_ngram_drafter_matches_jax():
    """Two slots growing, a slot reused by a shorter context without a
    retire (the index rebuilds), and a retire."""
    ours, theirs = NgramDrafter(), JNgramDrafter()
    a, b = _contexts(3), _contexts(4)
    for end in range(2, 50, 3):
        for slot, ctx in ((0, a[:end]), (1, b[:end])):
            want = theirs.propose(slot, ctx, 3)
            got = ours.propose(slot, ctx, 3)
            assert (got is None) == (want is None)
            assert want is None or got.tolist() == want.tolist()
    fresh = np.array([4, 5, 4, 5, 4], np.int32)
    assert ours.propose(0, fresh, 3).tolist() == theirs.propose(0, fresh, 3).tolist()
    ours.retire(1)
    assert 1 not in ours._idx and 0 in ours._idx


def test_draft_context_window_matches_jax():
    rng = np.random.default_rng(7)
    ours, theirs = DraftContextWindow(3, 8, pad=0), JDraftContextWindow(3, 8, pad=0)
    for _ in range(60):
        slot = int(rng.integers(0, 3))
        op = rng.choice(["begin", "push", "push", "retire"])
        toks = rng.integers(1, 99, int(rng.integers(1, 12))).astype(np.int32)
        if op == "retire":
            ours.retire(slot)
            theirs.retire(slot)
        else:
            getattr(ours, op)(slot, toks)
            getattr(theirs, op)(slot, toks)
        np.testing.assert_array_equal(ours.tokens, theirs.tokens)
        np.testing.assert_array_equal(ours.length, theirs.length)
    with pytest.raises(ValueError):
        DraftContextWindow(1, 0)


# ------------------------------------------------------------------ draft model
def test_build_draft_slices_and_shares_the_served_tensors(models):
    jmodel, jparams, model = models
    sd = model.state_dict()
    cfg, dsd = build_draft(model.config, sd, 1, draft_ctx=16, depth=3)
    jcfg, jdp = jbuild_draft(jmodel.config, jparams, 1, draft_ctx=16, depth=3)
    assert cfg.num_layers == jcfg.num_layers == 1
    assert cfg.max_seq_len == jcfg.max_seq_len == 64
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jdp), device="cpu")
    assert sorted(dsd) == sorted(want)
    for key, t in dsd.items():
        assert torch.equal(t, want[key])
        assert t.data_ptr() == sd[key].data_ptr()   # shared, not copied
    cfg200, _ = build_draft(model.config, sd, 1, draft_ctx=200, depth=3)
    assert cfg200.max_seq_len == 204              # context + rollout + 1
    draft = draft_transformer(cfg, dsd, "cpu")
    assert draft.lm_head.weight.data_ptr() == model.lm_head.weight.data_ptr()
    assert len(draft.layers) == 1


def test_build_draft_forms_and_refusals(models):
    _, _, model = models
    sd = model.state_dict()
    cfg, dsd = build_draft(model.config, sd, (model.config, sd), draft_ctx=8, depth=2)
    assert cfg is model.config and dsd.keys() == sd.keys()
    for bad in (0, 3, -1):
        with pytest.raises(ValueError, match="out of range"):
            build_draft(model.config, sd, bad, draft_ctx=8, depth=2)
    for bad in (True, 1.5, [1]):
        with pytest.raises(ValueError, match="draft_model must be"):
            build_draft(model.config, sd, bad, draft_ctx=8, depth=2)
    # a checkpoint directory (tests/test_torch_hf_compat.py) must hold a
    # config.json, as the reference's hf_compat requires
    with pytest.raises(FileNotFoundError, match="no config.json"):
        build_draft(model.config, sd, "ckpt/dir#1", draft_ctx=8, depth=2)
    assert default_draft_layers(32) == 8 and default_draft_layers(2) == 1


@pytest.mark.parametrize("layers,width,depth", [(1, 2, 3), (2, 3, 2), (1, 1, 4)])
def test_draft_forward_matches_jax(models, layers, width, depth):
    """The draft forward's ``[N, nodes]`` tokens, ragged lane lengths (a
    lane of one token, a full window), identical to JAX's."""
    jmodel, jparams, model = models
    ctx_len = 16
    jcfg, jdp = jbuild_draft(jmodel.config, jparams, layers, draft_ctx=ctx_len, depth=depth)
    jfwd = jmake_draft_forward(JTransformer(jcfg), JTreeSpec(width, depth), ctx_len)
    cfg, dsd = build_draft(model.config, model.state_dict(), layers, draft_ctx=ctx_len,
                           depth=depth)
    fwd = make_draft_forward(draft_transformer(cfg, dsd, "cpu"), TreeSpec(width, depth), ctx_len)
    rng = np.random.default_rng(40 + layers)
    lens = np.asarray([5, ctx_len, 1], np.int32)
    ctx = np.zeros((3, ctx_len), np.int32)
    for i, n in enumerate(lens):
        ctx[i, :n] = rng.integers(1, 256, n)
    want = np.asarray(jfwd(jdp, jnp.asarray(ctx), jnp.asarray(lens)))
    got = fwd(torch.from_numpy(ctx), torch.from_numpy(lens)).numpy()
    assert got.shape == (3, 1 + width * depth) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], ctx[np.arange(3), lens - 1])


# --------------------------------------------------------------- verify windows
PROMPTS = [np.asarray(p, np.int32) for p in
           ([17, 3, 99, 4, 250, 8, 31, 77, 5, 64, 12], [200, 1, 45, 45, 9, 130])]


def _pool(model, kv_dtype=None):
    """Two lanes holding the prompts' KV (prefilled through the port), each
    with its last prompt token pending, as the engine installs them."""
    cfg = model.config
    pool = PagedKVPool(cfg, SLOTS, MAX_LEN, PAGE, 17, kv_dtype=kv_dtype, device="cpu")
    lanes = LaneState.create(SLOTS, "cpu")
    for lane, prompt in enumerate(PROMPTS):
        pool.tables[lane, :8] = np.arange(1 + 8 * lane, 9 + 8 * lane)
        padded = np.zeros(-(-len(prompt) // PAGE) * PAGE, np.int32)
        padded[:len(prompt)] = prompt
        prefill_chunk(model, torch.from_numpy(padded[None]), pool.pages_k, pool.pages_v,
                      pool.k_scales, pool.v_scales, torch.from_numpy(pool.tables[lane].copy()),
                      0)
        lanes.install(lane, int(prompt[-1]), -1, 1.0, 0, 1.0, None)
    index = torch.tensor([len(p) - 1 for p in PROMPTS], dtype=torch.int32)
    return pool, lanes, torch.from_numpy(pool.tables.copy()), index


def _greedy_chain(model, n, kv_dtype=None):
    """The ``n`` tokens plain greedy decode emits from each lane's pending
    token, and the pages it leaves (a pool of its own)."""
    pool, lanes, tables, index = _pool(model, kv_dtype)
    toks, _ = decode_window(model, n, pool.pages_k, pool.pages_v, pool.k_scales,
                            pool.v_scales, tables, index, lanes, 0)
    return toks.numpy(), pool


def _jax_window(jmodel, jparams, pool, tables, index, tokens, eos=-1, kind="linear", tree=None):
    """The JAX direct paged window (``paged_kernel="pallas"``, interpret
    mode) over the port pool's pages as they are before the port's call."""
    kmodel = JTransformer(dataclasses.replace(jmodel.config, paged_kernel="pallas"))
    if kind == "linear":
        win = make_paged_verify_window(kmodel, tokens.shape[1] - 1, direct=True)
    else:
        win = make_paged_tree_verify_window(kmodel, JTreeSpec(tree.width, tree.depth),
                                            direct=True)
    n = tokens.shape[0]

    def pages(t):
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.int8) \
            if t.dtype == torch.int8 else jnp.asarray(t.numpy())

    res = win(jparams, pages(pool.pages_k), pages(pool.pages_v),
              jnp.asarray(pool.k_scales.numpy()), jnp.asarray(pool.v_scales.numpy()),
              jnp.asarray(tables.numpy()), jnp.asarray(index.numpy()), jnp.asarray(tokens),
              jnp.ones(n, bool), jnp.full(n, eos, jnp.int32), jnp.zeros(n, bool),
              jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.float32),
              jnp.zeros(n, jnp.int32), jnp.zeros((n, 2), jnp.uint32))
    pk, pv, ks, vs, out, n_commit, pending, _, qerr = (np.asarray(a) for a in res)
    return dict(pages_k=pk, pages_v=pv, k_scales=ks, v_scales=vs, out=out, n_commit=n_commit,
                pending=pending, qerr=float(qerr))


def _hold_pages(pool, want, kv_dtype):
    """The port pool's pages against the JAX window's: f32 within 1e-5;
    int8 dequantized within one code step of the larger scale."""
    for name, scale_name in (("pages_k", "k_scales"), ("pages_v", "v_scales")):
        got, scales, jscales = getattr(pool, name), getattr(pool, scale_name), want[scale_name]
        if kv_dtype is None:
            np.testing.assert_allclose(got.numpy(), want[name], atol=1e-5, rtol=0)
        else:
            values = got.float().numpy() * scales.numpy()[..., None, :, None]
            jvalues = want[name].astype(np.float32) * jscales[..., None, :, None]
            step = float(max(scales.max(), jscales.max()))
            np.testing.assert_allclose(values, jvalues, atol=1.01 * step, rtol=0)


def _copy_pool(pool):
    """The pool's page and scale arrays as they are now (the windows write
    the pool in place; JAX gets this copy)."""
    return PoolCopy(pool.pages_k.clone(), pool.pages_v.clone(), pool.k_scales.clone(),
                    pool.v_scales.clone())


@dataclasses.dataclass
class PoolCopy:
    pages_k: torch.Tensor
    pages_v: torch.Tensor
    k_scales: torch.Tensor
    v_scales: torch.Tensor


def _run_linear(jmodel, jparams, model, tokens, kv_dtype=None, eos=-1):
    """The port's linear verify window on a fresh pool, and JAX's on a copy
    of the same pages; returns ``(port results, JAX results)``."""
    pool, lanes, tables, index = _pool(model, kv_dtype)
    lanes.eos[:] = eos
    want = _jax_window(jmodel, jparams, _copy_pool(pool), tables, index, tokens, eos=eos)
    out, n_commit, err = verify_window(model, pool.pages_k, pool.pages_v, pool.k_scales,
                                       pool.v_scales, tables, index, torch.from_numpy(tokens),
                                       lanes, 0)
    return dict(out=out.numpy(), n_commit=n_commit.numpy(), pending=lanes.pending.numpy(),
                qerr=float(err), pool=pool), want


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("accept", ["chain", "wrong"])
def test_linear_verify_window_matches_jax(models, kv_dtype, accept):
    """K = 3 drafts: the true greedy chain commits all K + 1 (native pages),
    wrong drafts commit 1; ``out``, ``n_commit`` and the pending tokens
    identical to JAX's, the pages and the quantization error held as the
    module says."""
    jmodel, jparams, model = models
    k = 3
    chain, _ = _greedy_chain(model, k + 1, kv_dtype)
    pending = np.asarray([p[-1] for p in PROMPTS], np.int32)
    drafts = chain[:, :k] if accept == "chain" else (chain[:, :k] + 1) % 256
    tokens = np.concatenate([pending[:, None], drafts], axis=1).astype(np.int32)
    got, want = _run_linear(jmodel, jparams, model, tokens, kv_dtype)
    for key in ("out", "n_commit", "pending"):
        np.testing.assert_array_equal(got[key], want[key])
    if accept == "chain" and kv_dtype is None:
        assert got["n_commit"].tolist() == [k + 1, k + 1]
        np.testing.assert_array_equal(got["out"], chain)
    if accept == "wrong":
        assert got["n_commit"].tolist() == [1, 1]
    _hold_pages(got["pool"], want, kv_dtype)
    assert got["qerr"] == pytest.approx(want["qerr"], abs=1e-6)
    assert (got["qerr"] > 0) == (kv_dtype is not None)


def _tree_tokens(model, tree, kv_dtype=None, alt=None):
    """Draft trees whose branch 1 carries the true greedy chain and every
    other branch a token the chain does not hold."""
    chain, decoded = _greedy_chain(model, tree.depth + 1, kv_dtype)
    pending = np.asarray([p[-1] for p in PROMPTS], np.int32)
    tokens = np.zeros((SLOTS, tree.nodes), np.int32)
    tokens[:, 0] = pending
    for lane in range(SLOTS):
        other = alt if alt is not None else next(
            t for t in range(1, 256) if t not in chain[lane] and t != pending[lane])
        for b in range(tree.width):
            tokens[lane, tree.paths[b, 1:]] = chain[lane, :tree.depth] if b == 1 else other
    return tokens, chain, decoded


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("width,depth", [(2, 3), (3, 2)])
def test_tree_verify_window_matches_jax(models, kv_dtype, width, depth):
    """The tree verify with its path commit: branch 1 (the true chain) wins
    and commits depth + 1 tokens (native pages); ``out``, ``n_commit``,
    pending, the pages after the commit and ``quant_err`` held against
    JAX's; with native pages the committed rows equal the ones plain decode
    wrote (the layout linear decode builds)."""
    jmodel, jparams, model = models
    tree = TreeSpec(width, depth)
    tokens, chain, decoded = _tree_tokens(model, tree, kv_dtype)
    pool, lanes, tables, index = _pool(model, kv_dtype)
    snap = _copy_pool(pool)
    out, n_commit, err = tree_verify_window(model, tree, tpa.TreeMask(tree.anc), pool.pages_k,
                                            pool.pages_v, pool.k_scales, pool.v_scales, tables,
                                            index, torch.from_numpy(tokens), lanes, 0)
    want = _jax_window(jmodel, jparams, snap, tables, index, tokens, kind="tree", tree=tree)
    np.testing.assert_array_equal(out.numpy(), want["out"])
    np.testing.assert_array_equal(n_commit.numpy(), want["n_commit"])
    np.testing.assert_array_equal(lanes.pending.numpy(), want["pending"])
    _hold_pages(pool, want, kv_dtype)
    assert float(err) == pytest.approx(want["qerr"], abs=1e-6)
    if kv_dtype is None:
        assert n_commit.tolist() == [depth + 1] * SLOTS
        np.testing.assert_array_equal(out.numpy(), chain)
        for lane in range(SLOTS):
            start = int(index[lane])
            for pos in range(start, start + depth + 1):
                pid, off = pool.tables[lane, pos // PAGE], pos % PAGE
                for mine, ref in ((pool.pages_k, decoded.pages_k), (pool.pages_v, decoded.pages_v)):
                    np.testing.assert_allclose(mine[:, pid, off].numpy(),
                                               ref[:, pid, off].numpy(), atol=1e-5, rtol=0)


def test_tree_eos_on_losing_branch_does_not_stop_the_lane(models):
    """The losing branches carry nothing but the EOS token: the winning
    path commits in full and never emits it (as JAX)."""
    jmodel, jparams, model = models
    tree = TreeSpec(2, 3)
    chain, _ = _greedy_chain(model, tree.depth + 1)
    eos = next(t for t in range(1, 256) if t not in chain)
    tokens, _, _ = _tree_tokens(model, tree, alt=eos)
    pool, lanes, tables, index = _pool(model)
    lanes.eos[:] = eos
    snap = _copy_pool(pool)
    out, n_commit, _ = tree_verify_window(model, tree, tpa.TreeMask(tree.anc), pool.pages_k,
                                          pool.pages_v, pool.k_scales, pool.v_scales, tables,
                                          index, torch.from_numpy(tokens), lanes, 0)
    want = _jax_window(jmodel, jparams, snap, tables, index, tokens, eos=eos, kind="tree",
                       tree=tree)
    assert n_commit.tolist() == want["n_commit"].tolist() == [tree.depth + 1] * SLOTS
    np.testing.assert_array_equal(out.numpy(), want["out"])
    assert eos not in out.numpy()


def test_eos_on_the_accepted_path_stops_the_commit(models):
    """An EOS the model itself emits inside the window ends the commit
    there (pad after it), in both arms, as JAX."""
    jmodel, jparams, model = models
    tree = TreeSpec(2, 3)
    tokens, chain, _ = _tree_tokens(model, tree)
    eos = int(chain[0, 1])
    pool, lanes, tables, index = _pool(model)
    lanes.eos[:] = eos
    snap = _copy_pool(pool)
    out, n_commit, _ = tree_verify_window(model, tree, tpa.TreeMask(tree.anc), pool.pages_k,
                                          pool.pages_v, pool.k_scales, pool.v_scales, tables,
                                          index, torch.from_numpy(tokens), lanes, 0)
    want = _jax_window(jmodel, jparams, snap, tables, index, tokens, eos=eos, kind="tree",
                       tree=tree)
    np.testing.assert_array_equal(out.numpy(), want["out"])
    assert n_commit[0] == 2 and out[0, 2:].tolist() == [0, 0]
    linear = np.concatenate([tokens[:, :1], chain[:, :3]], axis=1).astype(np.int32)
    got, want = _run_linear(jmodel, jparams, model, linear, eos=eos)
    np.testing.assert_array_equal(got["out"], want["out"])
    assert got["n_commit"][0] == 2


@pytest.mark.parametrize("kind", ["linear", "tree"])
def test_sampled_lanes_reproducible_and_in_vocab(models, kind):
    """Sampled lanes draw from their own keys, a fixed count a window: the
    same seed gives the same tokens, another seed other ones (over a few
    windows), and every token is in the vocabulary.  ``top_k=1`` collapses
    each distribution to its argmax, so the sampled rule then commits the
    greedy chain."""
    _, _, model = models
    tree = TreeSpec(2, 3)
    tokens, chain, _ = _tree_tokens(model, tree)
    if kind == "linear":
        tokens = np.concatenate([tokens[:, :1], chain[:, :3]], axis=1).astype(np.int32)

    def run(seed, top_k, temperature=1.5):
        pool, lanes, tables, index = _pool(model)
        for lane in range(SLOTS):
            lanes.install(lane, int(tokens[lane, 0]), -1, temperature, top_k, 1.0,
                          lane_key(seed, lane))
        outs = []
        for _ in range(3):
            args = (pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales, tables, index,
                    torch.from_numpy(tokens), lanes, 0)
            out, n_commit, _ = (verify_window(model, *args) if kind == "linear" else
                                tree_verify_window(model, tree, tpa.TreeMask(tree.anc), *args))
            outs.append(out.numpy().copy())
        return np.stack(outs), n_commit.numpy()

    a, _ = run(3, 0)
    b, _ = run(3, 0)
    c, _ = run(4, 0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < model.config.vocab_size)).all()
    point, n_commit = run(3, 1)
    np.testing.assert_array_equal(point[0], chain)
    assert n_commit.tolist() == [chain.shape[1]] * SLOTS


@pytest.mark.parametrize("kind", ["decode", "linear", "tree"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_windows_over_static_buffers_match_direct_calls(models, kind, kv_dtype):
    """The engine binds each window once to its static buffers (tables,
    index, verify tokens) and writes them in place every cycle: such a call
    gives the outputs, pending tokens and pages of a direct call on fresh
    tensors, on the CPU."""
    _, _, model = models
    tree = TreeSpec(2, 3)
    tokens, chain, _ = _tree_tokens(model, tree, kv_dtype)
    if kind == "linear":
        tokens = np.concatenate([tokens[:, :1], chain[:, :3]], axis=1).astype(np.int32)

    def call(pool, lanes, tables, index, toks):
        kv = (pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales, tables, index)
        if kind == "decode":
            return decode_window(model, 3, *kv, lanes, 0)
        if kind == "linear":
            return verify_window(model, *kv, toks, lanes, 0)
        return tree_verify_window(model, tree, tpa.TreeMask(tree.anc), *kv, toks, lanes, 0)

    pool, lanes, tables, index = _pool(model, kv_dtype)
    direct = call(pool, lanes, tables, index, torch.from_numpy(tokens))
    static = _pool(model, kv_dtype)
    s_pool, s_lanes = static[0], static[1]
    bufs = (torch.zeros_like(tables), torch.zeros_like(index), torch.zeros_like(
        torch.from_numpy(tokens)))
    window = functools.partial(call, s_pool, s_lanes, *bufs)
    for buf, value in zip(bufs, (tables, index, torch.from_numpy(tokens))):
        buf.copy_(value)
    got = window()
    for a, b in zip(direct, got):
        assert torch.equal(a, b)
    assert torch.equal(lanes.pending, s_lanes.pending)
    for name in ("pages_k", "pages_v", "k_scales", "v_scales"):
        assert torch.equal(getattr(pool, name), getattr(s_pool, name))
