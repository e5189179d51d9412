"""Port parity: the prefix KV cache on the paged serving path.

* Cache operations: one scripted sequence of inserts, matches, pins,
  evictions, spills, settles, promotions, flushes and disk-ring moves runs
  on the JAX ``PrefixCache`` and the port's, each with a fake spill hook;
  after every step the tree (node keys, tiers, pins, LRU stamps, pages,
  bytes), the hooks' traffic (LRU victims) and ``stats()`` must be equal
  (the port's ``stats()`` adds ``disk_writes`` and ``disk_s``).  These are the cases of
  ``tests/test_hier_cache.py``'s ``TestSpillTierMechanics`` and
  ``TestDiskTier``.
* Byte accounting: ``chunk_bytes`` (pages and both scale slabs) equals the
  JAX pool's for f32, bf16, int8 and fp8 pages.
* Pool operations: ``copy_page``, ``spill_extract`` and ``promote_install``
  are bit for bit the JAX executables on the same pools, and write the
  port's pool tensors in place (their ``data_ptr()`` does not move).
* Engine parity: the JAX ``ServingEngine(paged=True)`` (Pallas kernels in
  interpret mode) and the port give identical greedy tokens and identical
  ``prefix_hit_tokens``, ``prefix_hit_tokens_host``, ``prefix_miss_tokens``,
  ``cow_copies``, ``preemptions`` and ``prefill_chunks``, for native, int8
  and fp8 pages, ``async_depth`` 0 and 1, the host tier off and on, under
  preemption, and with the disk ring.
* The port alone: cache on equals cache off (greedy, sampled, both
  speculation arms), the ``cache_prefix=False`` opt-out, a preempted lane
  replaying through its own chunks, a copy-on-write leaving the cached
  pages untouched, pages freeing only at refcount zero, and the knobs'
  validation.

The workloads are the reference's ``_shared_workload`` (8-token prompts
submitted twice: the repeats hit prefixes the small device budget has
spilled) and a shared 8-token system prefix with distinct tails mixed with
other prompts; 2 slots, buckets (4, 8), pages of 4 tokens.  Tokens and
counters are compared exactly.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.models.generation import GenerationConfig as JGenerationConfig
from accelerate_tpu.models.transformer import Transformer as JTransformer
from accelerate_tpu.models.transformer import TransformerConfig as JConfig
from accelerate_tpu.serving import PagedKVPool as JPagedKVPool
from accelerate_tpu.serving import PrefixCache as JPrefixCache
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving.pool import (
    make_copy_page,
    make_promote_install,
    make_spill_extract,
)
from accelerate_tpu.telemetry import MetricsRegistry
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig
from accelerate_tpu_torch.serving import PagedKVPool, PrefixCache, ServingEngine
from accelerate_tpu_torch.serving.pool import copy_page, promote_install, spill_extract
from accelerate_tpu_torch.serving.prefix_cache import rolling_hash
from accelerate_tpu_torch.weights import params_from_jax

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(4, 8), prefill_token_budget=8,
                 decode_window=2)
NBYTES = 100  # a node's cost in the cache-operation scripts
COUNTERS = ("prefix_hit_tokens", "prefix_hit_tokens_host", "prefix_miss_tokens",
            "cow_copies", "preemptions", "prefill_chunks")


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_off():
    """As in ``test_torch_engine.py``: the JAX engine beats no heartbeat
    that a later ``/healthz`` check in the same process could find stale."""
    from accelerate_tpu.telemetry import metrics as jax_metrics

    was = jax_metrics.enabled()
    jax_metrics.set_enabled(False)
    yield
    jax_metrics.set_enabled(was)


# ------------------------------------------------------------ cache operations
class _Side:
    """One package's cache under a script: the cache, a fake spill hook that
    records its traffic, and the payload type that package lands."""

    def __init__(self, package, capacity, host=0, fail=False, landed=False, **kw):
        self.package, self.fail, self.landed = package, fail, landed
        self.spilled, self.evicted = [], []
        cls = JPrefixCache if package == "jax" else PrefixCache
        extra = {"registry": MetricsRegistry()} if package == "jax" else {}
        self.cache = cls(capacity, on_evict=self.evicted.append, host_capacity_bytes=host,
                         spill=self.spill if host else None, **extra, **kw)
        self.nodes = {}

    def payload(self):
        rng = np.random.default_rng(0)
        arrays = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(4)]
        if self.package == "jax":
            return tuple(arrays)
        return tuple(torch.from_numpy(a) for a in arrays)

    def spill(self, node):
        if self.fail:
            return None
        self.spilled.append(node.key)
        if self.landed:
            return self.payload()
        return (f"k{node.key}", f"v{node.key}", "ks", "vs")

    def insert(self, i, parent=None):
        parent = self.nodes[parent] if parent is not None else None
        node = self.cache.insert_pages(parent, np.full(4, 10 + i, np.int32),
                                       (2 * i, 2 * i + 1), nbytes=NBYTES)
        if node is not None:
            self.nodes[i] = node
        return node is not None

    def snapshot(self):
        """Every node of the tree with its state, the hooks' traffic and the
        stats."""
        rows, stack = [], [self.cache.root]
        while stack:
            n = stack.pop()
            for key in sorted(n.children):
                c = n.children[key]
                rows.append((key, c.tier, c.refs, c.last_used, c.pages, c.nbytes))
                stack.append(c)
        stats = self.cache.stats()
        stats.pop("disk_writes", None)
        stats.pop("disk_s", None)
        return rows, list(self.spilled), [n.key for n in self.evicted], stats


def _match(side, i):
    return [n.key for n in side.cache.match(np.full(4, 10 + i, np.int32), [(4, 4)])]


def _loaded(side, i):
    payload = side.cache.node_payload(side.nodes[i])
    if payload is None or isinstance(payload[0], str):
        return payload
    return [np.asarray(p) for p in payload]


SCRIPTS = {
    # eviction demotes, and the spilled node still hits
    "demote_and_match": (dict(host=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("match", 0)]),
    "no_host_tier_drops": (dict(), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("match", 0)]),
    "failed_spill_drops": (dict(host=10 * NBYTES, fail=True), [
        ("insert", 0), ("insert", 1), ("insert", 2)]),
    "per_tier_lru": (dict(host=2 * NBYTES + NBYTES // 2), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("insert", 3), ("insert", 4)]),
    "pinned_never_spill": (dict(host=10 * NBYTES), [
        ("insert", 0), ("acquire", 0), ("insert", 1), ("acquire", 1), ("evict_one",),
        ("insert", 2), ("release", 0), ("insert", 3)]),
    "promote_readmits": (dict(host=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("payload", 0), ("promote", 0)]),
    "promotion_blocked_by_pins": (dict(host=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("acquire", 1), ("acquire", 2),
        ("promote", 0), ("payload", 0)]),
    "settle_then_promote": (dict(host=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("settle", 0), ("promote", 0),
        ("settle", 0)]),
    "host_budget": (dict(host=2 * NBYTES), [("insert", i) for i in range(6)]),
    "flush_all_tiers": (dict(host=10 * NBYTES), [
        *[("insert", i) for i in range(4)], ("flush",)]),
    "discard_spilled": (dict(host=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("discard", 0), ("match", 0),
        ("discard", 0)]),
    "chain_and_evict": (dict(host=10 * NBYTES, capacity=3 * NBYTES), [
        ("insert", 0), ("insert", 1, 0), ("insert", 2, 1), ("insert", 3), ("evict_one",),
        ("evict_one",), ("match", 0), ("flush",)]),
    "disk_roundtrip": (dict(host=NBYTES, landed=True, disk=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("insert", 3), ("payload", 0),
        ("promote", 0), ("files",)]),
    "inflight_not_disk_eligible": (dict(host=NBYTES, disk=10 * NBYTES), [
        ("insert", 0), ("insert", 1), ("insert", 2), ("insert", 3), ("files",)]),
    "flush_unlinks_disk_files": (dict(host=NBYTES, landed=True, disk=10 * NBYTES), [
        *[("insert", i) for i in range(4)], ("files",), ("flush",), ("files",)]),
}


def _run_script(package, knobs, ops, disk_dir):
    knobs = dict(knobs)
    capacity = knobs.pop("capacity", 2 * NBYTES + NBYTES // 2)
    disk = knobs.pop("disk", 0)
    kw = dict(disk_capacity_bytes=disk, disk_dir=disk_dir) if disk else {}
    side = _Side(package, capacity, **knobs, **kw)
    trace = []
    for op, *args in ops:
        nodes = [side.nodes[a] for a in args if a in side.nodes]
        if op == "insert":
            out = side.insert(*args)
        elif op == "match":
            out = _match(side, args[0])
        elif op == "acquire":
            out = side.cache.acquire(nodes)
        elif op == "release":
            out = side.cache.release(nodes)
        elif op == "evict_one":
            out = side.cache.evict_one()
        elif op == "flush":
            out = side.cache.flush()
        elif op == "payload":
            out = _loaded(side, args[0])
        elif op == "promote":
            out = side.cache.promote_node(nodes[0], (40 + args[0], 41 + args[0]))
        elif op == "settle":
            out = side.cache.settle_payload(nodes[0], ("landed",) * 4)
            out = nodes[0].host
        elif op == "discard":
            out = side.cache.discard_spilled(nodes[0])
        else:  # "files"
            out = sorted(f for f in os.listdir(disk_dir) if f.startswith("prefix_"))
        trace.append((op, out, side.snapshot()))
    return trace


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_cache_operations_match_jax(script, tmp_path):
    """Each step of the script gives the same result, tree, hook traffic
    and stats in both packages."""
    knobs, ops = SCRIPTS[script]
    dirs = {}
    for package in ("jax", "torch"):
        dirs[package] = tmp_path / package
        dirs[package].mkdir()
    jax_trace = _run_script("jax", knobs, ops, str(dirs["jax"]))
    port_trace = _run_script("torch", knobs, ops, str(dirs["torch"]))
    assert len(jax_trace) == len(port_trace)
    for (op, jout, jsnap), (_, pout, psnap) in zip(jax_trace, port_trace):
        if isinstance(jout, list) and jout and isinstance(jout[0], np.ndarray):
            assert all(np.array_equal(a, b) for a, b in zip(jout, pout)), op
        else:
            assert jout == pout, op
        assert jsnap == psnap, op
    if script == "disk_roundtrip":
        # the payload came back bit for bit, and the promoted node's ring
        # file (the first written) was unlinked
        assert jax_trace[4][1] is not None
        assert not [f for f in jax_trace[-1][1] if f.endswith("_1.npz")]


def test_disk_ring_needs_a_dir_and_keeps_bits(tmp_path):
    """``disk_capacity_bytes`` without ``disk_dir`` is refused as in the
    reference; a bf16 and an fp8 payload (no numpy dtype) round-trip the
    disk ring bit for bit."""
    with pytest.raises(ValueError, match="disk_dir"):
        JPrefixCache(1024, registry=MetricsRegistry(), disk_capacity_bytes=1024)
    with pytest.raises(ValueError, match="disk_dir"):
        PrefixCache(1024, disk_capacity_bytes=1024)
    gen = torch.Generator().manual_seed(0)
    payload = (torch.randn((2, 3, 4), generator=gen).bfloat16(),
               torch.randn((2, 3, 4), generator=gen).to(torch.float8_e4m3fn),
               torch.randint(-127, 128, (2, 5), dtype=torch.int8, generator=gen),
               torch.rand((2, 5), generator=gen))
    cache = PrefixCache(NBYTES, host_capacity_bytes=NBYTES, spill=lambda node: payload,
                        disk_capacity_bytes=10 * NBYTES, disk_dir=str(tmp_path))
    first = cache.insert_pages(None, np.arange(4), (1, 2), nbytes=NBYTES)
    cache.insert_pages(None, np.arange(4) + 1, (3, 4), nbytes=NBYTES)
    cache.insert_pages(None, np.arange(4) + 2, (5, 6), nbytes=NBYTES)
    assert first.tier == "disk" and cache.stats()["disk_writes"] == 1
    back = cache.node_payload(first)
    for got, want in zip(back, payload):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_rolling_hash_matches_jax():
    from accelerate_tpu.serving.prefix_cache import rolling_hash as jhash

    rng = np.random.default_rng(1)
    for n in (0, 1, 8, 512):
        toks = rng.integers(0, 32000, n)
        assert rolling_hash(5381, toks) == jhash(5381, toks)
    assert rolling_hash(rolling_hash(5381, [1, 2]), [3]) == rolling_hash(5381, [1, 2, 3])


# -------------------------------------------------------------- byte accounting
@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8", "fp8"])
def test_chunk_bytes_match_jax(kv_dtype):
    """Pages and both f32 scale slabs, as in the reference, for native,
    bf16, int8 and fp8 pages."""
    jcfg = JConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, max_seq_len=64)
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, max_seq_len=64)
    jpool = JPagedKVPool(jcfg, num_slots=2, max_len=64, page_size=8, num_pages=17,
                         registry=MetricsRegistry(), kv_dtype=kv_dtype)
    pool = PagedKVPool(cfg, 2, 64, 8, 17, kv_dtype=kv_dtype, device="cpu")
    assert pool.page_kv_bytes == jpool.page_kv_bytes
    for npg in (1, 2, 5):
        assert pool.chunk_bytes(npg) == jpool.chunk_bytes(npg)
    per_page = sum(t.nbytes for t in (pool.pages_k, pool.pages_v, pool.k_scales,
                                      pool.v_scales)) // pool.num_pages
    assert pool.chunk_bytes(1) == per_page


# -------------------------------------------------------------- pool operations
_FORMATS = {  # name: (numpy bits, ml_dtypes type, torch dtype)
    "f32": (np.uint32, np.float32, torch.float32),
    "bf16": (np.uint16, ml_dtypes.bfloat16, torch.bfloat16),
    "int8": (np.uint8, np.int8, torch.int8),
    "fp8": (np.uint8, ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
}
_TORCH_BITS = {np.uint32: torch.int32, np.uint16: torch.int16, np.uint8: torch.uint8}


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()]
                      ).numpy().view(np.uint8)
    return np.asarray(t).view(np.uint8)


def _twin_pools(fmt, rng):
    """The same page and scale bits as JAX arrays and as the port's tensors:
    ``[L 2, P 9, page 4, Hkv 2, D 8]`` and ``[2, 9, 2]``.  Quantized codes
    avoid the NaN patterns, which JAX's scatter need not keep."""
    bits, jdtype, tdtype = _FORMATS[fmt]
    shape = (2, 9, 4, 2, 8)
    if fmt == "fp8":
        raw = rng.integers(0, 0x7F, shape).astype(np.uint8) | \
            (rng.integers(0, 2, shape).astype(np.uint8) << 7)
    elif fmt == "int8":
        raw = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        raw = rng.standard_normal(shape).astype(np.float32).astype(jdtype).view(bits)
    pages = [raw, np.roll(raw, 1, axis=1)]
    scales = [rng.random((2, 9, 2)).astype(np.float32) for _ in range(2)]
    jax_pool = [jnp.asarray(p.view(jdtype)) for p in pages] + [jnp.asarray(s) for s in scales]
    port_pool = [torch.from_numpy(p.copy()).view(_TORCH_BITS[bits]).view(tdtype)
                 for p in pages] + [torch.from_numpy(s.copy()) for s in scales]
    return jax_pool, port_pool


@pytest.mark.parametrize("fmt", list(_FORMATS))
def test_pool_operations_bitwise_jax_and_in_place(fmt):
    """``copy_page``, ``spill_extract`` and ``promote_install`` against the
    JAX executables on the same bits; the port's pool tensors keep their
    storage."""
    rng = np.random.default_rng(3)
    jpool, pool = _twin_pools(fmt, rng)
    ptrs = [t.data_ptr() for t in pool]
    # copy-on-write of page 3 into page 7
    jpool = list(make_copy_page()(*jpool, jnp.int32(3), jnp.int32(7)))
    copy_page(pool, 3, 7)
    # spill two pages, install them into two others
    ids = np.asarray([5, 2], np.int32)
    jchunk = make_spill_extract(2)(*jpool, jnp.asarray(ids))
    chunk = spill_extract(pool, torch.from_numpy(ids.astype(np.int64)))
    for j, t in zip(jchunk, chunk):
        assert np.array_equal(_bits(j), _bits(t))
    dst = np.asarray([8, 1], np.int32)
    jpool = list(make_promote_install(2)(*jpool, *jchunk, jnp.asarray(dst)))
    promote_install(pool, chunk, torch.from_numpy(dst.astype(np.int64)))
    for j, t in zip(jpool, pool):
        assert np.array_equal(_bits(j), _bits(t))
    assert [t.data_ptr() for t in pool] == ptrs
    for t in pool:
        assert np.array_equal(_bits(t[:, 8]), _bits(t[:, 5]))
        assert np.array_equal(_bits(t[:, 7]), _bits(t[:, 3]))


# ---------------------------------------------------------------- engine parity
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


def _shared_workload(vocab=256, seed=7, n=4, repeat=2):
    """The reference's: distinct full-bucket prompts, each submitted
    ``repeat`` times; the repeats hit prefixes the device budget spilled."""
    rng = np.random.default_rng(seed)
    base = [rng.integers(1, vocab, (8,)).astype(np.int32) for _ in range(n)]
    return [p.copy() for _ in range(repeat) for p in base]


def _system_workload(seed=7):
    """An 8-token system prefix with distinct tails (of 3, 4, 6 and 1
    tokens, and none: that request hits the whole prompt and copies its
    tail page on write), mixed with three other prompts, two of them
    repeated."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 256, 8).astype(np.int32)
    others = [rng.integers(1, 256, 8).astype(np.int32) for _ in range(3)]
    tails = [rng.integers(1, 256, n).astype(np.int32) for n in (3, 4, 6, 1)]
    with_tail = [np.concatenate([system, t]) for t in tails]
    return [with_tail[0], others[0], others[1], with_tail[1], others[2], system.copy(),
            others[0], with_tail[2], others[1], with_tail[3]]


def _cache_mb(cfg, kv_dtype, nodes=2.5):
    """A device budget of ``nodes`` 8-token chunks at the page format."""
    pool = PagedKVPool(cfg, 2, 64, 4, 17, kv_dtype=kv_dtype, device="cpu")
    return nodes * pool.chunk_bytes(2) / 2**20


def _serve(model, prompts, configs, **kw):
    engine = ServingEngine(model, None, device="cpu", **{**ENGINE_KW, **kw})
    reqs = engine.serve([p.copy() for p in prompts], configs=configs)
    return engine, [r.tokens for r in reqs]


PARITY_CASES = {
    f"{kv or 'native'}-depth{depth}-host{'on' if host else 'off'}":
        dict(kv_dtype=kv, async_depth=depth, prefix_host_mb=host)
    for kv in (None, "int8", "fp8") for depth in (0, 1) for host in (0.0, 8.0)
}
PARITY_CASES["int8-depth1-preempt"] = dict(kv_dtype="int8", async_depth=1, prefix_host_mb=8.0,
                                           num_pages=17)
PARITY_CASES["native-depth1-disk"] = dict(kv_dtype=None, async_depth=1, prefix_host_mb="1node",
                                          prefix_disk_mb=8.0)


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_engine_matches_jax_engine(models, case, tmp_path):
    """The system-prefix workload and the reference's shared workload,
    served by the JAX paged engine and by the port with the same knobs:
    greedy tokens and the cache and scheduling counters are identical; the
    host tier serves hits when it is on, and every page returns to the free
    list after a flush."""
    jmodel, jparams, model = models
    knobs = dict(PARITY_CASES[case])
    prompts = _system_workload() + _shared_workload()
    new = 24 if "num_pages" in knobs else 6
    knobs["prefix_cache_mb"] = _cache_mb(model.config, knobs["kv_dtype"])
    if knobs["prefix_host_mb"] == "1node":
        knobs["prefix_host_mb"] = _cache_mb(model.config, None, nodes=1.5)
    if "prefix_disk_mb" in knobs:
        knobs["prefix_disk_dir"] = str(tmp_path)
    jeng = JServingEngine(jmodel, jparams, paged=True, decode_kernel="pallas",
                          registry=MetricsRegistry(), **ENGINE_KW, **knobs)
    jreqs = jeng.serve([p.copy() for p in prompts],
                       configs=JGenerationConfig(max_new_tokens=new, eos_token_id=None))
    engine, toks = _serve(model, prompts, GenerationConfig(max_new_tokens=new), **knobs)
    assert toks == [r.tokens for r in jreqs]
    assert {k: engine.stats[k] for k in COUNTERS} == {k: jeng.stats[k] for k in COUNTERS}
    st, jst = engine.prefix_cache_stats(), jeng.prefix_cache_stats()
    assert {k: st[k] for k in jst} == jst
    assert engine.stats["prefix_hit_tokens"] > 0 and engine.stats["cow_copies"] > 0
    assert engine.stats["promote_degraded"] == 0
    if knobs["prefix_host_mb"]:
        assert st["spills"] > 0 and engine.stats["prefix_hit_tokens_host"] > 0
    if "num_pages" in knobs:
        assert engine.stats["preemptions"] > 0
    if "prefix_disk_mb" in knobs:
        assert st["disk_writes"] > 0
    engine.flush_prefix_cache()
    assert engine.kv.allocator.free_count == engine.num_pages - 1
    assert not [f for f in os.listdir(tmp_path) if f.startswith("prefix_")]


# ---------------------------------------------------------------- port alone
MODES = {
    "greedy": (dict(), GenerationConfig(max_new_tokens=8)),
    "sampled": (dict(rng_seed=3), GenerationConfig(max_new_tokens=8, do_sample=True,
                                                   temperature=0.8, top_k=50)),
    "linear_spec": (dict(speculate_k=2), GenerationConfig(max_new_tokens=8)),
    "tree_spec": (dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16),
                  GenerationConfig(max_new_tokens=8)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cache_on_equals_cache_off(models, mode):
    """The same tokens with the cache (and its host tier) as without: hits
    replay the KV a prefill would have written, and sampled lanes draw from
    device keys that do not depend on scheduling."""
    _, _, model = models
    knobs, gen = MODES[mode]
    prompts = _system_workload()
    mb = _cache_mb(model.config, None)
    on, toks_on = _serve(model, prompts, gen, prefix_cache_mb=mb, prefix_host_mb=8.0, **knobs)
    _, toks_off = _serve(model, prompts, gen, prefix_cache_mb=0, **knobs)
    assert toks_on == toks_off
    assert on.stats["prefix_hit_tokens"] > 0 and on.stats["prefix_hit_tokens_host"] > 0


def test_cache_prefix_opt_out(models):
    """``submit(..., cache_prefix=False)``: the request neither hits nor
    populates; the others still do."""
    _, _, model = models
    prompts = _system_workload()
    gen = GenerationConfig(max_new_tokens=4)
    engine = ServingEngine(model, None, device="cpu", **ENGINE_KW)
    assert engine.prefix_cache is not None and engine.prefix_cache.capacity == 64 * 2**20
    opted = [engine.submit(p, config=gen, cache_prefix=False) for p in prompts]
    engine.run()
    st = engine.stats
    assert st["prefix_hit_tokens"] == st["prefix_miss_tokens"] == 0
    assert engine.prefix_cache.num_nodes == 0
    _, plain = _serve(model, prompts, gen, prefix_cache_mb=0)
    assert [r.tokens for r in opted] == plain
    _, cached = _serve(model, prompts, gen)
    assert cached == plain


def test_preempted_lane_replays_through_its_own_chunks(models):
    """A page-starved pool preempts; the victim's replay hits the full
    chunks its first life cached (its prompt and generated tokens): the
    reclaim ladder evicts cache leaves before it preempts, so they come
    back from the host ring.  The tokens equal a cache-off serve without
    preemption."""
    _, _, model = models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (12, 11, 10)]
    gen = GenerationConfig(max_new_tokens=40)
    engine, toks = _serve(model, prompts, gen, num_pages=17, prefix_host_mb=8.0)
    _, ref = _serve(model, prompts, gen, prefix_cache_mb=0)
    assert toks == ref
    assert engine.stats["preemptions"] > 0 and engine.stats["prefix_hit_tokens"] > 0


def test_copy_on_write_leaves_the_cached_pages(models):
    """A request whose whole prompt is cached copies its tail page on write
    before decoding into it: the cached pages keep their bits, and the
    tokens equal the first serve's."""
    _, _, model = models
    prompt = np.random.default_rng(11).integers(1, 256, 8).astype(np.int32)
    gen = GenerationConfig(max_new_tokens=6)
    engine = ServingEngine(model, None, device="cpu", **ENGINE_KW)
    first = engine.serve([prompt.copy()], configs=gen)[0].tokens
    (node,) = engine.prefix_cache._nodes
    kv = engine.kv
    before = [t[:, list(node.pages)].clone() for t in (kv.pages_k, kv.pages_v)]
    assert list(kv.allocator.refs[list(node.pages)]) == [1, 1]
    second = engine.serve([prompt.copy()], configs=gen)[0].tokens
    assert second == first and engine.stats["cow_copies"] == 2
    assert engine.stats["prefix_hit_tokens"] == 8
    for t, b in zip((kv.pages_k, kv.pages_v), before):
        assert torch.equal(t[:, list(node.pages)], b)


def test_pages_free_only_at_refcount_zero(models):
    """Cached pages hold one reference each and stay allocated after the
    serve; lanes aliasing them add theirs; a flush frees every page."""
    _, _, model = models
    engine = ServingEngine(model, None, device="cpu", **ENGINE_KW)
    reqs = [engine.submit(p, max_new_tokens=4) for p in _system_workload()[:4]]
    seen_shared = False
    while engine.has_work:
        engine.step()
        seen_shared |= engine.kv.allocator.shared_extra_refs() > 0
    assert all(r.done for r in reqs) and seen_shared
    cached = [p for n in engine.prefix_cache._nodes for p in n.pages]
    assert cached and all(engine.kv.allocator.refs[p] == 1 for p in cached)
    assert engine.kv.allocator.used_count == len(cached)
    nodes = engine.prefix_cache.num_nodes
    assert engine.flush_prefix_cache() == nodes
    assert engine.kv.allocator.free_count == engine.num_pages - 1


def test_prefix_knob_validation(models, tmp_path):
    """The reference's refusals: a host ring needs the cache, a disk ring
    needs the host ring and a directory, and the budget must hold a byte."""
    _, _, model = models
    bad = [
        (dict(prefix_cache_mb=0, prefix_host_mb=8.0), "prefix_cache_mb"),
        (dict(prefix_host_mb=0.0, prefix_disk_mb=8.0), "prefix_host_mb"),
        (dict(prefix_host_mb=8.0, prefix_disk_mb=8.0), "disk_dir"),
        (dict(prefix_cache_mb=1e-9), "positive"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            ServingEngine(model, None, device="cpu", **ENGINE_KW, **kw)
    engine = ServingEngine(model, None, device="cpu", prefix_host_mb=8.0, prefix_disk_mb=8.0,
                           prefix_disk_dir=str(tmp_path), **ENGINE_KW)
    st = engine.prefix_cache_stats()
    assert st["host_capacity_bytes"] == 8 * 2**20 and st["hit_rate"] == 0.0
    off = ServingEngine(model, None, device="cpu", prefix_cache_mb=0, **ENGINE_KW)
    assert off.prefix_cache is None and off.flush_prefix_cache() == 0
