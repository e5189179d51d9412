"""Port parity: the PyTorch plain paged-attention versions vs the JAX kernels.

The port's ``paged_attention`` / ``paged_flash_prefill`` take their plain
PyTorch versions on CPU tensors; the JAX wrappers run their Pallas kernels in
interpret mode (their CPU default).  The same numpy inputs go through both:
ragged lengths, dead table slots holding stale page ids of other lanes,
GQA rep 1 and 2, f32 and bf16 pages, int8 and fp8-e4m3 pages with their
per-(page, kv-head) scales, and prefill chunks at a nonzero base.  The
quantized write path (``paged_quantized_insert``) must match the JAX
function bit for bit: codes, scales and error.

Tolerances: f32 2e-5 — the JAX kernel's online softmax against the port's
full-row softmax, the same bound the JAX package holds its kernel to against
its own reference; bf16 2e-2 (decode) / 3e-2 (prefill) — the plain version
rounds logits and probabilities to bf16 where the kernel keeps f32, the JAX
package's own bf16 bounds.  Quantized pages are held to the same bounds as
the q dtype's: both sides dequantize the same codes with the same scales.
"""

import inspect
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import paged_attention as jpa
from accelerate_tpu_torch.ops import paged_attention as tpa

STALE = 1e4  # stale pages past a lane's frontier hold large finite garbage


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under
    the tier-1 run's six workers such threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenario(seed, n, s, page, pages_per_lane, hkv, rep, d, lengths=None):
    """Ragged paged-KV state as numpy: per-lane tables over a shared pool,
    the ``s`` new positions' KV already inserted, and every table slot past
    a lane's live pages holding another lane's id or a stale page.  Lengths
    are drawn from the seed unless given."""
    rng = np.random.default_rng(seed)
    num_pages = n * pages_per_lane + 2
    stale = num_pages - 1
    tables = np.arange(1, n * pages_per_lane + 1).reshape(n, pages_per_lane).astype(np.int32)
    cap = page * (pages_per_lane - 1) - s
    drawn = rng.integers(0, cap + 1, n).astype(np.int32)
    lengths = drawn if lengths is None else np.asarray(lengths, np.int32)
    pages_k = np.zeros((num_pages, page, hkv, d), np.float32)
    pages_v = np.zeros((num_pages, page, hkv, d), np.float32)
    pages_k[stale] = STALE
    pages_v[stale] = -STALE
    for lane in range(n):
        t_total = int(lengths[lane]) + s
        kv = rng.normal(size=(2, t_total, hkv, d)).astype(np.float32)
        for t in range(t_total):
            pages_k[tables[lane, t // page], t % page] = kv[0, t]
            pages_v[tables[lane, t // page], t % page] = kv[1, t]
    live = (lengths + s - 1) // page + 1
    for lane in range(n):
        for slot in range(int(live[lane]), pages_per_lane):
            # alternate: a previous owner's stale page, or a neighbour's live one
            tables[lane, slot] = stale if slot % 2 else tables[(lane + 1) % n, 0]
    q = rng.normal(size=(n, s, hkv * rep, d)).astype(np.float32)
    return q, pages_k, pages_v, tables, lengths


def _run_both(fn_jax, fn_torch, arrays, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, pk, pv, tables, lengths = arrays
    ref = fn_jax(jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
                 jnp.asarray(tables), jnp.asarray(lengths))
    out = fn_torch(torch.from_numpy(q).to(dtype), torch.from_numpy(pk).to(dtype),
                   torch.from_numpy(pv).to(dtype), torch.from_numpy(tables),
                   torch.from_numpy(lengths))
    return out.float().numpy(), np.asarray(ref, np.float32)


def _codes(jax_array, fmt):
    """A JAX int8 / fp8 array as the port's tensor of the same bits."""
    bits = np.asarray(jax_array).view(np.uint8)
    return torch.from_numpy(bits.copy()).view(tpa.KV_FORMATS[fmt][0])


def _quantized_scenario(seed, fmt, *case):
    """``_scenario``'s state with its pages turned into codes of ``fmt``
    (30 x the values, rounded into [-100, 100], cast by JAX) and random
    per-(page, kv-head) scales near 1/30, so that the dequantized values
    keep the native scenario's unit scale; as JAX arrays and as the port's
    tensors of the same bits."""
    q, pk, pv, tables, lengths = _scenario(seed, *case)
    rng = np.random.default_rng(seed + 1)
    jdt = jpa.KV_FORMATS[fmt][0]
    jk, jv = (jnp.asarray(np.clip(np.round(a * 30), -100, 100)).astype(jdt) for a in (pk, pv))
    ks, vs = (rng.uniform(0.5 / 30, 1.5 / 30, (pk.shape[0], pk.shape[2])).astype(np.float32)
              for _ in range(2))
    return (q, jk, jv, tables, lengths, ks, vs), (_codes(jk, fmt), _codes(jv, fmt))


def _run_quantized(fn_jax, fn_torch, seed, fmt, dtype, case):
    (q, jk, jv, tables, lengths, ks, vs), (tk, tv) = _quantized_scenario(seed, fmt, *case)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = fn_jax(jnp.asarray(q, jdt), jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
                 k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    out = fn_torch(torch.from_numpy(q).to(dtype), tk, tv, torch.from_numpy(tables),
                   torch.from_numpy(lengths), k_scales=torch.from_numpy(ks),
                   v_scales=torch.from_numpy(vs))
    return out.float().numpy(), np.asarray(ref, np.float32)


DECODE_CASES = [
    # n, s, page, pages_per_lane, hkv, rep, d
    (1, 1, 8, 4, 2, 1, 16),    # plain decode, MHA
    (3, 1, 8, 4, 2, 2, 32),    # batched decode, GQA rep 2
    (2, 3, 8, 4, 2, 1, 16),    # verify-width span crossing a page
    (4, 1, 16, 3, 1, 2, 64),   # GQA rep 2, head_dim 64
]

PREFILL_CASES = [
    (1, 8, 8, 4, 2, 1, 16),    # one chunk == one page, MHA
    (2, 16, 8, 6, 2, 2, 32),   # chunk spans pages, GQA rep 2
    (3, 4, 16, 3, 2, 1, 16),   # chunk smaller than a page
    (2, 8, 8, 5, 1, 2, 64),    # GQA rep 2, head_dim 64
    # the page sizes K2's tensor-core arm tiles apart: 64-key tiles of 8 or 4
    # small pages, or one box of a page of 64 or 128, with chunks whose last
    # tile straddles the causal frontier and stale slots inside a tile
    (2, 40, 8, 12, 2, 1, 16),   # eight pages per tile
    (2, 40, 16, 8, 1, 2, 16),   # four pages per tile, GQA rep 2
    (1, 80, 64, 3, 2, 1, 16),   # a tile is a page
    (2, 70, 128, 3, 2, 2, 32),  # two tiles per page, GQA rep 2
    # a GQA group of 128 query heads per kv head: K2 splits it into two
    # q-blocks of 64 over the same kv head's pages
    (2, 8, 8, 4, 1, 128, 16),
]


class TestDecodeParity:
    @pytest.mark.parametrize("case", DECODE_CASES)
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
    def test_matches_jax_kernel(self, case, dtype, atol):
        arrays = _scenario(zlib.crc32(repr(("d", case)).encode()), *case)
        out, ref = _run_both(jpa.paged_attention, tpa.paged_attention, arrays, dtype)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=atol)

    @pytest.mark.parametrize("case", DECODE_CASES)
    @pytest.mark.parametrize("fmt", ["int8", "fp8"])
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
    def test_quantized_pages_match_jax_kernel(self, case, fmt, dtype, atol):
        """The dequant arm (``quantized``, the JAX kernel's ``:291``): the
        plain version over int8 / fp8 codes and their scales."""
        out, ref = _run_quantized(jpa.paged_attention, tpa.paged_attention,
                                  zlib.crc32(repr(("dq", case, fmt)).encode()), fmt, dtype, case)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=atol)

    def test_dead_slots_never_read(self):
        """Poisoning every page past each lane's live count leaves the plain
        version's output bitwise unchanged."""
        q, pk, pv, tables, lengths = _scenario(42, 3, 1, 8, 4, 2, 2, 16)
        args = [torch.from_numpy(a) for a in (q, pk, pv, tables, lengths)]
        out = tpa.paged_attention(*args)
        live = (lengths + 1 - 1) // 8 + 1
        pk2, pv2 = pk.copy(), pv.copy()
        owned = {int(tables[lane, slot]) for lane in range(3) for slot in range(int(live[lane]))}
        for p in range(1, pk.shape[0]):
            if p not in owned:
                pk2[p], pv2[p] = 1e9, 1e9
        out2 = tpa.paged_attention(args[0], torch.from_numpy(pk2), torch.from_numpy(pv2),
                                   *args[3:])
        torch.testing.assert_close(out, out2, rtol=0, atol=0)


# ------------------------------------------------------ K1's tree-mask arm
def _random_tree(seed, nodes):
    """A random ancestor-closed mask: node i's parent drawn from 0 .. i - 1."""
    rng = np.random.default_rng(seed)
    parent = [0] + [int(rng.integers(0, i)) for i in range(1, nodes)]
    anc = np.zeros((nodes, nodes), bool)
    for i in range(nodes):
        j = i
        anc[i, j] = True
        while j:
            j = parent[j]
            anc[i, j] = True
    return anc


def _tree_masks():
    from accelerate_tpu.serving.spec_exec import TreeSpec as JTreeSpec

    return {"2x3": JTreeSpec(2, 3).anc, "31x1": JTreeSpec(31, 1).anc,
            "random9": _random_tree(9, 9)}


TREE_CASES = [
    # n, page, pages_per_lane, hkv, rep, d, tree
    (3, 8, 4, 2, 1, 16, "2x3"),    # the engine's chains, spans crossing pages
    (2, 8, 6, 1, 2, 16, "31x1"),   # 32 nodes: word bit 31, GQA rep 2 (64 rows)
    (3, 16, 3, 2, 2, 32, "random9"),  # the words are data
]


class TestTreeArmParity:
    """K1's tree-mask arm (``accelerate_tpu/ops/paged_attention.py:300-315``):
    the port's plain version with ``tree_mask`` against JAX's plain version
    and JAX's kernel in interpret mode, on native f32 and int8 pages.
    Tolerance 2e-5, the f32 decode bound above."""

    @pytest.mark.parametrize("case", TREE_CASES)
    def test_matches_jax_reference_and_kernel(self, case):
        n, page, ppl, hkv, rep, d, name = case
        anc = _tree_masks()[name]
        s = anc.shape[0]
        q, pk, pv, tables, lengths = _scenario(zlib.crc32(repr(("tree", case)).encode()),
                                               n, s, page, ppl, hkv, rep, d)
        jargs = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
                 jnp.asarray(lengths))
        ref = np.asarray(jpa.paged_attention_reference(*jargs, tree_mask=anc))
        kernel = np.asarray(jpa.paged_attention(*jargs, tree_mask=anc, interpret=True))
        targs = [torch.from_numpy(a) for a in (q, pk, pv, tables, lengths)]
        out = tpa.paged_attention(*targs, tree_mask=anc).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=2e-5)
        np.testing.assert_allclose(out, kernel, atol=2e-5)
        # the mask matters: the causal arm differs where a node hides a slot
        causal = tpa.paged_attention(*targs).numpy()
        assert np.abs(causal - out).max() > 1e-3
        assert np.array_equal(
            tpa.paged_attention(*targs, tree_mask=tpa.TreeMask(anc)).numpy(), out)

    @pytest.mark.parametrize("name", ["2x3", "random9"])
    def test_int8_pages_match_jax_kernel(self, name):
        anc = _tree_masks()[name]
        s = anc.shape[0]
        case = (3, s, 8, 4, 2, 2, 16)
        (q, jk, jv, tables, lengths, ks, vs), (tk, tv) = _quantized_scenario(
            zlib.crc32(repr(("tree8", name)).encode()), "int8", *case)
        kw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), tree_mask=anc)
        ref = np.asarray(jpa.paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                                             jnp.asarray(lengths), interpret=True, **kw))
        out = tpa.paged_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
                                  torch.from_numpy(lengths), k_scales=torch.from_numpy(ks),
                                  v_scales=torch.from_numpy(vs), tree_mask=anc).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_words_pack_as_the_reference_does(self):
        """Bit j of node i's word set iff node i sees node j: the words the
        reference bakes into its kernel (``:392-406``), here a device array
        of int32 bit patterns."""
        for anc in _tree_masks().values():
            want = (anc.astype(np.uint64) << np.arange(anc.shape[0], dtype=np.uint64)).sum(1)
            mask = tpa.TreeMask(anc)
            assert mask.packed().tolist() == want.astype(np.uint32).tolist()
            words = mask.words("cpu")
            assert words.dtype == torch.int32 and words is mask.words("cpu")
            assert words.numpy().view(np.uint32).tolist() == want.tolist()

    def test_refusals(self):
        """As the reference: a mask that is not [S, S], or more than 32
        nodes, raises ValueError (on every device, before any dispatch)."""
        q, pk, pv, tables, lengths = _scenario(5, 2, 33, 8, 6, 1, 1, 16)
        args = [torch.from_numpy(a) for a in (q, pk, pv, tables, lengths)]
        with pytest.raises(ValueError, match="32"):
            tpa.paged_attention(*args, tree_mask=np.tril(np.ones((33, 33), bool)))
        with pytest.raises(ValueError, match="S, S"):
            tpa.paged_attention(args[0][:, :7], *args[1:], tree_mask=np.ones((6, 6), bool))
        with pytest.raises(ValueError, match="square"):
            tpa.TreeMask(np.ones((3, 4), bool))


# ------------------------------------------------- K1's split walk and merge
MASK_VALUE = np.float32(-0.7 * np.finfo(np.float32).max)  # the kernels' finite mask


def _split_merge_model(q, pages_k, pages_v, tables, lengths, pps):
    """Plain f32 model of K1's algorithm, for the tests only: split ``z`` of
    (lane, kv-head) walks the table slots ``[z * pps, (z + 1) * pps)`` up to
    the lane's last key; a split past the live pages does nothing.  Each
    working split keeps its partial (m, l, acc) over its keys, masked keys
    at the finite mask value (a row that sees none of a split's keys keeps
    m at the mask, which the merge weighs by 0), and the partials merge in
    split order; l == 0 reads as 1.  The ``rep * S`` folded rows go in
    blocks of ``DECODE_ROWS``, each walking the keys on its own, as the
    kernel's CTAs do."""
    q, pages_k, pages_v = (np.asarray(a, np.float32) for a in (q, pages_k, pages_v))
    n, s, hq, d = q.shape
    page, hkv = pages_k.shape[1], pages_k.shape[2]
    rep, num_p = hq // hkv, tables.shape[1]
    out = np.zeros_like(q)
    rows = np.arange(rep * s)
    for lane in range(n):
        length = int(lengths[lane])
        live = min((length + s - 1) // page + 1, num_p)
        last = min(length + s, live * page)
        visible_to = length + rows % s                   # row r sees keys <= this
        for h in range(hkv):
            # fold the group's heads into rows, group-major: r -> head h * rep + r // s
            qf = q[lane, :, h * rep:(h + 1) * rep].transpose(1, 0, 2).reshape(rep * s, d)
            qf = qf * np.float32(d ** -0.5)
            o = np.zeros_like(qf)
            rpb, _ = tpa.decode_row_blocks(rep * s)
            for r0 in range(0, rep * s, rpb):
                block = slice(r0, min(r0 + rpb, rep * s))
                parts = []
                for z in range(-(-num_p // pps)):
                    if z * pps >= live:
                        break
                    keys = np.arange(z * pps * page, min((z + 1) * pps * page, last))
                    pid = tables[lane, keys // page]
                    k = pages_k[pid, keys % page, h]
                    v = pages_v[pid, keys % page, h]
                    x = np.where(keys[None, :] <= visible_to[block, None], qf[block] @ k.T,
                                 MASK_VALUE)
                    m = x.max(axis=1)
                    p = np.exp(x - m[:, None])
                    parts.append((m, p.sum(axis=1), p @ v))
                top = np.max([m for m, _, _ in parts], axis=0)
                weights = [np.exp(m - top) for m, _, _ in parts]
                l_sum = sum(w * l for w, (_, l, _) in zip(weights, parts))
                acc = sum(w[:, None] * a for w, (_, _, a) in zip(weights, parts))
                o[block] = acc / np.where(l_sum == 0, 1.0, l_sum)[:, None]
            out[lane, :, h * rep:(h + 1) * rep] = o.reshape(rep, s, d).transpose(1, 0, 2)
    return out


SPLIT_CASES = DECODE_CASES + [
    # n, s, page, pages_per_lane, hkv, rep, d, lengths
    (2, 1, 8, 5, 2, 1, 16, [0, 30]),    # an empty lane beside a long one
    (2, 5, 8, 4, 2, 2, 16, [15, 0]),    # keys 16..19 are a split no row 0 sees
    # past the 32 folded rows K1 once took: GQA 8 verifying 5 (40), rep 2 at S 17 (34)
    (2, 5, 8, 4, 1, 8, 16, [3, 20]),
    (2, 17, 8, 6, 2, 2, 16, [0, 21]),
]


class TestSplitWalk:
    @pytest.mark.parametrize("pps", [1, 2, None])
    @pytest.mark.parametrize("case", SPLIT_CASES)
    def test_split_merge_model_matches_jax_kernel(self, case, pps):
        n, s, page, ppl, hkv, rep, d, *lengths = case
        arrays = _scenario(zlib.crc32(repr(("split", case)).encode()), n, s, page, ppl, hkv,
                           rep, d, lengths=lengths[0] if lengths else None)
        q, pk, pv, tables, lens = arrays
        if pps is None:  # the plan for a small card: several splits per lane
            pps, _ = tpa.decode_split_plan(ppl, n, hkv, page, sm_count=2)
        ref = jpa.paged_attention(*(jnp.asarray(a) for a in arrays))
        out = _split_merge_model(q, pk, pv, tables, lens, pps)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=2e-5)

    @pytest.mark.parametrize("num_p,n,hkv,page,sm_count", [
        (16, 4, 32, 128, 132),    # the serving path: 4 lanes x 32 heads, page 128
        (16, 4, 8, 128, 132),     # GQA 32/8
        (16, 2, 32, 128, 132),
        (128, 2, 32, 16, 132),    # pages of 16: a split walks at least 128 keys
        (256, 1, 1, 8, 132),      # one lane, one head: the split cap
        (1000, 1, 1, 128, 132),
        (13, 64, 32, 128, 132),   # more (lane, head) pairs than CTAs wanted
        (7, 3, 2, 24, 1),
        (1, 1, 1, 4, 132),
    ])
    def test_split_plan_tiles_the_table(self, num_p, n, hkv, page, sm_count):
        """The splits lie inside the table and cover every slot once; for
        any lengths, the splits a launch walks (those starting inside the
        lane's live pages) cover exactly the live pages."""
        pps, splits = tpa.decode_split_plan(num_p, n, hkv, page, sm_count)
        assert 1 <= pps <= num_p and 1 <= splits <= 64
        spans = [range(z * pps, min((z + 1) * pps, num_p)) for z in range(splits)]
        assert all(len(span) > 0 for span in spans)
        assert [p for span in spans for p in span] == list(range(num_p))
        rng = np.random.default_rng(num_p * n + page)
        for s in (1, 3):
            for length in rng.integers(0, num_p * page - s + 1, 20):
                live = (int(length) + s - 1) // page + 1
                walked = [p for span in spans if span.start < live for p in span if p < live]
                assert walked == list(range(live))

    @pytest.mark.parametrize("gs", [1, 3, 4, 5, 12, 16, 17, 32, 33, 34, 40, 200])
    def test_row_blocks_cover_the_rows(self, gs):
        """K1's CTAs hold DECODE_ROWS rows each: a call covers its rep * S
        rows in blocks of four, the last one ragged, and never a block with
        no row."""
        rows, blocks = tpa.decode_row_blocks(gs)
        assert rows == min(gs, tpa.DECODE_ROWS) and blocks == -(-gs // tpa.DECODE_ROWS)
        assert (blocks - 1) * tpa.DECODE_ROWS < gs <= blocks * tpa.DECODE_ROWS

    @pytest.mark.parametrize("gs", [1, 3, 4, 5, 34, 40])
    @pytest.mark.parametrize("nsplit", [2, 5, 64])
    def test_partials_fit_the_scratch_apart(self, gs, nsplit):
        """Model of K1's partial indexing (``paged_attention.cu``): every
        (lane, kv-head, row block, split) writes its acc rows and (m, l)
        pairs to a region of its own, inside the f32 scratch the wrapper
        allocates — so a merge reads only what its own splits wrote."""
        n, hkv, d = 3, 2, 16
        rows, blocks = tpa.decode_row_blocks(gs)
        size = n * hkv * blocks * nsplit * rows * (d + 2)  # as paged_attention allocates
        acc_total = n * hkv * blocks * nsplit * rows * d
        used = np.zeros(size, np.int32)
        for lane_head in range(n * hkv * blocks):
            g = min(tpa.DECODE_ROWS, gs - (lane_head % blocks) * tpa.DECODE_ROWS)
            for z in range(nsplit):
                acc0 = lane_head * nsplit * rows * d + z * g * d
                ml0 = acc_total + lane_head * nsplit * rows * 2 + z * g * 2
                used[acc0:acc0 + g * d] += 1
                used[ml0:ml0 + g * 2] += 1
                assert acc0 + g * d <= acc_total and ml0 + g * 2 <= size
        assert used.max() == 1

    def test_split_plan_never_reads_lengths(self):
        """The plan is a function of shapes and the card: nothing a launch
        would have to read back from the device."""
        params = inspect.signature(tpa.decode_split_plan).parameters
        assert list(params) == ["num_p", "n", "hkv", "page", "sm_count"]


class TestPrefillParity:
    @pytest.mark.parametrize("case", PREFILL_CASES)
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
    def test_matches_jax_kernel(self, case, dtype, atol):
        arrays = _scenario(zlib.crc32(repr(("p", case)).encode()), *case)
        out, ref = _run_both(jpa.paged_flash_prefill, tpa.paged_flash_prefill, arrays, dtype)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=atol)

    @pytest.mark.parametrize("case", PREFILL_CASES)
    @pytest.mark.parametrize("fmt", ["int8", "fp8"])
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
    def test_quantized_pages_match_jax_kernel(self, case, fmt, dtype, atol):
        """K2's dequant arm (the JAX kernel's ``:511``) through the plain
        version, on int8 / fp8 codes and their scales."""
        out, ref = _run_quantized(jpa.paged_flash_prefill, tpa.paged_flash_prefill,
                                  zlib.crc32(repr(("pq", case, fmt)).encode()), fmt, dtype, case)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=atol)

    def test_chunk_at_nonzero_base(self):
        """A later chunk (base 13) attends all prior history plus its own
        causal triangle, as the JAX kernel does."""
        q, pk, pv, tables, _ = _scenario(31, 1, 8, 8, 5, 2, 2, 16)
        lengths = np.asarray([13], np.int32)
        out, ref = _run_both(jpa.paged_flash_prefill, tpa.paged_flash_prefill,
                             (q, pk, pv, tables, lengths), torch.float32)
        np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("q_dtype,page_dtype,page,design", [
    (torch.bfloat16, torch.bfloat16, 128, "wgmma"),   # the engine's pages
    (torch.bfloat16, torch.int8, 128, "wgmma"),       # codes converted to bf16 tiles
    (torch.bfloat16, torch.float8_e4m3fn, 128, "wgmma"),
    (torch.bfloat16, torch.int8, 16, "wgmma"),
    (torch.bfloat16, torch.float8_e4m3fn, 24, "cuda-cores"),
    (torch.float32, torch.int8, 128, "cuda-cores"),   # f32 q keeps f32 products
    (torch.float32, torch.float8_e4m3fn, 128, "cuda-cores"),
    (torch.bfloat16, torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 4, "cuda-cores"),    # a box under 8 rows
    (torch.bfloat16, torch.bfloat16, 24, "cuda-cores"),   # neither divides 64 nor a multiple
    (torch.bfloat16, torch.bfloat16, 96, "cuda-cores"),
    (torch.float32, torch.float32, 128, "cuda-cores"),    # f32 keeps f32 products
    (torch.bfloat16, torch.float32, 128, "cuda-cores"),
    (torch.float32, torch.bfloat16, 128, "cuda-cores"),
])
def test_prefill_design_from_shapes_alone(q_dtype, page_dtype, page, design):
    """K2's arm is chosen from the dtypes, the page size and the head dim
    before launch: the tensor-core arm at D 64 and 128, never at 16 or 32."""
    assert tpa.prefill_design(q_dtype, page_dtype, page, 128) == design
    assert tpa.prefill_design(q_dtype, page_dtype, page, 64) == design
    for d in (16, 32):
        assert tpa.prefill_design(q_dtype, page_dtype, page, d) == "cuda-cores"


class TestPagedInsert:
    def test_matches_jax_and_routes_inactive_to_null(self):
        rng = np.random.default_rng(5)
        pages = rng.normal(size=(7, 4, 2, 8)).astype(np.float32)
        new = rng.normal(size=(3, 3, 2, 8)).astype(np.float32)
        tables = np.asarray([[1, 2, 3], [4, 5, 6], [6, 5, 4]], np.int32)
        index = np.asarray([2, 5, 1], np.int32)
        active = np.asarray([True, True, False])
        ref = jpa.paged_insert(jnp.asarray(pages), jnp.asarray(new), jnp.asarray(tables),
                               jnp.asarray(index), jnp.asarray(active))
        out = tpa.paged_insert(torch.from_numpy(pages.copy()), torch.from_numpy(new),
                               torch.from_numpy(tables), torch.from_numpy(index),
                               torch.from_numpy(active))
        ref = np.asarray(ref)
        # the null page takes the inactive lane's writes in both; which of the
        # colliding writes wins there is unspecified, so compare real pages
        np.testing.assert_array_equal(out.numpy()[1:], ref[1:])
        np.testing.assert_array_equal(out.numpy()[6], pages[6])  # frozen lane's page
        assert not np.array_equal(out.numpy()[0], pages[0])

    def test_writes_in_place_and_casts(self):
        pages = torch.zeros(3, 4, 1, 2, dtype=torch.bfloat16)
        new = torch.full((1, 2, 1, 2), 1.5)
        out = tpa.paged_insert(pages, new, torch.tensor([[1, 2]], dtype=torch.int32),
                               torch.tensor([3], dtype=torch.int32), torch.tensor([True]))
        assert out is pages
        assert pages[1, 3].float().sum() == 3.0 and pages[2, 0].float().sum() == 3.0


class TestWrapperDispatch:
    def test_cpu_path_does_not_count_launches(self):
        tpa.reset_launch_counts()
        q, pk, pv, tables, lengths = _scenario(3, 2, 1, 8, 3, 1, 1, 16)
        args = [torch.from_numpy(a) for a in (q, pk, pv, tables, lengths)]
        tpa.paged_attention(*args)
        tpa.paged_flash_prefill(*args)
        assert tpa.paged_attention.launches == 0 == tpa.paged_flash_prefill.launches

    @pytest.mark.parametrize("fn", [tpa.paged_attention, tpa.paged_flash_prefill])
    def test_non_cpu_tensor_never_falls_back(self, fn):
        """A tensor that is not on the CPU goes to the kernel path, which
        refuses anything but a CUDA tensor instead of running the plain one."""
        meta = torch.empty(1, 1, 2, 64, device="meta")
        pages = torch.empty(3, 8, 2, 64, device="meta")
        tables = torch.empty(1, 2, dtype=torch.int32, device="meta")
        lengths = torch.empty(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fn(meta, pages, pages, tables, lengths)

    def test_kv_storage_dtype(self):
        """The storage dtypes and quantization ceilings of the JAX package's
        formats: int8 (127) and fp8-e4m3 (448); native dtypes store directly."""
        assert tpa.kv_storage_dtype(None, torch.float32) is torch.float32
        assert tpa.kv_storage_dtype("bf16", torch.float32) is torch.bfloat16
        assert tpa.kv_storage_dtype("int8", torch.bfloat16) is torch.int8
        assert tpa.kv_storage_dtype("fp8", torch.bfloat16) is torch.float8_e4m3fn
        for fmt, (dtype, qmax) in tpa.KV_FORMATS.items():
            assert qmax == jpa.KV_FORMATS[fmt][1]
            assert tpa.kv_qmax(dtype) == jpa.kv_qmax(jpa.KV_FORMATS[fmt][0])
        assert tpa.kv_qmax(torch.bfloat16) is None and tpa.kv_qmax(torch.float32) is None
        with pytest.raises(ValueError):
            tpa.kv_storage_dtype("fp4", torch.float32)


# ------------------------------------------------------ quantized write path
def _insert_both(fmt, pages, scales, new, tables, index, active):
    """``paged_quantized_insert`` of both packages on the same inputs
    (``pages`` given as f32 values, cast to the format by JAX, the port fed
    the same bits); returns ``((codes, scales, err) of JAX, of the port)``
    with the codes as raw bytes."""
    jdt = jpa.KV_FORMATS[fmt][0]
    jpages = jnp.asarray(pages).astype(jdt) if pages.dtype != np.int8 else jnp.asarray(pages)
    tpages = _codes(jpages, fmt)
    jp, js, je = jpa.paged_quantized_insert(
        jpages, jnp.asarray(scales), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(index), jnp.asarray(active))
    tscales = torch.from_numpy(np.asarray(scales, np.float32).copy())
    tp, ts, te = tpa.paged_quantized_insert(
        tpages, tscales, torch.from_numpy(new), torch.from_numpy(tables),
        torch.from_numpy(index), torch.from_numpy(active))
    assert tp is tpages and ts is tscales          # written in place
    assert te.dim() == 0 and te.dtype == torch.float32
    want = (np.asarray(jp).view(np.uint8), np.asarray(js), np.float32(je))
    got = (tp.view(torch.uint8).numpy(), ts.numpy(), np.float32(te.item()))
    return want, got


def _assert_bit_identical(want, got):
    """Codes, scales and error equal bit for bit on every real page (the
    null page takes colliding discarded writes, in unspecified order)."""
    np.testing.assert_array_equal(got[0][1:], want[0][1:])
    np.testing.assert_array_equal(got[1][1:].view(np.uint32), want[1][1:].view(np.uint32))
    assert got[2].view(np.uint32) == want[2].view(np.uint32)


class TestQuantizedInsert:
    """The four cases of the JAX package's ``TestQuantizedInsert``, each run
    through both packages and held bit for bit, plus a ragged batch."""

    @pytest.mark.parametrize("fmt", ["int8", "fp8"])
    def test_single_shot_scale_is_amax_over_qmax(self, fmt):
        _, qmax = tpa.KV_FORMATS[fmt]
        rng = np.random.default_rng(3)
        page, h, d = 8, 2, 16
        new = rng.normal(size=(1, page, h, d)).astype(np.float32)
        want, got = _insert_both(fmt, np.zeros((3, page, h, d), np.float32),
                                 np.ones((3, h), np.float32), new,
                                 np.asarray([[1, 2]], np.int32), np.asarray([0], np.int32),
                                 np.asarray([True]))
        _assert_bit_identical(want, got)
        amax = np.abs(new[0]).max(axis=(0, 2))
        np.testing.assert_allclose(got[1][1], amax / qmax, rtol=1e-6)
        assert 0.0 < got[2]

    @pytest.mark.parametrize("fmt", ["int8", "fp8"])
    def test_requant_exact_when_amax_unchanged(self, fmt):
        """A second insert under the page's amax leaves the old codes and
        the scale as they were, in both packages."""
        rng = np.random.default_rng(4)
        page, h, d = 8, 1, 4
        first = rng.normal(size=(1, 4, h, d)).astype(np.float32)
        first[0, 0, 0, 0] = 5.0
        tables = np.asarray([[1]], np.int32)
        want, got = _insert_both(fmt, np.zeros((2, page, h, d), np.float32),
                                 np.ones((2, h), np.float32), first, tables,
                                 np.asarray([0], np.int32), np.asarray([True]))
        _assert_bit_identical(want, got)
        codes = got[0].view(np.int8) if fmt == "int8" else got[0]
        second = np.clip(rng.normal(size=(1, 4, h, d)), -1, 1).astype(np.float32)
        jdt = jpa.KV_FORMATS[fmt][0]
        pages = np.asarray(jnp.asarray(codes.view(np.dtype(jdt)) if fmt == "fp8" else codes))
        want2, got2 = _insert_both(fmt, pages.astype(np.float32) if fmt == "fp8" else pages,
                                   got[1], second, tables, np.asarray([4], np.int32),
                                   np.asarray([True]))
        _assert_bit_identical(want2, got2)
        assert got2[1][1, 0] == got[1][1, 0]
        np.testing.assert_array_equal(got2[0][1, :4], got[0][1, :4])

    def test_stale_slots_cannot_inflate_the_scale(self):
        page, h, d = 8, 1, 2
        pages = np.zeros((2, page, h, d), np.int8)
        pages[1, 4:] = 127                                 # garbage past the frontier
        want, got = _insert_both("int8", pages, np.full((2, h), 100.0, np.float32),
                                 np.full((1, 2, h, d), 0.5, np.float32),
                                 np.asarray([[1]], np.int32), np.asarray([2], np.int32),
                                 np.asarray([True]))
        _assert_bit_identical(want, got)
        np.testing.assert_allclose(got[1][1], 0.5 / 127, rtol=1e-6)
        assert got[0][1, 4:].sum() == 0

    @pytest.mark.parametrize("fmt", ["int8", "fp8"])
    def test_inactive_lane_is_a_noop_on_real_pages(self, fmt):
        page, h, d = 4, 1, 2
        want, got = _insert_both(fmt, np.zeros((2, page, h, d), np.float32),
                                 np.ones((2, h), np.float32),
                                 np.full((1, 1, h, d), 3.0, np.float32),
                                 np.asarray([[1]], np.int32), np.asarray([0], np.int32),
                                 np.asarray([False]))
        _assert_bit_identical(want, got)
        assert got[0][1].sum() == 0 and (got[1][1] == 1.0).all()

    @pytest.mark.parametrize("fmt", ["int8", "fp8"])
    @pytest.mark.parametrize("s", [1, 3, 11])
    def test_ragged_batch_bit_identical(self, fmt, s):
        """Three lanes writing spans that cross pages over history, a
        frozen lane, stale values past each frontier, a wide value range
        (fp8 subnormals included): every code, scale and the error equal."""
        rng = np.random.default_rng(100 + s)
        page, h, d, ppl = 4, 2, 8, 6
        pages = (rng.normal(size=(3 * ppl + 1, page, h, d)) * 50).astype(np.float32)
        scales = rng.uniform(0.01, 2.0, (3 * ppl + 1, h)).astype(np.float32)
        new = (rng.normal(size=(3, s, h, d))
               * np.exp(rng.uniform(-8, 3, (3, s, h, 1)))).astype(np.float32)
        tables = np.arange(1, 3 * ppl + 1, dtype=np.int32).reshape(3, ppl)
        index = np.asarray([0, 5, page * ppl - s - 1], np.int32)
        active = np.asarray([True, True, False]) if s != 3 else np.asarray([True] * 3)
        want, got = _insert_both(fmt, pages, scales, new, tables, index, active)
        _assert_bit_identical(want, got)
        assert got[2] > 0.0
