"""Port parity: the PyTorch plain paged-attention versions vs the JAX kernels.

The port's ``paged_attention`` / ``paged_flash_prefill`` take their plain
PyTorch versions on CPU tensors; the JAX wrappers run their Pallas kernels in
interpret mode (their CPU default).  The same numpy inputs go through both:
ragged lengths, dead table slots holding stale page ids of other lanes,
GQA rep 1 and 2, f32 and bf16 pages, and prefill chunks at a nonzero base.

Tolerances: f32 2e-5 — the JAX kernel's online softmax against the port's
full-row softmax, the same bound the JAX package holds its kernel to against
its own reference; bf16 2e-2 (decode) / 3e-2 (prefill) — the plain version
rounds logits and probabilities to bf16 where the kernel keeps f32, the JAX
package's own bf16 bounds.
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
]


class TestDecodeParity:
    @pytest.mark.parametrize("case", DECODE_CASES)
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
    def test_matches_jax_kernel(self, case, dtype, atol):
        arrays = _scenario(zlib.crc32(repr(("d", case)).encode()), *case)
        out, ref = _run_both(jpa.paged_attention, tpa.paged_attention, arrays, dtype)
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


# ------------------------------------------------- K1's split walk and merge
MASK_VALUE = np.float32(-0.7 * np.finfo(np.float32).max)  # the kernels' finite mask


def _split_merge_model(q, pages_k, pages_v, tables, lengths, pps):
    """Plain f32 model of K1's algorithm, for the tests only: split ``z`` of
    (lane, kv-head) walks the table slots ``[z * pps, (z + 1) * pps)`` up to
    the lane's last key; a split past the live pages does nothing.  Each
    working split keeps its partial (m, l, acc) over its keys, masked keys
    at the finite mask value (a row that sees none of a split's keys keeps
    m at the mask, which the merge weighs by 0), and the partials merge in
    split order; l == 0 reads as 1."""
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
            parts = []
            for z in range(-(-num_p // pps)):
                if z * pps >= live:
                    break
                keys = np.arange(z * pps * page, min((z + 1) * pps * page, last))
                pid = tables[lane, keys // page]
                k = pages_k[pid, keys % page, h]
                v = pages_v[pid, keys % page, h]
                x = np.where(keys[None, :] <= visible_to[:, None], qf @ k.T, MASK_VALUE)
                m = x.max(axis=1)
                p = np.exp(x - m[:, None])
                parts.append((m, p.sum(axis=1), p @ v))
            top = np.max([m for m, _, _ in parts], axis=0)
            weights = [np.exp(m - top) for m, _, _ in parts]
            l_sum = sum(w * l for w, (_, l, _) in zip(weights, parts))
            acc = sum(w[:, None] * a for w, (_, _, a) in zip(weights, parts))
            o = acc / np.where(l_sum == 0, 1.0, l_sum)[:, None]
            out[lane, :, h * rep:(h + 1) * rep] = o.reshape(rep, s, d).transpose(1, 0, 2)
    return out


SPLIT_CASES = DECODE_CASES + [
    # n, s, page, pages_per_lane, hkv, rep, d, lengths
    (2, 1, 8, 5, 2, 1, 16, [0, 30]),    # an empty lane beside a long one
    (2, 5, 8, 4, 2, 2, 16, [15, 0]),    # keys 16..19 are a split no row 0 sees
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
    """K2's arm is chosen from the dtypes and the page size before launch."""
    assert tpa.prefill_design(q_dtype, page_dtype, page) == design


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
        assert tpa.kv_storage_dtype(None, torch.float32) is torch.float32
        assert tpa.kv_storage_dtype("bf16", torch.float32) is torch.bfloat16
        with pytest.raises(NotImplementedError):
            tpa.kv_storage_dtype("int8", torch.float32)
        with pytest.raises(ValueError):
            tpa.kv_storage_dtype("fp4", torch.float32)
