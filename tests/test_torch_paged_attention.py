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

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import paged_attention as jpa
from accelerate_tpu_torch.ops import paged_attention as tpa

STALE = 1e4  # stale pages past a lane's frontier hold large finite garbage


def _scenario(seed, n, s, page, pages_per_lane, hkv, rep, d):
    """Ragged paged-KV state as numpy: per-lane tables over a shared pool,
    the ``s`` new positions' KV already inserted, and every table slot past
    a lane's live pages holding another lane's id or a stale page."""
    rng = np.random.default_rng(seed)
    num_pages = n * pages_per_lane + 2
    stale = num_pages - 1
    tables = np.arange(1, n * pages_per_lane + 1).reshape(n, pages_per_lane).astype(np.int32)
    cap = page * (pages_per_lane - 1) - s
    lengths = rng.integers(0, cap + 1, n).astype(np.int32)
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
