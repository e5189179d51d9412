"""Card-only tests of the port: the CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips without a card.  This file
imports torch, the port and ``chip_smoke.py``'s checks only (no JAX), so it
also runs on a machine that has no JAX; run it there, from the repo root,
with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 (the kernels sum in another order than the plain
version, measured errors are ~1e-6); bf16 2e-2 — the plain version rounds
logits and probabilities to bf16 where the kernels keep f32.  The flash
kernels (K3-K5) are held as ``chip_smoke.py`` holds them: relative to the
largest plain value (``FLASH_REL_TOL``), and each tile of 64 positions of
one head at its own scale (``tile_rel_err`` against ``FLASH_TILE_TOL``), so
that an error in one tile cannot hide under the largest value.  The bf16
tensor-core arm of the paged prefill kernel (K2) is held the same way per
tile, against the plain version computed in f32 from the same bf16 inputs
(it rounds the probabilities to bf16 before P.V), and to 3e-2 absolute
against the plain bf16 version, as ``chip_smoke.py`` holds it.  The paged
decode kernel (K1), whose lanes split across CTAs and merge, is also held
per (lane, query, head) row against the plain version in f32
(``ROW_REL_TOL``: bf16 2^-7, f32 1e-5), must repeat bit for bit, and must
leave its arrival counters at zero.  Quantized pages (int8, fp8-e4m3) are
written by the port's own ``paged_quantized_insert`` on the card
(``chip_smoke.quantized_case``: dead slots poisoned with NaN codes or NaN
scales) and held the same ways, the f32 plain version computed from the
same codes and scales.  K1's tree-mask arm (speculative tree verification)
is held the same ways against the plain version with the same
``tree_mask``, at ``chip_smoke.py``'s tree shapes and at D 64 and 16; the
linear and tree verify windows of a 2-layer f32 model on the card are held
against the same windows on the CPU (tokens and commit counts identical,
pages within 1e-4).  The engine's CUDA graphs: each window's and each
prefill bucket's replay bitwise equal to the eager program on the same
inputs (chunks at base 0, after aliased prefix hits and after promotions,
over bf16, int8 and fp8 pages; ``kv_quant_error`` equal with several chunks
a cycle), the pipelined dispatch free of synchronisations
(``torch.cuda.set_sync_debug_mode("error")``, with and without interleaved
prefill), and a failed capture raising.  Weight-only quantization, fp8 and MoE: the fp8
linear (``_scaled_mm``, forward and both gradients) within
``chip_smoke.FP8_LINEAR_REL_TOL`` of its plain version, ``QuantizedLinear``
bitwise an ``nn.Linear`` on the dequantized weight, an MoE layer's graph
replay bitwise its eager call, and a quantized MoE engine's tokens on the
card equal the CPU engine's; the fp8 product zero-padded at M = 4 and 24.
Single-card training memory: per-layer remat bitwise the plain backward
(K3 relaunched by the recompute), the offloaded chunked update bitwise one
chunk's and two in flight's, and its whole-state round trip bitwise the
optimizer kept on the card.  The fleet surface: ``swap_params`` on a graphed
engine replays the new weights with no capture (tokens equal a fresh
engine's), gauges keep the host values they were set to while the graphs
replay, ``/metrics`` is scraped over HTTP while a graphed engine serves,
and ``revive`` after a ``kill`` mid-window serves the same tokens again.
The router's live migration: lanes moved mid-generation by the d2d and the
bounce arm over bf16, int8 and fp8 pages give the unmoved serve's greedy
and sampled tokens, their pages and scales bitwise, with no graph captured
by an install; a prefill handoff queues behind a decode window in flight;
and a replica built by the front door's driver thread (its graphs captured
there) serves requests submitted from another thread.
"""

import functools

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SimpleDataLoader
from accelerate_tpu_torch.models.generation import GenerationConfig
from accelerate_tpu_torch.models.transformer import Transformer, TransformerConfig, lm_loss_fn
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.serving import LaneState, PagedKVPool, ServingEngine
from accelerate_tpu_torch.serving.pool import tree_verify_window, verify_window
from accelerate_tpu_torch.serving.spec_exec import TreeSpec
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.weights import init_params
from accelerate_tpu_torch.ops import _build
from chip_smoke import (
    FLASH_REL_TOL,
    FLASH_TILE_TOL,
    ROW_REL_TOL,
    TOL,
    quantized_case,
    random_tree,
    row_rel_err,
    tile_rel_err,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)


def _case(card, lengths, s, hq, hkv, d, page, ppl, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    n = len(lengths)
    num_pages = n * ppl + 1
    pages = [torch.randn((num_pages, page, hkv, d), generator=gen, device=card).to(dtype)
             for _ in range(2)]
    tables = torch.arange(1, num_pages, dtype=torch.int32, device=card).reshape(n, ppl)
    q = torch.randn((n, s, hq, d), generator=gen, device=card).to(dtype)
    return q, pages[0], pages[1], tables, torch.tensor(lengths, dtype=torch.int32, device=card)


@pytest.mark.parametrize("kernel,plain,s", [
    (pa.paged_attention, pa.paged_attention_reference, 1),
    (pa.paged_attention, pa.paged_attention_reference, 3),
    (pa.paged_flash_prefill, pa.paged_flash_prefill_reference, 40),
])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hkv,d,page", [(4, 128, 16), (2, 64, 32)])
def test_kernel_matches_plain(card, kernel, plain, s, dtype, atol, hkv, d, page):
    args = _case(card, [0, 17, 70], s, 8, hkv, d, page, 8, dtype)
    out = kernel(*args)
    ref = plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def _prefill_case(card, lengths, s, hq, hkv, d, page, seed=0, ppl=None):
    """bf16 paged prefill state whose dead table slots (past each lane's live
    pages) point at NaN-filled pages; the null page 0 holds zeros, as the
    plain version reads it for dead slots.  ``ppl`` table slots per lane
    (default: two past the longest lane's live pages)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n = len(lengths)
    ppl = ppl or max((length + s - 1) // page + 1 for length in lengths) + 2
    live_pages = n * ppl + 1
    shape = (live_pages + 1, page, hkv, d)
    pages = [torch.randn(shape, generator=gen, device=card) for _ in range(2)]
    tables = torch.arange(1, live_pages, dtype=torch.int32, device=card).reshape(n, ppl)
    for lane, length in enumerate(lengths):
        tables[lane, (length + s - 1) // page + 1:] = live_pages
    for t in pages:
        t[0] = 0.0
        t[live_pages] = float("nan")
    q = torch.randn((n, s, hq, d), generator=gen, device=card)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
    return q.bfloat16(), pages[0].bfloat16(), pages[1].bfloat16(), tables, lengths


@pytest.mark.parametrize("page", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("lengths,s,hq,hkv,d", [
    ([0, 37, 100], 90, 8, 8, 128),   # tiles straddle pages and each q-block's frontier
    ([5, 150], 200, 8, 2, 128),      # GQA rep 4, a ragged last q-block
    ([70, 0], 61, 12, 2, 64),        # D 64, rep 6 (64 is no multiple: spare rows)
    ([0, 37, 100], 90, 8, 8, 256),   # D 256: four panels, two N-128 products
    ([5, 150], 200, 8, 1, 256),      # D 256, one kv head (Gemma-2B's MQA)
    ([0, 37, 100], 90, 8, 8, 80),    # D 80: two panels, the second's columns past D zero
    ([70, 0], 61, 12, 2, 96),        # D 96, rep 6
])
def test_paged_prefill_tensor_cores(card, page, lengths, s, hq, hkv, d):
    """The bf16 arm of K2 (wgmma over 64-key tiles read through the block
    table: one box per tile for pages of 64 or more, 64 / page boxes below)
    against the plain version; dead slots hold NaN pages, so a tile that
    read one past the frontier would turn its rows NaN."""
    args = _prefill_case(card, lengths, s, hq, hkv, d, page, seed=page)
    assert pa.prefill_design(args[0].dtype, args[1].dtype, page, d) == "wgmma"
    out = pa.paged_flash_prefill(*args)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_flash_prefill_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k2"][torch.bfloat16], rtol=0)
    ref32 = pa.paged_flash_prefill_reference(*(t.float() for t in args[:3]), *args[3:])
    assert tile_rel_err(out, ref32) <= FLASH_TILE_TOL[torch.bfloat16]


@pytest.mark.parametrize("page,dtype,design", [
    (16, torch.bfloat16, "wgmma"),
    (64, torch.bfloat16, "wgmma"),
    (24, torch.bfloat16, "cuda-cores"),   # neither divides 64 nor is a multiple of it
    (4, torch.bfloat16, "cuda-cores"),    # a box of fewer than 8 rows
    (64, torch.float32, "cuda-cores"),
])
def test_paged_prefill_route(card, page, dtype, design):
    """Each page size and dtype takes the arm ``prefill_design`` names, and
    either arm matches the plain version; the entry point refuses a
    tensor-core launch it cannot run rather than run another arm."""
    q, pk, pv, tables, lengths = (t.to(dtype) if t.is_floating_point() else t
                                  for t in _prefill_case(card, [9, 40], 70, 4, 2, 64, page))
    assert pa.prefill_design(q.dtype, pk.dtype, page, 64) == design
    out = pa.paged_flash_prefill(q, pk, pv, tables, lengths)
    ref = pa.paged_flash_prefill_reference(q, pk, pv, tables, lengths)
    atol = TOL["k2"][dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    if design == "cuda-cores":
        ones = torch.ones((pk.shape[0], 2), device=card)
        with pytest.raises(RuntimeError, match="invalid argument"):
            _build.launch(
                "paged_prefill", "atpu_paged_prefill", "forced tensor cores",
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(), ones.data_ptr(), ones.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), torch.empty_like(q).data_ptr(),
                2, 70, 4, 2, 64, page, pk.shape[0], tables.shape[1],
                int(dtype == torch.bfloat16), int(dtype == torch.bfloat16), 1, 0.125,
                torch.cuda.current_stream().cuda_stream)


K1_CASES = [
    # lengths, s, hq, hkv, d, page, table slots per lane
    ([5, 700, 1500, 2040], 1, 32, 32, 128, 128, 16),  # the serving path's shape
    ([0, 2040], 1, 8, 8, 128, 128, 16),      # an empty lane beside a full one
    ([127, 128, 255], 1, 8, 8, 128, 128, 4),  # at and one past page edges
    ([2040, 33], 1, 8, 8, 128, 16, 128),     # 128 pages of 16: many splits
    ([5, 700, 2040], 3, 8, 2, 128, 128, 16),  # verify span, rep 4 (gs 12)
    ([5, 300, 1000], 1, 8, 2, 64, 128, 16),   # D 64
    ([9, 250], 4, 16, 2, 64, 24, 12),        # gs 32, a page of 24 keys
    ([3, 40, 77], 2, 4, 4, 128, 8, 16),      # pages of 8, a 2-token span
    ([5, 300, 1000], 5, 16, 2, 64, 128, 16),  # 40 rows (rep 8, S 5): two row blocks
    ([9, 250, 700], 17, 8, 4, 128, 16, 64),  # 34 rows (rep 2, S 17), pages of 16
    ([5, 300, 1000], 1, 8, 2, 16, 128, 16),  # D 16
    ([3, 40, 77], 3, 8, 2, 32, 8, 16),       # D 32, pages of 8
    ([5, 700, 1500, 2040], 1, 16, 16, 256, 128, 16),  # Gemma-7B: 16 heads of D 256
    ([5, 300, 1000], 1, 8, 1, 256, 128, 16),  # Gemma-2B: 8 heads over one kv head
    ([5, 700, 2040], 1, 32, 32, 80, 128, 16),  # Phi-2: D 80 (uneven lane shares)
    ([3, 40, 77], 3, 8, 2, 80, 8, 16),       # D 80, pages of 8, a verify span
    ([9, 250, 700], 5, 32, 32, 96, 16, 64),  # Phi-3-mini: D 96, pages of 16
    ([2040, 33], 1, 8, 2, 256, 16, 128),     # D 256, 128 pages of 16: many splits
]


@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("lengths,s,hq,hkv,d,page,ppl", K1_CASES)
def test_paged_decode_split(card, dtype, q_dtype, lengths, s, hq, hkv, d, page, ppl):
    """K1's split walk over NaN dead pages against the plain version: within
    its absolute tolerance, per row against the plain version in f32, bit
    for bit on a second run, and the arrival counters left at zero."""
    q, pk, pv, tables, lens = _prefill_case(card, lengths, s, hq, hkv, d, page,
                                            seed=len(lengths) * page + s, ppl=ppl)
    args = (q.to(q_dtype), pk.to(dtype), pv.to(dtype), tables, lens)
    # f32 tensors take values off the bf16 grid
    args = (*(t + torch.randn(t.shape, device=card) * 2.0**-10 if t.dtype == torch.float32
              else t for t in args[:3]), tables, lens)
    out = pa.paged_attention(*args)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_attention_reference(*args)
    rows32 = (args[0].dtype, args[1].dtype) == (torch.float32, torch.float32)
    atol = TOL["k1"][torch.float32 if rows32 else torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    ref32 = pa.paged_attention_reference(*(t.float() for t in args[:3]), tables, lens)
    assert row_rel_err(out, ref32) <= ROW_REL_TOL[out.dtype]
    assert torch.equal(out, pa.paged_attention(*args))
    assert pa.pending_split_counters() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_page_scales(card, dtype):
    """Per-(page, kv-head) scales, as quantized pages will carry: K1 scales
    each key's logit by its k-scale and its probability by its v-scale, the
    plain version scales the pages before the products."""
    q, pk, pv, tables, lens = _prefill_case(card, [40, 700, 2040], 1, 8, 4, 128, 128,
                                            seed=5, ppl=16)
    args = (q.to(dtype), pk.to(dtype), pv.to(dtype), tables, lens)
    gen = torch.Generator(device=card).manual_seed(6)
    scales = [0.5 + 1.5 * torch.rand((pk.shape[0], 4), generator=gen, device=card)
              for _ in range(2)]
    out = pa.paged_attention(*args, k_scales=scales[0], v_scales=scales[1])
    assert bool(torch.isfinite(out).all())
    ref32 = pa.paged_attention_reference(*(t.float() for t in args[:3]), tables, lens,
                                         k_scales=scales[0], v_scales=scales[1])
    assert row_rel_err(out, ref32) <= ROW_REL_TOL[dtype]
    unscaled = pa.paged_attention(*args)
    assert row_rel_err(unscaled, ref32) > 100 * ROW_REL_TOL[dtype]


K1_QUANT_CASES = [
    # lengths, s, hq, hkv, d, page, table slots per lane
    ([5, 700, 1500, 2040], 1, 32, 32, 128, 128, 16),  # the serving path's shape
    ([5, 700, 2040], 3, 8, 2, 128, 128, 16),  # verify span, rep 4
    ([5, 300, 1000], 5, 16, 2, 64, 128, 16),  # 40 rows
    ([9, 250, 700], 17, 8, 4, 128, 16, 64),  # 34 rows, pages of 16
    ([5, 300, 1000], 1, 8, 2, 16, 128, 16),  # D 16
    ([3, 40, 77], 3, 8, 2, 32, 8, 16),       # D 32, pages of 8
    ([5, 700, 2040], 1, 16, 16, 256, 128, 16),  # D 256 (Gemma-7B's heads)
    ([5, 300, 1000], 1, 32, 32, 80, 128, 16),  # D 80: five 16-byte pieces a key row
    ([9, 250, 700], 3, 8, 2, 96, 16, 64),    # D 96: six pieces, pages of 16
]


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths,s,hq,hkv,d,page,ppl", K1_QUANT_CASES)
def test_paged_decode_quantized(card, fmt, q_dtype, lengths, s, hq, hkv, d, page, ppl):
    """K1's dequant arm over int8 / fp8 codes and their scales: within the
    q dtype's absolute tolerance of the plain version, per row against the
    plain version in f32, bit for bit on a second run, counters at zero."""
    args = quantized_case(len(lengths) * page + s, fmt, lengths, s, hq, hkv, d, page, ppl,
                          q_dtype)
    out = pa.paged_attention(*args)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_attention_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k1"][q_dtype], rtol=0)
    ref32 = pa.paged_attention_reference(*(t.float() for t in args[:3]), *args[3:])
    assert row_rel_err(out, ref32) <= ROW_REL_TOL[q_dtype]
    assert torch.equal(out, pa.paged_attention(*args))
    assert pa.pending_split_counters() == 0


def _quantized_prefill_case(card, fmt, lengths, s, hq, hkv, d, page, q_dtype):
    ppl = max((length + s - 1) // page + 1 for length in lengths) + 2
    return quantized_case(page + s + d, fmt, lengths, s, hq, hkv, d, page, ppl, q_dtype)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("page", [8, 16, 64, 128])
@pytest.mark.parametrize("lengths,s,hq,hkv,d", [
    ([0, 37, 100], 90, 8, 8, 128),   # tiles straddle pages and each q-block's frontier
    ([70, 0], 61, 12, 2, 64),        # D 64, rep 6
    ([0, 37, 100], 90, 8, 1, 256),   # D 256
    ([70, 0], 61, 12, 2, 80),        # D 80: the converted tiles' pad chunks zeroed
    ([0, 37, 100], 90, 8, 8, 96),    # D 96
])
def test_paged_prefill_quantized_tensor_cores(card, fmt, page, lengths, s, hq, hkv, d):
    """K2's dequant arm on the tensor cores: TMA lands the codes, the
    consumer warpgroup converts them to bf16 tiles; held per tile against
    the plain version in f32 from the same codes and scales, to the bf16
    plain version's absolute tolerance, and bit for bit on a second run."""
    args = _quantized_prefill_case(card, fmt, lengths, s, hq, hkv, d, page, torch.bfloat16)
    assert pa.prefill_design(args[0].dtype, args[1].dtype, page, d) == "wgmma"
    out = pa.paged_flash_prefill(*args)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_flash_prefill_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k2"][torch.bfloat16], rtol=0)
    ref32 = pa.paged_flash_prefill_reference(*(t.float() for t in args[:3]), *args[3:])
    assert tile_rel_err(out, ref32) <= FLASH_TILE_TOL[torch.bfloat16]
    assert torch.equal(out, pa.paged_flash_prefill(*args))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("q_dtype,d,page", [
    (torch.float32, 128, 128),   # f32 q keeps f32 products
    (torch.float32, 64, 24),
    (torch.bfloat16, 128, 24),   # a page that tiles into no 64-key box
    (torch.bfloat16, 16, 128),   # D 16 and 32 fill no 64-column panel
    (torch.bfloat16, 32, 16),
    (torch.float32, 16, 8),
    (torch.float32, 256, 128),   # D 256 over pages of 128: key tiles of 64
    (torch.float32, 80, 16),
    (torch.bfloat16, 96, 24),
])
def test_paged_prefill_quantized_cuda_cores(card, fmt, q_dtype, d, page):
    """K2's dequant arm on the CUDA cores (codes times scales as the tiles
    load) against the plain version."""
    args = _quantized_prefill_case(card, fmt, [9, 40], 70, 8, 2, d, page, q_dtype)
    assert pa.prefill_design(args[0].dtype, args[1].dtype, page, d) == "cuda-cores"
    out = pa.paged_flash_prefill(*args)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_flash_prefill_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k2"][q_dtype], rtol=0)
    assert torch.equal(out, pa.paged_flash_prefill(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,page", [(16, 16), (32, 16), (80, 24), (96, 128), (256, 128),
                                    (256, 24)])
def test_paged_prefill_small_head_dims(card, dtype, d, page):
    """K2's CUDA-core arm at D 16 and 32 (TransformerConfig.tiny's 16), and
    at D 80, 96 and 256 where the page or the dtype keeps a call off the
    tensor cores (D 256 over pages of 128 walks key tiles of 64)."""
    q, pk, pv, tables, lengths = (t.to(dtype) if t.is_floating_point() else t
                                  for t in _prefill_case(card, [9, 40, 0], 70, 8, 2, d, page))
    if dtype == torch.bfloat16 and page % 64 == 0 and d >= 64:
        pk, pv = pk.float(), pv.float()  # bf16 q over f32 pages: the CUDA cores
    assert pa.prefill_design(q.dtype, pk.dtype, page, d) == "cuda-cores"
    out = pa.paged_flash_prefill(q, pk, pv, tables, lengths)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_flash_prefill_reference(q, pk, pv, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k2"][dtype], rtol=0)


def test_quantized_pages_need_scales(card):
    args = quantized_case(1, "int8", [5, 40], 1, 4, 2, 64, 16, 4, torch.float32)
    for fn in (pa.paged_attention, pa.paged_flash_prefill):
        with pytest.raises(ValueError, match="need k_scales"):
            fn(*args[:5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq", [65, 128, 192])
def test_prefill_splits_a_group_wider_than_a_q_block(card, dtype, hq):
    """A GQA group of more query heads per kv head than K2's 64-row q-block
    splits into q-blocks of head groups (65: five of 13; 128: two of 64;
    192: three of 64) over the same kv head's pages, in both arms, and
    matches the plain version."""
    args = _case(card, [5, 130], 40, hq, 1, 64, 16, 12, dtype)
    out = pa.paged_flash_prefill(*args)
    ref = pa.paged_flash_prefill_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k2"][dtype], rtol=0)


TREES = {"2x4": TreeSpec(2, 4).anc, "3x3": TreeSpec(3, 3).anc, "31x1": TreeSpec(31, 1).anc,
         "random20": random_tree(78, 20), "random7": random_tree(5, 7)}

K1_TREE_CASES = [
    # lengths, hq, hkv, d, page, table slots per lane, tree
    ([5, 700, 1500, 2000], 32, 32, 128, 128, 16, "2x4"),  # chip_smoke.py's tree_main
    ([5, 700, 1500, 2000], 32, 8, 128, 128, 16, "3x3"),   # 40 folded rows
    ([5, 700, 1500, 2000], 32, 32, 128, 128, 16, "31x1"),  # 32 nodes: word bit 31
    ([5, 700, 1500, 2000], 32, 8, 128, 128, 16, "random20"),  # the words are data
    ([127, 128], 32, 32, 128, 128, 16, "2x4"),            # across a page edge
    ([0, 40, 1000], 16, 2, 64, 128, 16, "random7"),       # D 64, an empty lane
    ([3, 40, 77], 8, 2, 16, 8, 16, "3x3"),                # D 16, pages of 8
    ([5, 700, 1500, 2000], 16, 16, 256, 128, 16, "2x4"),  # D 256
    ([5, 700, 1500, 2000], 32, 32, 80, 128, 16, "2x4"),   # D 80
    ([0, 40, 1000], 32, 32, 96, 16, 64, "random7"),       # D 96, pages of 16
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths,hq,hkv,d,page,ppl,tree", K1_TREE_CASES)
def test_paged_decode_tree_arm(card, dtype, lengths, hq, hkv, d, page, ppl, tree):
    """K1's tree-mask arm over NaN dead pages against the plain version
    with the same mask: within K1's absolute tolerance, per row against the
    plain version in f32, bit for bit on a second run, counters at zero,
    one launch counted on both counters; and unlike the causal arm's
    output wherever a node is hidden from a later slot."""
    anc = TREES[tree]
    s = anc.shape[0]
    q, pk, pv, tables, lens = _prefill_case(card, lengths, s, hq, hkv, d, page,
                                            seed=len(lengths) * page + s, ppl=ppl)
    args = tuple(t.to(dtype) for t in (q, pk, pv)) + (tables, lens)
    mask = pa.TreeMask(anc)
    pa.reset_launch_counts()
    out = pa.paged_attention(*args, tree_mask=mask)
    assert (pa.paged_attention.launches, pa.paged_attention.tree_launches) == (1, 1)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_attention_reference(*args, tree_mask=mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k1"][dtype], rtol=0)
    ref32 = pa.paged_attention_reference(*(t.float() for t in args[:3]), tables, lens,
                                         tree_mask=mask)
    assert row_rel_err(out, ref32) <= ROW_REL_TOL[dtype]
    assert torch.equal(out, pa.paged_attention(*args, tree_mask=mask))
    assert pa.pending_split_counters() == 0
    causal = pa.paged_attention(*args)
    assert pa.paged_attention.tree_launches == 2
    assert row_rel_err(causal, ref32) > 100 * ROW_REL_TOL[dtype]


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_tree_arm_quantized(card, fmt, q_dtype):
    """The tree-mask arm over int8 / fp8 pages (the dequant arm beside it),
    dead slots poisoned: as the native tree cases."""
    mask = pa.TreeMask(TREES["2x4"])
    args = quantized_case(9, fmt, [5, 700, 1500, 2000], 9, 32, 32, 128, 128, 16, q_dtype)
    out = pa.paged_attention(*args, tree_mask=mask)
    assert bool(torch.isfinite(out).all())
    ref = pa.paged_attention_reference(*args, tree_mask=mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["k1"][q_dtype], rtol=0)
    ref32 = pa.paged_attention_reference(*(t.float() for t in args[:3]), *args[3:],
                                         tree_mask=mask)
    assert row_rel_err(out, ref32) <= ROW_REL_TOL[q_dtype]
    assert torch.equal(out, pa.paged_attention(*args, tree_mask=mask))
    assert pa.pending_split_counters() == 0


def test_paged_decode_tree_arm_refusals(card):
    """A mask that is not [S, S] or has more than 32 nodes raises before
    any launch; the words are read from the card."""
    q, pk, pv, tables, lens = _prefill_case(card, [5, 40], 33, 8, 8, 64, 16, seed=1, ppl=8)
    pa.reset_launch_counts()
    with pytest.raises(ValueError, match="32"):
        pa.paged_attention(q, pk, pv, tables, lens, tree_mask=np.tril(np.ones((33, 33), bool)))
    with pytest.raises(ValueError, match="S, S"):
        pa.paged_attention(q[:, :9], pk, pv, tables, lens, tree_mask=TREES["3x3"])
    assert pa.paged_attention.launches == 0
    assert pa.TreeMask(TREES["31x1"]).words(card).device == card


def _verify_setup(dev, sd, cfg, prompts, kv_dtype=None):
    """A 2-lane pool on ``dev`` holding each prompt's KV (prefilled through
    the model), the lanes installed greedy with their last prompt token
    pending."""
    from accelerate_tpu_torch.serving.pool import prefill_chunk

    model = Transformer(cfg, device=dev)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, assign=True)
    pool = PagedKVPool(cfg, 2, 64, 8, 17, kv_dtype=kv_dtype, device=dev)
    lanes = LaneState.create(2, dev)
    lengths = []
    for lane, prompt in enumerate(prompts):
        pool.tables[lane, :8] = np.arange(1 + 8 * lane, 9 + 8 * lane)
        padded = np.zeros(-(-len(prompt) // 8) * 8, np.int32)
        padded[:len(prompt)] = prompt
        table = torch.from_numpy(pool.tables[lane].copy()).to(dev)
        prefill_chunk(model, torch.from_numpy(padded[None]).to(dev), pool.pages_k,
                      pool.pages_v, pool.k_scales, pool.v_scales, table, 0)
        lanes.install(lane, int(prompt[-1]), -1, 1.0, 0, 1.0, None)
        lengths.append(len(prompt) - 1)
    tables = torch.from_numpy(pool.tables.copy()).to(dev)
    index = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return model, pool, lanes, tables, index


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_verify_windows_on_card_match_cpu(card, kv_dtype):
    """A linear verify (K1's causal arm at S = 4) and a tree verify (its
    tree-mask arm at S = 7, and the path commit) of a 2-layer f32 model on
    the card against the same windows on the CPU: tokens and commit counts
    identical, the pages within 1e-4 (the kernels sum in another order)."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 head_dim=64, max_seq_len=64)
    sd = init_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (11, 6)]
    tree = TreeSpec(2, 3)
    draws = rng.integers(1, 256, (2, 3)).astype(np.int32)
    tree_draws = rng.integers(1, 256, (2, tree.nodes)).astype(np.int32)
    results = {}
    for dev in ("cpu", card):
        model, pool, lanes, tables, index = _verify_setup(dev, sd, cfg, prompts, kv_dtype)
        kv = (pool.pages_k, pool.pages_v, pool.k_scales, pool.v_scales, tables)
        tokens = torch.cat([lanes.pending[:, None], torch.from_numpy(draws).to(dev)], dim=1)
        pa.reset_launch_counts()
        out, n_commit, _ = verify_window(model, *kv, index, tokens, lanes, 0)
        index = index + n_commit
        tree_tokens = torch.from_numpy(tree_draws).to(dev)
        tree_tokens[:, 0] = lanes.pending
        t_out, t_commit, _ = tree_verify_window(model, tree, pa.TreeMask(tree.anc), *kv, index,
                                                tree_tokens, lanes, 0)
        if dev != "cpu":
            assert (pa.paged_attention.launches, pa.paged_attention.tree_launches) == (4, 2)
        # the pages' values: codes x scales for int8 pages
        values = [pages.float() * scales[..., None, :, None] for pages, scales in
                  ((pool.pages_k, pool.k_scales), (pool.pages_v, pool.v_scales))]
        results[str(dev)] = [t.cpu() for t in (out, n_commit, t_out, t_commit, *values)]
        step = max(pool.k_scales.max().item(), pool.v_scales.max().item())
    cpu, gpu = results["cpu"], results[str(card)]
    for a, b in zip(cpu[:4], gpu[:4]):
        assert torch.equal(a, b)
    # int8: a value may round to the neighbouring code on the other device
    atol = 1e-4 if kv_dtype is None else 1.01 * step
    for a, b in zip(cpu[4:], gpu[4:]):
        torch.testing.assert_close(b, a, atol=atol, rtol=0)


def test_paged_decode_shapes_in_turn(card):
    """Calls at one shape, then another, then the first again: each right,
    so every launch leaves the arrival counters at zero for the next."""
    cases = [_prefill_case(card, lengths, 1, 8, 8, 128, 128, seed=i, ppl=16)
             for i, lengths in enumerate(([700, 2040], [5, 300, 1000, 2040, 64]))]
    for args in (cases[0], cases[1], cases[0], cases[1]):
        out = pa.paged_attention(*args)
        ref32 = pa.paged_attention_reference(*(t.float() for t in args[:3]), *args[3:])
        assert row_rel_err(out, ref32) <= ROW_REL_TOL[torch.bfloat16]
    assert pa.pending_split_counters() == 0


def test_launch_counters_count_kernel_launches_only(card):
    pa.reset_launch_counts()
    args = _case(card, [5], 1, 4, 4, 64, 16, 2, torch.float32)
    pa.paged_attention(*args)
    pa.paged_attention_reference(*args)
    pa.paged_flash_prefill(*args)
    assert (pa.paged_attention.launches, pa.paged_flash_prefill.launches) == (1, 1)


def test_unsupported_head_dim_raises(card):
    """D 16, 32, 64, 80, 96, 128 and 256 are taken; any other D (48 here)
    is refused by the wrapper, before a launch, for both paged kernels."""
    args = _case(card, [5], 1, 4, 4, 48, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(*args)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_flash_prefill(*args)


def test_too_many_lanes_raise(card):
    """A call of more lanes than a launch's grid holds is refused by the
    wrapper, naming the limit, before a launch, for both paged kernels."""
    n = pa.MAX_LANES + 1
    q = torch.zeros((n, 1, 1, 16), dtype=torch.bfloat16, device=card)
    pages = torch.zeros((2, 16, 1, 16), dtype=torch.bfloat16, device=card)
    tables = torch.ones((n, 1), dtype=torch.int32, device=card)
    lengths = torch.zeros((n,), dtype=torch.int32, device=card)
    for fn in (pa.paged_attention, pa.paged_flash_prefill):
        before = fn.launches
        with pytest.raises(ValueError, match=str(pa.MAX_LANES)):
            fn(q, pages, pages, tables, lengths)
        assert fn.launches == before


def test_engine_on_card_matches_cpu_engine(card):
    """Greedy tokens of the f32 tiny model: kernels on the card == plain
    versions on the CPU."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 head_dim=64, max_seq_len=128)
    sd = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8)]
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               device=dev)
        out[str(dev)] = [r.tokens for r in engine.serve(prompts, configs=gen)]
    assert out["cpu"] == out[str(card)]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_tiny_engine_on_card_matches_cpu_engine(card, kv_dtype):
    """``TransformerConfig.tiny`` as the reference runs it (D 16, GQA 4/2),
    f32, native and quantized pages: greedy tokens on the card (K1, K2 and
    the quantized insert there) == the plain versions on the CPU."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=128)
    assert cfg.resolved_head_dim == 16
    sd = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8)]
    gen = GenerationConfig(max_new_tokens=12)
    out, errs = {}, {}
    pa.reset_launch_counts()
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               kv_dtype=kv_dtype, device=dev)
        out[str(dev)] = [r.tokens for r in engine.serve(prompts, configs=gen)]
        errs[str(dev)] = engine.stats["kv_quant_error"]
    assert out["cpu"] == out[str(card)]
    assert pa.paged_attention.launches > 0 and pa.paged_flash_prefill.launches > 0
    if kv_dtype is not None:
        assert errs["cpu"] > 0.0 and errs[str(card)] > 0.0


#: model families on the card (``TransformerConfig.tiny`` widths, D 16): the
#: first three through K1 and K2, the last two through the plain paged
#: versions, as the reference routes sliding-window and alibi models
CARD_FAMILIES = {
    "gpt_neox": dict(norm_type="layernorm", rope_dim=8, parallel_residual=True, use_bias=True,
                     mlp_variant="gelu_exact"),
    "gpt2": dict(norm_type="layernorm", use_bias=True, positional="learned",
                 mlp_variant="gelu", tie_word_embeddings=True),
    "falcon_mq": dict(norm_type="layernorm", mlp_variant="gelu_exact", parallel_residual=True,
                      shared_norm=True, num_kv_heads=1),
    "mistral_window16": dict(sliding_window=16),
    "bloom_alibi": dict(norm_type="layernorm", use_bias=True, positional="alibi",
                        embed_norm=True, mlp_variant="gelu", tie_word_embeddings=True),
}


@pytest.mark.parametrize("family", list(CARD_FAMILIES))
def test_family_engine_on_card_matches_cpu_engine(card, family):
    """Greedy tokens of an f32 tiny model of each family, biases drawn
    nonzero: the engine on the card (K1 and K2, or for window and alibi
    models the plain paged versions, launching neither kernel) == the
    plain versions on the CPU."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=128, **CARD_FAMILIES[family])
    sd = init_params(cfg, seed=7, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(8)
    for name, t in sd.items():
        if name.endswith(".bias"):
            t.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8)]
    out = {}
    for dev in ("cpu", card):
        pa.reset_launch_counts()
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               device=dev)
        out[str(dev)] = [r.tokens for r in engine.serve(prompts, configs=GenerationConfig(
            max_new_tokens=12))]
    assert out["cpu"] == out[str(card)]
    kernels = cfg.full_causal
    assert (pa.paged_attention.launches > 0) == kernels
    assert (pa.paged_flash_prefill.launches > 0) == kernels


@pytest.mark.parametrize("family", ["gpt_neox", "mistral_window16", "bloom_alibi"])
def test_family_graphs_replay_the_eager_windows(card, family):
    """The window and chunk graphs capture whichever paged path the family
    takes, and replay it bitwise as the eager engine runs it."""
    _lockstep_engines(card, {}, **CARD_FAMILIES[family])


def _lockstep_engines(card, knobs, steps=None, lens=(17, 30, 9, 24), dtype=torch.float32,
                      **cfg_kw):
    """A graph engine (the default: window and chunk graphs) and an eager one
    (``ServingEngine._eager``), both synchronous so that each step drains its
    window, on one tiny model (``dtype``, ``cfg_kw`` for its config): the
    same requests stepped in turn, every state the windows and chunks write
    (pages and scales, or the running lanes' rows of the slab pool; pending
    tokens, draft tokens), every token and
    ``kv_quant_error`` compared bitwise after each step.  One request
    samples, so both variants of each window run.  The null page is left
    out: it is the garbage sink of inactive lanes, never read.  The prompts
    are one random segment tiled to ``lens``; the prefix cache is off
    unless ``knobs`` set it."""
    cfg = TransformerConfig.tiny(dtype=dtype, param_dtype=dtype, max_seq_len=128, **cfg_kw)
    model = Transformer(cfg, device=card)
    model.load_state_dict(init_params(cfg, seed=5, device=card, dtype=dtype), assign=True)
    rng = np.random.default_rng(9)
    segment = rng.integers(1, 256, 12).astype(np.int32)
    prompts = [np.resize(segment, n) for n in lens]
    configs = [GenerationConfig(max_new_tokens=20)] * (len(lens) - 1) + [
        GenerationConfig(max_new_tokens=20, do_sample=True, temperature=0.8, top_k=20)]
    kw = {**dict(num_slots=2, max_len=128, prefill_buckets=(16, 32), decode_window=3,
                 async_depth=0, device=card, prefix_cache_mb=0), **knobs}
    graphed = ServingEngine(model, None, **kw)
    eager = ServingEngine._eager(model, None, **kw)
    captures = graphed.stats["graph_captures"]
    assert captures == len(graphed.graphs) > 0 and eager.graphs is None
    reqs = {}
    for name, engine in (("graphed", graphed), ("eager", eager)):
        reqs[name] = [engine.submit(p, config=c) for p, c in zip(prompts, configs)]
    while graphed.has_work:
        for engine in (graphed, eager):
            engine.step()
        if graphed.paged:
            # every page but the null page (id 0), the sink of inactive
            # lanes' writes, whose last writer among them is not defined
            for name in ("pages_k", "pages_v", "k_scales", "v_scales"):
                assert torch.equal(getattr(graphed.kv, name)[:, 1:],
                                   getattr(eager.kv, name)[:, 1:]), name
        else:
            # the slab pool's live rows: each running lane's history.  Rows
            # past it are dead, and differ: the captures' warm-ups wrote
            # there, and an insert copies the scratch's stale tail along
            np.testing.assert_array_equal(graphed._lane_len, eager._lane_len)
            for s in np.nonzero(graphed._active)[0]:
                rows = int(graphed._lane_len[s])
                for kv in ("k", "v"):
                    assert torch.equal(getattr(graphed.pool, kv)[:, s, :rows],
                                       getattr(eager.pool, kv)[:, s, :rows]), (s, kv)
        assert torch.equal(graphed.lanes.pending, eager.lanes.pending)
        assert torch.equal(graphed.lanes.keys, eager.lanes.keys)
        if graphed.tree is not None:
            assert torch.equal(graphed._draft_tokens, eager._draft_tokens)
        assert [r.tokens for r in reqs["graphed"]] == [r.tokens for r in reqs["eager"]]
        assert graphed.stats["kv_quant_error"] == eager.stats["kv_quant_error"]
    assert not eager.has_work
    st = graphed.stats
    assert st["graph_captures"] == captures and st["graph_replays"] > 0
    assert eager.stats["graph_replays"] == 0
    return graphed


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify", "tree"])
def test_window_graphs_replay_the_eager_windows(card, kind, kv_dtype):
    """Each window's graph replay is bitwise equal to the eager window on
    the same inputs: the decode window, the linear verify, and the tree
    draft with the tree verify and its commit, native and int8 pages (and
    each prefill bucket's chunk beside them); the capture count stays
    constant over the serve."""
    knobs = {"decode": {}, "verify": dict(speculate_k=2),
             "tree": dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16)}[kind]
    engine = _lockstep_engines(card, dict(kv_dtype=kv_dtype, **knobs))
    # every engine also holds one graph per prefill bucket
    want = {"decode": {"decode"}, "verify": {"decode", "verify"},
            "tree": {"decode", "tree", "draft"}}[kind] | {"prefill"}
    assert {key[0] for key in engine.graphs.keys()} == want
    if kind != "decode":
        assert engine.stats["verify_forwards"] > 0


@pytest.mark.parametrize("knobs", [{}, dict(kv_dtype="int8"),
                                   dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16)])
def test_plain_route_on_card_matches_cpu(card, knobs):
    """``decode_kernel="xla"`` on the paged pool: every window and chunk graph
    captures the kernels' plain versions (native and int8 pages, and the
    tree verify's dense mask), K1 and K2 launch never, and the greedy tokens
    equal the CPU engine's."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=128)
    sd = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8)]
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               decode_kernel="xla", device=dev, **knobs)
        pa.reset_launch_counts()
        out[str(dev)] = [r.tokens for r in engine.serve(prompts, configs=gen)]
    assert out["cpu"] == out[str(card)]
    assert engine.stats["graph_replays"] > 0
    assert pa.launch_counts() == (0,) * len(pa.launch_counts())


@pytest.mark.parametrize("kind", ["decode", "verify", "tree"])
def test_slab_graphs_replay_the_eager_windows(card, kind):
    """The slab pool (``paged=False``): each window's graph replay and each
    bucket's chunk replay leave every running lane's rows of the slab pool
    bitwise equal to the eager engine's, with the prefix cache copying cached chunks into
    the scratch (the 16-token prompts hit); every graph key names the slab
    pool; K1 and K2 launch never; the capture count stays constant."""
    knobs = {"decode": {}, "verify": dict(speculate_k=2),
             "tree": dict(draft_model=1, tree_width=2, tree_depth=3, draft_ctx=16)}[kind]
    pa.reset_launch_counts()
    engine = _lockstep_engines(card, dict(paged=False, prefix_cache_mb=1.0, **knobs),
                               lens=(16, 40, 17, 16, 33, 24))
    assert all("slab" in key for key in engine.graphs.keys())
    assert sorted(k[1] for k in engine.graphs.keys() if k[0] == "prefill") == [16, 32]
    assert engine.stats["prefix_hit_tokens"] > 0
    assert pa.launch_counts() == (0,) * len(pa.launch_counts())
    if kind != "decode":
        assert engine.stats["verify_forwards"] > 0


def test_slab_pipeline_on_card_matches_cpu_and_does_not_synchronise(card):
    """The pipelined slab engine (prefix cache on): admission, the scratch
    prefill, the cached-chunk copy, the insert and every dispatch run under
    ``torch.cuda.set_sync_debug_mode("error")``; greedy tokens equal the
    CPU slab engine's."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=128)
    sd = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    head = rng.integers(1, 256, 32).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, 256, n).astype(np.int32)])
               for n in (5, 19, 33, 8, 12)]
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               paged=False, device=dev)
        reqs = [engine.submit(p, config=gen) for p in prompts]
        while engine.has_work:
            engine._prefree_exhausted()
            prev = None
            on_card = dev != "cpu"
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                engine._admit()
                if engine._active.any():
                    prev = engine._dispatch()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
            if not engine._active.any():
                prev = engine._dispatch()
            engine._hand_cache_traffic(engine._inflight if engine._inflight is not None
                                       else prev)
            if prev is not None:
                engine._drain(prev)
        out[str(dev)] = [r.tokens for r in reqs]
        assert engine.stats["prefix_hit_tokens"] > 0
    assert out["cpu"] == out[str(card)]
    assert engine.stats["prefreed_lanes"] > 0 and engine.stats["graph_replays"] > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_graph_replay_reads_copied_and_promoted_pages(card, kind, kv_dtype):
    """With the prefix cache and its host ring, lanes alias cached pages,
    copy their tail page on write (the 16-token prompts hit their whole
    prompt) and promote spilled chunks into fresh pages, all in place:
    each graph replay after such an edit is bitwise the eager window on
    the same pages, and the tokens are equal."""
    knobs = {"decode": {}, "verify": dict(speculate_k=2)}[kind]
    kw = dict(kv_dtype=kv_dtype, prefix_cache_mb=0.004 if kv_dtype else 0.016,
              prefix_host_mb=8.0, **knobs)
    engine = _lockstep_engines(card, kw, lens=(16, 40, 17, 16, 33, 24, 16, 50))
    st = engine.stats
    assert st["cow_copies"] > 0 and st["prefix_hit_tokens"] > 0
    assert st["prefix_hit_tokens_host"] > 0 and st["promote_degraded"] == 0


@pytest.mark.parametrize("fmt", [None, "bf16", "int8", "fp8"])
def test_spill_payload_round_trips_bit_for_bit(card, fmt, tmp_path):
    """A chunk's pages and scales gathered on the card, copied into pinned
    host buffers (``stage``), through the disk ring's file, and installed
    back into other pages: the bits come back, and the pool tensors keep
    their storage through ``copy_page`` and ``promote_install``."""
    from accelerate_tpu_torch.serving.pool import copy_page, promote_install, spill_extract
    from accelerate_tpu_torch.serving.prefix_cache import load_payload, save_payload
    from accelerate_tpu_torch.serving.readback import stage

    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=64)
    kv = PagedKVPool(cfg, 2, 64, 8, 17, kv_dtype=fmt, device=card)
    pool = (kv.pages_k, kv.pages_v, kv.k_scales, kv.v_scales)
    gen = torch.Generator(device=card).manual_seed(0)
    for t in pool:
        raw = t.view(torch.uint8) if t.element_size() == 1 else t
        if t.element_size() == 1:
            # every code but the fp8 NaN patterns
            raw.copy_(torch.randint(0, 0x7F, t.shape, generator=gen, device=card,
                                    dtype=torch.uint8))
        else:
            raw.copy_(torch.randn(t.shape, generator=gen, device=card))
    ptrs = [t.data_ptr() for t in pool]
    ids = torch.tensor([3, 9], device=card)
    gathered = spill_extract(pool, ids)
    host, ready = stage(gathered)
    ready.synchronize()
    assert all(h.is_pinned() for h in host)
    path = str(tmp_path / "chunk.npz")
    save_payload(path, tuple(host))
    back = load_payload(path)
    dst = torch.tensor([12, 5], device=card)
    promote_install(pool, tuple(b.to(card, non_blocking=True) for b in back), dst)
    copy_page(pool, 12, 14)
    for t in pool:
        bits = t.view(torch.uint8) if t.element_size() == 1 else t
        assert torch.equal(bits[:, 12], bits[:, 3]) and torch.equal(bits[:, 5], bits[:, 9])
        assert torch.equal(bits[:, 14], bits[:, 3])
    assert [t.data_ptr() for t in pool] == ptrs


@pytest.mark.parametrize("prefix", ["off", "tiers"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pipelined_dispatch_does_not_synchronise(card, kv_dtype, prefix, tmp_path):
    """Admission and the dispatch of every cycle of the depth-1 pipeline run
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing waits for
    the window in flight except the drain, also with the prefix cache
    spilling to its host and disk rings and promoting back (``tiers``).
    Greedy tokens equal the CPU engine's; after a flush every page is
    free."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=128)
    sd = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8, 12)]
    cache = dict(prefix_cache_mb=0)
    if prefix == "tiers":
        # three 32-token prefixes cycled A B C A ..., device and host budgets
        # of one 32-token chunk each, a disk ring behind them
        heads = [rng.integers(1, 256, 32).astype(np.int32) for _ in range(3)]
        prompts = [np.concatenate([heads[i % 3], p]) for i, p in enumerate(prompts + prompts[:4])]
        one = PagedKVPool(cfg, 2, 128, 16, 17, kv_dtype=kv_dtype,
                          device="cpu").chunk_bytes(2) / 2**20
        cache = dict(prefix_cache_mb=one, prefix_host_mb=one, prefix_disk_mb=1.0)
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        disk = tmp_path / str(dev)
        disk.mkdir()
        if prefix == "tiers":
            cache["prefix_disk_dir"] = str(disk)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               kv_dtype=kv_dtype, device=dev, **cache)
        reqs = [engine.submit(p, config=gen) for p in prompts]
        while engine.has_work:
            engine._prefree_exhausted()
            prev = None
            on_card = dev != "cpu"
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                engine._admit()
                if engine._active.any():
                    prev = engine._dispatch()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
            if not engine._active.any():
                prev = engine._dispatch()
            engine._hand_cache_traffic(engine._inflight if engine._inflight is not None
                                       else prev)
            if prev is not None:
                engine._drain(prev)
        out[str(dev)] = [r.tokens for r in reqs]
        engine.flush_prefix_cache()
        assert engine.kv.allocator.free_count == engine.num_pages - 1
    assert out["cpu"] == out[str(card)]
    assert engine.stats["prefreed_lanes"] > 0 and engine.stats["graph_replays"] > 0
    if prefix == "tiers":
        st = engine.prefix_cache_stats()
        assert st["spills"] > 0 and st["promotions"] > 0 and st["disk_writes"] > 0


def _chunk_budget_mb(cfg, kv_dtype, chunks=1.0):
    """MiB of ``chunks`` cached 32-token chunks (two pages of 16) at the
    page format: the lockstep engines' device-tier budget."""
    return chunks * PagedKVPool(cfg, 2, 128, 16, 17, kv_dtype=kv_dtype,
                                device="cpu").chunk_bytes(2) / 2**20


@pytest.mark.parametrize("pages", ["bf16", "int8", "fp8"])
def test_prefill_graphs_replay_the_eager_chunks(card, pages):
    """Each prefill bucket's graph replay is bitwise the eager chunk: a bf16
    model at D 64 (K2's tensor-core arm) over bf16, int8 and fp8 pages,
    stepped in lockstep with the eager engine (pages compared after every
    step), with chunks at base 0, chunks after aliased prefix hits, and
    chunks after promotions from the host ring (a device budget of one
    chunk).  The engine holds one chunk graph per bucket."""
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                 max_seq_len=128, head_dim=64)
    kw = dict(kv_dtype=pages, prefix_cache_mb=_chunk_budget_mb(cfg, pages, 1.01),
              prefix_host_mb=8.0)
    engine = _lockstep_engines(card, kw, lens=(16, 40, 17, 16, 33, 24, 16, 50),
                               dtype=torch.bfloat16, head_dim=64)
    assert sorted(k[1] for k in engine.graphs.keys() if k[0] == "prefill") == [16, 32]
    st = engine.stats
    assert st["prefix_hit_tokens"] > 0 and st["prefix_hit_tokens_host"] > 0
    assert st["prefill_chunks"] > 0 and st["promote_degraded"] == 0


def test_graphed_chunks_keep_every_quantization_error(card):
    """int8 pages, one 16-token bucket and a 64-token budget: four chunks a
    cycle replay one graph, whose error output each next replay rewrites;
    ``kv_quant_error`` after every step equals the eager engine's (the
    lockstep compares it), so no chunk's error was lost."""
    engine = _lockstep_engines(card, dict(kv_dtype="int8", prefill_buckets=(16,),
                                          prefill_token_budget=64),
                               lens=(64, 60, 48, 64, 33))
    assert engine.stats["prefill_chunks"] >= 16 and engine.stats["kv_quant_error"] > 0.0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_interleaved_dispatch_does_not_synchronise(card, kv_dtype):
    """``interleave_prefill``: the dispatch of each window and the admission
    behind it (chunk graph replays, their errors kept) run under
    ``torch.cuda.set_sync_debug_mode("error")``; only the drain waits.
    Greedy tokens equal the CPU engine's, and chunks were interleaved."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                                 max_seq_len=128)
    sd = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 40, 33, 8, 60, 12)]
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               kv_dtype=kv_dtype, prefix_cache_mb=0, interleave_prefill=True,
                               device=dev)
        reqs = [engine.submit(p, config=gen) for p in prompts]
        while engine.has_work:
            engine._prefree_exhausted()
            active = bool(engine._active.any())
            if not active:
                engine._prev_handle = engine._dispatch()  # drains the pipeline: waits
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode("error")
            try:
                if active:
                    engine._prev_handle = engine._dispatch()
                engine._admit()
            finally:
                if dev != "cpu":
                    torch.cuda.set_sync_debug_mode(0)
            engine._hand_cache_traffic(engine._inflight if engine._inflight is not None
                                       else engine._prev_handle)
            prev, engine._prev_handle = engine._prev_handle, None
            if prev is not None:
                engine._drain(prev)
        out[str(dev)] = [r.tokens for r in reqs]
        assert engine.kv.allocator.free_count == engine.num_pages - 1
    assert out["cpu"] == out[str(card)]
    st = engine.stats
    assert st["interleaved_chunks"] > 0 and st["graph_replays"] > st["decode_steps"] // 3


def test_failed_capture_raises(card, monkeypatch):
    """A window whose capture fails raises out of the constructor: there is
    no fallback to the eager window."""
    from accelerate_tpu_torch.serving import engine as engine_mod

    def refuse(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture refused")
        return decode_window(*args, **kwargs)

    decode_window = engine_mod.decode_window
    monkeypatch.setattr(engine_mod, "decode_window", refuse)
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = Transformer(cfg, device=card)
    model.load_state_dict(init_params(cfg, seed=0, device=card, dtype=torch.float32),
                          assign=True)
    with pytest.raises(RuntimeError, match="capture refused"):
        ServingEngine(model, None, num_slots=2, max_len=64, prefill_buckets=(16,),
                      device=card)


def _flash_case(card, b, s, hq, hkv, d, dtype, segmented=False, seed=0, sk=None):
    sk = sk or s
    gen = torch.Generator(device=card).manual_seed(seed)
    q, dout = (torch.randn((b, s, hq, d), generator=gen, device=card).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=card).to(dtype) for _ in range(2))
    seg = None
    if segmented:
        n = max(s, sk)
        pos = torch.arange(n, device=card)
        seg = ((pos >= n // 3).int() + (pos >= (2 * n) // 3).int()).expand(b, n).contiguous()
    return q, k, v, dout, seg


def _close(got, want, dtype):
    tol = FLASH_REL_TOL[dtype] * max(want.float().abs().max().item(), 1.0)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if want.dim() == 4:
        assert tile_rel_err(got, want) <= FLASH_TILE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,segmented", [
    (2, 256, 4, 4, 64, True, False),    # the JAX package's test shapes
    (2, 256, 4, 4, 64, False, False),
    (2, 256, 4, 2, 64, True, False),
    (2, 200, 4, 2, 64, True, False),    # ragged last q-block and k-tile
    (2, 200, 4, 2, 64, False, True),
    (1, 131, 6, 2, 128, True, True),
    (1, 100, 8, 1, 128, True, False),   # MQA: one kv head for eight query heads
    (2, 200, 4, 2, 256, True, False),   # D 256: the f32 arms' column chunks
    (1, 131, 8, 1, 256, True, True),    # Gemma-2B's MQA at D 256, segments
    (2, 200, 4, 2, 80, True, False),    # D 80: a column group past D on some threads
    (1, 131, 6, 2, 96, False, True),
    (2, 200, 4, 2, 32, True, False),
    (1, 131, 4, 4, 16, True, True),
])
def test_flash_kernels_match_plain(card, dtype, b, s, hq, hkv, d, causal, segmented):
    _hold_flash_kernels(*_flash_case(card, b, s, hq, hkv, d, dtype, segmented), causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,segmented", [
    (1, 96, 160, 4, 2, 64, True, True),     # fewer queries than keys
    (1, 160, 96, 4, 2, 128, False, False),  # more queries than keys
    (1, 80, 80, 72, 1, 64, True, False),    # a group of 72 heads: two parts of 36
    (1, 70, 70, 71, 1, 64, True, True),     # 71 heads over one kv head: parts of one
])
def test_flash_kernels_match_plain_uneven(card, dtype, b, sq, sk, hq, hkv, d, causal, segmented):
    case = _flash_case(card, b, sq, hq, hkv, d, dtype, segmented, seed=1, sk=sk)
    _hold_flash_kernels(*case, causal, dtype)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,segmented", [
    (1, 129, 129, 4, 2, 128, True, False),  # one row and one key past a 128 boundary
    (1, 257, 257, 4, 4, 64, True, False),
    (2, 257, 257, 8, 2, 128, True, False),
    (1, 96, 320, 4, 2, 128, True, True),    # fewer queries than keys, with segments
    (1, 512, 512, 32, 4, 128, True, False),  # GQA 32/4: 8 heads folded into each tile
    (1, 512, 512, 32, 4, 64, True, False),
    (1, 160, 96, 4, 2, 64, False, False),    # more queries than keys
    (1, 70, 70, 12, 2, 64, True, False),     # rep 6: 64 is no multiple, spare rows
    (2, 257, 257, 8, 2, 256, True, False),   # D 256: 2 stages; K4 one warpgroup, K5 split
    (1, 96, 320, 4, 2, 256, True, True),
    (1, 70, 70, 12, 2, 256, True, False),    # D 256 with spare rows
    (2, 257, 257, 8, 2, 80, True, False),    # D 80 and 96: a zero-padded second panel
    (1, 160, 96, 4, 2, 96, False, False),
    (1, 70, 70, 12, 2, 80, True, False),
    (1, 257, 257, 8, 2, 32, True, False),    # D 32 and 16: one zero-padded panel
    (1, 129, 129, 4, 4, 16, True, True),
])
def test_flash_bf16_tensor_core_tiles(card, b, sq, sk, hq, hkv, d, causal, segmented):
    """The bf16 arms of K3, K4 and K5 (wgmma tiles of 64 folded rows x 64
    keys; two consumer warpgroups per CTA, fed through a ring of 3 TMA
    stages) on shapes that cut their tiles raggedly: S 257 walks 5 k-tiles,
    the last one 1 key wide, so the ring wraps before the ragged tile.  K4
    reads dS from registers into dS . K with K read MN-major, and repeats
    bit for bit (``_hold_flash_kernels``)."""
    case = _flash_case(card, b, sq, hq, hkv, d, torch.bfloat16, segmented, seed=2, sk=sk)
    _hold_flash_kernels(*case, causal, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_negative_scale(card, dtype, causal):
    """A negative scale turns the row maximum into the smallest raw score:
    the kernels must take the maximum of the scaled scores."""
    case = _flash_case(card, 1, 200, 4, 2, 64, dtype, seed=3)
    _hold_flash_kernels(*case, causal, dtype, scale=-0.125)


def _hold_flash_kernels(q, k, v, dout, seg, causal, dtype, scale=None):
    kw = dict(causal=causal, segment_ids=seg, scale=scale)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    delta = fa.flash_delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    dq = fa.flash_dq(*args, **kw)
    dk, dv = fa.flash_dkv(*args, **kw)
    _close(dq, fa.flash_dq_reference(*args, **kw), dtype)
    for got, want in zip((dk, dv), fa.flash_dkv_reference(*args, **kw)):
        _close(got, want, dtype)
    # two passes without atomics: the same bits on every run
    assert torch.equal(dq, fa.flash_dq(*args, **kw))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_dkv(*args, **kw)))


def test_flash_launch_counters_count_kernel_launches_only(card):
    fa.reset_launch_counts()
    q, k, v, dout, _ = _flash_case(card, 1, 64, 4, 2, 64, torch.float32)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(tq, tk, tv).backward(dout)
    fa.flash_attention_reference(q, k, v)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == (1, 1, 1)


def test_flash_refuses_unsupported_head_dim(card):
    q, k, v, _, _ = _flash_case(card, 1, 64, 4, 2, 72, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, v)


@pytest.mark.parametrize("change,match", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), "dtypes"),
    (lambda q, k, v: (q, k.bfloat16(), v), "dtypes"),
    (lambda q, k, v: (q.transpose(1, 2).contiguous().transpose(1, 2), k, v), "contiguous"),
], ids=["fp16", "mixed", "strided"])
def test_flash_refuses_other_dtypes_and_layouts(card, change, match):
    q, k, v, dout, _ = _flash_case(card, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(*change(q, k, v))
    q, k, v = change(q, k, v)
    lse = torch.zeros((1, 4, 64), device=card)
    with pytest.raises(ValueError, match=match):
        fa.flash_dkv(q, k, v, dout.to(q.dtype), lse, lse)


def _train(device, steps=3):
    """Three train calls (accumulation 1) of the f32 tiny model, flash path."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, head_dim=64,
                                 attention_impl="pallas")
    model = Transformer(cfg, device=device)
    # made on the CPU for both runs: the card's generator draws other values
    model.load_state_dict(init_params(cfg, seed=2, device="cpu", dtype=torch.float32))
    acc = Accelerator(cpu=device == "cpu")
    state = acc.create_train_state(params=model, tx=functools.partial(torch.optim.SGD, lr=0.1))
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    ids = np.random.default_rng(5).integers(1, 256, (steps * 2, 48)).astype(np.int32)
    loader = acc.prepare(SimpleDataLoader([{"input_ids": r} for r in ids], batch_size=2))
    metrics = [{k: float(v) for k, v in step(state, batch)[1].items()} for batch in loader]
    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    return metrics, {k: v.detach().cpu() for k, v in model.named_parameters()}


def test_train_steps_on_card_match_cpu(card):
    """The train step with K3-K5 on the card against the same three steps
    with the plain versions on the CPU: f32, SGD, so parameters differ only
    by lr times the kernels' summation-order noise."""
    fa.reset_launch_counts()
    got, got_params = _train(None)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == (6, 6, 6)
    want, want_params = _train("cpu")
    for g, w in zip(got, want):
        assert g["applied"] == w["applied"] == 1.0
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    for name in want_params:
        torch.testing.assert_close(got_params[name], want_params[name], atol=1e-5, rtol=0)


def _reference_loop_model(device, attention_impl="pallas", seed=2):
    cfg = TransformerConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, head_dim=64,
                                 attention_impl=attention_impl)
    model = Transformer(cfg, device=device)
    # made on the CPU: the card's generator draws other values
    model.load_state_dict(init_params(cfg, seed=seed, device="cpu", dtype=torch.float32))
    return model


def _loop_batches(device, n=4):
    ids = np.random.default_rng(5).integers(1, 256, (n, 2, 48)).astype(np.int32)
    return [{"input_ids": torch.from_numpy(b).to(device)} for b in ids]


def _adamw(**kw):
    return functools.partial(torch.optim.AdamW, lr=1e-3, betas=(0.9, 0.95), eps=1e-6,
                             weight_decay=0.1, **kw)


def _loop_call(acc, state, loss_fn):
    def call(batch):
        with acc.accumulate():
            grads, m = acc.compute_gradients(loss_fn, state, batch)
            acc.apply_gradients(state, grads, max_grad_norm=1.0)
        return m["loss"].item()
    return call


def test_reference_loop_on_card_matches_compiled_step(card):
    """compute_gradients + apply_gradients (accumulation 2, clip 1.0,
    AdamW) against compile_train_step on the same weights and batches, both
    through K3-K5 on the card: the same kernels on the same inputs, only
    the buffer's additions in another order, so losses within 1e-6 and
    params within 1e-6 (f32)."""
    runs = []
    for kind in ("compiled", "loop"):
        model = _reference_loop_model(None)
        acc = Accelerator(gradient_accumulation_steps=2)
        state = acc.create_train_state(params=model, tx=_adamw())
        if kind == "compiled":
            step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
            call = lambda b: step(state, b)[1]["loss"].item()  # noqa: E731
        else:
            call = _loop_call(acc, state, lm_loss_fn(model))
        fa.reset_launch_counts()
        losses = [call(b) for b in _loop_batches(card)]
        launches = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
        assert launches == (4 * 2,) * 3 and state.step == 2 and state.micro_step == 0
        runs.append((losses, {k: v.detach().clone() for k, v in model.named_parameters()}))
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)
    (want, want_params), (got, got_params) = runs
    assert got == pytest.approx(want, rel=1e-6)
    for name in want_params:
        torch.testing.assert_close(got_params[name], want_params[name], atol=1e-6, rtol=0)


def test_fp16_overflow_skips_on_card(card):
    """fp16 with a 2**40 scale: the sync call overflows, is skipped (the
    params stay), and the scale backs off; the returned grads are f32."""
    from accelerate_tpu_torch.utils.dataclasses import GradScalerKwargs

    model = _reference_loop_model(None, attention_impl="xla")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    acc = Accelerator(mixed_precision="fp16", gradient_accumulation_steps=2,
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0**40)])
    state = acc.create_train_state(params=model, tx=_adamw())
    for batch in _loop_batches(card, 2):
        with acc.accumulate():
            grads, m = acc.compute_gradients(lm_loss_fn(model), state, batch)
            assert all(g.dtype == torch.float32 and g.is_cuda for g in grads.values())
            acc.apply_gradients(state, grads, max_grad_norm=1.0)
    assert state.step == 0 and state.micro_step == 0 and state.loss_scale.scale == 2.0**39
    assert acc._optimizers[-1].step_was_skipped
    assert all(torch.equal(before[k], v) for k, v in model.named_parameters())
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("capturable", [False, True])
def test_mid_window_resume_on_card(card, tmp_path, capturable):
    """Save after 3 calls of a window of 2 (one micro-step in the buffer),
    load onto the card into a fresh accelerator and a state made from
    another seed, run 3 more: bitwise the uninterrupted 6.  The moments and
    the buffer come back on the card, each step count where torch keeps it
    (the card only under ``capturable``)."""
    batches = _loop_batches(card, 6)

    def trainer(seed):
        model = _reference_loop_model(None, seed=seed)
        acc = Accelerator(gradient_accumulation_steps=2)
        state = acc.create_train_state(params=model, tx=_adamw(capturable=capturable))
        return acc, state, _loop_call(acc, state, lm_loss_fn(model))

    def reset():
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)

    _, state, call = trainer(2)
    whole = [call(b) for b in batches]
    want = {k: v.detach().clone() for k, v in state.params.items()}
    reset()
    acc, state, call = trainer(2)
    first = [call(b) for b in batches[:3]]
    out = acc.save_state(str(tmp_path / "ckpt"), state=state)
    reset()
    acc, state, call = trainer(3)
    acc.load_state(out, state=state)
    assert state.micro_step == 1 and all(p.grad.is_cuda for p in state.model.parameters())
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert st["exp_avg"].is_cuda and st["exp_avg_sq"].is_cuda
        assert st["step"].is_cuda == capturable
    rest = [call(b) for b in batches[3:]]
    assert first + rest == whole
    for name, p in state.params.items():
        assert torch.equal(p, want[name]), name


# ------------------------------------------------- quantization, fp8 and MoE
@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
def test_fp8_linear_on_card_matches_plain(card, fmt):
    """``FP8Linear`` on the card (``_scaled_mm``: forward, input and weight
    gradients) against its plain version (quantize -> dequantize in bf16,
    then a bf16 product) on the same inputs, at ``chip_smoke.py``'s
    tolerance; each product counted once."""
    from accelerate_tpu_torch.ops import fp8
    from chip_smoke import FP8_LINEAR_REL_TOL

    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(256, 512, device=card, dtype=torch.bfloat16, generator=gen)
    g = torch.randn(256, 384, device=card, dtype=torch.bfloat16, generator=gen) * 1e-2
    lin = fp8.FP8Linear(512, 384, bias=False, fp8_format=fmt, device=card, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
    xr = x.clone().requires_grad_()
    fp8.launches = 0
    out = lin(xr)
    out.backward(g)
    assert fp8.launches == 3
    bwd = fp8.bwd_dtype_of(fmt)
    want = fp8.plain_fp8_linear(x, lin.weight.detach())
    dx, dw_t = fp8.plain_fp8_grads(x, lin.weight.detach().t(), g, bwd_dtype=bwd)
    for got, ref in ((out.detach(), want), (xr.grad, dx), (lin.weight.grad, dw_t.t())):
        rel = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
        assert rel <= FP8_LINEAR_REL_TOL, rel


def test_fp8_refuses_shapes_scaled_mm_cannot_take(card):
    """Shapes ``_scaled_mm`` cannot take itself (M = 4, a decode window's
    lanes, and M = 24): ``fp8.scaled_mm`` zero-pads them, and each row of
    the product is bitwise that row of the unpadded product of an aligned
    operand holding the same rows (a GEMM's row depends on its own row
    only); ``FP8Linear`` at those rows runs its three products, each
    counted once, within ``chip_smoke.FP8_LINEAR_REL_TOL`` of its plain
    version."""
    from accelerate_tpu_torch.ops import fp8
    from chip_smoke import FP8_LINEAR_REL_TOL

    gen = torch.Generator(device=card).manual_seed(4)
    lin = fp8.FP8Linear(512, 384, bias=False, device=card, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
    b, b_inv = fp8._codes(lin.weight.detach().t(), torch.float8_e4m3fn, 0)
    for m in (4, 24):
        x = torch.randn(m, 512, device=card, dtype=torch.bfloat16, generator=gen)
        a, a_inv = fp8._codes(x, torch.float8_e4m3fn, 0)
        rows = -(-m // 16) * 16
        aligned = torch.cat([a, a[:1].expand(rows - m, -1)]).contiguous()
        got = fp8.scaled_mm(a, a_inv, b, b_inv, torch.float32)
        assert got.shape == (m, 384)
        assert torch.equal(got, fp8.scaled_mm(aligned, a_inv, b, b_inv, torch.float32)[:m])
        xr = x.clone().requires_grad_()
        fp8.launches = 0
        out = lin(xr)
        out.backward(torch.randn(m, 384, device=card, dtype=torch.bfloat16, generator=gen))
        assert fp8.launches == 3 and out.shape == (m, 384)
        want = fp8.plain_fp8_linear(x, lin.weight.detach())
        rel = ((out.detach().float() - want.float()).norm() / want.float().norm()).item()
        assert rel <= FP8_LINEAR_REL_TOL, (m, rel)
        lin.weight.grad = None


# ------------------------------------------------ remat and the offloaded optimizer
@pytest.mark.parametrize("policy", ["full", "proj_saveable", "dots_saveable"])
def test_remat_on_card_is_bitwise(card, policy):
    """Per-layer remat on the card (K3-K5, bf16 compute from f32 weights):
    loss and gradients bitwise the plain forward and backward's, K3
    launched again in the recompute (2 a layer), K4 and K5 once."""
    import dataclasses

    base = _reference_loop_model(None)
    ids = _loop_batches(card, 1)[0]["input_ids"]
    masters = list(base.parameters())
    plain_cfg = dataclasses.replace(base.config, dtype=torch.bfloat16)
    runs = []
    for cfg in (plain_cfg, dataclasses.replace(plain_cfg, remat=True, remat_policy=policy)):
        model = Transformer(cfg, device="meta")
        model.load_state_dict(base.state_dict(keep_vars=True), assign=True)
        fa.reset_launch_counts()
        params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss = lm_loss_fn(model)(params, {"input_ids": ids})
        grads = torch.autograd.grad(loss, masters)
        runs.append((loss, grads, (fa.flash_fwd.launches, fa.flash_dq.launches,
                                   fa.flash_dkv.launches)))
    (loss0, grads0, l0), (loss1, grads1, l1) = runs
    layers = base.config.num_layers
    assert l0 == (layers,) * 3 and l1 == (2 * layers, layers, layers)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))


def _offload_train(card, mixed_precision, **plugin):
    """Four calls at accumulation 2 of the tiny D-64 model through
    compile_train_step, the optimizer offloaded with ``plugin`` (none: on
    the card); the final weights and the state."""
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    GradientState._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    fsdp = (FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD", offload_optimizer=True,
                                           **plugin) if plugin else None)
    acc = Accelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=2,
                      fsdp_plugin=fsdp)
    model = _reference_loop_model(None)
    state = acc.create_train_state(params=model, tx=_adamw())
    step = acc.compile_train_step(lm_loss_fn(model), max_grad_norm=1.0)
    for batch in _loop_batches(card):
        state, _ = step(state, batch)
    assert state.step == 2
    return {k: v.detach().cpu() for k, v in model.named_parameters()}, state


def test_chunked_step_on_card_is_bitwise_unchunked(card):
    """The offloaded, chunked update on the card (pinned host state, two
    copy streams): bf16 working weights with f32 masters in 1 MB chunks,
    bitwise one chunk's, two chunks in flight's and ``cpu_offload``'s (the
    working weights on the host between steps); and the whole-state round
    trip without masters (``offload_update_chunk_mb=0``) bitwise the
    optimizer kept on the card."""
    chunked, state = _offload_train(card, "bf16", offload_update_chunk_mb=1)
    assert len(state.optimizer.chunks) >= 2 and state.optimizer.store.buffer.is_pinned()
    assert all(w.dtype == torch.bfloat16 for w in chunked.values())
    for kw in (dict(offload_update_chunk_mb=1, offload_update_overlap=2),
               dict(offload_update_chunk_mb=1 << 20),
               dict(offload_update_chunk_mb=1, cpu_offload=True)):
        twin, twin_state = _offload_train(card, "bf16", **kw)
        for name, w in chunked.items():
            assert torch.equal(twin[name], w), (kw, name)
    # cpu_offload: the working weights wait in pinned host memory between steps
    assert all(p.device.type == "cpu" and p.is_pinned() for p in twin_state.model.parameters())
    whole, _ = _offload_train(card, "no", offload_update_chunk_mb=0)
    plain, _ = _offload_train(card, "no")
    for name, w in plain.items():
        assert torch.equal(whole[name], w), name


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linear_on_card_is_linear_on_dequantized_weight(card, bits):
    """``QuantizedLinear`` on the card: bitwise an ``nn.Linear`` holding
    the dequantized weight (the same cuBLAS product on the same values)."""
    from accelerate_tpu_torch.ops import quantization as q

    gen = torch.Generator(device=card).manual_seed(bits)
    w = torch.randn(4096, 1024, device=card, generator=gen) * 0.02
    qt = q.quantize(w, q.QuantizationConfig(bits=bits))
    lin = q.QuantizedLinear(4096, 1024, bits=bits, device=card)
    lin.load_state_dict({"qweight": qt.data, "scales": qt.scales})
    dense = torch.nn.Linear(4096, 1024, bias=False, device=card, dtype=torch.bfloat16)
    with torch.no_grad():
        dense.weight.copy_(q.dequantize(qt, torch.bfloat16).t())
        for rows in (4, 512):
            x = torch.randn(rows, 4096, device=card, dtype=torch.bfloat16, generator=gen)
            assert torch.equal(lin(x), dense(x))


@pytest.mark.parametrize("quantization", [None, 8])
def test_moe_layer_graph_replays_eager(card, quantization):
    """An MoE layer (routing, dispatch, stacked experts, int8 or bf16)
    captured in a CUDA graph: its replay bitwise the eager call on new
    inputs written in place (routing reads nothing back to the host)."""
    from accelerate_tpu_torch.parallel.moe import MoEMLP

    cfg = TransformerConfig.tiny_moe(dtype=torch.bfloat16, hidden_size=256,
                                     intermediate_size=512, num_experts=8,
                                     quantization=quantization)
    model = Transformer(cfg, device=card, dtype=torch.bfloat16)
    model.load_state_dict(init_params(cfg, seed=5, device=card))
    layer = model.layers[0].moe_mlp
    assert isinstance(layer, MoEMLP)
    gen = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(4, 16, 256, device=card, dtype=torch.bfloat16, generator=gen)
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            layer(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = layer(x)
        for seed in (1, 2):
            x.copy_(torch.randn(x.shape, device=card, dtype=x.dtype,
                                generator=torch.Generator(device=card).manual_seed(seed)))
            graph.replay()
            assert torch.equal(out, layer(x))


def test_quantized_moe_engine_on_card_matches_cpu_engine(card):
    """``tiny_moe`` with int8 weights, f32: greedy tokens of the card's
    engine (its windows and chunks CUDA graphs, K1 and K2) == the CPU
    engine's."""
    cfg = TransformerConfig.tiny_moe(dtype=torch.float32, param_dtype=torch.float32,
                                     max_seq_len=128, quantization=8)
    sd = init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (5, 19, 33, 8)]
    gen = GenerationConfig(max_new_tokens=12)
    out = {}
    for dev in ("cpu", card):
        model = Transformer(cfg, device=dev)
        engine = ServingEngine(model, {k: v.to(dev) for k, v in sd.items()}, num_slots=2,
                               max_len=128, prefill_buckets=(16, 32), decode_window=3,
                               device=dev)
        out[str(dev)] = [r.tokens for r in engine.serve(prompts, configs=gen)]
        if dev != "cpu":
            assert engine.stats["graph_replays"] > 0
    assert out["cpu"] == out[str(card)]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_null_page_writes_land_as_on_cpu(card, kv_dtype):
    """Inactive lanes write their rows to the null page, several into one
    slot: on the card each slot ends as a serial scatter on the CPU leaves
    it, the last row's, and bitwise the same on every run.  Native and int8
    pages equal the CPU's bitwise.  fp8 pages hold the CPU's scales within
    4 f32 ulps (the card divides by ``qmax`` through its reciprocal) and its
    dequantized values within one e4m3 step (2^-3 relative, 2^-9 of the
    scale absolute below the normal range): a scale one ulp apart may round
    a code the other way."""
    gen = torch.Generator().manual_seed(7)
    n, s, h, d, page, num_pages = 12, 5, 2, 16, 4, 6
    new = torch.randn((n, s, h, d), generator=gen)
    tables = torch.randint(1, num_pages, (n, 2), generator=gen, dtype=torch.int32)
    index = torch.randint(0, page, (n,), generator=gen, dtype=torch.int32)
    active = torch.zeros(n, dtype=torch.bool)
    active[0] = True
    storage = torch.float32 if kv_dtype is None else pa.KV_FORMATS[kv_dtype][0]

    def run(dev):
        pages = torch.zeros((num_pages, page, h, d), dtype=storage, device=dev)
        args = (new.to(dev), tables.to(dev), index.to(dev), active.to(dev))
        if kv_dtype is None:
            return (pa.paged_insert(pages, *args),)
        scales = torch.ones((num_pages, h), device=dev)
        return pa.paged_quantized_insert(pages, scales, *args)[:2]

    def raw(ts):
        return [t.cpu().view(torch.uint8) for t in ts]

    want, first = run("cpu"), run(card)
    for _ in range(4):
        assert all(torch.equal(g, f) for g, f in zip(raw(run(card)), raw(first)))
    if kv_dtype != "fp8":
        assert all(torch.equal(g, w) for g, w in zip(raw(first), raw(want)))
    else:
        (pages, scales), (want_pages, want_scales) = [t.cpu() for t in first], want
        torch.testing.assert_close(scales, want_scales, rtol=2**-21, atol=0)
        torch.testing.assert_close(pages.float() * scales[:, None, :, None],
                                   want_pages.float() * want_scales[:, None, :, None],
                                   rtol=2**-3, atol=want_scales.max().item() * 2**-9)


def test_fp8_model_engine_graphs_match_sync_eager(card):
    """A ``use_fp8`` tiny model, bf16, two requests on four lanes (inactive
    lanes every window): the graphed, pipelined engine's tokens equal the
    eager synchronous engine's, and a second graphed engine's.  The fp8
    products scale by the amax of every lane's row, the inactive lanes'
    (which read the null page back) included."""
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16, use_fp8=True, max_seq_len=256)
    sd = init_params(cfg, seed=5, device=card, dtype=torch.bfloat16)
    model = Transformer(cfg, device=card)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (37, 90)]
    gen = GenerationConfig(max_new_tokens=40)
    kw = dict(num_slots=4, max_len=256, prefill_buckets=(16, 64), decode_window=4,
              prefix_cache_mb=0, device=card)
    graphed = [[r.tokens for r in ServingEngine(model, sd, **kw).serve(prompts, configs=gen)]
               for _ in range(2)]
    eager = ServingEngine._eager(model, sd, async_depth=0, **kw)
    assert graphed[0] == graphed[1]
    assert graphed[0] == [r.tokens for r in eager.serve(prompts, configs=gen)]


# ----------------------------------------------------- big-model inference
def _stream_model(card, layers=2):
    """A 2-layer bf16 model at hidden 1024 on the card, random weights."""
    cfg = TransformerConfig(vocab_size=4096, hidden_size=1024, intermediate_size=2816,
                            num_layers=layers, num_heads=8, num_kv_heads=4, max_seq_len=1024,
                            dtype=torch.bfloat16)
    sd = init_params(cfg, seed=3, device=card)
    model = Transformer(cfg, device="meta", dtype=torch.bfloat16)
    model.load_state_dict(sd, assign=True)
    return cfg, sd, model


@pytest.mark.parametrize("where", ["pinned", "packed", "mapped", "mixed"])
def test_streamed_model_bitwise_resident(card, where, tmp_path):
    """The streamed forward, its prefill and three decode steps, bitwise the
    resident model's on the card, whichever way the weights travel: one
    pinned block (``cpu_offload``), packed snapshots of pageable tensors,
    ``.dat`` memory maps through the staging buffer, or a map mixing the
    card, the host and the disk."""
    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.models.transformer import KVCache

    cfg, sd, model = _stream_model(card)
    if where == "pinned":
        placed, loader = bm.cpu_offload(sd)
    elif where == "packed":
        placed, loader = {k: v.cpu() for k, v in sd.items()}, None
    elif where == "mapped":
        placed, loader = bm.disk_offload(sd, str(tmp_path))
    else:
        dm = {"embed_tokens": 0, "layers.0": "cpu", "layers.1": "disk", "final_norm": "cpu",
              "lm_head": 0}
        placed, loader = bm.dispatch_params(sd, dm, offload_folder=str(tmp_path))
    st = bm.StreamingTransformer(cfg, placed, weights_loader=loader)
    kinds = {st._resolve(i).kind for i in range(len(st.plan))}
    assert kinds == ({"resident", "pinned", "mapped"} if where == "mixed" else {where})
    gen = torch.Generator(device=card).manual_seed(0)
    ids = torch.randint(1, cfg.vocab_size, (2, 96), device=card, generator=gen)
    with torch.inference_mode():
        assert torch.equal(st(ids), model(ids))
    cache, ref = st.init_cache(2, 100), KVCache.create(cfg, 2, 100, device=card)
    for step in range(4):
        logits, cache = st.forward_with_cache(ids, cache)
        with torch.inference_mode():
            want, ref = model(ids, cache=ref)
        assert torch.equal(logits, want), step
        ids = logits[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("kind", ["pinned", "packed", "mapped"])
def test_double_buffer_never_reads_stale_weights(card, kind, tmp_path):
    """Six stages through the two device buffers with every copy held back
    by a spin kernel on the copy stream, and every stage's compute held
    back before it reads its weights: a compute that did not wait for its
    copy would read the stage before last's weights, and a copy that did
    not wait for the compute would overwrite them under it.  Each stage
    multiplies by its own constant: the product is exact only if every
    stage saw its own."""
    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.utils.offload import (OffloadedWeightsLoader,
                                                    offload_state_dict, pinned_host_views)

    n, width = 6, 256
    weights = {f"m{i}.w": torch.full((width, width), float(i + 1)) for i in range(n)}
    loader = None
    if kind == "pinned":
        views = pinned_host_views({k: (tuple(v.shape), v.dtype) for k, v in weights.items()})
        for k, v in weights.items():
            views[k].copy_(v)
        params = views
    elif kind == "packed":
        params = weights
    else:
        offload_state_dict(str(tmp_path), weights)
        params, loader = {}, OffloadedWeightsLoader(save_folder=str(tmp_path))

    def stage(p, x):
        torch.cuda._sleep(20_000_000)  # the compute starts late ...
        return (x @ p["w"]) / width

    ex = bm.StreamingExecutor([(f"m{i}", stage) for i in range(n)], params=params,
                              weights_loader=loader)
    issue = ex._issue

    def slow_issue(st, s):
        with torch.cuda.stream(ex._copy_stream):
            torch.cuda._sleep(20_000_000)  # ... and every copy later still
        issue(st, s)

    ex._issue = slow_issue
    for _ in range(3):
        out = ex(torch.ones(4, width, device=card))
        assert torch.equal(out, torch.full((4, width), 720.0, device=card))
    assert {ex._resolve(i).kind for i in range(n)} == {kind}


def test_pinned_host_buffer_is_pinned(card):
    from accelerate_tpu_torch.utils.offload import pinned_host_buffer

    buf = pinned_host_buffer(1 << 20)
    assert buf.is_pinned() and buf[256:4096].view(torch.float32).is_pinned()
    dev = torch.empty(1 << 20, dtype=torch.uint8, device=card)
    dev.copy_(buf.fill_(7), non_blocking=True)
    assert int(dev.sum()) == 7 << 20


def test_find_executable_batch_size_halves_on_a_real_oom(card):
    """A real ``torch.cuda.OutOfMemoryError`` halves the batch: a batch of
    4 asks for the card's whole memory, 2 for half of it."""
    from accelerate_tpu_torch.utils.memory import find_executable_batch_size

    torch.cuda.empty_cache()
    unit = torch.cuda.get_device_properties(card).total_memory // 4
    tried = []

    @find_executable_batch_size(starting_batch_size=64)
    def run(batch_size):
        tried.append(batch_size)
        x = torch.empty(batch_size * unit, dtype=torch.uint8, device=card)
        x.fill_(1)
        return batch_size

    got = run()
    assert got in (1, 2) and tried == [64 >> i for i in range(len(tried))] and tried[-1] == got


def test_generate_graph_replays_the_eager_step(card):
    """``generate``'s decode step replayed as a CUDA graph: the tokens, the
    cache's rows and its index equal an eager ``make_prefill_step`` /
    ``make_decode_step`` loop's, on a warm cache too."""
    from accelerate_tpu_torch.models import generation as gen
    from accelerate_tpu_torch.models.transformer import KVCache

    cfg, sd, model = _stream_model(card)
    g = torch.Generator(device=card).manual_seed(1)
    ids = torch.randint(1, cfg.vocab_size, (2, 40), device=card, generator=g)
    graphed = KVCache.create(cfg, 2, 80, device=card)
    eager = KVCache.create(cfg, 2, 80, device=card)
    prefill, decode = gen.make_prefill_step(model), gen.make_decode_step(model)
    for prompt, new in ((ids, 12), (ids[:, :5], 9)):
        seq, graphed = gen.generate(model, None, prompt, max_new_tokens=new, cache=graphed)
        logits, eager = prefill(None, prompt, eager)
        toks = [logits[:, -1].argmax(-1)]
        for _ in range(new - 1):
            logits, eager = decode(None, toks[-1], eager)
            toks.append(logits.argmax(-1))
        assert torch.equal(seq[:, prompt.shape[1]:], torch.stack(toks, 1))
    assert graphed.index.tolist() == eager.index.tolist() == [64, 64]
    assert torch.equal(graphed.k, eager.k) and torch.equal(graphed.v, eager.v)


# ------------------------------------------------------------ fleet surface
def _fleet_model(card, seed):
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                                 max_seq_len=128)
    sd = init_params(cfg, seed=seed, device=card, dtype=torch.bfloat16)
    model = Transformer(cfg, device="meta")
    model.load_state_dict(sd, assign=True)
    return cfg, model


_FLEET_KW = dict(num_slots=2, max_len=128, prefill_buckets=(16, 32), decode_window=3,
                 prefix_cache_mb=0)


def _fleet_prompts(n=4):
    rng = np.random.default_rng(3)
    return [rng.integers(1, 256, int(k)).astype(np.int32) for k in (9, 40, 17, 25)[:n]]


def _greedy(engine, prompts, new=12):
    reqs = engine.serve([p.copy() for p in prompts],
                        configs=GenerationConfig(max_new_tokens=new))
    return [r.tokens for r in reqs]


def test_swap_params_replays_new_weights_without_captures(card):
    """``swap_params`` on a graphed engine copies the new weights into the
    tensors its graphs read: no graph is captured again, and the tokens
    equal a fresh engine's on the new weights."""
    _, model_a = _fleet_model(card, 0)
    cfg, model_b = _fleet_model(card, 1)
    engine = ServingEngine(model_a, None, device=card, **_FLEET_KW)
    fresh = ServingEngine(model_b, None, device=card, **_FLEET_KW)
    prompts = _fleet_prompts()
    before = _greedy(engine, prompts)
    captures = engine.stats["graph_captures"]
    new = {k: v.clone() for k, v in model_b.state_dict().items()}
    engine.swap_params(new, version="v1")
    assert engine.stats["graph_captures"] == captures > 0
    after = _greedy(engine, prompts)
    assert after == _greedy(fresh, prompts) and after != before
    assert engine.stats["graph_replays"] > 0 and engine.weights_version == "v1"


def test_gauges_hold_landed_values_across_replays(card):
    """The engine hands gauges host values that have landed, never a
    graph's output: ``serve/kv_quant_error`` keeps the value of the window it
    was read from while the graph replays again; a gauge holding a CUDA
    tensor that nothing rewrites is read at snapshot time."""
    from accelerate_tpu_torch.telemetry import MetricsRegistry

    _, model = _fleet_model(card, 0)
    registry = MetricsRegistry()
    engine = ServingEngine(model, None, device=card, kv_dtype="int8", registry=registry,
                           **_FLEET_KW)
    _greedy(engine, _fleet_prompts())
    gauge = registry.get("serve/kv_quant_error")
    seen = gauge.value
    assert seen == engine.stats["kv_quant_error"] > 0.0
    key = engine._graph_key("decode", False)
    err = engine.graphs._windows[key].outputs[1]  # the graph's own error output
    for _ in range(3):
        engine.graphs.replay(key)  # rewritten by replays of every lane inactive
    torch.cuda.synchronize()
    assert gauge.value == seen and isinstance(gauge._value, float)
    assert float(err) != seen  # the graph's output moved on; the gauge did not
    level = torch.full((), 2.5, device=card)
    registry.gauge("serve/level").set(level)
    level.fill_(4.0)
    assert registry.snapshot()["serve/level"] == 4.0


def test_metrics_scrape_while_a_graphed_engine_serves(card, monkeypatch):
    """``/metrics`` fetched over HTTP from another thread while a graphed
    engine serves (the scrape runs ``analyze_costs``): every scrape parses
    and the last one counts every request; each graph's capture is its
    program's card memory."""
    import threading
    import urllib.request

    from accelerate_tpu_torch.telemetry import MetricsRegistry, stop_debug_server
    from chip_smoke import parse_prometheus

    monkeypatch.setenv("ATPU_METRICS_HOST", "127.0.0.1")
    _, model = _fleet_model(card, 0)
    engine = ServingEngine(model, None, device=card, registry=MetricsRegistry(),
                           metrics_port=0, **_FLEET_KW)
    url = engine.debug_server.url + "/metrics"
    scrapes, stop = [], threading.Event()

    def scrape():
        while not stop.is_set():
            with urllib.request.urlopen(url, timeout=30) as resp:
                scrapes.append(parse_prometheus(resp.read().decode()))

    thread = threading.Thread(target=scrape)
    try:
        thread.start()
        prompts = _fleet_prompts()
        _greedy(engine, prompts + prompts)
        stop.set()
        thread.join(timeout=60)
        with urllib.request.urlopen(url, timeout=30) as resp:
            last = parse_prometheus(resp.read().decode())
    finally:
        stop.set()
        stop_debug_server()
    assert scrapes and last["atpu_serve_requests_completed_total_total"] == 8
    assert last["atpu_serve_ttft_s_count"] == 8 and last["atpu_serve_hbm_peak_bytes"] > 0
    assert last["atpu_serve_decode_flops_per_token"] > 0
    peaks = engine.cost_table.snapshot()
    assert peaks["serve/decode_window"]["hbm_peak_bytes"] > 0


def test_revive_after_kill_mid_window(card):
    """``kill`` with a window in flight, ``export_inflight`` (adopted by a
    survivor: the tokens of an uninterrupted serve, none streamed twice),
    then ``revive``: the handles are fetched, every page comes back, and the
    engine serves the same tokens as before."""
    _, model = _fleet_model(card, 0)
    _, twin = _fleet_model(card, 0)
    engine = ServingEngine(model, None, device=card, **_FLEET_KW)
    survivor = ServingEngine(twin, None, device=card, **_FLEET_KW)
    prompts = _fleet_prompts()
    want = _greedy(survivor, prompts)
    streamed = {}
    reqs = [engine.submit(p.copy(), max_new_tokens=12,
                          on_token=lambda r, t: streamed.setdefault(id(r), []).append(
                              len(r.tokens)))
            for p in prompts]
    while not (engine._inflight is not None and any(r.tokens for r in reqs)):
        engine.step()
    engine.kill()
    for r in engine.export_inflight():
        survivor.adopt(r)
    survivor.run()
    assert [r.tokens for r in reqs] == want
    assert all(streamed[id(r)] == list(range(1, 13)) for r in reqs)
    engine.revive()
    assert engine.drained and engine.kv.allocator.free_count == engine.num_pages - 1
    assert _greedy(engine, prompts) == want


# ------------------------------------------------- router, migration, front door
def _own_model(card, seed=0):
    """A replica's own copy of the fleet model's weights."""
    return _fleet_model(card, seed)[1]


_MIGRATE_KW = dict(num_slots=4, max_len=128, prefill_buckets=(16, 32), decode_window=3,
                   prefix_cache_mb=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_migrated_lanes_bit_identical_on_the_card(card, kv_dtype):
    """Two lanes (greedy, sampled) per arm, moved mid-generation by the d2d
    and the bounce arm between graphed engines over bf16, int8 and fp8
    pages: the tokens of the same requests served unmoved (the baseline
    engine takes the same request ids), pages and scales bitwise, and no
    graph captured by an install."""
    from accelerate_tpu_torch.serving import PageMigrator

    kw = dict(_MIGRATE_KW, kv_dtype=kv_dtype)
    # long enough that no lane is retired early (pre-freed) at its move
    gens = [GenerationConfig(max_new_tokens=30),
            GenerationConfig(max_new_tokens=30, do_sample=True, temperature=0.8, top_k=50)]
    prompts = _fleet_prompts(2)
    base = ServingEngine(_own_model(card), None, device=card, **kw)
    src = ServingEngine(_own_model(card), None, device=card, **kw)
    dst = ServingEngine(_own_model(card), None, device=card, **kw)
    mig = PageMigrator()
    for arm in ("d2d", "bounce"):
        want = [r.tokens for r in base.serve([p.copy() for p in prompts], configs=gens)]
        reqs = [src.submit(p.copy(), config=g) for p, g in zip(prompts, gens)]
        while any(len(r.tokens) < 6 for r in reqs):
            src.step()
        captures = src.stats["graph_captures"] + dst.stats["graph_captures"]
        for r in reqs:
            slot = next(s for s in range(src.num_slots) if src._slot_req[s] is r)
            src._drain_inflight()
            old = src.kv.lane_pages(slot)
            pages = [t[:, old].clone() for t in src._pool]
            mig.migrate(src, dst, slot, mode=arm)
            new = dst.kv.lane_pages(r.slot)
            torch.cuda.synchronize()
            assert all(torch.equal(t[:, new].view(torch.uint8), p.view(torch.uint8))
                       for t, p in zip(dst._pool, pages))
        dst.run()
        src.run()
        assert [r.tokens for r in reqs] == want, arm
        assert src.stats["graph_captures"] + dst.stats["graph_captures"] == captures
    assert dst.stats["graph_replays"] > 0
    assert src.compiled_executable_counts()["migrate_extract"] == 1
    assert dst.compiled_executable_counts()["migrate_install"] == 1


def test_handoff_under_an_inflight_destination_window(card):
    """A prefill replica's lane handed off to a decode replica whose window
    is in flight: the install queues behind the window on the stream, and
    both requests' tokens are a monolithic engine's."""
    from accelerate_tpu_torch.serving import PageMigrator

    prompts = _fleet_prompts(2)
    mono = ServingEngine(_own_model(card), None, device=card, **_MIGRATE_KW)
    want = _greedy(mono, prompts)
    pre = ServingEngine(_own_model(card), None, device=card, role="prefill", **_MIGRATE_KW)
    dec = ServingEngine(_own_model(card), None, device=card, role="decode", **_MIGRATE_KW)
    assert len(pre.graphs) == len(pre.buckets)  # chunks only: no window captured
    r0 = dec.submit(prompts[0].copy(), max_new_tokens=12)
    r1 = pre.submit(prompts[1].copy(), max_new_tokens=12)
    while r1.state.name != "RUNNING":
        pre.step()
    while not (dec._inflight is not None and r0.tokens):
        dec.step()
    captures = dec.stats["graph_captures"]
    slot = next(s for s in range(pre.num_slots) if pre._slot_req[s] is r1)
    PageMigrator().handoff(pre, dec, slot)
    dec.run()
    assert [r0.tokens, r1.tokens] == want
    assert dec.stats["graph_captures"] == captures and pre.stats["decode_steps"] == 0


def test_frontdoor_driver_thread_captures_and_serves(card):
    """A replica built by the front door's driver thread (its graphs
    captured there) serves the requests submitted through the front door
    from another thread: the tokens of an in-process engine, graphs
    replayed, none captured after construction."""
    import threading

    from accelerate_tpu_torch.serving import ReplicaRouter
    from accelerate_tpu_torch.serving.api import CompletionCall, FrontDoor

    prompts = _fleet_prompts()
    want = _greedy(ServingEngine(_own_model(card), None, device=card, **_FLEET_KW), prompts)
    first = ServingEngine(_own_model(card), None, device=card, **_FLEET_KW)
    frontdoor = FrontDoor(ReplicaRouter([first])).start()
    built = {}

    def build():
        built["thread"] = threading.current_thread().name
        built["engine"] = ServingEngine(_own_model(card), None, device=card, **_FLEET_KW)
        return built["engine"]

    try:
        rid = frontdoor.add_replica(build)
        frontdoor.drain_replica(0)  # new requests go to the replica built on the driver
        engine = built["engine"]
        captures = engine.stats["graph_captures"]
        streams = [frontdoor.submit(CompletionCall(prompt=[int(t) for t in p], max_tokens=12,
                                                   temperature=0.0))[1] for p in prompts]
        assert all(s.wait_done(120) for s in streams)
    finally:
        frontdoor.stop()
    assert built["thread"] == "atpu-frontdoor-driver" and rid == 1
    assert [s.final_tokens for s in streams] == want
    assert engine.stats["graph_replays"] > 0 and engine.stats["graph_captures"] == captures > 0
