"""Paged attention over the KV page pool: the two CUDA kernels and their plain versions.

Port of :mod:`accelerate_tpu.ops.paged_attention`.  The serving engine keeps
every lane's KV in a shared page pool ``[num_pages, page, Hkv, D]`` addressed
through per-lane block tables; attention reads those pages in place.

* :func:`paged_attention` — decode (and short verify spans): launches the
  hand-written kernel ``csrc/paged_attention.cu`` (K1) on a CUDA tensor,
  each lane's page walk split across CTAs by :func:`decode_split_plan`;
  with a ``tree_mask`` (:class:`TreeMask`, speculative tree verification)
  its tree-mask arm.
* :func:`paged_flash_prefill` — a prefill chunk's causal flash attention over
  the same pages: launches ``csrc/paged_prefill.cu`` (K2), on the tensor
  cores for bf16 where :func:`prefill_design` allows it.
* :func:`paged_attention_reference` / :func:`paged_flash_prefill_reference` —
  the plain PyTorch versions: a live-masked page gather feeding
  :func:`~accelerate_tpu_torch.models.transformer.cached_attention`.  A CPU
  tensor goes to them; a CUDA tensor launches the kernel or raises — no
  ``try`` falls back.
* :func:`paged_insert` — the write path: scatter new K/V through the block
  tables, in place (``index_put_``), inactive lanes routed to the null page.
* :func:`paged_quantized_insert` — the write path of int8 and fp8-e4m3
  pages (:data:`KV_FORMATS`): every touched page requantized against its
  own amax, one f32 scale per (page, kv-head), in place.  Both kernels read
  such pages through their dequant arms.

Each kernel wrapper counts its launches in an integer attribute
(``paged_attention.launches``), raised by one where the kernel is launched
and nowhere else, so a run can show that its path went through the kernel;
``paged_attention.tree_launches`` counts those of K1's tree-mask arm.  A
launch inside a CUDA graph's capture is counted there, and the graph's
replays credit their launches (:func:`credit_launches`), so a count always
means launches on the card.  Both wrappers are graph-safe: what they make
once (K1's arrival counters, the unit scales of native pages, the SM count)
a warm-up call makes before capture, and nothing they do reads the card.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

#: reserved garbage-sink page id — must match ``serving.paging.NULL_PAGE``
NULL_PAGE = 0

#: largest finite float8-e4m3fn magnitude (``accelerate_tpu/ops/fp8.py:35``)
E4M3_MAX = 448.0
#: quantized KV storage formats (``accelerate_tpu/ops/paged_attention.py:64``):
#: page dtype + the largest magnitude the per-page scale maps each head's
#: amax onto
KV_FORMATS = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, E4M3_MAX),
}

#: q dtypes the kernels take, and page dtypes: native, then quantized
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: page dtype -> the C ABI's page-format code (``ATPU_DISPATCH``)
_PAGE_FORMATS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_HEAD_DIMS = (16, 32, 64, 128)
#: head dims of K2's tensor-core arm (64-column wgmma panels)
_WGMMA_HEAD_DIMS = (64, 128)


def kv_storage_dtype(kv_dtype: Optional[str], native: torch.dtype) -> torch.dtype:
    """Resolve a ``ServingEngine(kv_dtype=...)`` string to the page dtype
    (``accelerate_tpu/ops/paged_attention.py:71``).  ``None`` keeps the
    model's native KV dtype; ``"bf16"`` stores bf16; ``"int8"`` and ``"fp8"``
    store quantized pages (:data:`KV_FORMATS`)."""
    if kv_dtype is None:
        return native
    if kv_dtype == "bf16":
        return torch.bfloat16
    if kv_dtype in KV_FORMATS:
        return KV_FORMATS[kv_dtype][0]
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}; choose None, 'bf16', 'int8' or 'fp8'")


def kv_qmax(dtype: torch.dtype) -> Optional[float]:
    """The quantization ceiling of a page dtype; None for direct-store dtypes
    (``accelerate_tpu/ops/paged_attention.py:85``)."""
    for fmt_dtype, qmax in KV_FORMATS.values():
        if dtype == fmt_dtype:
            return qmax
    return None


def _bytes_view(pages: torch.Tensor) -> torch.Tensor:
    """Quantized pages as raw bytes, for gathers and scatters: indexing
    float8 tensors is not implemented on every PyTorch build."""
    return pages.view(torch.uint8) if pages.element_size() == 1 else pages


#: most tree nodes K1's tree-mask arm takes: one uint32 ancestor word a node
MAX_TREE_NODES = 32


class TreeMask:
    """The ``[S, S]`` ancestor-or-self mask of a speculative token tree:
    ``mask[i, j]`` says tree node ``i`` (at slot ``lengths[n] + i``) sees tree
    node ``j``; every node also sees the lane's history.  Built once (the
    engine makes one per engine); its device copies are made once per
    device: the bool mask the plain versions take, and the packed words K1's
    tree-mask arm reads — bit ``j`` of node ``i``'s uint32 word set iff
    ``mask[i, j]``, as the reference packs them
    (``accelerate_tpu/ops/paged_attention.py:392-406``), passed as int32 bit
    patterns."""

    def __init__(self, mask):
        m = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) else mask
        self.mask = np.asarray(m, dtype=bool)
        if self.mask.ndim != 2 or self.mask.shape[0] != self.mask.shape[1]:
            raise ValueError(f"tree_mask {self.mask.shape} must be square [S, S]")
        self.nodes = self.mask.shape[0]
        self._dense: Dict[torch.device, torch.Tensor] = {}
        self._words: Dict[torch.device, torch.Tensor] = {}

    def packed(self) -> np.ndarray:
        """The ``[S]`` uint32 ancestor words (``S <= 32``)."""
        if self.nodes > MAX_TREE_NODES:
            raise ValueError(f"tree verification packs ancestor sets into uint32 words: "
                             f"{self.nodes} tree nodes > {MAX_TREE_NODES}")
        bits = self.mask.astype(np.uint64) << np.arange(self.nodes, dtype=np.uint64)[None, :]
        return bits.sum(axis=1).astype(np.uint32)

    def dense(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._dense.get(device)
        if t is None:
            t = self._dense[device] = torch.from_numpy(self.mask.copy()).to(device)
        return t

    def words(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._words.get(device)
        if t is None:
            t = self._words[device] = torch.from_numpy(self.packed().view(np.int32)).to(device)
        return t


def as_tree_mask(tree_mask) -> Optional[TreeMask]:
    """``None``, a :class:`TreeMask`, or an ``[S, S]`` bool array (wrapped)."""
    if tree_mask is None or isinstance(tree_mask, TreeMask):
        return tree_mask
    return TreeMask(tree_mask)


def _check_tree(tree: TreeMask, s: int, what: str) -> None:
    """K1's tree arm's operand rules, as the reference's (``:394-401``)."""
    if tree.nodes != s:
        raise ValueError(f"{what}: tree_mask {tree.mask.shape} must be [S, S] = [{s}, {s}]")
    if s > MAX_TREE_NODES:
        raise ValueError(f"{what}: tree verification packs ancestor sets into uint32 "
                         f"words: {s} tree nodes > {MAX_TREE_NODES}")


def _live_pages(lengths: torch.Tensor, s: int, page: int) -> torch.Tensor:
    """Pages holding any key visible to this call's queries: keys
    ``0 .. lengths + s - 1`` (the ``s`` new positions included)."""
    return (lengths + s - 1) // page + 1


# ------------------------------------------------------------------- writes
def paged_insert(pages: torch.Tensor, new: torch.Tensor, tables: torch.Tensor,
                 index: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Scatter ``new [N, S, H, D]`` into ``pages [NP, page, H, D]`` at
    positions ``index[n] .. index[n] + S - 1`` through lane ``n``'s block
    table, in place, and return ``pages``.  Inactive lanes are rerouted to the
    null page — a lane mid-prefill has real pages mapped and a stale index
    that must never trample them.  Values are cast to the page dtype."""
    n, s, h, d = new.shape
    page = pages.shape[1]
    p_max = tables.shape[1] - 1
    pos = index.long()[:, None] + torch.arange(s, device=new.device)[None, :]   # [N, S]
    pid = torch.gather(tables.long(), 1, torch.clamp(pos // page, 0, p_max))
    pid = torch.where(active[:, None], pid, torch.full_like(pid, NULL_PAGE))
    off = pos % page
    pages.index_put_((pid.reshape(-1), off.reshape(-1)),
                     new.to(pages.dtype).reshape(n * s, h, d))
    return pages


def paged_quantized_insert(pages: torch.Tensor, scales: torch.Tensor, new: torch.Tensor,
                           tables: torch.Tensor, index: torch.Tensor, active: torch.Tensor,
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantized scatter: requantize every page the ``S`` new positions touch
    (``accelerate_tpu/ops/paged_attention.py:143``), in place.

    ``pages [NP, page, H, D]`` int8 or float8-e4m3fn, ``scales [NP, H]`` f32
    with ``dequant = pages * scales``; ``new [N, S, H, D]`` goes to positions
    ``index[n] .. index[n] + S - 1`` of lane ``n``.  Per touched page:
    dequantize, insert the new rows, zero every slot at or past the lane's
    pre-call frontier that is not written now (a page's previous owner's
    values must not inflate the amax), take each head's scale as
    ``max(amax, 1e-8) / qmax``, requantize (int8: ``clip(round(x), ±qmax)``,
    round half to even; fp8: a plain cast).  Inactive lanes and untouched
    span slots write to the null page.  Returns ``(pages, scales,
    max_abs_err)``: the largest round-trip error over the newly written
    values, a device scalar (nothing here reads the device back).  Plain
    PyTorch: the reference leaves this to XLA, and it matches the JAX
    function bit for bit."""
    qmax = kv_qmax(pages.dtype)
    if qmax is None:
        raise ValueError(f"pages dtype {pages.dtype} is not a quantized KV format")
    n, s, h, d = new.shape
    page = pages.shape[1]
    p_max = tables.shape[1] - 1
    dev = new.device
    index = index.long()
    t = (s + page - 2) // page + 1                   # most pages a span of S touches
    pt = (index // page)[:, None] + torch.arange(t, device=dev)[None, :]       # [N, T]
    last = (index + s - 1) // page
    touched = (pt <= last[:, None]) & active[:, None]
    pid = torch.gather(tables.long(), 1, torch.clamp(pt, 0, p_max))
    pid = torch.where(touched, pid, torch.full_like(pid, NULL_PAGE))          # [N, T]

    raw = _bytes_view(pages)
    old = raw[pid].view(pages.dtype).float() * scales[pid][:, :, None, :, None]
    g = pt[:, :, None] * page + torch.arange(page, device=dev)[None, None, :]  # [N, T, page]
    i_new = g - index[:, None, None]
    use_new = (i_new >= 0) & (i_new < s)
    rows = torch.clamp(i_new, 0, s - 1).reshape(n, t * page)
    gathered = new.float()[torch.arange(n, device=dev)[:, None], rows].reshape(n, t, page, h, d)
    keep_old = g < index[:, None, None]              # valid history, strictly pre-frontier
    content = torch.where(use_new[..., None, None], gathered,
                          torch.where(keep_old[..., None, None], old, torch.zeros_like(old)))
    amax = content.abs().amax(dim=(2, 4))                                       # [N, T, H]
    new_scales = torch.clamp(amax, min=1e-8) / qmax
    q = content / new_scales[:, :, None, :, None]
    if pages.dtype == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    q = q.to(pages.dtype)
    err = torch.where(use_new[..., None, None],
                      (q.float() * new_scales[:, :, None, :, None] - content).abs(),
                      torch.zeros_like(content)).amax()
    flat = pid.reshape(-1)
    raw[flat] = _bytes_view(q.reshape(n * t, page, h, d))
    scales[flat] = new_scales.reshape(n * t, h)
    return pages, scales, err


# ------------------------------------------------------------------ reference
def paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                              k_scales=None, v_scales=None, window=None,
                              alibi: bool = False, tree_mask=None):
    """Plain version of both kernels: live-masked gather + the slab attention math.

    ``q [N, S, Hq, D]`` against pages ``[NP, page, Hkv, D]`` through
    ``tables [N, P]``; query ``i`` of lane ``n`` sits at position
    ``lengths[n] + i`` and sees keys ``j <= lengths[n] + i`` (the new
    positions' KV must already be inserted).  Table slots past each lane's
    live page count gather the null page instead of stale pages.
    ``tree_mask`` (``[S, S]`` or :class:`TreeMask`) swaps the causal rule for
    token-tree visibility: node ``i`` sees the history ``j < lengths[n]``
    and the tree nodes its row of the mask names (the live pages are the
    same: the tree spans the same ``S`` slots).  ``window`` and ``alibi`` are
    the slab math's sliding-window band and alibi bias
    (``accelerate_tpu/ops/paged_attention.py:207-247``): the kernels have
    neither, so those models attend through this version only."""
    from ..models.transformer import cached_attention

    n, s, _, d = q.shape
    num_p = tables.shape[1]
    page = pages_k.shape[1]
    hkv = pages_k.shape[2]
    lengths = lengths.long()
    live = _live_pages(lengths, s, page)
    slots = torch.arange(num_p, device=q.device)[None, :]
    t = torch.where(slots < live[:, None], tables.long(),
                    torch.full_like(tables, NULL_PAGE, dtype=torch.long))
    k = _bytes_view(pages_k)[t].view(pages_k.dtype)   # [N, P, page, Hkv, D]
    v = _bytes_view(pages_v)[t].view(pages_v.dtype)
    if k_scales is not None:
        k = (k.float() * k_scales[t][:, :, None, :, None]).to(q.dtype)
        v = (v.float() * v_scales[t][:, :, None, :, None]).to(q.dtype)
    else:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    k = k.reshape(n, num_p * page, hkv, d)
    v = v.reshape(n, num_p * page, hkv, d)
    q_positions = lengths[:, None] + torch.arange(s, device=q.device)[None, :]
    return cached_attention(q, k, v, q_positions, window=window, alibi=alibi,
                            tree_mask=tree_mask)


def paged_flash_prefill_reference(q, pages_k, pages_v, tables, lengths,
                                  k_scales=None, v_scales=None, window=None,
                                  alibi: bool = False):
    """Plain version of :func:`paged_flash_prefill`: chunk-wide queries share
    the decode reference's math (prior pages and the in-chunk causal triangle
    are one visibility rule), so this is a documented delegation
    (``accelerate_tpu/ops/paged_attention.py:462-476``)."""
    return paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                                     k_scales=k_scales, v_scales=v_scales, window=window,
                                     alibi=alibi)


# -------------------------------------------------------------------- kernels
#: how K1 computes: each lane's page walk split across CTAs, tiles streamed
#: by cp.async in the page dtype, f32 products on the CUDA cores
DECODE_DESIGN = "split-kv"
#: CTAs the split plan aims for per SM over a launch: four waves of four
#: (four of K1's CTAs fit on an SM at bf16, D 128).  Short splits win while
#: the (lane, kv-head) pairs alone do not fill the card: each CTA's fixed
#: cost overlaps its neighbours' walks (``profile_decode``)
_SPLIT_CTAS_PER_SM = 16
#: keys a split walks at least (a page at the engine's page size)
_SPLIT_MIN_KEYS = 128
#: the most splits of one (lane, kv-head): the merge keeps a weight per split
_MAX_SPLITS = 64


def decode_split_plan(num_p: int, n: int, hkv: int, page: int,
                      sm_count: int) -> Tuple[int, int]:
    """``(pages_per_split, splits)`` of K1's grid (kv-head, lane, split):
    split ``z`` walks the table slots ``[z * pps, (z + 1) * pps)``, so the
    splits tile all ``num_p`` slots, the last one ragged.  Chosen from the
    table width, the lanes, the kv heads, the page size and the SM count
    alone — never from the lengths, whose reading would sync the card — so
    that about ``_SPLIT_CTAS_PER_SM`` CTAs per SM exist, each walking at
    least ``_SPLIT_MIN_KEYS`` keys.  A split that starts past its lane's
    live pages exits at once; a lane whose live pages fit one split writes
    its output without the merge."""
    num_p = max(num_p, 1)
    wanted = -(-_SPLIT_CTAS_PER_SM * sm_count // max(n * hkv, 1))
    pps = max(-(-num_p // max(wanted, 1)), -(-_SPLIT_MIN_KEYS // page),
              -(-num_p // _MAX_SPLITS))
    pps = min(pps, num_p)
    return pps, -(-num_p // pps)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: (device, lanes x kv heads x row blocks) -> K1's per-(lane, kv-head, row
#: block) arrival counters:
#: zeroed once, and every launch leaves them at zero.  Launches that share a
#: buffer must not overlap, as on one stream.
_SPLIT_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
#: (device, num_pages, kv heads) -> the ones native pages feed as scales
_UNIT_SCALES: Dict[Tuple[torch.device, int, int], torch.Tensor] = {}


def _split_counters(device: torch.device, size: int) -> torch.Tensor:
    key = (device, size)
    counters = _SPLIT_COUNTERS.get(key)
    if counters is None:
        counters = _SPLIT_COUNTERS[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return counters


def pending_split_counters() -> int:
    """Sum of every K1 arrival counter (syncs the card; for checks): 0
    unless a launch was cut short."""
    return int(sum(int(c.sum()) for c in _SPLIT_COUNTERS.values()))

#: page sizes whose 64-key tiles K2's tensor-core arm reads as whole TMA boxes:
#: one box of 64 keys of a page of 64 or more, or 64 / page whole pages of a
#: smaller page (a box of at least 8 rows keeps the swizzle's period); the
#: other sizes keep the CUDA-core arm
_PREFILL_TC_SMALL_PAGES = (8, 16, 32)
#: folded rows (rep * S) one K1 CTA holds (``kDecodeRows``): a launch
#: covers rep * S rows in blocks of four, one CTA per block.  Four: the
#: register class keeps four CTAs on an SM, and re-reading the keys per
#: block costs less than wide CTAs' occupancy (PERF.md §6: 40 rows 0.071 ms
#: at 4 rows a CTA against 0.171 at 20; 32 rows 0.065 against 0.149 at 32)
DECODE_ROWS = 4
#: lanes one launch of either kernel takes: a lane per block along a grid
#: dimension that holds at most 65535
MAX_LANES = 65535
#: folded rows of one K2 q-block (``kPrefillRows``): a GQA group of more
#: query heads than this per kv head splits into the fewest groups that
#: divide it and fit a q-block, each its own q-block over the kv head's
#: pages (``prefill_group_split``)
PREFILL_MAX_GROUP = 64


def prefill_design(q_dtype: torch.dtype, page_dtype: torch.dtype, page: int, d: int) -> str:
    """The arm of K2 a call takes, from its dtypes, page size and head dim
    alone: ``"wgmma"`` (the tensor cores) for bf16 q over bf16, int8 or fp8
    pages with a page of 8, 16 or 32 keys or a multiple of 64 and D 64 or
    128; ``"cuda-cores"`` otherwise (f32 or mixed native dtypes keep f32
    products; other pages do not tile into 64-key boxes; D 16 and 32 fill
    no 64-column panel).  Quantized pages reach the tensor cores as bf16
    tiles made in shared memory: each code times its page's scale, rounded
    once, as the reference dequantizes a tile for a bf16 product."""
    if q_dtype == torch.bfloat16 and page_dtype in (torch.bfloat16, torch.int8,
                                                    torch.float8_e4m3fn) \
            and d in _WGMMA_HEAD_DIMS and (page % 64 == 0 or page in _PREFILL_TC_SMALL_PAGES):
        return "wgmma"
    return "cuda-cores"


def _operands(what: str, q, pages_k, pages_v, tables, lengths, k_scales, v_scales):
    """Validate a paged kernel's operands; return the ``(k_scales, v_scales)``
    to launch with (ones for native pages, so both kernels take scales).
    Quantized pages need their scales, as in the reference (``:408``)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors, got {q.device}")
    n, s, hq, d = q.shape
    num_pages, page, hkv, d_kv = pages_k.shape
    if pages_v.shape != pages_k.shape or d_kv != d:
        raise ValueError(f"{what}: pages {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} do not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not supported (kernel takes {_HEAD_DIMS})")
    if hq % hkv != 0:
        raise ValueError(f"{what}: {hq} query heads do not fold over {hkv} kv heads")
    if n > MAX_LANES:
        raise ValueError(f"{what}: {n} lanes exceed the {MAX_LANES} of one launch's grid")
    if q.dtype not in _KERNEL_DTYPES or pages_k.dtype not in _PAGE_FORMATS \
            or pages_v.dtype != pages_k.dtype:
        raise ValueError(f"{what}: dtypes q={q.dtype} pages={pages_k.dtype}/"
                         f"{pages_v.dtype} not supported (q f32 or bf16; pages f32, "
                         "bf16, int8 or float8_e4m3fn)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: tables and lengths must be int32")
    if tables.shape[0] != n or lengths.shape != (n,):
        raise ValueError(f"{what}: tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {n} lanes")
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{what}: give both k_scales and v_scales, or neither")
    if k_scales is None:
        if kv_qmax(pages_k.dtype) is not None:
            raise ValueError(f"{what}: quantized pages ({pages_k.dtype}) need "
                             "k_scales/v_scales")
        # native pages: feed ones (made once per pool shape) so the kernel
        # signature is uniform
        key = (q.device, num_pages, hkv)
        k_scales = _UNIT_SCALES.get(key)
        if k_scales is None:
            k_scales = _UNIT_SCALES[key] = torch.ones((num_pages, hkv), dtype=torch.float32,
                                                      device=q.device)
        v_scales = k_scales
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v),
                    ("tables", tables), ("lengths", lengths),
                    ("k_scales", k_scales), ("v_scales", v_scales)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if k_scales.shape != (num_pages, hkv) or v_scales.shape != (num_pages, hkv) \
            or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise ValueError(f"{what}: scales must be f32 [{num_pages}, {hkv}]")
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return k_scales, v_scales


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def decode_row_blocks(gs: int) -> Tuple[int, int]:
    """``(rows_per_block, blocks)`` of K1's ``gs = rep * S`` folded rows: one
    CTA per block of :data:`DECODE_ROWS` rows (the last one ragged), each
    walking the split's keys for its own rows.  Rows are independent: the
    blocking changes no bit of the output."""
    return min(gs, DECODE_ROWS), -(-gs // DECODE_ROWS)


def paged_attention(q, pages_k, pages_v, tables, lengths, k_scales=None,
                    v_scales=None, tree_mask=None):
    """Decode attention over paged KV, reading pages in place (kernel K1).

    ``q [N, S, Hq, D]`` — query ``i`` of lane ``n`` at position
    ``lengths[n] + i``; ``pages_k``/``pages_v [NP, page, Hkv, D]`` — the pool
    of ONE layer with this call's KV already inserted, f32, bf16, int8 or
    fp8-e4m3; ``tables [N, P]`` int32; ``lengths [N]`` int32;
    ``k_scales``/``v_scales [NP, Hkv]`` f32 — required for int8/fp8 pages,
    else None (ones).  Returns ``[N, S, Hq, D]`` in ``q.dtype``.  A CPU
    ``q`` takes :func:`paged_attention_reference`; a CUDA ``q`` launches
    ``csrc/paged_attention.cu`` or raises.  The launch splits each lane's
    pages by :func:`decode_split_plan` and its ``rep * S`` folded rows into
    blocks by :func:`decode_row_blocks`; with more than one split the
    partials go to f32 scratch allocated here, and the arrival counters are
    this device's cached ones, which the kernel leaves at zero.  Native
    pages (no scales) pass null scales, which the kernel reads as ones.

    ``tree_mask`` (a :class:`TreeMask`, or an ``[S, S]`` bool array wrapped
    into one per call) runs the tree-mask arm: query ``i`` is tree node
    ``i`` at slot ``lengths[n] + i`` and sees the history plus the nodes its
    row of the mask names; its RoPE position is the caller's business.  A
    mask that is not ``[S, S]`` or has more than :data:`MAX_TREE_NODES`
    nodes raises ``ValueError``, on every device; the kernel reads the
    mask's packed words from the card."""
    tree = as_tree_mask(tree_mask)
    if tree is not None:
        _check_tree(tree, q.shape[1], "paged_attention")
    if q.device.type == "cpu":
        return paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                                         k_scales=k_scales, v_scales=v_scales,
                                         tree_mask=tree)
    native = k_scales is None
    k_scales, v_scales = _operands("paged_attention", q, pages_k, pages_v, tables, lengths,
                                   k_scales, v_scales)
    n, s, hq, d = q.shape
    _, page, hkv, _ = pages_k.shape
    num_p = tables.shape[1]
    pps, nsplit = decode_split_plan(num_p, n, hkv, page, _sm_count(q.device.index))
    rows, blocks = decode_row_blocks((hq // hkv) * s)
    out = torch.empty_like(q)
    part_ptr = counters_ptr = 0
    if nsplit > 1:
        part = torch.empty(n * hkv * blocks * nsplit * rows * (d + 2), dtype=torch.float32,
                           device=q.device)
        part_ptr = part.data_ptr()
        counters_ptr = _split_counters(q.device, n * hkv * blocks).data_ptr()
    _build.launch(
        "paged_attention", "atpu_paged_decode", "paged_attention",
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
        0 if native else k_scales.data_ptr(), 0 if native else v_scales.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_ptr, counters_ptr, 0 if tree is None else tree.words(q.device).data_ptr(),
        n, s, hq, hkv, d, page, num_p, pps, nsplit, _bf16(q),
        _PAGE_FORMATS[pages_k.dtype], float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_attention.launches += 1
    if tree is not None:
        paged_attention.tree_launches += 1
    return out


def paged_flash_prefill(q, pages_k, pages_v, tables, lengths, k_scales=None,
                        v_scales=None):
    """Flash-attention prefill over paged KV, reading pages in place (kernel K2).

    The prefill-side twin of :func:`paged_attention` with a chunk-wide ``S``:
    the chunk's K/V must already be in the pool, so the causal online softmax
    over prior pages and the in-chunk triangle are one page walk, cut per
    q-block at its causal frontier.  Pages f32, bf16, int8 or fp8-e4m3
    (scales required for the last two).  A CPU ``q`` takes
    :func:`paged_flash_prefill_reference`; a CUDA ``q`` launches
    ``csrc/paged_prefill.cu`` or raises: on the tensor cores where
    :func:`prefill_design` says ``"wgmma"`` (bf16 q over bf16, int8 or fp8
    pages, a page of 8, 16 or 32 keys or a multiple of 64, D 64 or 128;
    bf16 operands with f32 sums, the probabilities rounded to bf16 before
    P.V), else on the CUDA cores in f32.  A GQA group of more than
    :data:`PREFILL_MAX_GROUP` query heads per kv head splits into q-blocks
    of its head groups, in both arms.  Graph-safe: the tensor-core arm's
    three TMA tensor maps (q, K and V pages) are encoded on the host at the
    call and passed as ``__grid_constant__`` kernel parameters, so a CUDA
    graph's capture keeps them and its replays encode nothing (the engine's
    prefill-chunk graphs; ``q`` then lives at a fixed address of the graph's
    pool)."""
    if q.device.type == "cpu":
        return paged_flash_prefill_reference(q, pages_k, pages_v, tables, lengths,
                                             k_scales=k_scales, v_scales=v_scales)
    k_scales, v_scales = _operands("paged_flash_prefill", q, pages_k, pages_v, tables,
                                   lengths, k_scales, v_scales)
    n, s, hq, d = q.shape
    num_pages, page, hkv, _ = pages_k.shape
    tensor_cores = int(prefill_design(q.dtype, pages_k.dtype, page, d) == "wgmma")
    out = torch.empty_like(q)
    _build.launch(
        "paged_prefill", "atpu_paged_prefill", "paged_flash_prefill",
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        n, s, hq, hkv, d, page, num_pages, tables.shape[1], _bf16(q),
        _PAGE_FORMATS[pages_k.dtype], tensor_cores, float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_flash_prefill.launches += 1
    return out


paged_attention.launches = 0
paged_attention.tree_launches = 0
paged_flash_prefill.launches = 0


#: the launch counters: (wrapper, attribute)
LAUNCH_COUNTERS = ((paged_attention, "launches"), (paged_attention, "tree_launches"),
                   (paged_flash_prefill, "launches"))


def launch_counts() -> Tuple[int, ...]:
    """The launch counters' values, in :data:`LAUNCH_COUNTERS` order."""
    return tuple(getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS)


def set_launch_counts(counts: Tuple[int, ...]) -> None:
    for (fn, attr), value in zip(LAUNCH_COUNTERS, counts):
        setattr(fn, attr, value)


def credit_launches(counts: Tuple[int, ...]) -> None:
    """Add ``counts`` to the launch counters: a CUDA graph's replay launches
    on the card what its capture counted, without running the wrappers."""
    set_launch_counts(tuple(a + b for a, b in zip(launch_counts(), counts)))


def reset_launch_counts() -> None:
    """Set both kernels' launch counters (and K1's tree-arm count) to zero."""
    set_launch_counts((0,) * len(LAUNCH_COUNTERS))
