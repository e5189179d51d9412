"""Paged attention over the KV page pool: the two CUDA kernels and their plain versions.

Port of :mod:`accelerate_tpu.ops.paged_attention`.  The serving engine keeps
every lane's KV in a shared page pool ``[num_pages, page, Hkv, D]`` addressed
through per-lane block tables; attention reads those pages in place.

* :func:`paged_attention` — decode (and short verify spans): launches the
  hand-written kernel ``csrc/paged_attention.cu`` (K1) on a CUDA tensor,
  each lane's page walk split across CTAs by :func:`decode_split_plan`.
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

Each kernel wrapper counts its launches in an integer attribute
(``paged_attention.launches``), raised by one where the kernel is launched
and nowhere else, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

#: reserved garbage-sink page id — must match ``serving.paging.NULL_PAGE``
NULL_PAGE = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)


def kv_storage_dtype(kv_dtype: Optional[str], native: torch.dtype) -> torch.dtype:
    """Resolve a ``ServingEngine(kv_dtype=...)`` string to the page dtype.
    ``None`` keeps the model's native KV dtype; ``"bf16"`` stores bf16.  The
    quantized formats (``"int8"``, ``"fp8"``) are not ported yet."""
    if kv_dtype is None:
        return native
    if kv_dtype == "bf16":
        return torch.bfloat16
    if kv_dtype in ("int8", "fp8"):
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r} (quantized KV pages) is not ported yet: "
            "ROADMAP Queue 1 item 6"
        )
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}; choose None or 'bf16'")


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


# ------------------------------------------------------------------ reference
def paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                              k_scales=None, v_scales=None):
    """Plain version of both kernels: live-masked gather + the slab attention math.

    ``q [N, S, Hq, D]`` against pages ``[NP, page, Hkv, D]`` through
    ``tables [N, P]``; query ``i`` of lane ``n`` sits at position
    ``lengths[n] + i`` and sees keys ``j <= lengths[n] + i`` (the new
    positions' KV must already be inserted).  Table slots past each lane's
    live page count gather the null page instead of stale pages."""
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
    k = pages_k[t]                                    # [N, P, page, Hkv, D]
    v = pages_v[t]
    if k_scales is not None:
        k = (k.float() * k_scales[t][:, :, None, :, None]).to(q.dtype)
        v = (v.float() * v_scales[t][:, :, None, :, None]).to(q.dtype)
    else:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    k = k.reshape(n, num_p * page, hkv, d)
    v = v.reshape(n, num_p * page, hkv, d)
    q_positions = lengths[:, None] + torch.arange(s, device=q.device)[None, :]
    return cached_attention(q, k, v, q_positions)


def paged_flash_prefill_reference(q, pages_k, pages_v, tables, lengths,
                                  k_scales=None, v_scales=None):
    """Plain version of :func:`paged_flash_prefill`: chunk-wide queries share
    the decode reference's math (prior pages and the in-chunk causal triangle
    are one visibility rule), so this is a documented delegation."""
    return paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                                     k_scales=k_scales, v_scales=v_scales)


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


#: (device, lanes x kv heads) -> K1's per-(lane, kv-head) arrival counters:
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


def prefill_design(q_dtype: torch.dtype, page_dtype: torch.dtype, page: int) -> str:
    """The arm of K2 a call takes, from its dtypes and page size alone:
    ``"wgmma"`` (the tensor cores) for bf16 q and pages with a page of 8, 16
    or 32 keys or a multiple of 64, ``"cuda-cores"`` otherwise (f32 or mixed
    dtypes keep f32 products; other pages do not tile into 64-key boxes)."""
    if q_dtype == page_dtype == torch.bfloat16 and (
            page % 64 == 0 or page in _PREFILL_TC_SMALL_PAGES):
        return "wgmma"
    return "cuda-cores"


def _operands(what: str, q, pages_k, pages_v, tables, lengths, k_scales, v_scales):
    """Validate a paged kernel's operands; return the ``(k_scales, v_scales)``
    to launch with (ones for native pages, so both kernels take scales)."""
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
    if q.dtype not in _KERNEL_DTYPES or pages_k.dtype not in _KERNEL_DTYPES \
            or pages_v.dtype != pages_k.dtype:
        raise ValueError(f"{what}: dtypes q={q.dtype} pages={pages_k.dtype}/"
                         f"{pages_v.dtype} not supported (f32 or bf16)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: tables and lengths must be int32")
    if tables.shape[0] != n or lengths.shape != (n,):
        raise ValueError(f"{what}: tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {n} lanes")
    if k_scales is None:
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


def paged_attention(q, pages_k, pages_v, tables, lengths, k_scales=None,
                    v_scales=None):
    """Decode attention over paged KV, reading pages in place (kernel K1).

    ``q [N, S, Hq, D]`` — query ``i`` of lane ``n`` at position
    ``lengths[n] + i``; ``pages_k``/``pages_v [NP, page, Hkv, D]`` — the pool
    of ONE layer with this call's KV already inserted; ``tables [N, P]``
    int32; ``lengths [N]`` int32; ``k_scales``/``v_scales [NP, Hkv]`` f32 or
    None (ones).  Returns ``[N, S, Hq, D]`` in ``q.dtype``.  A CPU ``q`` takes
    :func:`paged_attention_reference`; a CUDA ``q`` launches
    ``csrc/paged_attention.cu`` or raises.  The launch splits each lane's
    pages by :func:`decode_split_plan`; with more than one split the
    partials go to f32 scratch allocated here, and the arrival counters are
    this device's cached ones, which the kernel leaves at zero.  Native
    pages (no scales) pass null scales, which the kernel reads as ones."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                                         k_scales=k_scales, v_scales=v_scales)
    native = k_scales is None
    k_scales, v_scales = _operands("paged_attention", q, pages_k, pages_v, tables, lengths,
                                   k_scales, v_scales)
    n, s, hq, d = q.shape
    _, page, hkv, _ = pages_k.shape
    num_p = tables.shape[1]
    pps, nsplit = decode_split_plan(num_p, n, hkv, page, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part_ptr = counters_ptr = 0
    if nsplit > 1:
        part = torch.empty(n * hq * s * nsplit * (d + 2), dtype=torch.float32, device=q.device)
        part_ptr = part.data_ptr()
        counters_ptr = _split_counters(q.device, n * hkv).data_ptr()
    _build.launch(
        "paged_attention", "atpu_paged_decode", "paged_attention",
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
        0 if native else k_scales.data_ptr(), 0 if native else v_scales.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_ptr, counters_ptr, n, s, hq, hkv, d, page, num_p, pps, nsplit, _bf16(q),
        _bf16(pages_k), float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_attention.launches += 1
    return out


def paged_flash_prefill(q, pages_k, pages_v, tables, lengths, k_scales=None,
                        v_scales=None):
    """Flash-attention prefill over paged KV, reading pages in place (kernel K2).

    The prefill-side twin of :func:`paged_attention` with a chunk-wide ``S``:
    the chunk's K/V must already be in the pool, so the causal online softmax
    over prior pages and the in-chunk triangle are one page walk, cut per
    q-block at its causal frontier.  A CPU ``q`` takes
    :func:`paged_flash_prefill_reference`; a CUDA ``q`` launches
    ``csrc/paged_prefill.cu`` or raises: on the tensor cores where
    :func:`prefill_design` says ``"wgmma"`` (bf16 q and pages, a page of 8,
    16 or 32 keys or a multiple of 64; bf16 operands with f32 sums, the
    probabilities rounded to bf16 before P.V), else on the CUDA cores in f32."""
    if q.device.type == "cpu":
        return paged_flash_prefill_reference(q, pages_k, pages_v, tables, lengths,
                                             k_scales=k_scales, v_scales=v_scales)
    k_scales, v_scales = _operands("paged_flash_prefill", q, pages_k, pages_v, tables,
                                   lengths, k_scales, v_scales)
    n, s, hq, d = q.shape
    num_pages, page, hkv, _ = pages_k.shape
    tensor_cores = int(prefill_design(q.dtype, pages_k.dtype, page) == "wgmma")
    out = torch.empty_like(q)
    _build.launch(
        "paged_prefill", "atpu_paged_prefill", "paged_flash_prefill",
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        n, s, hq, hkv, d, page, num_pages, tables.shape[1], _bf16(q), _bf16(pages_k),
        tensor_cores, float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_flash_prefill.launches += 1
    return out


paged_attention.launches = 0
paged_flash_prefill.launches = 0


def reset_launch_counts() -> None:
    """Set both kernels' launch counters to zero."""
    paged_attention.launches = 0
    paged_flash_prefill.launches = 0
