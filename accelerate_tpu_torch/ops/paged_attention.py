"""Paged attention over the KV page pool: the two CUDA kernels and their plain versions.

Port of :mod:`accelerate_tpu.ops.paged_attention`.  The serving engine keeps
every lane's KV in a shared page pool ``[num_pages, page, Hkv, D]`` addressed
through per-lane block tables; attention reads those pages in place.

* :func:`paged_attention` — decode (and short verify spans): launches the
  hand-written kernel ``csrc/paged_attention.cu`` (K1) on a CUDA tensor.
* :func:`paged_flash_prefill` — a prefill chunk's causal flash attention over
  the same pages: launches ``csrc/paged_prefill.cu`` (K2).
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

from typing import Optional

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
def _launch(what: str, library: str, entry: str, q, pages_k, pages_v, tables,
            lengths, k_scales, v_scales) -> torch.Tensor:
    """Validate the operands, launch one kernel on the current stream, raise
    on a non-zero ``cudaGetLastError``.  Returns the ``[N, S, Hq, D]`` output."""
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
        # native pages: feed ones so the kernel signature is uniform
        k_scales = torch.ones((num_pages, hkv), dtype=torch.float32, device=q.device)
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
    out = torch.empty_like(q)
    _build.launch(
        library, entry, what,
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        n, s, hq, hkv, d, page, tables.shape[1],
        int(q.dtype == torch.bfloat16), int(pages_k.dtype == torch.bfloat16),
        float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def paged_attention(q, pages_k, pages_v, tables, lengths, k_scales=None,
                    v_scales=None):
    """Decode attention over paged KV, reading pages in place (kernel K1).

    ``q [N, S, Hq, D]`` — query ``i`` of lane ``n`` at position
    ``lengths[n] + i``; ``pages_k``/``pages_v [NP, page, Hkv, D]`` — the pool
    of ONE layer with this call's KV already inserted; ``tables [N, P]``
    int32; ``lengths [N]`` int32; ``k_scales``/``v_scales [NP, Hkv]`` f32 or
    None (ones).  Returns ``[N, S, Hq, D]`` in ``q.dtype``.  A CPU ``q`` takes
    :func:`paged_attention_reference`; a CUDA ``q`` launches
    ``csrc/paged_attention.cu`` or raises."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, pages_k, pages_v, tables, lengths,
                                         k_scales=k_scales, v_scales=v_scales)
    out = _launch("paged_attention", "paged_attention", "atpu_paged_decode", q,
                  pages_k, pages_v, tables, lengths, k_scales, v_scales)
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
    ``csrc/paged_prefill.cu`` or raises."""
    if q.device.type == "cpu":
        return paged_flash_prefill_reference(q, pages_k, pages_v, tables, lengths,
                                             k_scales=k_scales, v_scales=v_scales)
    out = _launch("paged_flash_prefill", "paged_prefill", "atpu_paged_prefill", q,
                  pages_k, pages_v, tables, lengths, k_scales, v_scales)
    paged_flash_prefill.launches += 1
    return out


paged_attention.launches = 0
paged_flash_prefill.launches = 0


def reset_launch_counts() -> None:
    """Set both kernels' launch counters to zero."""
    paged_attention.launches = 0
    paged_flash_prefill.launches = 0
