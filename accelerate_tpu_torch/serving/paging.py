"""Paged KV allocator: one physical page pool behind every lane.

Port of :mod:`accelerate_tpu.serving.paging`.  KV lives in fixed-size pages;
a lane owns a block table mapping logical positions to physical pages, pages
are allocated as the lane grows, and refcounts let lanes and the prefix
cache (:mod:`.prefix_cache`) alias a page.  Allocation and refcounting are
host-side numpy; the page arrays live on the device and are written in
place by the model's forward (no donation: PyTorch updates the tensors
themselves).

Sharing: the prefix cache holds one allocator reference per page of each
device-tier node, every lane aliasing a cached prefix takes its own, and a
page returns to the free list only at refcount zero.  Copy-on-write happens
in one place: the page holding a lane's first decode write (position
``prompt_len - 1``) when that page is shared; everything a lane writes after
that lands in pages it owns alone.

* :class:`PageAllocator` — the refcounted free list.  Page id ``0`` is the
  reserved **null page**: freed or frozen lanes' writes land there.
* :class:`DraftContextWindow` — the draft model's per-lane context window
  (tree speculation), host numpy.
* :class:`PagedKVPool` — the device page arrays
  ``[L, num_pages, page_size, Hkv, Dh]`` in the storage dtype (native, bf16,
  int8 or fp8-e4m3), f32 dequantization scales ``[L, num_pages, Hkv]``
  (ones; quantized pages rewrite theirs at every insert) and per-lane block
  tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..ops.paged_attention import NULL_PAGE, kv_qmax, kv_storage_dtype


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` physical pages.

    Page 0 is the permanently pinned null page.  The free list hands out
    ascending ids deterministically (same workload, same tables)."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError(f"need at least 2 pages (null + 1), got {num_pages}")
        self.refs = np.zeros(self.num_pages, np.int64)
        self.refs[NULL_PAGE] = 1  # never allocatable, never freed
        # pop() takes from the tail: ids come out ascending (1, 2, 3, ...)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Allocated pages (null excluded)."""
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages (refcount 1 each) or ``None`` — all-or-nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.refs[ids] += 1
        return ids

    def ref(self, ids: Sequence[int]) -> None:
        """One more reference on each of ``ids`` (aliasing a shared prefix)."""
        for p in ids:
            if self.refs[p] <= 0:
                raise RuntimeError(f"ref() on unallocated page {p}")
            self.refs[p] += 1

    def deref(self, ids: Sequence[int]) -> int:
        """Drop one reference per page; pages hitting zero return to the free
        list.  Returns how many pages were freed."""
        freed = 0
        for p in ids:
            if p == NULL_PAGE:
                continue
            self.refs[p] -= 1
            if self.refs[p] < 0:
                raise RuntimeError(f"page {p} refcount underflow")
            if self.refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def shared_extra_refs(self) -> int:
        """Sum of ``max(refs - 1, 0)`` over real pages: how many page copies
        sharing saves right now."""
        return int(np.maximum(self.refs[1:] - 1, 0).sum())


class PagedKVPool:
    """Device page arrays + host block tables for ``num_slots`` lanes.

    ``max_len`` must be a multiple of ``page_size``; ``num_pages`` counts the
    null page and must hold one full lane plus it.  ``kv_dtype``: ``None``
    keeps ``config.dtype``, ``"bf16"`` stores bf16, ``"int8"`` / ``"fp8"``
    store quantized pages with one f32 scale per (layer, page, kv-head),
    written at scatter time
    (:func:`~accelerate_tpu_torch.ops.paged_attention.paged_quantized_insert`;
    ``accelerate_tpu/serving/paging.py:136``)."""

    def __init__(self, config, num_slots: int, max_len: int, page_size: int,
                 num_pages: int, kv_dtype: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if max_len % page_size != 0:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.num_slots = int(num_slots)
        self.pages_per_lane = self.max_len // self.page_size
        self.num_pages = int(num_pages)
        if self.num_pages < self.pages_per_lane + 1:
            raise ValueError(
                f"num_pages {num_pages} cannot hold one full lane "
                f"({self.pages_per_lane} pages) plus the null page"
            )
        cfg = config
        self.kv_dtype = kv_dtype
        self.storage_dtype = kv_storage_dtype(kv_dtype, cfg.dtype)
        self.quantized = kv_qmax(self.storage_dtype) is not None
        shape = (cfg.num_layers, self.num_pages, self.page_size,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        scale_shape = (cfg.num_layers, self.num_pages, cfg.num_kv_heads)
        self.pages_k = torch.zeros(shape, dtype=self.storage_dtype, device=self.device)
        self.pages_v = torch.zeros(shape, dtype=self.storage_dtype, device=self.device)
        # per-(layer, page, kv-head) dequantization scales: ones, the no-op
        # multiply the kernels take for native pages; quantized inserts
        # rewrite the scales of every page they touch
        self.k_scales = torch.ones(scale_shape, dtype=torch.float32, device=self.device)
        self.v_scales = torch.ones(scale_shape, dtype=torch.float32, device=self.device)
        #: bytes of K+V one page holds across all layers, its scales included
        #: (``accelerate_tpu/serving/paging.py:204``)
        itemsize = self.pages_k.element_size()
        self.page_kv_bytes = 2 * (self.page_size * cfg.num_kv_heads * cfg.resolved_head_dim
                                  * cfg.num_layers * itemsize
                                  + cfg.num_layers * cfg.num_kv_heads * 4)
        self.allocator = PageAllocator(self.num_pages)
        # host block tables: row s maps lane s's logical page slots to
        # physical ids; NULL_PAGE marks unmapped entries
        self.tables = np.zeros((self.num_slots, self.pages_per_lane), np.int32)
        self.lane_npages = np.zeros(self.num_slots, np.int32)

    def lane_append_owned(self, slot: int, ids: Sequence[int]) -> None:
        """Map freshly allocated pages (ownership transfers to the lane) onto
        the lane's next logical slots."""
        n = self.lane_npages[slot]
        self.tables[slot, n:n + len(ids)] = ids
        self.lane_npages[slot] = n + len(ids)

    def lane_append_shared(self, slot: int, ids: Sequence[int]) -> None:
        """Alias already resident pages (a prefix-cache hit): one new
        reference per page, then map them.  No device work: the zero-copy
        hit."""
        self.allocator.ref(ids)
        self.lane_append_owned(slot, ids)

    def lane_replace(self, slot: int, page_slot: int, new_id: int) -> int:
        """Copy-on-write bookkeeping: map logical slot ``page_slot`` to
        ``new_id`` (allocated by the caller) and drop the lane's reference
        on the old page.  Returns the old id (the copy's source)."""
        old = int(self.tables[slot, page_slot])
        self.tables[slot, page_slot] = new_id
        self.allocator.deref([old])
        return old

    def chunk_ids(self, slot: int, start_page: int, n: int) -> List[int]:
        """Physical ids behind ``n`` logical page slots from ``start_page``
        (what the prefix cache retains for a freshly prefilled chunk)."""
        return [int(p) for p in self.tables[slot, start_page:start_page + n]]

    def lane_pages(self, slot: int) -> List[int]:
        """Every physical id the lane maps, in logical order."""
        return self.chunk_ids(slot, 0, int(self.lane_npages[slot]))

    def lane_detach(self, slot: int) -> List[int]:
        """Unmap the whole lane WITHOUT dropping its references: returns the
        page ids the caller must deref later (a window in flight may still
        write them through the table it was dispatched with)."""
        n = int(self.lane_npages[slot])
        held = [int(p) for p in self.tables[slot, :n]]
        self.tables[slot, :] = NULL_PAGE
        self.lane_npages[slot] = 0
        return held

    def lane_release(self, slot: int) -> int:
        """Unmap the whole lane (finish / preempt): deref every mapped page
        and reset the row to the null sink.  Returns pages freed."""
        return self.allocator.deref(self.lane_detach(slot))

    @property
    def kv_bytes_per_token(self) -> float:
        """KV bytes one token costs across all layers at the storage dtype,
        the per-page scales amortized (``serve/kv_bytes_per_token``)."""
        return self.page_kv_bytes / self.page_size

    def chunk_bytes(self, npages: int) -> int:
        """Bytes ``npages`` pages of KV cost: K+V at the storage dtype plus
        both per-page f32 scale slabs, the one unit every per-chunk budget
        charges (``prefix_cache_mb``, ``prefix_host_mb``,
        ``prefix_disk_mb``)."""
        return int(npages) * self.page_kv_bytes

    def kv_bytes(self) -> int:
        """Device bytes held by the page and scale arrays (null page included)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.pages_k, self.pages_v, self.k_scales, self.v_scales))


class DraftContextWindow:
    """Host-side sliding context for the draft model of tree speculation
    (``accelerate_tpu/serving/paging.py:332-378``).

    The draft forward is stateless: every cycle it re-prefills the last
    ``width`` visible tokens of each lane, right-padded, plus a valid length.
    Two numpy arrays ``[slots, width]`` / ``[slots]`` hold them:
    :meth:`begin` seeds a lane from its prompt tail, :meth:`push` slides
    committed tokens in after each verify cycle, :meth:`retire` clears the
    row.  The window's last token is the lane's pending token, the draft
    tree's root."""

    def __init__(self, slots: int, width: int, pad: int = 0) -> None:
        if width < 1:
            raise ValueError(f"need width >= 1, got {width}")
        self.width = width
        self.pad = pad
        self.tokens = np.full((slots, width), pad, dtype=np.int32)
        self.length = np.zeros(slots, dtype=np.int32)

    def begin(self, slot: int, tokens: Sequence[int]) -> None:
        """Seed ``slot`` from a prompt: keep the last ``width`` tokens."""
        toks = np.asarray(tokens, dtype=np.int32).ravel()[-self.width:]
        self.tokens[slot] = self.pad
        self.tokens[slot, : toks.size] = toks
        self.length[slot] = toks.size

    def push(self, slot: int, tokens: Sequence[int]) -> None:
        """Append committed tokens, sliding the window left on overflow."""
        toks = np.asarray(tokens, dtype=np.int32).ravel()
        if toks.size >= self.width:
            self.tokens[slot] = toks[-self.width:]
            self.length[slot] = self.width
            return
        n = int(self.length[slot])
        spill = n + toks.size - self.width
        if spill > 0:
            self.tokens[slot, : n - spill] = self.tokens[slot, spill:n]
            n -= spill
        self.tokens[slot, n: n + toks.size] = toks
        self.length[slot] = n + toks.size

    def retire(self, slot: int) -> None:
        self.tokens[slot] = self.pad
        self.length[slot] = 0


__all__ = ["NULL_PAGE", "DraftContextWindow", "PageAllocator", "PagedKVPool"]
