"""Paged KV allocator: one physical page pool behind every lane.

Port of :mod:`accelerate_tpu.serving.paging`.  KV lives in fixed-size pages;
a lane owns a block table mapping logical positions to physical pages, pages
are allocated as the lane grows, and refcounts let lanes alias a page.
Allocation and refcounting are host-side numpy; the page arrays live on the
device and are written in place by the model's forward (no donation: PyTorch
updates the tensors themselves).

* :class:`PageAllocator` — the refcounted free list.  Page id ``0`` is the
  reserved **null page**: freed or frozen lanes' writes land there.
* :class:`PagedKVPool` — the device page arrays
  ``[L, num_pages, page_size, Hkv, Dh]``, f32 scales ``[L, num_pages, Hkv]``
  (ones: only native and bf16 pages are ported) and per-lane block tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..ops.paged_attention import NULL_PAGE, kv_storage_dtype


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` physical pages.

    Page 0 is the permanently pinned null page.  The free list hands out
    ascending ids deterministically (same workload, same tables).  Lanes
    do not share pages in this slice (no prefix cache), so every allocated
    page holds exactly one reference."""

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

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages (refcount 1 each) or ``None`` — all-or-nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.refs[ids] += 1
        return ids

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


class PagedKVPool:
    """Device page arrays + host block tables for ``num_slots`` lanes.

    ``max_len`` must be a multiple of ``page_size``; ``num_pages`` counts the
    null page and must hold one full lane plus it.  ``kv_dtype``: ``None``
    keeps ``config.dtype``, ``"bf16"`` stores bf16."""

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
        self.storage_dtype = kv_storage_dtype(kv_dtype, cfg.dtype)
        shape = (cfg.num_layers, self.num_pages, self.page_size,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        scale_shape = (cfg.num_layers, self.num_pages, cfg.num_kv_heads)
        self.pages_k = torch.zeros(shape, dtype=self.storage_dtype, device=self.device)
        self.pages_v = torch.zeros(shape, dtype=self.storage_dtype, device=self.device)
        # per-(layer, page, kv-head) dequantization scales: ones, the no-op
        # multiply the kernels take for native pages
        self.k_scales = torch.ones(scale_shape, dtype=torch.float32, device=self.device)
        self.v_scales = torch.ones(scale_shape, dtype=torch.float32, device=self.device)
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

    def lane_release(self, slot: int) -> int:
        """Unmap the whole lane (finish / preempt): deref every mapped page
        and reset the row to the null sink.  Returns pages freed."""
        n = int(self.lane_npages[slot])
        held = [int(p) for p in self.tables[slot, :n]]
        self.tables[slot, :] = NULL_PAGE
        self.lane_npages[slot] = 0
        return self.allocator.deref(held)

    def kv_bytes(self) -> int:
        """Device bytes held by the page and scale arrays (null page included)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.pages_k, self.pages_v, self.k_scales, self.v_scales))


__all__ = ["NULL_PAGE", "PageAllocator", "PagedKVPool"]
