"""Deferred device->host readback for the pipelined serve loop.

Port of :mod:`accelerate_tpu.serving.readback`.  With
``ServingEngine(async_depth=1)`` (the default) the engine parks a window's
outputs in a :class:`Readback` handle, dispatches the NEXT window, and only
then lands the previous window's tokens: the card runs the new window while
the host emits tokens, runs callbacks, drafts and admits.

At dispatch, right behind the window on the same stream, :func:`stage`
copies its tokens, counts and quantization errors from the window's outputs
(a CUDA graph's static outputs, which the next replay overwrites) into
pinned host buffers of the handle's own, and records an event after the
copies.  :meth:`Readback.fetch` waits on that event: it is the one blocking
point of a window, and it also proves the window's KV writes landed, which
the deferred page release (:meth:`Readback.settle`) relies on.  On the CPU
everything ran at dispatch and nothing waits.

The handle also carries the prefix cache's traffic enqueued in its cycle
(:class:`CacheTransfer`): ``spills`` (a chunk's pages gathered on the card
and copied into pinned host buffers, behind the work already on the stream)
land their payloads at the drain, once the fetch proved the copies done;
``promotions`` (a payload copied up and installed into fresh pages) keep
their pinned source buffers referenced until then, because the copy reads
them later.  The reference's handle also holds ``consumed``, which parks
donated JAX buffers whose release would block on the window; PyTorch writes
the engine's tensors in place and drops nothing a window still reads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["CacheTransfer", "Readback", "stage"]


def stage(tensors: Sequence[Optional[torch.Tensor]]
          ) -> Tuple[List[Optional[torch.Tensor]], Optional[torch.cuda.Event]]:
    """Copy each CUDA tensor into a pinned host buffer of its own, behind
    the work already on the current stream, and record an event after the
    copies.  Returns the host tensors (CPU tensors and ``None`` pass
    through) and the event (``None`` when nothing was on the card).
    Nothing here waits for the card."""
    out: List[Optional[torch.Tensor]] = []
    device = None
    for t in tensors:
        if t is None or t.device.type == "cpu":
            out.append(t)
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out.append(host)
        device = t.device
    if device is None:
        return out, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return out, ready


@dataclasses.dataclass
class CacheTransfer:
    """One prefix-cache transfer in flight: a spill (``kind="spill"``) or a
    promotion (``"promote"``) of one chunk.

    A spill's ``gathered`` are the chunk's pages and scales gathered on the
    device (a promotion before the drain installs straight from them) and
    ``host`` the buffers the device-to-host copies land in (the same
    tensors on the CPU): its payload once settled.  A promotion keeps its
    host source buffers in ``host`` until the drain.  ``marks`` are CUDA
    events around the transfer on the stream (``None`` on the CPU, where
    ``seconds`` is its host wall); ``nbytes`` the bytes it moved."""

    kind: str
    nbytes: int
    node: object = None
    gathered: Tuple[torch.Tensor, ...] = ()
    host: Tuple[torch.Tensor, ...] = ()
    marks: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
    seconds: float = 0.0

    def finish(self) -> float:
        """Wait for the transfer (nothing is left to wait for after its
        window's fetch) and return its seconds on the stream."""
        if self.marks is None:
            return self.seconds
        self.marks[1].synchronize()
        return self.marks[0].elapsed_time(self.marks[1]) / 1e3


@dataclasses.dataclass
class Readback:
    """One in-flight decode or verify window: its staged outputs and the
    dispatch-time host state needed to land them later.

    Made at dispatch and drained at most one cycle later (depth-1
    pipeline).  ``active``/``reqs``/``eos`` snapshot the lanes as the window
    saw them: between dispatch and drain the host may retire or preempt a
    lane or install a new request into a slot the window still holds, so
    the engine lands tokens against this snapshot and retires by identity
    (``engine._slot_req[s] is reqs[s]``), not by slot number."""

    kind: str                             # "decode" | "verify"
    toks: torch.Tensor                    # host [slots, width] token block
    width: int                            # decode window / verify commit width
    counts: Optional[torch.Tensor] = None  # host [slots] n_commit (verify only)
    qerr: Optional[torch.Tensor] = None   # host scalar: the window's KV round-trip error
    active: Optional[np.ndarray] = None   # dispatch-time active mask (copy)
    reqs: Optional[list] = None           # dispatch-time _slot_req snapshot
    eos: Optional[np.ndarray] = None      # dispatch-time per-lane EOS ids
    n_occupied: int = 0
    drafted: Optional[np.ndarray] = None  # verify: lanes that proposed drafts
    dispatch_t: float = dataclasses.field(default_factory=time.perf_counter)
    #: the event behind the staging copies (``None`` on the CPU)
    ready: Optional[torch.cuda.Event] = None
    #: tree cycles on the card: events around the draft forward's replay
    draft_marks: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
    #: tree cycles on the CPU: the draft forward's host seconds
    draft_s: float = 0.0
    #: physical KV page ids whose release waits for this window: it may
    #: still write through the block table it was dispatched with
    deferred_pages: List[int] = dataclasses.field(default_factory=list)
    #: slots retired after dispatch because this window provably finishes
    #: their request (no EOS, fixed width): the slot was re-admitted one
    #: cycle early, and the request's tokens still land at drain
    prefreed: set = dataclasses.field(default_factory=set)
    #: host [chunks] KV round-trip errors of the prefill chunks dispatched
    #: in this window's cycle, staged behind the chunks when the engine
    #: hands them to the window (``ready`` then follows them)
    prefill_qerrs: Optional[torch.Tensor] = None
    #: prefix-cache spills and promotions enqueued before this window
    spills: List[CacheTransfer] = dataclasses.field(default_factory=list)
    promotions: List[CacheTransfer] = dataclasses.field(default_factory=list)
    fetched: bool = False

    def fetch(self) -> None:
        """Wait until the window and its staging copies are done (the one
        blocking point of a window; nothing on the CPU)."""
        if self.ready is not None:
            self.ready.synchronize()
        self.fetched = True

    def lane_live(self, slot: int) -> bool:
        """Was ``slot`` active when this window was dispatched?  A live
        lane's pages must not return to the allocator until it retires."""
        return self.active is not None and bool(self.active[slot])

    def settle(self, allocator) -> int:
        """Release every deferred page (after :meth:`fetch`)."""
        if not self.fetched:
            raise RuntimeError("settle() before fetch(): the window may still write its pages")
        freed = allocator.deref(self.deferred_pages)
        self.deferred_pages = []
        return freed
