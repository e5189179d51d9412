"""One CUDA graph per window kind, and per prefill bucket, of a serving engine.

The port's counterpart of the reference's one compiled executable per
window and per prefill bucket (``_serve_jit`` and ``jit_cache_sizes``,
``accelerate_tpu/serving/pool.py:102``, ``:1228``; ``self._prefill[bucket]``,
``accelerate_tpu/serving/engine.py:668``).  The engine captures each of its
windows and each bucket's chunk once, at construction, on the card, with
every lane inactive and the chunk's table on the null page (all writes go
to the null page), and replays the graph every cycle: one launch where the
eager program makes thousands.  A graph reads and writes only tensors that
live as long as the engine (pages, scales, tables, index, lane vectors, the
verify token block, the chunk's tokens, table and start); the host writes
its inputs in place before a replay and copies the graph's static outputs
out right after it (:func:`~accelerate_tpu_torch.serving.readback.stage`;
a chunk's quantization error is cloned).

Capture follows ``torch.cuda.graph``'s rules: one eager warm-up on a side
stream first (it makes what the kernel wrappers make once: K1's arrival
counters, cuBLAS handles), then the capture.  The kernels' launch counters
advance during the warm-up and the capture as the wrappers run; both are
taken back, the capture's count is kept with the graph, and each replay
credits it (:func:`~accelerate_tpu_torch.ops.paged_attention.
credit_launches`), so the counters keep meaning launches on the card.  A
capture that fails raises: nothing falls back to the eager window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Tuple

import torch

from ..ops import paged_attention as pa


@dataclasses.dataclass
class CapturedWindow:
    graph: torch.cuda.CUDAGraph
    #: the window's outputs: tensors of the graph's pool, rewritten by every replay
    outputs: Any
    #: launch counts of one replay, in ``paged_attention.LAUNCH_COUNTERS`` order
    launches: Tuple[int, ...]


class WindowGraphs:
    """The captured programs of one engine, by key: for a window (kind,
    lanes, window or span, table width, page dtype, sampled variant), for a
    chunk ("prefill", bucket, table width, page dtype); each fixed for the
    engine's life."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._windows: Dict[Hashable, CapturedWindow] = {}

    def __len__(self) -> int:
        return len(self._windows)

    def keys(self):
        return self._windows.keys()

    def capture(self, key: Hashable, fn: Callable[[], Any],
                reset: Callable[[], None]) -> CapturedWindow:
        """Warm ``fn`` up on a side stream, capture it, and run ``reset``
        (which must undo the warm-up's writes to the engine's lane state)."""
        if key in self._windows:
            raise ValueError(f"window {key} is already captured")
        counts = pa.launch_counts()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn()
        stream.wait_stream(side)
        pa.set_launch_counts(counts)          # the warm-up is not the path's
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = fn()
        launches = tuple(a - b for a, b in zip(pa.launch_counts(), counts))
        pa.set_launch_counts(counts)
        reset()
        window = self._windows[key] = CapturedWindow(graph, outputs, launches)
        return window

    def replay(self, key: Hashable) -> Any:
        """Launch the window's graph on the current stream; returns its
        static outputs (valid until the next replay)."""
        window = self._windows[key]
        window.graph.replay()
        pa.credit_launches(window.launches)
        return window.outputs
