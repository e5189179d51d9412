"""Chunked, host-offloaded optimizer updates: the ZeRO-Offload piece of one card.

Port of :mod:`accelerate_tpu.utils.chunked_update`.  The card cannot hold a
7B model's f32 masters, its gradients and two AdamW moments at once (108
GB), so the optimizer state lives in pinned host memory (or, the nvme tier,
in files) and streams through the card **one chunk at a time** on sync
steps; the card holds the working weights and the gradient buffer, plus
O(chunk).

Two mechanisms compose, as in the reference:

1. **Sliced view** (:func:`build_slice_spec`, :func:`flatten_view_meta`):
   a parameter bigger than the chunk budget is split along its leading axis
   into slices (a 32000 x 4096 embedding carries 1.57 GB of state, three
   512 MB chunks); each slice is a view leaf with a state of its own.
2. **Per-chunk optimizers** (:func:`build_chunked_tx`): the reference chains
   one masked copy of its optax transformation per chunk; here each chunk
   gets its own ``torch.optim.Optimizer`` built by the user's ``tx`` over
   *staging* parameters, one per view leaf of the chunk.  The math is the
   plain optimizer's: every view leaf is updated by exactly one chunk, and
   every chunk's optimizer steps on every sync step (torch's step counts
   stay where torch keeps them, on the host unless ``capturable``).  Any
   optimizer whose per-parameter state is tensors works; torch's ``foreach``
   AdamW is elementwise, so the grouping does not change a value.

:class:`ChunkedOptimizer` is that optimizer, and with master weights it is
also what :func:`with_master_weights` builds (one chunk, kept on the card).
Each chunk's state (and under master weights the f32 masters) is one
contiguous pinned buffer on the host; a sync step copies it to the card in one
transfer on a copy stream, steps the chunk's optimizer on the compute
stream, updates the working weights and copies the buffer back on a second
copy stream, with at most ``overlap`` chunks in flight.  Under master
weights the working copy is updated as the reference's
``with_master_weights.update`` does it: ``delta = cast(new_master) -
working``, then ``working + delta``, both in the working dtype.
"""

from __future__ import annotations

import collections
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .offload import pinned_host_buffer

# Per parameter element the streamed chunk holds master + two f32 moments
# plus the transient update: 12 bytes an element when sizing groups.
_BYTES_PER_ELEMENT = 12

# The per-chunk device budget relative to the chunk's 12 B/element state:
# the reference's value, swept on a 2.13B model on a 16 GB TPU v5e (in + out
# stream copies and the Adam temporaries ~4x the chunk, plus allocator
# slack).  Kept for parity of auto_chunk_bytes; it is not a measurement of
# this card.
_CHUNK_TRANSIENT_FACTOR = 6

# byte alignment of each tensor inside a chunk's flat buffer
_ALIGN = 256


def detect_hbm_bytes(device=None) -> int:
    """The card's memory capacity (``total_memory`` of its properties); a
    conservative 16 GB for the CPU."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 << 30


def _shapes(params: Any) -> List[Tuple[int, ...]]:
    """The shapes of ``params``: a module's parameters, a dict's values, a
    sequence of tensors, shapes or anything with a ``shape``."""
    if isinstance(params, nn.Module):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    elif hasattr(params, "shape"):
        params = [params]
    return [tuple(getattr(p, "shape", p)) for p in params]


def _numel(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def auto_chunk_bytes(
    params: Any,
    *,
    working_bytes_per_element: int,
    grad_bytes_per_element: int,
    accum_buffer_bytes_per_element: int = 0,
    shard_degree: int = 1,
    overlap: int = 2,
    hbm_bytes: Optional[int] = None,
) -> int:
    """The streamed chunk's size from the card's memory: what the resident
    set (working weights + gradient buffer [+ a separate accumulation
    buffer], each divided by ``shard_degree``) and a margin for activations
    leave, split over ``overlap`` chunks in flight at
    ``_CHUNK_TRANSIENT_FACTOR`` times their 12 B/element state each;
    clamped to [64 MB, 4 GB].  The reference's arithmetic."""
    hbm = hbm_bytes if hbm_bytes is not None else detect_hbm_bytes()
    n_elements = sum(_numel(s) for s in _shapes(params))
    per_el = working_bytes_per_element + grad_bytes_per_element + accum_buffer_bytes_per_element
    resident = n_elements * per_el // max(shard_degree, 1)
    margin = max(1 << 30, int(hbm * 0.10))  # activations + fragmentation
    free = hbm - resident - margin
    per_dev_chunk = free // (_CHUNK_TRANSIENT_FACTOR * max(overlap, 1))
    chunk = per_dev_chunk * max(shard_degree, 1)
    return int(min(max(chunk, 64 << 20), 4 << 30))


# ----------------------------------------------------------------- slicing
def build_slice_spec(params: Any, chunk_bytes: int) -> List[List[Tuple[int, int]]]:
    """Per parameter: ``[(start, end), ...]`` ranges along axis 0 whose
    state (12 B/element) stays within ``chunk_bytes``.  A parameter that
    fits whole, or cannot be sliced (a scalar, axis 0 of size 1), gets one
    range over all of it ((0, dim0); (0, 1) for a scalar)."""
    spec: List[List[Tuple[int, int]]] = []
    for shape in _shapes(params):
        n = _numel(shape)
        dim0 = shape[0] if shape else 1
        if n * _BYTES_PER_ELEMENT <= chunk_bytes or dim0 <= 1:
            spec.append([(0, max(dim0, 1))])
            continue
        per_row = (n // dim0) * _BYTES_PER_ELEMENT
        rows = max(1, chunk_bytes // max(per_row, 1))
        spec.append([(s, min(s + rows, dim0)) for s in range(0, dim0, rows)])
    return spec


def _slice(t: torch.Tensor, s: int, e: int) -> torch.Tensor:
    return t if t.dim() == 0 else t[s:e]


def flatten_view_meta(params: Any, spec) -> List[Tuple[int, int, int]]:
    """``meta[v] = (param_index, start, end)`` for every view leaf, in
    order (the slices of one parameter stay contiguous)."""
    return [(i, s, e) for i, ranges in enumerate(spec) for (s, e) in ranges]


def partition_view(sizes: Sequence[int], chunk_bytes: int) -> List[List[int]]:
    """Greedily group view-leaf indices, in order, into ~``chunk_bytes`` of
    12 B/element state each."""
    groups: List[List[int]] = []
    current: List[int] = []
    current_bytes = 0
    for v, size in enumerate(sizes):
        b = size * _BYTES_PER_ELEMENT
        if current and current_bytes + b > chunk_bytes:
            groups.append(current)
            current, current_bytes = [], 0
        current.append(v)
        current_bytes += b
    if current:
        groups.append(current)
    return groups


def partition_leaves(params: Any, chunk_bytes: int) -> List[List[int]]:
    """Whole-parameter grouping (no slicing), the reference's degenerate
    case: parameter indices grouped to ~``chunk_bytes`` of state each."""
    return partition_view([_numel(s) for s in _shapes(params)], chunk_bytes)


def chunk_layout(params: Any, chunk_bytes: Optional[int]):
    """``(spec, meta, groups)`` of ``params`` at ``chunk_bytes``: the slice
    spec, the view leaves and the view-leaf indices of each chunk;
    ``chunk_bytes=None`` is one chunk of whole parameters."""
    shapes = _shapes(params)
    if chunk_bytes is None:
        spec = [[(0, max(s[0] if s else 1, 1))] for s in shapes]
        return spec, flatten_view_meta(shapes, spec), [list(range(len(shapes)))]
    spec = build_slice_spec(shapes, chunk_bytes)
    meta = flatten_view_meta(shapes, spec)
    sizes = [1 if not shapes[i] else (_numel(shapes[i]) // shapes[i][0]) * (e - s)
             for (i, s, e) in meta]
    return spec, meta, partition_view(sizes, chunk_bytes)


def build_chunked_tx(tx: Callable, params: Any, chunk_bytes: int
                     ) -> Tuple[Callable, Optional[Dict[str, Any]]]:
    """The chunk layout of ``params`` at ``chunk_bytes``: ``(tx, info)``
    with ``info`` holding ``spec`` (per-parameter ranges), ``meta`` (per
    view leaf: parameter, start, end), ``groups`` (view-leaf indices per
    chunk) and ``n_view_leaves``; ``info`` is ``None`` when one chunk holds
    everything.  ``tx`` comes back unchanged: :class:`ChunkedOptimizer`
    builds one optimizer per chunk with it."""
    spec, meta, groups = chunk_layout(params, chunk_bytes)
    if len(groups) <= 1:
        return tx, None
    return tx, {"spec": spec, "meta": meta, "groups": groups, "n_view_leaves": len(meta)}


def with_master_weights(tx: Callable, master_dtype: torch.dtype = torch.float32) -> Callable:
    """``tx`` with f32 master weights inside the optimizer state (the
    ZeRO-Offload layout): ``with_master_weights(tx)(params)`` is a
    one-chunk :class:`ChunkedOptimizer` whose state stays on the
    parameters' device (:class:`DeviceChunkStore`).  It keeps a
    ``master_dtype`` copy of each parameter, steps ``tx`` on the copies
    with the gradients cast to it, and moves each working parameter by
    ``cast(new_master) - working``, so the working parameters can live in
    the compute dtype."""

    def make(params):
        params = list(params)
        return ChunkedOptimizer(params, tx, None, master_dtype=master_dtype,
                                store=DeviceChunkStore(params[0].device))

    return make


def _apply_delta(working: torch.Tensor, master: torch.Tensor) -> None:
    """``working += cast(master) - working``, in the working dtype (the
    reference anchors the update on the working copy, so that its rounding
    never accumulates; a plain copy of the cast can differ in the last bit)."""
    working.add_(master.to(working.dtype) - working)


# ------------------------------------------------------------ chunk stores
class HostChunkStore:
    """Every chunk's state in one pinned host buffer, each chunk a slice of
    it (pageable on a CPU-only build, where the device is the host).

    The buffer is plain host memory page-locked with ``cudaHostRegister``,
    exactly its size (:func:`~accelerate_tpu_torch.utils.offload.
    pinned_host_buffer`): ``pin_memory=True`` goes through torch's caching
    host allocator, which rounds each request up to a power of two (a 75 GiB
    state would ask for 128; 512 MB chunks plus their alignment would each
    take a 1 GiB block) and keeps freed blocks cached.  The registration is
    undone, and the memory freed, when the buffer is."""

    def __init__(self, pin: bool):
        self.pin = pin
        self.offsets: Dict[int, Tuple[int, int]] = {}
        self.total = 0
        self.buffer: Optional[torch.Tensor] = None

    def allocate(self, i: int, nbytes: int) -> None:
        """Reserve chunk ``i``'s bytes; :meth:`commit` allocates them all."""
        self.offsets[i] = (self.total, nbytes)
        self.total += -(-nbytes // _ALIGN) * _ALIGN

    def commit(self) -> None:
        # zero-filled (a parallel fill, which faults the pages in faster
        # than the registration does; the alignment padding is then zeros)
        try:
            self.buffer = pinned_host_buffer(self.total, pin=self.pin)
        except RuntimeError as e:
            raise RuntimeError(f"the optimizer state: {e}; use the nvme tier "
                               "(offload_optimizer_nvme_path) instead") from e

    def read(self, i: int) -> torch.Tensor:
        start, n = self.offsets[i]
        return self.buffer[start: start + n]

    def write(self, i: int, host: torch.Tensor) -> None:
        mine = self.read(i)
        if host.data_ptr() != mine.data_ptr():
            mine.copy_(host)

    def nbytes(self) -> int:
        return self.total

    def pinned_bytes(self) -> int:
        return self.total if self.buffer is not None and self.buffer.is_pinned() else 0


class DeviceChunkStore(HostChunkStore):
    """Every chunk's state in one buffer on ``device``, where the optimizer
    steps: nothing streams (:func:`with_master_weights` without offload)."""

    def __init__(self, device):
        super().__init__(pin=False)
        self.device = torch.device(device)

    def commit(self) -> None:
        self.buffer = torch.zeros(max(self.total, 1), dtype=torch.uint8, device=self.device)

    def pinned_bytes(self) -> int:
        return 0


class DiskChunkStore:
    """The nvme tier (the reference's ``offload_optimizer_nvme_path``,
    DeepSpeed ZeRO-Infinity's optimizer tier): each chunk's state buffer is
    a raw file ``path/chunk_<i>.dat``, read through a copy-on-write
    ``np.memmap`` before its update and replaced (a temp file, then
    ``os.replace``) after it.  Host memory holds O(chunk) in flight; the
    whole state lives only on disk."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.sizes: Dict[int, int] = {}

    def _file(self, i: int) -> str:
        return os.path.join(self.path, f"chunk_{i}.dat")

    def allocate(self, i: int, nbytes: int) -> None:
        self.sizes[i] = nbytes
        with open(self._file(i), "wb") as f:
            f.truncate(nbytes)

    def commit(self) -> None:
        pass

    def read(self, i: int) -> torch.Tensor:
        mm = np.memmap(self._file(i), dtype=np.uint8, mode="c", shape=(self.sizes[i],))
        return torch.from_numpy(mm)

    def write(self, i: int, host: torch.Tensor) -> None:
        tmp = self._file(i) + ".tmp"
        host.numpy().tofile(tmp)
        os.replace(tmp, self._file(i))

    def nbytes(self) -> int:
        return sum(self.sizes.values())

    def pinned_bytes(self) -> int:
        return 0


# ------------------------------------------------------ chunked optimizer
def _state_template(tx: Callable, dtype: torch.dtype, device) -> Dict[str, Optional[torch.dtype]]:
    """The per-element state ``tx`` keeps: key -> its dtype, or ``None``
    where it takes the parameter's.  One step of ``tx`` on a two-element
    ``dtype`` probe: its state tensors of the probe's shape are per-element
    (scalars such as AdamW's ``step`` stay inside the optimizer, where torch
    keeps them)."""
    probe = nn.Parameter(torch.zeros(2, dtype=dtype, device=device))
    probe.grad = torch.zeros_like(probe)
    opt = tx([probe])
    opt.step()
    return {k: (None if v.dtype == dtype else v.dtype) for k, v in opt.state[probe].items()
            if isinstance(v, torch.Tensor) and v.shape == probe.shape}


class _Chunk:
    """One chunk: its view leaves, their staging parameters, its optimizer
    and the layout of its flat state buffer."""

    def __init__(self, index: int, leaves: List[Tuple[int, int, int]]):
        self.index = index
        self.leaves = leaves                 # (param index, start, end)
        self.staging: List[nn.Parameter] = []
        self.opt: Optional[torch.optim.Optimizer] = None
        self.layout: List[Dict[str, Tuple[int, torch.dtype, Tuple[int, ...]]]] = []
        self.nbytes = 0
        self.initialized = False

    def plan(self, params, keys: Dict[str, Optional[torch.dtype]],
             master_dtype: Optional[torch.dtype]) -> None:
        """Lay out each leaf's master (under master weights) and per-element
        state in one flat byte buffer, each tensor ``_ALIGN``-aligned."""
        offset = 0
        for (i, s, e) in self.leaves:
            shape = tuple(_slice(params[i], s, e).shape)
            own = master_dtype or params[i].dtype
            items = [("master", master_dtype)] if master_dtype is not None else []
            items += [(k, dt or own) for k, dt in keys.items()]
            entry = {}
            for key, dt in items:
                entry[key] = (offset, dt, shape)
                offset += -(-_numel(shape) * dt.itemsize // _ALIGN) * _ALIGN
            self.layout.append(entry)
        self.nbytes = max(offset, _ALIGN)

    def views(self, flat: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """The leaves' tensors inside ``flat`` (views: no copy)."""
        return [{key: flat[off: off + _numel(shape) * dt.itemsize].view(dt).view(shape)
                 for key, (off, dt, shape) in entry.items()}
                for entry in self.layout]


class ChunkedOptimizer(torch.optim.Optimizer):
    """The host-offloaded, chunked optimizer over ``params`` (the working
    weights, in order).

    ``tx(parameters) -> Optimizer`` is built once per chunk over that
    chunk's staging parameters.  With ``master_dtype`` the masters are
    ``master_dtype`` copies of the parameters' values at construction,
    kept with the state on the host (the caller then casts the working
    weights to the compute dtype); without, the optimizer updates slices
    of the working weights in place.  ``store``: a :class:`HostChunkStore`
    or a :class:`DiskChunkStore`; ``overlap``: chunks in flight.  Every
    chunk's buffer is allocated here, once (``alloc_s`` times it).

    ``param_groups`` are every chunk optimizer's groups (the same dicts):
    setting a learning rate there moves all of them."""

    def __init__(self, params, tx: Callable, chunk_bytes: Optional[int], *,
                 master_dtype: Optional[torch.dtype] = None, store=None, overlap: int = 1):
        self.params = list(params)
        device = self.params[0].device
        self.device = device
        self.master_dtype = master_dtype
        self.overlap = max(int(overlap), 1)
        self.store = store if store is not None else HostChunkStore(pin=device.type == "cuda")
        self.spec, self.meta, self.groups = chunk_layout(self.params, chunk_bytes)
        dtype = master_dtype or self.params[0].dtype
        keys = _state_template(tx, dtype, device)
        self.state_keys = keys
        self.chunks: List[_Chunk] = []
        t0 = time.perf_counter()
        for c, group in enumerate(self.groups):
            chunk = _Chunk(c, [self.meta[v] for v in group])
            chunk.plan(self.params, keys, master_dtype)
            for (i, s, e) in chunk.leaves:
                sdt = master_dtype or self.params[i].dtype
                chunk.staging.append(nn.Parameter(torch.empty(0, dtype=sdt, device=device)))
            chunk.opt = tx(chunk.staging)
            self.store.allocate(c, chunk.nbytes)
            self.chunks.append(chunk)
        self.store.commit()
        self.alloc_s = time.perf_counter() - t0
        if master_dtype is not None:
            self._seed_masters()
        super().__init__(self.params, {})
        self.param_groups = [g for chunk in self.chunks for g in chunk.opt.param_groups]
        self._streams = None
        # pinned bounce buffers, one a chunk in flight, for a store whose
        # buffers are not pinned (the nvme tier on the card)
        self._bounce: List[torch.Tensor] = []
        self.last_step_s = 0.0

    @property
    def host_bytes(self) -> int:
        return self.store.nbytes()

    def _seed_masters(self) -> None:
        """The masters from the parameters' current (full-precision) values."""
        for chunk in self.chunks:
            host = self.store.read(chunk.index)
            for (i, s, e), views in zip(chunk.leaves, chunk.views(host)):
                views["master"].copy_(_slice(self.params[i].detach(), s, e))
            self.store.write(chunk.index, host)

    def zero_grad(self, set_to_none: bool = True):
        for p in self.params:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()

    # --------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, closure=None):
        """One update of every chunk, ``overlap`` in flight."""
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self._streams is None:
            self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
        inflight = collections.deque()
        for chunk in self.chunks:
            if len(inflight) >= self.overlap:
                self._drain(inflight.popleft())
            inflight.append(self._update(chunk))
        while inflight:
            self._drain(inflight.popleft())
        self.last_step_s = time.perf_counter() - t0

    def _update(self, chunk: _Chunk):
        host = self.store.read(chunk.index)
        # a buffer where the optimizer steps (the CPU, the device store) is
        # updated in place; one on the host streams through the card
        streamed = host.device != self.device
        if streamed:
            if not host.is_pinned():
                slot = chunk.index % self.overlap
                if len(self._bounce) <= slot:
                    size = max(c.nbytes for c in self.chunks)
                    self._bounce.append(torch.empty(size, dtype=torch.uint8, pin_memory=True))
                host = self._bounce[slot][: chunk.nbytes].copy_(host)
            compute = torch.cuda.current_stream(self.device)
            h2d, d2h = self._streams
            with torch.cuda.stream(h2d):
                dev = torch.empty(chunk.nbytes, dtype=torch.uint8, device=self.device)
                dev.copy_(host, non_blocking=True)
            compute.wait_stream(h2d)
            dev.record_stream(compute)
        else:
            dev = host
        views = chunk.views(dev)
        opt = chunk.opt
        for (i, s, e), sp, v in zip(chunk.leaves, chunk.staging, views):
            p = self.params[i]
            if self.master_dtype is not None:
                sp.data = v["master"]
                g = p.grad
                sp.grad = None if g is None else _slice(g, s, e).to(self.master_dtype)
            else:
                sp.data = _slice(p.data, s, e)
                sp.grad = None if p.grad is None else _slice(p.grad, s, e)
            if chunk.initialized:
                opt.state[sp].update({k: v[k] for k in self.state_keys})
        opt.step()
        for (i, s, e), sp, v in zip(chunk.leaves, chunk.staging, views):
            state = opt.state.get(sp, {})
            for k in self.state_keys:
                t = state.pop(k, None)
                if t is not None and t is not v[k]:  # first step: the optimizer's own
                    v[k].copy_(t)
            if self.master_dtype is not None:
                _apply_delta(_slice(self.params[i].data, s, e), v["master"])
            sp.data = sp.data.new_empty(0)
            sp.grad = None
        chunk.initialized = chunk.initialized or bool(opt.state)
        if streamed:
            with torch.cuda.stream(d2h):
                d2h.wait_stream(compute)
                host.copy_(dev, non_blocking=True)
                dev.record_stream(d2h)
                done = torch.cuda.Event()
                done.record(d2h)
            return chunk, host, done
        return chunk, host, None

    def _drain(self, entry) -> None:
        chunk, host, done = entry
        if done is not None:
            done.synchronize()
        self.store.write(chunk.index, host)

    def host_state(self, key: str = "master") -> List[Optional[torch.Tensor]]:
        """Per parameter, a host copy of its ``key`` state (``"master"``, or
        a per-element optimizer state such as ``"exp_avg"``), the slices of
        a sliced parameter put back together; ``None`` before the state
        exists."""
        parts: Dict[int, List[torch.Tensor]] = collections.defaultdict(list)
        for chunk in self.chunks:
            if key != "master" and not chunk.initialized:
                continue
            host = self.store.read(chunk.index)
            for (i, s, e), views in zip(chunk.leaves, chunk.views(host)):
                parts[i].append(views[key].clone())
        out: List[Optional[torch.Tensor]] = []
        for i, p in enumerate(self.params):
            got = parts.get(i)
            out.append(None if not got else got[0] if len(got) == 1 else torch.cat(got, dim=0))
        return out

    # --------------------------------------------------------- state dict
    def state_dict(self) -> Dict[str, Any]:
        """Every chunk's optimizer state dict (its scalars: ``step``, the
        groups) and its flat state buffer, a host tensor read from the
        store (the disk tier's files come back into memory here)."""
        return {"chunks": [{"optimizer": chunk.opt.state_dict(),
                            "initialized": chunk.initialized,
                            "buffer": self.store.read(chunk.index).clone()}
                           for chunk in self.chunks]}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        saved = state_dict["chunks"]
        if len(saved) != len(self.chunks):
            raise ValueError(f"the saved state has {len(saved)} chunks, this optimizer "
                             f"{len(self.chunks)}: a different model or chunk size")
        for chunk, entry in zip(self.chunks, saved):
            buf = entry["buffer"]
            if buf.numel() != chunk.nbytes:
                raise ValueError(f"chunk {chunk.index}: {buf.numel()} saved bytes, want "
                                 f"{chunk.nbytes}")
            host = self.store.read(chunk.index)
            host.copy_(buf)
            self.store.write(chunk.index, host)
            opt_state = entry["optimizer"]
            for param_state in opt_state["state"].values():
                if isinstance(param_state.get("step"), torch.Tensor):
                    param_state["step"] = param_state["step"].cpu()
            chunk.opt.load_state_dict(opt_state)
            chunk.initialized = bool(entry["initialized"])
