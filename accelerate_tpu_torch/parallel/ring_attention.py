"""Ring attention: sequence (context) parallelism over an ``sp`` mesh axis.

Port of :mod:`accelerate_tpu.parallel.ring_attention`.  The sequence is cut
over the ``sp`` ranks; each rank keeps its query shard and the key/value
shards travel the ring one hop a step (:func:`~accelerate_tpu_torch.
parallel.mesh.ppermute`), so only a ``[S/sp, S/sp]`` tile of scores exists
at a time.

Where the reference computes each chunk pair with einsums and merges the
row statistics ``(m, l, pv)``, the port computes each non-empty pair with
the flash forward kernel K3 (:func:`~accelerate_tpu_torch.ops.
flash_attention.flash_fwd`: the pair's output and its row logsumexp) and
merges the pairs by their ``lse``.  Every pair's output and gradients come
out of the kernels in f32 (their f32 epilogue for bf16 inputs), so a row's
output and each gradient are rounded to the input dtype once, after the
sum over the pairs, as the reference's f32 ``(m, l, pv)`` are.  A row that sees no key in a pair
carries ``lse`` = the finite mask value plus ``log(Sk)`` there, which
weighs ``exp(mask - lse) = 0`` in the merge; every row sees at least
itself in the diagonal pair, which the schedule takes first.

The backward is a :class:`torch.autograd.Function`: ``delta = rowsum(dO *
O)`` from the merged output, then for each pair dQ with K4 and dK/dV with
K5, both with the rows' *merged* ``lse`` and ``delta`` (so each pair's
probabilities are the global softmax's); the dK/dV of a chunk accumulate
in f32 while they travel the ring with it, and a last hop brings them to
the chunk's owner.  ``remat=False`` keeps the forward's incoming K/V
chunks for the backward; ``remat=True`` keeps only the rank's own and
rotates them again.

Schedules (``t``-th step, kv chunk from ``src = (idx - t) mod n``):

* contiguous, causal: ``src == idx`` the diagonal, K3 causal; ``src <
  idx`` K3 unmasked; ``src > idx`` all in the future: skipped, nothing is
  launched (the reference computes that tile and masks it to zeros);
* zig-zag (:func:`ring_attention_zigzag`, shard ``r`` holds chunks ``r``
  and ``2n - 1 - r``): the diagonal is K3 causal over the shard's ``2c``
  rows (its global positions increase with the index, so the plain causal
  mask is exact); ``src < idx`` the whole q against the incoming early
  half; ``src > idx`` the late q half against the whole incoming kv — every
  rank two balanced half-tiles a step;
* not causal: every pair K3 unmasked.

Segment ids travel with the kv chunk; a pair's queries and keys then carry
different ids, which the kernels take as ``kv_segment_ids``.

Entry points: :func:`ring_attention` and :func:`ring_attention_zigzag` on
this rank's shards (the reference's calls inside ``shard_map``);
:func:`ring_attention_sharded` on whole arrays, every rank passing the same
ones; :func:`sequence_sharded`, the context in which a model whose config
says ``attention_impl="ring"`` runs on its rank's shard
(``models/transformer.py``'s ``lm_loss_fn``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from ..ops import flash_attention as fa
from . import mesh as mesh_lib


def _resolve_mesh(mesh):
    if mesh is not None:
        return mesh
    from ..state import PartialState

    return PartialState().mesh


def zigzag_permutation(seq_len: int, n: int) -> np.ndarray:
    """Index vector from natural order to the zig-zag shard layout: the
    sequence cut into ``2n`` chunks, shard ``r`` holding ``(r, 2n-1-r)``."""
    if seq_len % (2 * n) != 0:
        raise ValueError(f"zig-zag layout needs seq_len % (2*sp)==0; got {seq_len} % {2*n}")
    c = seq_len // (2 * n)
    idx: List[int] = []
    for r in range(n):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * n - 1 - r) * c, (2 * n - r) * c))
    return np.asarray(idx, np.int32)


def inverse_zigzag_permutation(seq_len: int, n: int) -> np.ndarray:
    return np.argsort(zigzag_permutation(seq_len, n)).astype(np.int32)


def shard_positions(seq_len: int, n: int, idx: int, layout: str) -> np.ndarray:
    """The global positions rank ``idx`` of ``n`` holds under ``layout``."""
    if layout == "zigzag" and n > 1:
        local = seq_len // n
        return zigzag_permutation(seq_len, n)[idx * local:(idx + 1) * local]
    if seq_len % n:
        raise ValueError(f"sequence {seq_len} does not split over sp={n}")
    local = seq_len // n
    return np.arange(idx * local, (idx + 1) * local, dtype=np.int32)


# ------------------------------------------------------------ chunk pairs
def _pairs(zigzag: bool, causal: bool, idx: int, src: int, sl: int):
    """The pair(s) of (query rows, key rows, causal) of step ``src``, or
    none.  Rows are ``(lo, hi)`` of the local shard."""
    if src == idx:
        return [((0, sl), (0, sl), causal)]
    if not causal:
        return [((0, sl), (0, sl), False)]
    if zigzag:
        c = sl // 2
        if src < idx:
            return [((0, sl), (0, c), False)]
        return [((c, sl), (0, sl), False)]
    return [((0, sl), (0, sl), False)] if src < idx else []


def _rows(x, lo, hi, dim=1):
    if lo == 0 and hi == x.shape[dim]:
        return x
    return x.narrow(dim, lo, hi - lo).contiguous()


def _ids(seg, lo, hi):
    # segment ids are a few bytes a row: copied, so every slice is aligned
    return None if seg is None else seg[:, lo:hi].clone(memory_format=torch.contiguous_format)


def _merge(acc, lse, out_p, lse_p, lo, hi):
    """Fold a pair's ``(out, lse)`` into rows ``[lo, hi)`` of the running
    f32 output ``acc [B, S, H, D]`` and ``lse [B, H, S]``."""
    if acc is None:
        return out_p, lse_p
    if lo != 0 or hi != acc.shape[1]:
        sub_acc, sub_lse = _merge(acc[:, lo:hi], lse[:, :, lo:hi], out_p, lse_p, 0, hi - lo)
        acc = acc.clone()
        lse = lse.clone()
        acc[:, lo:hi] = sub_acc
        lse[:, :, lo:hi] = sub_lse
        return acc, lse
    new = torch.logaddexp(lse, lse_p)
    w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_p - new).transpose(1, 2)[..., None]
    return acc * w_old + out_p * w_new, new


def _ring_forward(q, k, v, seg, group, n, idx, zigzag, causal, scale, keep):
    """The forward ring: ``(out, lse, chunks)``, ``chunks`` the kv chunks
    of every step when ``keep``."""
    sl = q.shape[1]
    acc = lse = None
    chunks = []
    k_cur, v_cur, seg_cur = k, v, seg
    for t in range(n):
        src = (idx - t) % n
        if keep:
            chunks.append((k_cur, v_cur, seg_cur))
        for (qlo, qhi), (klo, khi), c in _pairs(zigzag, causal, idx, src, sl):
            out_p, lse_p = fa.flash_fwd(
                _rows(q, qlo, qhi), _rows(k_cur, klo, khi), _rows(v_cur, klo, khi),
                causal=c, scale=scale, segment_ids=_ids(seg, qlo, qhi),
                kv_segment_ids=None if seg is None else _ids(seg_cur, klo, khi),
                out_dtype=torch.float32)
            acc, lse = _merge(acc, lse, out_p, lse_p, qlo, qhi)
        if t < n - 1:
            moving = [k_cur, v_cur] + ([] if seg_cur is None else [seg_cur])
            moved = mesh_lib.ppermute(moving, group, 1)
            k_cur, v_cur = moved[0], moved[1]
            seg_cur = None if seg_cur is None else moved[2]
    return acc.to(q.dtype), lse.contiguous(), chunks


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, group, n, idx, zigzag, causal, scale, remat):
        out, lse, chunks = _ring_forward(q, k, v, seg, group, n, idx, zigzag, causal, scale,
                                         keep=not remat)
        ctx.meta = (group, n, idx, zigzag, causal, scale, remat)
        flat = [] if remat else [t for c in chunks[1:] for t in c[:2]]
        segs = [] if remat or seg is None else [c[2] for c in chunks[1:]]
        ctx.save_for_backward(q, k, v, out, lse, *([] if seg is None else [seg]), *flat, *segs)
        ctx.has_seg = seg is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        group, n, idx, zigzag, causal, scale, remat = ctx.meta
        saved = list(ctx.saved_tensors)
        q, k, v, out, lse = saved[:5]
        rest = saved[5:]
        seg = rest.pop(0) if ctx.has_seg else None
        kept = None
        if not remat:
            kv = rest[:2 * (n - 1)]
            segs = rest[2 * (n - 1):]
            kept = [(k, v, seg)] + [(kv[2 * i], kv[2 * i + 1], segs[i] if segs else None)
                                    for i in range(n - 1)]
        dout = dout.contiguous()
        delta = fa.flash_delta(out, dout)
        sl = q.shape[1]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur, seg_cur = k, v, seg
        for t in range(n):
            src = (idx - t) % n
            if kept is not None:
                k_cur, v_cur, seg_cur = kept[t]
            for (qlo, qhi), (klo, khi), c in _pairs(zigzag, causal, idx, src, sl):
                args = (_rows(q, qlo, qhi), _rows(k_cur, klo, khi), _rows(v_cur, klo, khi),
                        _rows(dout, qlo, qhi), _rows(lse, qlo, qhi, dim=2),
                        _rows(delta, qlo, qhi, dim=2))
                kw = dict(causal=c, scale=scale, segment_ids=_ids(seg, qlo, qhi),
                          kv_segment_ids=None if seg is None else _ids(seg_cur, klo, khi),
                          out_dtype=torch.float32)
                dq[:, qlo:qhi] += fa.flash_dq(*args, **kw)
                dk_p, dv_p = fa.flash_dkv(*args, **kw)
                dk_acc[:, klo:khi] += dk_p
                dv_acc[:, klo:khi] += dv_p
            # the chunk's gradients travel with it; after the last step one
            # more hop brings them home (the chunk came from idx + 1)
            moving = [dk_acc, dv_acc]
            if remat and t < n - 1:
                moving += [k_cur, v_cur] + ([] if seg_cur is None else [seg_cur])
            moved = mesh_lib.ppermute(moving, group, 1)
            dk_acc, dv_acc = moved[0], moved[1]
            if remat and t < n - 1:
                k_cur, v_cur = moved[2], moved[3]
                seg_cur = None if seg_cur is None else moved[4]
        return (dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype),
                None, None, None, None, None, None, None, None)


def _ring(q, k, v, *, axis_name, causal, scale, segment_ids, remat, zigzag, mesh):
    mesh = _resolve_mesh(mesh)
    n = mesh_lib.mesh_axis_size(mesh, axis_name)
    idx = mesh.axis_index(axis_name) if n > 1 else 0
    group = mesh.group(axis_name)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not fold over {k.shape[2]} kv heads")
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
                                group, n, idx, zigzag, bool(causal), scale, bool(remat))


def ring_attention(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, segment_ids=None, remat: bool = False,
                   mesh=None) -> torch.Tensor:
    """Ring attention on this rank's contiguous sequence shard
    (``accelerate_tpu/parallel/ring_attention.py:154``): BSHD ``[B, S/sp,
    H, D]`` shards of q, k (GQA: fewer heads), v and ``segment_ids [B,
    S/sp]``; returns this rank's output shard.  ``mesh`` defaults to the
    active one; every rank of the ``axis_name`` group calls it together."""
    return _ring(q, k, v, axis_name=axis_name, causal=causal, scale=scale,
                 segment_ids=segment_ids, remat=remat, zigzag=False, mesh=mesh)


def ring_attention_zigzag(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                          scale: Optional[float] = None, segment_ids=None, remat: bool = False,
                          mesh=None) -> torch.Tensor:
    """Causal ring attention on zig-zag shards (``:212``): every rank two
    half-tiles a step, no masked tile.  Without ``causal`` there is nothing
    to balance: the contiguous schedule runs."""
    if not causal:
        return ring_attention(q, k, v, axis_name=axis_name, causal=False, scale=scale,
                              segment_ids=segment_ids, remat=remat, mesh=mesh)
    if q.shape[1] % 2 != 0:
        raise ValueError(f"zig-zag shards hold two chunks; local seq {q.shape[1]} must be even")
    return _ring(q, k, v, axis_name=axis_name, causal=True, scale=scale,
                 segment_ids=segment_ids, remat=remat, zigzag=True, mesh=mesh)


# ------------------------------------------------------ whole arrays
class _Cut(torch.autograd.Function):
    """This rank's block of a whole array (every rank holds the same one):
    the rows ``index`` along ``dim``; the backward all-gathers every rank's
    block gradient back into the whole array, so each rank's gradient is
    the whole one."""

    @staticmethod
    def forward(ctx, x, index, dim, groups_and_indices):
        ctx.shape, ctx.dim, ctx.meta = x.shape, dim, groups_and_indices
        return x.index_select(dim, index).contiguous()

    @staticmethod
    def backward(ctx, g):
        whole = g.new_zeros(ctx.shape)
        for group, index in ctx.meta:
            parts = [torch.empty_like(g) for _ in range(torch.distributed.get_world_size(group))]
            torch.distributed.all_gather(parts, g.contiguous(), group=group)
            for part, rows in zip(parts, index):
                whole.index_copy_(ctx.dim, rows, part)
        return whole, None, None, None


class _Uncut(torch.autograd.Function):
    """The whole array from every rank's block along ``dim`` (positions
    ``index[r]`` for group rank ``r``); the backward keeps this rank's
    rows (every rank's gradient of the whole array is the same)."""

    @staticmethod
    def forward(ctx, x, mine, dim, group, index, shape):
        ctx.mine, ctx.dim = mine, dim
        parts = [torch.empty_like(x) for _ in range(torch.distributed.get_world_size(group))]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        whole = x.new_empty(shape)
        for part, rows in zip(parts, index):
            whole.index_copy_(dim, rows, part)
        return whole

    @staticmethod
    def backward(ctx, g):
        return g.index_select(ctx.dim, ctx.mine).contiguous(), None, None, None, None, None


def ring_attention_sharded(q, k, v, mesh=None, *, axis_name: str = "sp", causal: bool = True,
                           scale: Optional[float] = None, segment_ids=None, batch_axes=None,
                           remat: bool = False, layout: str = "contiguous") -> torch.Tensor:
    """Ring attention over whole BSHD arrays in natural order (``:318``):
    every rank passes the same arrays; the sequence (dim 1) is cut over
    ``axis_name`` (contiguous, or zig-zag with ``layout="zigzag"`` when
    causal), the batch over the data axes of ``batch_axes`` present in the
    mesh; the output is the whole array on every rank, and so are the
    gradients of q, k and v."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got {layout!r}")
    mesh = _resolve_mesh(mesh)
    n = mesh_lib.mesh_axis_size(mesh, axis_name)
    zigzag = layout == "zigzag" and causal and n > 1
    if batch_axes is None:
        batch_axes = mesh_lib.DATA_AXES
    b_axes = [a for a in batch_axes if mesh_lib.mesh_axis_size(mesh, a) > 1]
    b, s = q.shape[:2]
    device = q.device
    cuts = []  # (dim, group, positions of each group rank)
    for a in b_axes:
        size = mesh.shape[a]
        if b % size:
            raise ValueError(f"batch {b} does not split over {a}={size}")
        cuts.append((0, mesh.group(a), [torch.arange(r * (b // size), (r + 1) * (b // size),
                                                     device=device) for r in range(size)],
                     mesh.axis_index(a)))
        b //= size
    if n > 1:
        lay = "zigzag" if zigzag else "contiguous"
        cuts.append((1, mesh.group(axis_name),
                     [torch.from_numpy(shard_positions(s, n, r, lay)).long().to(device)
                      for r in range(n)], mesh.axis_index(axis_name)))

    def cut(x):
        for dim, group, index, me in cuts:
            x = _Cut.apply(x, index[me], dim, [(group, index)])
        return x

    q_l, k_l, v_l = cut(q), cut(k), cut(v)
    seg_l = None
    if segment_ids is not None:
        seg_l = segment_ids
        for dim, _, index, me in cuts:
            seg_l = seg_l.index_select(dim, index[me])
    inner = ring_attention_zigzag if zigzag else ring_attention
    out = inner(q_l, k_l, v_l, axis_name=axis_name, causal=causal, scale=scale,
                segment_ids=seg_l, remat=remat, mesh=mesh)
    for dim, group, index, me in reversed(cuts):
        shape = list(out.shape)
        shape[dim] *= len(index)
        out = _Uncut.apply(out, index[me], dim, group, index, tuple(shape))
    return out


# ------------------------------------------------ a model on its shard
#: the active sequence shards (innermost last): dicts of mesh, axis, layout
_SHARDS: List[dict] = []


@contextlib.contextmanager
def sequence_sharded(mesh, layout: str = "contiguous", axis_name: str = "sp"):
    """Inside the block, attention with ``implementation="ring"`` takes its
    q, k, v as this rank's ``layout`` shard of the sequence over
    ``axis_name`` and runs the ring."""
    entry = {"mesh": mesh, "layout": layout, "axis": axis_name}
    _SHARDS.append(entry)
    try:
        yield entry
    finally:
        _SHARDS.remove(entry)


def active_shard() -> Optional[dict]:
    """The innermost :func:`sequence_sharded` block's settings, else ``None``."""
    return _SHARDS[-1] if _SHARDS else None


def shard_attention(q, k, v, *, causal: bool, scale: Optional[float], segment_ids,
                    shard: dict) -> torch.Tensor:
    """Ring attention on this rank's shard under ``shard``'s layout."""
    fn = ring_attention_zigzag if shard["layout"] == "zigzag" else ring_attention
    return fn(q, k, v, axis_name=shard["axis"], causal=causal, scale=scale,
              segment_ids=segment_ids, mesh=shard["mesh"])


__all__ = ["active_shard", "inverse_zigzag_permutation", "ring_attention",
           "ring_attention_sharded", "ring_attention_zigzag", "sequence_sharded",
           "shard_attention", "shard_positions", "zigzag_permutation"]
