"""Attention dispatch: one entry point over the port's implementations.

Port of :mod:`accelerate_tpu.ops.attention`.  All take ``[batch, seq, heads,
head_dim]`` (BSHD) tensors; ``k``/``v`` may carry fewer heads than ``q``
(GQA).

* ``"xla"`` — :func:`xla_attention`, the plain math the JAX package leaves to
  XLA: f32 scores from the input dtype, a finite mask, f32 softmax,
  probabilities cast to v's dtype.  No kernel.
  ``window=`` (a banded causal mask, ``i - j < window``) and ``bias=`` (an
  additive logits bias, alibi) act on this arm only.
* ``"blocked"`` — :func:`blocked_causal_attention`, the causal-only schedule
  over static query chunks that never computes the masked upper triangle.
  Plain PyTorch, as it is XLA code in the reference.
* ``"pallas"`` — :func:`~accelerate_tpu_torch.ops.flash_attention.flash_attention`,
  the hand-written CUDA kernels K3–K5 (their plain versions on the CPU).

* ``"ring"`` — sequence parallelism over the active mesh's ``sp`` axis
  (:mod:`~accelerate_tpu_torch.parallel.ring_attention`: K3 on each chunk
  pair, K4/K5 in its backward).  Inside
  :func:`~accelerate_tpu_torch.parallel.ring_attention.sequence_sharded`
  (``lm_loss_fn`` of a ring model) q, k and v are this rank's shard and the
  ring runs.  Outside such a block the whole sequence is on every rank: on
  an ``sp`` mesh that splits it, :func:`~accelerate_tpu_torch.parallel.
  ring_attention.ring_attention_sharded` cuts it over the ranks in
  ``ring_layout``, as the reference does; a sequence that does not split
  over ``sp`` raises; a batch that does not split over the data axes
  (batch 1) warns once and computes unsharded.  A ring of one rank — no
  ``sp`` axis above 1, or that batch-1 case — is its diagonal pair: K3–K5
  (:func:`~accelerate_tpu_torch.ops.flash_attention.flash_attention`,
  their plain versions on the CPU).  No active mesh raises.

``window`` or ``bias`` with ``"blocked"``, ``"pallas"`` or ``"ring"`` raises
``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import DEFAULT_MASK_VALUE, flash_attention

def check_implementation(implementation: str) -> None:
    """Raise ``ValueError`` for an implementation the JAX package does not
    have."""
    if implementation not in ("xla", "blocked", "pallas", "ring"):
        raise ValueError(f"unknown attention implementation {implementation!r}; "
                         "choose 'xla', 'blocked', 'pallas' or 'ring'")


def causal_mask(q_len: int, kv_len: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal mask ``[q_len, kv_len]``: 0 keep, ``finfo(dtype).min``
    drop; the last query sees every key (``offset = kv_len - q_len``)."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    keep = j <= i + (kv_len - q_len)
    return torch.where(keep, 0.0, torch.finfo(dtype).min).to(dtype)


def xla_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                  segment_ids=None, window: Optional[int] = None, bias=None) -> torch.Tensor:
    """Plain attention over BSHD tensors — the ``implementation="xla"`` math:
    kv heads repeated to the query heads, logits in f32 from the input
    dtype, ``bias`` added, masked with the finite ``DEFAULT_MASK_VALUE``
    (causal, segments, and the band ``i - j < window``), f32 softmax,
    probabilities cast to ``v.dtype`` for the PV product."""
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    sq, sk = q.shape[1], k.shape[1]
    keep = None
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :sq, None] == segment_ids[:, None, :sk])[:, None]
        keep = seg if keep is None else keep & seg
    if window is not None:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(sk, device=q.device)[None, :]
        band = ((i - j) < window)[None, None]
        keep = band if keep is None else keep & band
    if keep is not None:
        logits = torch.where(keep, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blocked_causal_attention(q, k, v, *, scale: Optional[float] = None, segment_ids=None,
                             chunk: int = 256) -> torch.Tensor:
    """Causal attention that never computes the masked upper triangle
    (``accelerate_tpu/ops/attention.py:175-236``).

    BSHD in and out.  The query axis is split into ``S / chunk`` static
    chunks; chunk ``i`` contracts against keys ``[0, (i + 1) * chunk)``
    only, and only its trailing diagonal block takes a triangular mask.
    GQA folds the query-head groups into the contraction
    (``bqgrd,bkgd->bgrqk``), so K/V are never expanded.  Logits are f32
    (products of the input dtype, exact in f32), softmax in f32, the
    probabilities cast to ``q.dtype`` for the PV product.  Raises
    ``ValueError`` unless the sequence divides into chunks."""
    b, s, n_q, d = q.shape
    n_kv = k.shape[2]
    rep = n_q // n_kv
    scale = float(scale if scale is not None else d ** -0.5)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"blocked attention needs seq {s} divisible by chunk {chunk}")
    qg = q.reshape(b, s, n_kv, rep, d)
    neg = torch.finfo(torch.float32).min
    tri = torch.arange(chunk, device=q.device)
    diag_mask = torch.where(tri[:, None] >= tri[None, :], 0.0, neg)   # [c, c] additive
    outs = []
    for i in range(s // chunk):
        lo, hi = i * chunk, (i + 1) * chunk
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg[:, lo:hi].float(),
                              k[:, :hi].float()) * scale            # [B, Hkv, rep, c, hi]
        logits = torch.cat([logits[..., :lo], logits[..., lo:] + diag_mask], dim=-1)
        if segment_ids is not None:
            seg = (segment_ids[:, lo:hi, None] == segment_ids[:, None, :hi])[:, None, None]
            logits = torch.where(seg, logits, neg)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bgrqk,bkgd->bqgrd", probs, v[:, :hi]))
    return torch.cat(outs, dim=1).reshape(b, s, n_q, d)


def dot_product_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                          implementation: str = "xla", segment_ids=None,
                          ring_layout: str = "contiguous", window: Optional[int] = None,
                          bias=None) -> torch.Tensor:
    """BSHD attention through ``implementation`` (``"xla"``, ``"blocked"``,
    ``"pallas"`` or ``"ring"``, the last cutting a whole sequence in
    ``ring_layout``).  ``window`` (sliding-window attention: query ``i`` sees
    keys ``i - window < j <= i``) and ``bias`` (additive, broadcastable to
    ``[B, H, Q, K]``) are the ``"xla"`` arm's, with the JAX refusals."""
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires causal=True")
        if implementation != "xla":
            raise NotImplementedError(
                f"window (sliding-window attention) is implemented for "
                f"implementation='xla' only, got {implementation!r}.")
    if bias is not None and implementation != "xla":
        raise NotImplementedError(f"bias (alibi) is implemented for implementation='xla' "
                                  f"only, got {implementation!r}.")
    check_implementation(implementation)
    if implementation == "pallas":
        return flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    if implementation == "blocked":
        if not causal:
            raise ValueError("implementation='blocked' is a causal-only schedule (its win is "
                             "skipping the masked upper triangle); use 'xla' for "
                             "bidirectional attention.")
        return blocked_causal_attention(q, k, v, scale=scale, segment_ids=segment_ids)
    if implementation == "ring":
        return _ring(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
                     layout=ring_layout)
    return xla_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
                         window=window, bias=bias)


def _ring(q, k, v, *, causal, scale, segment_ids, layout):
    """The ring arm (``accelerate_tpu/ops/attention.py:88-140``)."""
    from ..parallel.mesh import mesh_axis_size, sp_shardable
    from ..parallel.ring_attention import active_shard, ring_attention_sharded, shard_attention
    from ..state import PartialState, is_initialized

    shard = active_shard()
    if shard is not None:
        return shard_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
                               shard=shard)
    if not is_initialized():
        raise ValueError(
            "attention_impl='ring' needs the active mesh: construct "
            "Accelerator/PartialState (with an sp-axis mesh) before the "
            "forward, or call parallel.ring_attention_sharded(q, k, v, mesh) "
            "directly with an explicit mesh.")
    mesh = PartialState().mesh
    if sp_shardable(mesh, q.shape[0], q.shape[1]):
        return ring_attention_sharded(q, k, v, mesh, causal=causal, scale=scale,
                                      segment_ids=segment_ids, layout=layout)
    sp = mesh_axis_size(mesh, "sp")
    if sp > 1 and (q.shape[1] % sp != 0 or q.shape[0] > 1):
        raise ValueError(
            f"attention_impl='ring' on an sp={sp} mesh requires seq "
            f"divisible by sp and batch divisible by the data axes; got "
            f"batch={q.shape[0]}, seq={q.shape[1]}. Pad the sequence (or "
            "drop sp_degree) — falling back would silently replicate "
            "compute across the sp devices.")
    if sp > 1:
        from ..logging import get_logger

        get_logger(__name__).warning_once(
            f"attention_impl='ring' on an sp={sp} mesh got a batch-1 forward "
            "that cannot shard over the data axes; computing UNSHARDED "
            "attention (replicated across the sp devices). Harmless for "
            "model.init shape probes — but if this is a real batch-1 "
            "eval/generation run, the sp devices are doing redundant work: "
            "use a batch divisible by the data axes or drop sp_degree.")
    # a ring of one: the diagonal pair
    return flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
