"""Attention dispatch: one entry point over the port's implementations.

Port of :mod:`accelerate_tpu.ops.attention`.  All take ``[batch, seq, heads,
head_dim]`` (BSHD) tensors; ``k``/``v`` may carry fewer heads than ``q``
(GQA).

* ``"xla"`` — :func:`xla_attention`, the plain math the JAX package leaves to
  XLA: f32 scores from the input dtype, a finite mask, f32 softmax,
  probabilities cast to v's dtype.  No kernel.
* ``"pallas"`` — :func:`~accelerate_tpu_torch.ops.flash_attention.flash_attention`,
  the hand-written CUDA kernels K3–K5 (their plain versions on the CPU).

``"blocked"``, ``"ring"``, ``window=`` and ``bias=`` are not ported and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import DEFAULT_MASK_VALUE, flash_attention

#: implementations of the JAX package not ported yet -> their ROADMAP item
_NOT_PORTED = {
    "blocked": "ROADMAP Queue 1 item 3",
    "ring": "ROADMAP Queue 1 item 9 (parallel/ring_attention.py)",
}


def check_implementation(implementation: str) -> None:
    """Raise unless the port runs ``implementation``: ``NotImplementedError``
    naming its ROADMAP item for one of the JAX package's other
    implementations, ``ValueError`` for an unknown name."""
    if implementation in _NOT_PORTED:
        raise NotImplementedError(f"attention implementation {implementation!r} is not "
                                  f"ported: {_NOT_PORTED[implementation]}")
    if implementation not in ("xla", "pallas"):
        raise ValueError(f"unknown attention implementation {implementation!r}; "
                         "choose 'xla' or 'pallas'")


def causal_mask(q_len: int, kv_len: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal mask ``[q_len, kv_len]``: 0 keep, ``finfo(dtype).min``
    drop; the last query sees every key (``offset = kv_len - q_len``)."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    keep = j <= i + (kv_len - q_len)
    return torch.where(keep, 0.0, torch.finfo(dtype).min).to(dtype)


def xla_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                  segment_ids=None) -> torch.Tensor:
    """Plain attention over BSHD tensors — the ``implementation="xla"`` math:
    kv heads repeated to the query heads, logits in f32 from the input
    dtype, masked with the finite ``DEFAULT_MASK_VALUE``, f32 softmax,
    probabilities cast to ``v.dtype`` for the PV product."""
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[1], k.shape[1]
    keep = None
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :sq, None] == segment_ids[:, None, :sk])[:, None]
        keep = seg if keep is None else keep & seg
    if keep is not None:
        logits = torch.where(keep, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                          implementation: str = "xla", segment_ids=None,
                          window: Optional[int] = None, bias=None) -> torch.Tensor:
    """BSHD attention through ``implementation`` (``"xla"`` or ``"pallas"``)."""
    if window is not None:
        raise NotImplementedError("window (sliding-window attention) is not ported: "
                                  "ROADMAP Queue 1 item 2")
    if bias is not None:
        raise NotImplementedError("bias (alibi) is not ported: ROADMAP Queue 1 item 2")
    check_implementation(implementation)
    attend = flash_attention if implementation == "pallas" else xla_attention
    return attend(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
