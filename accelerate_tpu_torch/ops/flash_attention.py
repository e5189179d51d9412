"""Dense flash attention, forward and backward: the three CUDA kernels and their plain versions.

Port of :mod:`accelerate_tpu.ops.flash_attention`.  The training path's
attention (``TransformerConfig(attention_impl="pallas")``) goes through
:func:`flash_attention`, a :class:`torch.autograd.Function` over three
hand-written kernels:

* :func:`flash_fwd` — K3, ``csrc/flash_fwd.cu``: online-softmax forward,
  returning the output and the row logsumexp ``lse`` the backward reuses;
* :func:`flash_dq` — K4, ``csrc/flash_bwd.cu``: dQ, recomputing the
  probabilities tile by tile from ``lse`` and ``delta = rowsum(dO * O)``;
* :func:`flash_dkv` — K5, ``csrc/flash_bwd.cu``: dK and dV, accumulated
  unexpanded over the GQA group.

The C entry points pick the arm by dtype: bf16 K3, K4 and K5 run on the
tensor cores (``wgmma`` on swizzled bf16 tiles fed by TMA,
``csrc/flash_wgmma.cuh``); f32 inputs run on the CUDA cores, so that f32
keeps f32 products.

Each wrapper takes its plain PyTorch version (:func:`flash_attention_reference`,
:func:`flash_dq_reference`, :func:`flash_dkv_reference`) for a tensor on the
CPU; a CUDA tensor launches the kernel or raises — no ``try`` falls back.
Each counts its launches in an integer attribute (``flash_fwd.launches``),
raised by one where the kernel is launched and nowhere else.

Layout, as the JAX function's: ``q [B, Sq, Hq, D]``, ``k``/``v [B, Sk, Hkv,
D]`` (BSHD, ``Hq`` a multiple of ``Hkv``), ``lse``/``delta [B, Hq, Sq]`` f32,
``segment_ids [B, S]`` integer (tokens attend only within equal ids,
composed with the causal mask); ``kv_segment_ids [B, Sk]``, when given,
are the keys' ids, and ``segment_ids`` then the queries' only (a ring
attention chunk pairs queries and keys of different shards).  ``out_dtype``
(f32 for bf16 inputs) has a kernel write its outputs unrounded: a ring
attention sums each pair's before its one rounding.  The plain versions repeat the kernels'
arithmetic: f32 scores from the input-dtype operands times ``scale``, the
finite ``DEFAULT_MASK_VALUE``, and the roundings of p and ds to the operand
dtype before each product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

#: finite mask value of the TPU kernels (``flash_attention.py:33``) and of
#: ``kFlashMask`` in ``csrc/flash_common.cuh``
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: head dims the three kernels take (``ATPU_FLASH_DISPATCH``); any other D raises
_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)


def _scale(scale: Optional[float], d: int) -> float:
    return float(scale if scale is not None else d ** -0.5)


# ------------------------------------------------------------------ plain math
def _scores(q, k, causal: bool, scale: float, segment_ids, kv_segment_ids=None):
    """Masked f32 scores ``[B, Hkv, rep, Sq, Sk]`` (the GQA group folded)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        kv_ids = segment_ids if kv_segment_ids is None else kv_segment_ids
        mask = mask & (segment_ids[:, :sq, None] == kv_ids[:, None, :sk])
    return torch.where(mask[:, None, None], s, DEFAULT_MASK_VALUE)


def _fold_stat(stat, hkv):
    """``[B, Hq, Sq]`` -> ``[B, Hkv, rep, Sq, 1]``."""
    b, hq, sq = stat.shape
    return stat.reshape(b, hkv, hq // hkv, sq, 1)


def flash_attention_reference(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                              segment_ids=None, kv_segment_ids=None, out_dtype=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``(out [B, Sq, Hq, D] in out_dtype (q.dtype by
    default), lse [B, Hq, Sq] f32)``.  A row that sees no key gets the mean
    of ``v`` and ``lse = mask value + log(Sk)``, as the kernel does."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    s = _scores(q, k, causal, _scale(scale, d), segment_ids, kv_segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(out_dtype or q.dtype)
    lse = (m + torch.log(l_safe)).reshape(b, hq, sq)
    return out, lse


def flash_delta(out, dout) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, ``[B, Hq, Sq]`` — plain PyTorch, as
    the JAX backward computes it in XLA (``flash_attention.py:366``)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, segment_ids, kv_segment_ids):
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    scale = _scale(scale, d)
    s = _scores(q, k, causal, scale, segment_ids, kv_segment_ids)
    p = torch.exp(s - _fold_stat(lse, hkv))
    dog = dout.float().reshape(b, sq, hkv, hq // hkv, d)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = p * (dp - _fold_stat(delta, hkv)) * scale
    return p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, *, causal: bool = True,
                       scale: Optional[float] = None, segment_ids=None,
                       kv_segment_ids=None, out_dtype=None) -> torch.Tensor:
    """Plain version of K4: dQ ``[B, Sq, Hq, D]`` in out_dtype (q.dtype by
    default)."""
    b, sq, hq, d = q.shape
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, segment_ids,
                          kv_segment_ids)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, sq, hq, d).to(out_dtype or q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, *, causal: bool = True,
                        scale: Optional[float] = None, segment_ids=None,
                        kv_segment_ids=None, out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: ``(dK, dV)`` ``[B, Sk, Hkv, D]``, summed over the
    GQA group, in out_dtype (k's and v's dtypes by default)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, segment_ids,
                          kv_segment_ids)
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    dog = dout.float().reshape(b, sq, hkv, hq // hkv, d)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(dout.dtype).float(), dog)
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, *, causal: bool = True,
                                  scale: Optional[float] = None, segment_ids=None):
    """Plain backward: ``(dq, dk, dv)`` from the forward's ``out`` and ``lse``."""
    delta = flash_delta(out, dout)
    kw = dict(causal=causal, scale=scale, segment_ids=segment_ids)
    dq = flash_dq_reference(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# -------------------------------------------------------------------- kernels
def _check(what: str, q, k, v, segment_ids, extra=(), kv_segment_ids=None):
    """Validate the operands of a flash kernel; return the launch ints
    ``(b, sq, sk, hq, hkv, d, seg_stride, kv_seg_stride)``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: want q [B, Sq, Hq, D] and k = v [B, Sk, Hkv, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, d_kv = k.shape
    if k.shape[0] != b or d_kv != d:
        raise ValueError(f"{what}: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not supported (kernel takes {_HEAD_DIMS})")
    if hq % hkv != 0:
        raise ValueError(f"{what}: {hq} query heads do not fold over {hkv} kv heads")
    if min(b, sq, sk) == 0:
        raise ValueError(f"{what}: empty operand {tuple(q.shape)} / {tuple(k.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: dtypes q={q.dtype} k={k.dtype} v={v.dtype} not "
                         "supported (all f32 or all bf16)")
    seg_stride = 0
    if segment_ids is not None:
        need = sq if kv_segment_ids is not None else max(sq, sk)
        if segment_ids.dtype != torch.int32 or segment_ids.dim() != 2 \
                or segment_ids.shape[0] != b or segment_ids.shape[1] < need:
            raise ValueError(f"{what}: segment_ids must be int32 [B, >= max(Sq, Sk)], got "
                             f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
        seg_stride = segment_ids.shape[1]
    kv_seg_stride = 0
    if kv_segment_ids is not None:
        if segment_ids is None:
            raise ValueError(f"{what}: kv_segment_ids needs segment_ids (the queries' ids)")
        if kv_segment_ids.dtype != torch.int32 or kv_segment_ids.dim() != 2 \
                or kv_segment_ids.shape[0] != b or kv_segment_ids.shape[1] < sk \
                or segment_ids.shape[1] < sq:
            raise ValueError(f"{what}: kv_segment_ids must be int32 [B, >= Sk], got "
                             f"{kv_segment_ids.dtype} {tuple(kv_segment_ids.shape)}")
        kv_seg_stride = kv_segment_ids.shape[1]
    named = (("q", q), ("k", k), ("v", v), ("segment_ids", segment_ids),
             ("kv_segment_ids", kv_segment_ids)) + tuple(extra)
    for name, t in named:
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{what}: {name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return b, sq, sk, hq, hkv, d, seg_stride, kv_seg_stride


def _check_grad_operands(what, q, dout, lse, delta):
    b, sq, hq, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout {dout.dtype} {tuple(dout.shape)} does not match "
                         f"q {q.dtype} {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be f32 [{b}, {hq}, {sq}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _out_f32(what: str, q, out_dtype) -> bool:
    """Whether a kernel writes f32 outputs for ``q``'s dtype: ``out_dtype``
    None or the input dtype writes that dtype; f32 outputs of bf16 inputs
    come from the tensor-core arms' f32 epilogue."""
    if out_dtype is None or out_dtype == q.dtype:
        return False
    if out_dtype == torch.float32 and q.dtype == torch.bfloat16:
        return True
    raise ValueError(f"{what}: out_dtype {out_dtype} for {q.dtype} inputs: only f32 outputs "
                     "of bf16 inputs")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              segment_ids=None, kv_segment_ids=None,
              out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward (kernel K3): ``(out, lse)``.

    A CPU ``q`` takes :func:`flash_attention_reference`; a CUDA ``q``
    launches ``csrc/flash_fwd.cu`` or raises."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
                                         out_dtype=out_dtype)
    b, sq, sk, hq, hkv, d, seg_stride, kv_stride = _check(
        "flash_fwd", q, k, v, segment_ids, kv_segment_ids=kv_segment_ids)
    f32 = _out_f32("flash_fwd", q, out_dtype)
    out = torch.empty_like(q, dtype=torch.float32 if f32 else q.dtype)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.launch("flash_fwd", "atpu_flash_fwd", "flash_fwd",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(segment_ids),
                  _ptr(kv_segment_ids), out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv, d,
                  seg_stride, kv_stride, int(causal), int(q.dtype == torch.bfloat16), int(f32),
                  _scale(scale, d), _stream(q))
    flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
             scale: Optional[float] = None, segment_ids=None,
             kv_segment_ids=None, out_dtype=None) -> torch.Tensor:
    """dQ of flash attention (kernel K4).  A CPU ``q`` takes
    :func:`flash_dq_reference`; a CUDA ``q`` launches ``csrc/flash_bwd.cu``
    (``atpu_flash_dq``) or raises."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, delta, causal=causal, scale=scale,
                                  segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
                                  out_dtype=out_dtype)
    b, sq, sk, hq, hkv, d, seg_stride, kv_stride = _check(
        "flash_dq", q, k, v, segment_ids, (("dout", dout), ("lse", lse), ("delta", delta)),
        kv_segment_ids=kv_segment_ids)
    _check_grad_operands("flash_dq", q, dout, lse, delta)
    f32 = _out_f32("flash_dq", q, out_dtype)
    dq = torch.empty_like(q, dtype=torch.float32 if f32 else q.dtype)
    _build.launch("flash_bwd", "atpu_flash_dq", "flash_dq",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids), _ptr(kv_segment_ids),
                  dq.data_ptr(), b, sq, sk, hq, hkv, d, seg_stride, kv_stride, int(causal),
                  int(q.dtype == torch.bfloat16), int(f32), _scale(scale, d), _stream(q))
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
              scale: Optional[float] = None, segment_ids=None,
              kv_segment_ids=None, out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of flash attention (kernel K5).  A CPU ``q`` takes
    :func:`flash_dkv_reference`; a CUDA ``q`` launches ``csrc/flash_bwd.cu``
    (``atpu_flash_dkv``) or raises."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, delta, causal=causal, scale=scale,
                                   segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
                                   out_dtype=out_dtype)
    b, sq, sk, hq, hkv, d, seg_stride, kv_stride = _check(
        "flash_dkv", q, k, v, segment_ids, (("dout", dout), ("lse", lse), ("delta", delta)),
        kv_segment_ids=kv_segment_ids)
    _check_grad_operands("flash_dkv", q, dout, lse, delta)
    f32 = _out_f32("flash_dkv", q, out_dtype)
    dk = torch.empty_like(k, dtype=torch.float32 if f32 else k.dtype)
    dv = torch.empty_like(v, dtype=torch.float32 if f32 else v.dtype)
    _build.launch("flash_bwd", "atpu_flash_dkv", "flash_dkv",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids), _ptr(kv_segment_ids),
                  dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d, seg_stride, kv_stride,
                  int(causal), int(q.dtype == torch.bfloat16), int(f32), _scale(scale, d),
                  _stream(q))
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


def reset_launch_counts() -> None:
    """Set the three kernels' launch counters to zero."""
    flash_fwd.launches = 0
    flash_dq.launches = 0
    flash_dkv.launches = 0


# ------------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """The role of the JAX ``_flash`` custom VJP (``flash_attention.py:455-482``):
    the forward saves q, k, v, out and lse; the backward computes delta in
    plain PyTorch, then dQ with K4 and dK/dV with K5."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        kw = dict(causal=ctx.causal, scale=ctx.scale, segment_ids=segment_ids)
        dq = flash_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    segment_ids=None) -> torch.Tensor:
    """Flash attention over BSHD tensors ``[batch, seq, heads, head_dim]``,
    differentiable in q, k and v.

    GQA is native: the query heads fold into per-KV-head groups inside the
    kernels, and dK/dV come back unexpanded (``[B, Sk, Hkv, D]``).
    ``segment_ids [B, S]`` restricts attention to equal ids (packed
    sequences), composed with the causal mask.  ``scale`` defaults to
    ``head_dim ** -0.5``."""
    scale = _scale(scale, q.shape[-1])
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32)
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal), scale)
