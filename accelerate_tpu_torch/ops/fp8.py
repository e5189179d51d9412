"""fp8 products for training: the port of :mod:`accelerate_tpu.ops.fp8`.

Operands are quantized to ``float8_e4m3fn`` on the forward pass and the
incoming gradient to ``float8_e5m2`` on the backward pass (the "HYBRID"
recipe; "E4M3" keeps e4m3 for the gradient too), each with a per-tensor
scale that maps its amax onto the format's largest value.

* **Just-in-time scaling** — :func:`fp8_matmul` / :class:`FP8Linear`: each
  operand's scale comes from its own amax at call time.  The backward
  computes both transpose products against the *saved quantized* operands,
  as the reference's ``_fp8_dot_core`` (``accelerate_tpu/ops/fp8.py:73-110``).
* **Delayed scaling** — :class:`DelayedScalingState` +
  :func:`fp8_dot_general_delayed`: scales from an amax history, refreshed
  every ``interval`` calls; the state is functional (``observe`` returns a
  new one).

On the card the product is ``torch._scaled_mm``: fp8 codes in, the f32
*dequant* multipliers (``1 / scale``) as its per-tensor scales, the
operand's dtype out.  That is the Hopper fp8 GEMM XLA's gemm rewriter makes
of the reference's quantize -> dequantize -> dot pattern; the reference has
no kernel of its own there.  Its plain version, on the CPU, is that pattern:
:func:`quantize_dequantize` both operands, then ``torch.matmul``.  A dim
that is not a multiple of 16 (which ``_scaled_mm`` refuses: a decode
window's M is its lane count) is zero-padded inside :func:`scaled_mm`;
nothing falls back to the plain version on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

# largest normal values of the two fp8 formats
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

_FMT_MAX = {torch.float8_e4m3fn: E4M3_MAX, torch.float8_e5m2: E5M2_MAX}


def _fp8_max(dtype: torch.dtype) -> float:
    return _FMT_MAX[dtype]


def compute_scale(amax: torch.Tensor, dtype: torch.dtype, margin: int = 0) -> torch.Tensor:
    """Per-tensor scale mapping ``amax`` onto the format's largest value,
    ``margin`` powers of two below it: ``(max / 2**margin) / max(amax,
    1e-12)`` in f32 (a true division, as the reference's)."""
    fp8_max = _fp8_max(dtype) / (2.0 ** margin)
    amax = torch.clamp(amax.float(), min=1e-12)
    return torch.div(torch.full_like(amax, fp8_max), amax)


def quantize_dequantize(x: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor) -> torch.Tensor:
    """Round-trip ``x`` through fp8: ``x * scale`` in f32, clipped to the
    format's range, cast to ``dtype`` (round to nearest even), back to f32,
    divided by ``scale`` and returned in ``x.dtype``."""
    fp8_max = _fp8_max(dtype)
    scaled = (x.float() * scale).clamp(-fp8_max, fp8_max)
    return (scaled.to(dtype).float() / scale).to(x.dtype)


def _amax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` as f32: exact in ``x``'s own dtype, so no f32 copy."""
    return torch.linalg.vector_norm(x, float("inf")).float()


def _current_scale_qdq(x: torch.Tensor, dtype: torch.dtype, margin: int) -> torch.Tensor:
    return quantize_dequantize(x, dtype, compute_scale(_amax(x), dtype, margin))


def _codes(x: torch.Tensor, dtype: torch.dtype, margin: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as fp8 codes with just-in-time scaling, and the f32 dequant
    multiplier ``1 / scale`` that ``_scaled_mm`` takes."""
    scale = compute_scale(_amax(x), dtype, margin)
    fp8_max = _fp8_max(dtype)
    codes = (x.float() * scale).clamp(-fp8_max, fp8_max).to(dtype)
    return codes, scale.reciprocal()


def _row_major(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(1) == 1 else t.contiguous()


def _col_major(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(0) == 1 else t.t().contiguous().t()


#: ``_scaled_mm`` launches (one count per product, forward and backward);
#: the plain version counts nothing
launches = 0


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` zero-padded to ``[rows, cols]`` (itself when it has that shape)."""
    if t.shape == (rows, cols):
        return t
    out = torch.zeros(rows, cols, dtype=t.dtype, device=t.device)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def scaled_mm(a: torch.Tensor, a_inv: torch.Tensor, b: torch.Tensor, b_inv: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``(a * a_inv) @ (b * b_inv)`` on the card from fp8 codes ``a [M, K]``
    and ``b [K, N]``: Hopper's fp8 GEMM (``torch._scaled_mm``, f32
    accumulation), ``a`` taken row-major and ``b`` column-major.

    ``_scaled_mm`` takes only dims that are multiples of 16, so M, K and N
    are zero-padded up to them and the output sliced back to ``[M, N]``.
    That is exact: the codes and their scales were taken before the pad,
    and zero rows and columns add nothing to the f32 accumulation (the
    reference's fp8 dot takes any shape)."""
    global launches
    m, k = a.shape
    n = b.shape[1]
    if a.dtype == torch.float8_e5m2 and b.dtype == torch.float8_e5m2:
        raise ValueError("the fp8 product takes no e5m2 x e5m2 operands")
    mp, kp, np_ = _up16(m), _up16(k), _up16(n)
    a = _pad_to(a, mp, kp)
    b = b if b.shape == (kp, np_) else _pad_to(b.t(), np_, kp).t()
    out = torch._scaled_mm(_row_major(a), _col_major(b), scale_a=a_inv, scale_b=b_inv,
                           out_dtype=out_dtype)
    launches += 1
    out = out[0] if isinstance(out, tuple) else out
    return out if (mp, np_) == (m, n) else out[:m, :n]


class _FP8Dot(torch.autograd.Function):
    """``x [M, K] @ w [K, N]`` with both operands quantized to e4m3 and the
    gradient to ``bwd_dtype`` (``_fp8_dot_core``'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, margin: int, bwd_dtype):
        ctx.margin, ctx.bwd_dtype, ctx.out_dtype = margin, bwd_dtype, x.dtype
        ctx.card = x.is_cuda
        if ctx.card:
            xc, x_inv = _codes(x, torch.float8_e4m3fn, margin)
            wc, w_inv = _codes(w, torch.float8_e4m3fn, margin)
            ctx.save_for_backward(xc, x_inv, wc, w_inv)
            return scaled_mm(xc, x_inv, wc, w_inv, x.dtype)
        xq = _current_scale_qdq(x, torch.float8_e4m3fn, margin)
        wq = _current_scale_qdq(w, torch.float8_e4m3fn, margin)
        ctx.save_for_backward(xq, wq)
        return torch.matmul(xq, wq)

    @staticmethod
    def backward(ctx, g):
        if ctx.card:
            xc, x_inv, wc, w_inv = ctx.saved_tensors
            gc, g_inv = _codes(g, ctx.bwd_dtype, ctx.margin)
            dx = scaled_mm(gc, g_inv, wc.t(), w_inv, ctx.out_dtype)
            dw = scaled_mm(xc.t(), x_inv, gc, g_inv, ctx.out_dtype)
            return dx, dw, None, None
        xq, wq = ctx.saved_tensors
        gq = _current_scale_qdq(g, ctx.bwd_dtype, ctx.margin)
        return torch.matmul(gq, wq.t()), torch.matmul(xq.t(), gq), None, None


def bwd_dtype_of(fp8_format: str) -> torch.dtype:
    """The gradient's format for a recipe's ``fp8_format``: e5m2 for
    "HYBRID", e4m3 for "E4M3" (``accelerate_tpu/ops/fp8.py:136-148``)."""
    fmt = str(fp8_format).upper()
    if fmt not in ("HYBRID", "E4M3"):
        raise ValueError(f"fp8_format must be 'HYBRID' or 'E4M3', got {fmt!r}")
    return torch.float8_e5m2 if fmt == "HYBRID" else torch.float8_e4m3fn


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, *, margin: int = 0,
               bwd_dtype: torch.dtype = torch.float8_e5m2) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with fp8 operands and just-in-time scaling
    (``fp8_dot_general``), differentiable in both; the output takes
    ``x.dtype``."""
    lead = x.shape[:-1]
    out = _FP8Dot.apply(x.reshape(-1, x.shape[-1]), w, int(margin), bwd_dtype)
    return out.reshape(*lead, w.shape[-1])


def make_fp8_linear(recipe=None):
    """``linear(x, weight [N, K], bias=None)`` from an ``FP8RecipeKwargs``
    (``make_fp8_dot_general``): the recipe's margin and gradient format."""
    margin = int(getattr(recipe, "margin", 0) or 0)
    bwd = bwd_dtype_of(getattr(recipe, "fp8_format", "HYBRID"))

    def linear(x, weight, bias=None):
        y = fp8_matmul(x, weight.t(), margin=margin, bwd_dtype=bwd)
        return y if bias is None else y + bias

    return linear


class FP8Linear(nn.Linear):
    """``nn.Linear`` whose product runs in fp8 (the reference's ``nn.Dense``
    with ``dot_general=fp8_dot_general``): input, weight and bias cast to
    ``compute_dtype`` first (Flax ``Dense(dtype=...)``), the bias added after
    the product.  The state dict is ``nn.Linear``'s."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 compute_dtype: torch.dtype = torch.bfloat16, margin: int = 0,
                 fp8_format: str = "HYBRID", device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype
        self.margin = int(margin)
        self.bwd_dtype = bwd_dtype_of(fp8_format)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = fp8_matmul(x.to(dt), self.weight.to(dt).t(), margin=self.margin,
                       bwd_dtype=self.bwd_dtype)
        return y if self.bias is None else y + self.bias.to(dt)


def plain_fp8_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     margin: int = 0, bwd_dtype: torch.dtype = torch.float8_e5m2) -> torch.Tensor:
    """The plain version of :class:`FP8Linear`'s forward on any device:
    quantize -> dequantize both operands, then ``torch.matmul``
    (:func:`plain_fp8_grads` is its backward)."""
    xq = _current_scale_qdq(x, torch.float8_e4m3fn, margin)
    wq = _current_scale_qdq(weight.t(), torch.float8_e4m3fn, margin)
    y = torch.matmul(xq, wq)
    return y if bias is None else y + bias


def plain_fp8_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, margin: int = 0,
                    bwd_dtype: torch.dtype = torch.float8_e5m2):
    """``(dx, dw)`` of ``x [M, K] @ w [K, N]`` for the incoming gradient
    ``g``, as the plain backward computes them against the quantized
    operands."""
    xq = _current_scale_qdq(x, torch.float8_e4m3fn, margin)
    wq = _current_scale_qdq(w, torch.float8_e4m3fn, margin)
    gq = _current_scale_qdq(g, bwd_dtype, margin)
    return torch.matmul(gq, wq.t()), torch.matmul(xq.t(), gq)


# ----------------------------------------------------------- delayed scaling
@dataclasses.dataclass(frozen=True)
class DelayedScalingState:
    """Amax-history state of one tensor role for delayed scaling
    (``accelerate_tpu/ops/fp8.py:151-203``): ``history`` is a ring buffer of
    the last ``len(history)`` amaxes, and ``scale`` is refreshed from it
    every ``interval`` calls by ``amax_compute_algo`` ("max" over the
    history, or "most_recent").  Functional: :meth:`observe` returns a new
    state."""

    scale: torch.Tensor        # f32 scalar
    history: torch.Tensor      # f32 [amax_history_len]
    step: torch.Tensor         # int32 scalar: calls since creation
    fp8_dtype: torch.dtype = torch.float8_e4m3fn
    margin: int = 0
    interval: int = 1
    amax_compute_algo: str = "max"

    @classmethod
    def create(cls, recipe=None, fp8_dtype: torch.dtype = torch.float8_e4m3fn,
               device=None) -> "DelayedScalingState":
        hist_len = int(getattr(recipe, "amax_history_len", 1024) or 1024)
        algo = str(getattr(recipe, "amax_compute_algo", "max"))
        if algo not in ("max", "most_recent"):
            raise ValueError(f"amax_compute_algo must be 'max' or 'most_recent', got {algo!r}")
        return cls(scale=torch.ones((), dtype=torch.float32, device=device),
                   history=torch.zeros(hist_len, dtype=torch.float32, device=device),
                   step=torch.zeros((), dtype=torch.int32, device=device),
                   fp8_dtype=fp8_dtype, margin=int(getattr(recipe, "margin", 0) or 0),
                   interval=int(getattr(recipe, "interval", 1) or 1), amax_compute_algo=algo)

    def observe(self, x: torch.Tensor) -> "DelayedScalingState":
        """Record ``x``'s amax and, on an interval boundary, refresh the scale."""
        amax = _amax(x)
        idx = torch.remainder(self.step, self.history.shape[0]).long()
        history = self.history.index_put((idx,), amax)
        ref = history.amax() if self.amax_compute_algo == "max" else amax
        refresh = torch.remainder(self.step + 1, self.interval) == 0
        scale = torch.where(refresh, compute_scale(ref, self.fp8_dtype, self.margin), self.scale)
        return dataclasses.replace(self, scale=scale, history=history, step=self.step + 1)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_dequantize(x, self.fp8_dtype, self.scale)


def fp8_dot_general_delayed(lhs: torch.Tensor, rhs: torch.Tensor,
                            lhs_state: DelayedScalingState, rhs_state: DelayedScalingState):
    """``lhs [..., K] @ rhs [K, N]`` quantized with the states' current
    (history-derived) scales, then this call's amaxes recorded: ``(out,
    new_lhs_state, new_rhs_state)``.  The backward runs through the
    quantize -> dequantize round trip, as the reference's does."""
    out = torch.matmul(lhs_state.quantize(lhs), rhs_state.quantize(rhs))
    return out, lhs_state.observe(lhs), rhs_state.observe(rhs)


__all__ = [
    "E4M3_MAX", "E5M2_MAX", "DelayedScalingState", "FP8Linear", "bwd_dtype_of",
    "compute_scale", "fp8_dot_general_delayed", "fp8_matmul", "make_fp8_linear",
    "plain_fp8_grads", "plain_fp8_linear", "quantize_dequantize", "scaled_mm",
]
