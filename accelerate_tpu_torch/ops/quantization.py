"""Weight-only int8/int4 quantization for serving: the port of
:mod:`accelerate_tpu.ops.quantization`.

Weights live on the card as int8 or packed int4 codes plus f32 scales and
are dequantized to the compute dtype right before their product (W8A16 /
W4A16): the f32 multiply of codes and scales, then the cast, the
reference's exact arithmetic.  The reference leaves that to XLA, which fuses
the dequantization into the GEMM's prologue; here it is plain PyTorch ahead
of the library GEMM (no kernel of the reference's is involved).

Formats, in the reference's layout (a JAX tree carries across as a copy):

* **int8** — symmetric per-output-column scales: ``w ~ q * scale[col]``, ``q``
  in [-127, 127]; ``qweight [K, N] int8``, ``scales [N]``.
* **int4** — symmetric per-(contraction-block, column) scales, two nibbles a
  byte packed along K (low nibble = even row): ``qweight [K_pad / 2, N]
  uint8``, ``scales [K_pad / block, N]``, K zero-padded to the block.

Every function takes leading batch dims (``[E, K, N]`` stacked experts are
quantized per expert).  :class:`QuantizedLinear` is the reference's
``QuantizedDense``; :func:`quantize_model_params` converts a dense state dict
of the port's :class:`~accelerate_tpu_torch.models.transformer.Transformer`
into the one its ``quantization=8|4`` config declares.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """What to quantize and how (``accelerate_tpu/ops/quantization.py:35``):
    ``min_size``, ``min_ndim`` and ``skip_patterns`` gate
    :func:`quantize_params`; ``keep_dtype`` is the dequantization target."""

    bits: int = 8                      # 8 | 4
    block_size: int = 64               # int4 contraction-dim block
    min_size: int = 4096               # leaves smaller than this stay fp
    min_ndim: int = 2                  # only matmul weights quantize
    skip_patterns: Tuple[str, ...] = ("lm_head", "embed")
    keep_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.bits not in (8, 4):
            raise ValueError(f"Only 8- and 4-bit quantization are supported, got {self.bits}")
        if self.bits == 4 and self.block_size % 2 != 0:
            raise ValueError("int4 block_size must be even")


def Int8Config(**kw) -> QuantizationConfig:
    return QuantizationConfig(bits=8, **kw)


def Int4Config(**kw) -> QuantizationConfig:
    return QuantizationConfig(bits=4, **kw)


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight: codes, f32 scales and the layout.  ``shape`` is
    the weight's (``[..., K, N]``)."""

    data: torch.Tensor                 # int8 [..., K, N] or packed uint8 [..., K_pad/2, N]
    scales: torch.Tensor               # [..., N] (int8) or [..., K_pad/block, N] (int4)
    shape: Tuple[int, ...]
    bits: int = 8
    block_size: int = 64

    @property
    def dtype(self) -> torch.dtype:
        return self.scales.dtype

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


def _padded_k(k: int, block_size: int) -> int:
    return -(-k // block_size) * block_size


# ------------------------------------------------------------------ int8
def _quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column (last dim) int8 over the contraction dim ``-2``."""
    mat = w.float()
    amax = mat.abs().amax(dim=-2)
    scales = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(mat / scales.unsqueeze(-2)), -127, 127).to(torch.int8)
    return q, scales


# ------------------------------------------------------------------ int4
def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (int8 storage, [-8, 7]) packed pairwise along dim ``-2``:
    ``[..., K, N] -> [..., K/2, N]`` uint8, the even row in the low nibble."""
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    return u[..., 0::2, :] | (u[..., 1::2, :] << 4)


def _unpack_int4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`_pack_int4`: int8 values in [-8, 7], ``[..., k, N]``."""
    low = (packed & 0xF).to(torch.int8)
    high = ((packed >> 4) & 0xF).to(torch.int8)
    low = torch.where(low >= 8, low - 16, low)
    high = torch.where(high >= 8, high - 16, high)
    out = torch.stack([low, high], dim=-2)                   # [..., K/2, 2, N]
    out = out.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])
    return out[..., :k, :]


def _quantize_int4(w: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(contraction block, column) int4, nibble-packed."""
    mat = w.float()
    *lead, k, n = mat.shape
    pad = _padded_k(k, block_size) - k
    if pad:
        mat = torch.cat([mat, mat.new_zeros(*lead, pad, n)], dim=-2)
    blocks = mat.reshape(*lead, -1, block_size, n)
    amax = blocks.abs().amax(dim=-2)                          # [..., K/bs, N]
    scales = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(blocks / scales.unsqueeze(-2)), -8, 7)
    return _pack_int4(q.reshape(*lead, -1, n).to(torch.int8)), scales


def quantize(w: torch.Tensor, config: QuantizationConfig) -> QuantizedTensor:
    """Quantize one weight ``[..., K, N]`` per ``config`` (leading dims each
    their own matrix)."""
    if config.bits == 8:
        data, scales = _quantize_int8(w)
    else:
        data, scales = _quantize_int4(w, config.block_size)
    return QuantizedTensor(data=data, scales=scales.float(), shape=tuple(w.shape),
                           bits=config.bits, block_size=config.block_size)


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.bfloat16,
               transposed: bool = False) -> torch.Tensor:
    """The weight in ``dtype``: codes times scales in f32, then the cast —
    one elementwise pass (the int8 codes promote to f32 inside the
    multiply, whose f32 result is rounded into the ``dtype`` output).
    ``transposed`` writes ``[..., N, K]`` in row-major order, the layout
    ``F.linear`` takes, with the same values."""
    *lead, k, n = qt.shape
    if qt.bits == 8:
        codes, scales, rows = qt.data, qt.scales.unsqueeze(-2), k
    else:
        rows = _padded_k(k, qt.block_size)
        codes = _unpack_int4(qt.data, rows).reshape(*lead, -1, qt.block_size, n)
        scales = qt.scales.unsqueeze(-2)
        if transposed:  # [..., K/bs, bs, N] -> [..., N, K/bs, bs]
            codes, scales = codes.movedim(-1, -3), scales.movedim(-1, -3)
    if transposed:
        out = torch.empty(*lead, n, rows, dtype=dtype, device=codes.device)
        if qt.bits == 8:
            torch.mul(codes.transpose(-1, -2), scales.transpose(-1, -2), out=out)
        else:
            torch.mul(codes, scales, out=out.view(*lead, n, -1, qt.block_size))
        return out if rows == k else out[..., :k].contiguous()
    out = torch.empty(*codes.shape, dtype=dtype, device=codes.device)
    torch.mul(codes, scales, out=out)
    out = out.reshape(*lead, rows, n)
    return out if rows == k else out[..., :k, :].contiguous()


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` with the weight dequantized right before the product."""
    return torch.matmul(x, dequantize(qt, dtype or x.dtype))


# ------------------------------------------------------------ tree surgery
def _should_quantize(name: str, t: torch.Tensor, config: QuantizationConfig) -> bool:
    if t.dim() < config.min_ndim or t.numel() < config.min_size:
        return False
    if not t.is_floating_point():
        return False
    return not any(pat in name.lower() for pat in config.skip_patterns)


def quantize_params(params: Dict[str, torch.Tensor], config: QuantizationConfig
                    ) -> Dict[str, object]:
    """Every eligible tensor of a flat ``name -> tensor`` dict as a
    :class:`QuantizedTensor` (floating, ``ndim >= min_ndim``, ``numel >=
    min_size``, name matching no ``skip_patterns``); the rest as they are.
    Each tensor is taken as ``[..., K, N]``."""
    return {k: quantize(v, config) if _should_quantize(k, v, config) else v
            for k, v in params.items()}


def dequantize_params(params: Dict[str, object], dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params` (materialises fp copies)."""
    return {k: dequantize(v, dtype) if is_quantized(v) else v for k, v in params.items()}


def quantized_shapes(k: int, n: int, bits: int, block_size: int
                     ) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], Tuple[Tuple[int, ...],
                                                                           torch.dtype]]:
    """``((qweight shape, dtype), (scales shape, dtype))`` of a ``[K, N]``
    weight."""
    if bits == 8:
        return ((k, n), torch.int8), ((n,), torch.float32)
    k_pad = _padded_k(k, block_size)
    return ((k_pad // 2, n), torch.uint8), ((k_pad // block_size, n), torch.float32)


class QuantizedLinear(nn.Module):
    """The reference's ``QuantizedDense`` (``accelerate_tpu/ops/quantization.py:
    215``): ``qweight`` and ``scales`` buffers in the reference's layout, an
    optional bias, and ``x @ dequantize(w) + bias`` in ``compute_dtype``.
    With ``experts=E`` it holds ``E`` stacked weights (``[E, K, N]`` codes,
    per-expert scales) and maps ``[E, C, K]`` to ``[E, C, N]``."""

    def __init__(self, in_features: int, out_features: int, bits: int = 8,
                 block_size: int = 64, bias: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, experts: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"Only 8- and 4-bit quantization are supported, got {bits}")
        self.in_features, self.out_features = in_features, out_features
        self.bits, self.block_size = bits, block_size
        self.compute_dtype = compute_dtype
        self.experts = experts
        lead = () if experts is None else (experts,)
        (qs, qd), (ss, sd) = quantized_shapes(in_features, out_features, bits, block_size)
        self.register_buffer("qweight", torch.zeros(lead + qs, dtype=qd, device=device))
        self.register_buffer("scales", torch.ones(lead + ss, dtype=sd, device=device))
        self.bias = (nn.Parameter(torch.zeros(lead + (out_features,), device=device,
                                              dtype=dtype or torch.float32))
                     if bias else None)

    def qtensor(self) -> QuantizedTensor:
        lead = () if self.experts is None else (self.experts,)
        return QuantizedTensor(self.qweight, self.scales,
                               lead + (self.in_features, self.out_features),
                               self.bits, self.block_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.experts is None:
            # the [N, K] layout nn.Linear keeps: the same product as a dense
            # Linear holding the dequantized weight
            return F.linear(x.to(dt), dequantize(self.qtensor(), dt, transposed=True), bias)
        y = torch.bmm(x.to(dt), dequantize(self.qtensor(), dt))
        return y if bias is None else y + bias[:, None, :]

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bits={self.bits}, block_size={self.block_size}, experts={self.experts}")


#: names the model never quantizes: the head, the embeddings (as the
#: reference's ``skip_patterns``) and the MoE router, which stays an f32
#: Linear in the quantized model
_SKIP = ("lm_head", "embed", ".router.")


def _weight_eligible(name: str, t: torch.Tensor) -> bool:
    if not name.endswith(".weight") or any(p in name for p in _SKIP):
        return False
    return t.dim() == 2 or (t.dim() == 3 and ".experts." in name)


def quantize_flat_tree(flat: Dict[str, torch.Tensor], config: QuantizationConfig
                       ) -> Dict[str, torch.Tensor]:
    """A dense state dict of the port's ``Transformer`` -> the one its
    ``quantization=config.bits`` config declares
    (``accelerate_tpu/ops/quantization.py:255-311``): every projection's
    ``.weight`` (``nn.Linear`` ``[N, K]``, or stacked experts ``[E, K, N]``)
    becomes ``.qweight`` + ``.scales`` in the reference's ``[K, N]`` layout,
    quantized per expert; the embeddings, the head and the router stay as
    they are.  Meta tensors give meta results of the quantized shapes (the
    reference's abstract branch)."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in flat.items():
        if not _weight_eligible(name, t):
            out[name] = t
            continue
        w = t.t() if t.dim() == 2 else t
        base = name[: -len(".weight")]
        if t.device.type == "meta":
            *lead, k, n = w.shape
            (qs, qd), (ss, sd) = quantized_shapes(k, n, config.bits, config.block_size)
            out[base + ".qweight"] = torch.empty(*lead, *qs, dtype=qd, device="meta")
            out[base + ".scales"] = torch.empty(*lead, *ss, dtype=sd, device="meta")
            continue
        qt = quantize(w, config)
        out[base + ".qweight"], out[base + ".scales"] = qt.data, qt.scales
    return out


def quantize_model_params(params: Dict[str, torch.Tensor], config: QuantizationConfig
                          ) -> Dict[str, torch.Tensor]:
    """:func:`quantize_flat_tree` of a state dict: the port's state dicts
    are flat already."""
    return quantize_flat_tree(params, config)


def quantized_nbytes(params: Dict[str, object]) -> int:
    """Total bytes of a ``name -> tensor or QuantizedTensor`` dict with its
    quantization applied (codes and scales counted)."""
    total = 0
    for v in params.values():
        if is_quantized(v):
            total += v.nbytes
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
    return total


__all__ = [
    "Int4Config", "Int8Config", "QuantizationConfig", "QuantizedLinear", "QuantizedTensor",
    "dequantize", "dequantize_params", "is_quantized", "quantize", "quantize_flat_tree",
    "quantize_model_params", "quantize_params", "quantized_matmul", "quantized_nbytes",
    "quantized_shapes",
]
