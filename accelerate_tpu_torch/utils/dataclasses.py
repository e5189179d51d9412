"""Configuration dataclasses of the training path.

Port of the four :mod:`accelerate_tpu.utils.dataclasses` classes the
single-device train step needs: :class:`PrecisionPolicy`,
:class:`GradScalerKwargs`, :class:`GradientAccumulationPlugin` and
:class:`DataLoaderConfiguration`.  Dtypes are ``torch`` dtypes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Mapping, Optional

import torch


class KwargsHandler:
    def to_dict(self):
        return copy.deepcopy(self.__dict__)


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss-scaling knobs for fp16."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    num_steps: Optional[int] = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class DataLoaderConfiguration:
    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    non_blocking: bool = False
    prefetch_size: int = 2


@dataclass(frozen=True)
class PrecisionPolicy:
    """Three-dtype mixed-precision policy: masters in ``param_dtype``, cast to
    ``compute_dtype`` at step entry, step outputs cast to ``output_dtype``."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    use_loss_scaling: bool = False

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "PrecisionPolicy":
        mp = str(mixed_precision or "no")
        if mp in ("no", "fp32"):
            return cls()
        if mp == "bf16":
            return cls(compute_dtype=torch.bfloat16)
        if mp == "fp16":
            return cls(compute_dtype=torch.float16, use_loss_scaling=True)
        if mp == "fp8":
            raise NotImplementedError("mixed_precision='fp8' is not ported: "
                                      "ROADMAP Queue 1 item 9 (ops/fp8.py)")
        raise ValueError(f"Unknown mixed precision: {mixed_precision!r}")

    @staticmethod
    def _cast(tree, dtype):
        if isinstance(tree, torch.Tensor):
            return tree.to(dtype) if tree.is_floating_point() else tree
        if isinstance(tree, Mapping):
            return type(tree)((k, PrecisionPolicy._cast(v, dtype)) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return type(tree)(PrecisionPolicy._cast(v, dtype) for v in tree)
        return tree

    def cast_to_compute(self, tree):
        """Every floating tensor of ``tree`` in ``compute_dtype`` — a
        differentiable ``.to``, so gradients reach the masters in their own
        dtype."""
        return self._cast(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return self._cast(tree, self.output_dtype)
