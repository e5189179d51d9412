"""PyTorch/CUDA port of ``accelerate_tpu``'s paged serving path.

The package mirrors the JAX package file for file where that helps a reader
find the counterpart (``ops/paged_attention.py``, ``models/transformer.py``,
``serving/engine.py`` ...).  It imports ``torch`` and numpy only — never JAX
and never the JAX package — and its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

The two attention kernels of the serving path are hand-written CUDA C++ for
Hopper (``ops/csrc/``), built with ``nvcc`` at first use on the card; a CPU
tensor takes each kernel's plain PyTorch version instead.
"""

from ._device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
