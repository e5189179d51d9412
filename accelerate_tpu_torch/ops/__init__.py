"""Attention ops of the port: the paged decode/prefill kernels and their plain
versions live in :mod:`.paged_attention`, their CUDA sources in ``csrc/``."""
