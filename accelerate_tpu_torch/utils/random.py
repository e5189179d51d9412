"""Seeding.  Port of :func:`accelerate_tpu.utils.random.set_seed`."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> int:
    """Seed python, numpy and torch (every card too) and return the seed.
    ``device_specific`` offsets by the process index (0 in one process);
    ``deterministic`` asks torch for deterministic algorithms."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    return seed
