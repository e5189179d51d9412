"""Seeding and RNG synchronization across processes.  Port of
:mod:`accelerate_tpu.utils.random`, without its JAX key helpers (the
port draws from torch generators)."""

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


def synchronize_rng_state(rng_type: str, generator=None):
    """Process 0's state of one RNG on every process (``accelerate_tpu/
    utils/random.py:66-110``): ``"python"``, ``"numpy"`` or ``"generator"``
    (a sampler with ``state_dict``/``load_state_dict``, such as the seedable
    sampler)."""
    from ..state import PartialState
    from .operations import broadcast_object_list

    if PartialState().num_processes <= 1:
        return
    rng_type = str(rng_type)
    if rng_type == "python":
        payload = [random.getstate()]
        broadcast_object_list(payload, from_process=0)
        random.setstate(payload[0])
    elif rng_type == "numpy":
        payload = [np.random.get_state()]
        broadcast_object_list(payload, from_process=0)
        np.random.set_state(payload[0])
    elif rng_type == "generator" and generator is not None:
        payload = [generator.state_dict() if hasattr(generator, "state_dict") else None]
        broadcast_object_list(payload, from_process=0)
        if payload[0] is not None and hasattr(generator, "load_state_dict"):
            generator.load_state_dict(payload[0])


def synchronize_rng_states(rng_types, generator=None):
    for rng_type in rng_types:
        synchronize_rng_state(rng_type, generator=generator)
