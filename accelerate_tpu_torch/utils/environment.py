"""Host-runtime tuning: thread-count defaults and NUMA affinity.

Port of :mod:`accelerate_tpu.utils.environment`, copied (it imports no
JAX). The analog of reference ``state.py:238-253`` (``OMP_NUM_THREADS``
auto-set so host-side data workers don't oversubscribe cores) and reference
``utils/environment.py:220-274`` (``set_numa_affinity``: pin a local process
to the cores of one NUMA node).  On a TPU host the hot host-side paths are the
numpy/torch dataloader workers and the checkpoint/streaming IO threads — the
same oversubscription and cross-socket-memory problems the reference tunes
for, minus any GPU-PCIe topology: we pin by round-robin over the host's NUMA
nodes instead of by accelerator bus locality.
"""

from __future__ import annotations

import functools
import math
import os
import re
from typing import Dict, List, Optional


def get_cpu_count() -> int:
    """Number of CPUs usable by this process (cgroup/affinity aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


def default_thread_count(local_world_size: int = 1, numa_pinned: bool = False) -> int:
    """Per-process host-thread budget: an even split of the host's cores.

    Reference ``state.py:248-253`` sets ``OMP_NUM_THREADS =
    nproc // local_world_size`` (min 1) when the user hasn't chosen; same rule
    here.  One JAX process per TPU host means the full core count by default;
    the CPU-debug gang launcher divides by the forked process count.  With
    ``numa_pinned`` each process will be confined to one NUMA node's cores, so
    the budget divides by the node count too (else a pinned worker runs
    whole-host thread counts on one socket's cores).
    """
    divisor = max(local_world_size, 1)
    if numa_pinned:
        divisor = max(divisor, len(get_numa_nodes()) or 1)
    return max(math.floor(get_cpu_count() / divisor), 1)


def set_default_thread_env(
    env: Dict[str, str], local_world_size: int = 1, numa_pinned: bool = False
) -> None:
    """Fill thread-tuning env vars into ``env`` unless the user already chose.

    ``OMP_NUM_THREADS`` bounds torch/numpy intra-op pools (the reference's
    knob); ``OPENBLAS``/``MKL`` variants catch numpy builds that ignore OMP.
    """
    n = str(default_thread_count(local_world_size, numa_pinned))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        if var not in env and var not in os.environ:
            env[var] = n


# --------------------------------------------------------------------- NUMA
def _parse_cpulist(text: str) -> List[int]:
    """Parse a sysfs cpulist like ``0-3,8-11`` into a list of CPU ids."""
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return cpus


def get_numa_nodes() -> List[List[int]]:
    """CPU ids per NUMA node from sysfs; [] when the topology is unreadable."""
    base = "/sys/devices/system/node"
    try:
        entries = sorted(
            (e for e in os.listdir(base) if re.fullmatch(r"node\d+", e)),
            key=lambda e: int(e[4:]),
        )
    except OSError:
        return []
    nodes: List[List[int]] = []
    for entry in entries:
        try:
            with open(os.path.join(base, entry, "cpulist")) as f:
                cpus = _parse_cpulist(f.read())
        except OSError:
            continue
        if cpus:
            nodes.append(cpus)
    return nodes


@functools.lru_cache(maxsize=None)
def _env_logger():
    # one shared adapter so warning_once actually dedups (it caches per instance)
    from ..logging import get_logger

    return get_logger(__name__)


def _warn_no_numa() -> None:
    _env_logger().warning_once(
        "ACCELERATE_USE_NUMA_AFFINITY was requested but the NUMA topology could "
        "not be read (or the platform has no sched_setaffinity); skipping pinning."
    )


def set_numa_affinity(local_process_index: int, verbose: bool = False) -> None:
    """Pin this process to one NUMA node's cores, round-robin by local rank.

    Reference ``utils/environment.py:220-274`` pins to the NUMA node of the
    process's GPU (read from the PCIe topology).  A TPU host has no per-process
    accelerator locality to read — every local chip is driven by the one
    process — so for the CPU-debug gang (N local processes) we spread ranks
    across nodes round-robin, which keeps each worker's dataloader memory
    traffic on one socket.  No-op (with a one-time warning) when the topology
    is unavailable.
    """
    if not hasattr(os, "sched_setaffinity"):
        _warn_no_numa()
        return
    nodes = get_numa_nodes()
    if not nodes:
        _warn_no_numa()
        return
    cpus = nodes[local_process_index % len(nodes)]
    usable = set(cpus) & os.sched_getaffinity(0)
    if not usable:
        _warn_no_numa()
        return
    os.sched_setaffinity(0, usable)
    if verbose:
        _env_logger().info(
            f"local rank {local_process_index} pinned to NUMA node "
            f"{local_process_index % len(nodes)} ({len(usable)} cpus)"
        )


def override_numa_affinity(local_process_index: int, verbose: Optional[bool] = None) -> None:
    """Apply NUMA pinning when ``ACCELERATE_USE_NUMA_AFFINITY`` is truthy
    (reference ``utils/environment.py:259-274``)."""
    from .dataclasses import parse_flag_from_env

    if parse_flag_from_env("ACCELERATE_USE_NUMA_AFFINITY"):
        if verbose is None:
            verbose = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        set_numa_affinity(local_process_index, verbose=verbose)
