"""Deterministic, seeded fault injection for the serving stack.

Port of :mod:`accelerate_tpu.serving.faults` (the same ``ATPU_FAULTS``
grammar and per-point streams).  The engine carries the
``decode_dispatch``, ``fetch_slow``, ``fetch_fail``, ``page_exhaustion``,
``hot_swap_upload`` and ``promote_h2d`` points, the router ``replica_kill``,
the HTTP front door ``handler_disconnect`` and the page migrator
``migrate_d2d`` / ``migrate_bounce``.

Chaos testing a continuous-batching engine is only useful when the chaos is
reproducible: a flaky failure that cannot be replayed cannot be debugged.
This module provides named injection points threaded through the serving hot
path — decode-window dispatch, the one sanctioned blocking ``fetch``, the KV
page pool, weight hot-swap upload, SSE handler writes, and whole-replica
kills — each driven by its own seeded PRNG stream so a given
``(seed, point)`` pair always fires on the same sequence of checks no matter
how the other points interleave.

Off by default with zero hot-path cost: every call site is guarded by
``if faults.ACTIVE is not None`` (a module-attribute load and an ``is``
check), no new programs are created, and nothing below this module
imports it.

Enable with the ``ATPU_FAULTS`` environment variable or programmatically::

    ATPU_FAULTS="seed=7,decode_dispatch=0.02,fetch_slow=0.05,replica_kill@40"

    from accelerate_tpu_torch.serving import faults
    faults.install(faults.FaultPlan(seed=7, probs={"fetch_fail": 0.01}))
    ...
    faults.clear()

Plan entries are either probabilistic (``point=p`` fires each check with
probability ``p``) or one-shot (``point@n`` fires exactly once, on the n-th
check of that point, 1-based).  ``slow_ms=<float>`` sets the stall injected
by ``fetch_slow``.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..telemetry import get_flight_recorder, get_registry

__all__ = [
    "FAULT_POINTS",
    "FaultInjected",
    "FaultInjector",
    "FaultPlan",
    "ACTIVE",
    "install",
    "clear",
]

#: Every injection point wired into the serving stack.  ``FaultPlan.parse``
#: rejects unknown names so a typo in ``ATPU_FAULTS`` fails loudly instead of
#: silently injecting nothing.
FAULT_POINTS = (
    "decode_dispatch",    # raise before the decode-window dispatch (engine)
    "fetch_slow",         # stall the sanctioned blocking fetch by slow_ms
    "fetch_fail",         # raise from the sanctioned blocking fetch
    "page_exhaustion",    # force one preemption as if the page pool ran dry
    "hot_swap_upload",    # raise mid weight upload, after the drain barrier
    "handler_disconnect", # break the SSE socket write (client vanished)
    "replica_kill",       # poison the busiest replica wholesale (router)
    "promote_h2d",        # raise before a spilled-prefix H2D promotion (engine)
    "migrate_d2d",        # raise mid device-to-device page migration (transfer)
    "migrate_bounce",     # raise mid pinned-host-bounce page migration (transfer)
)


class FaultInjected(RuntimeError):
    """Raised by an injection point standing in for a real infrastructure
    failure (a launch error, a lost card, a torn upload)."""


@dataclass
class FaultPlan:
    """What to inject, with what probability or at which check.

    ``probs`` maps point name -> per-check fire probability in ``[0, 1]``.
    ``at`` maps point name -> 1-based check index that fires exactly once.
    A point may appear in at most one of the two.
    """

    seed: int = 0
    probs: Dict[str, float] = field(default_factory=dict)
    at: Dict[str, int] = field(default_factory=dict)
    slow_ms: float = 10.0

    def __post_init__(self) -> None:
        for name in (*self.probs, *self.at):
            if name not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {name!r}; known: {FAULT_POINTS}"
                )
        dup = set(self.probs) & set(self.at)
        if dup:
            raise ValueError(
                f"fault point(s) {sorted(dup)} listed both probabilistically "
                "and one-shot; pick one form per point"
            )
        for name, p in self.probs.items():
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(f"{name}={p}: probability must be in [0, 1]")
        for name, n in self.at.items():
            if int(n) < 1:
                raise ValueError(f"{name}@{n}: check index is 1-based")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``ATPU_FAULTS`` comma-separated plan syntax.

        ``seed=7,decode_dispatch=0.02,replica_kill@40,slow_ms=25``
        """
        seed, slow_ms = 0, 10.0
        probs: Dict[str, float] = {}
        at: Dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "@" in part:
                name, _, idx = part.partition("@")
                at[name.strip()] = int(idx)
            elif "=" in part:
                name, _, val = part.partition("=")
                name = name.strip()
                if name == "seed":
                    seed = int(val)
                elif name == "slow_ms":
                    slow_ms = float(val)
                else:
                    probs[name] = float(val)
            else:
                raise ValueError(
                    f"bad fault plan entry {part!r}: expected point=prob, "
                    "point@n, seed=<int>, or slow_ms=<float>"
                )
        return cls(seed=seed, probs=probs, at=at, slow_ms=slow_ms)


class FaultInjector:
    """Seeded decision engine behind every injection point.

    Each point gets its own ``random.Random(f"{seed}:{point}")`` stream and
    its own check counter, so whether ``fetch_slow`` fires on its 12th check
    is a pure function of ``(seed, point)`` — independent of how many times
    the other points were consulted in between.  ``fire`` is thread-safe:
    injection points are hit from the driver thread, HTTP handler threads,
    and tests concurrently.
    """

    def __init__(self, plan: FaultPlan, registry=None) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._checks: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self._fired: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self._rngs = {
            p: random.Random(f"{plan.seed}:{p}") for p in plan.probs
        }
        self.metrics = registry if registry is not None else get_registry()
        self.recorder = get_flight_recorder()
        self._injected = self.metrics.counter(
            "serve/faults_injected_total",
            help="Faults fired by the chaos injector, all points",
        )

    @property
    def slow_ms(self) -> float:
        return self.plan.slow_ms

    def checks(self, point: str) -> int:
        with self._lock:
            return self._checks[point]

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired[point]

    def fire(self, point: str) -> bool:
        """One consultation of ``point``: returns True when the plan says
        this check is the one that fails, recording the injection."""
        with self._lock:
            self._checks[point] += 1
            n = self._checks[point]
            if point in self.plan.at:
                hit = n == self.plan.at[point]
            elif point in self.plan.probs:
                hit = self._rngs[point].random() < self.plan.probs[point]
            else:
                return False
            if not hit:
                return False
            self._fired[point] += 1
        self._injected.inc()
        self.recorder.record("serve/fault", point=point, check=n)
        return True


#: The process-wide injector consulted by every call site, or None (the
#: default) for zero-cost pass-through.  Initialised from ``ATPU_FAULTS`` at
#: import so chaos plans reach subprocess benchmarks without code changes.
ACTIVE: Optional[FaultInjector] = None


def install(plan, registry=None) -> FaultInjector:
    """Activate fault injection for this process.  ``plan`` is a
    ``FaultPlan`` or the ``ATPU_FAULTS`` string syntax."""
    global ACTIVE
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    ACTIVE = FaultInjector(plan, registry=registry)
    return ACTIVE


def clear() -> None:
    """Deactivate fault injection (restores the zero-cost path)."""
    global ACTIVE
    ACTIVE = None


_env_plan = os.environ.get("ATPU_FAULTS", "").strip()
if _env_plan:
    install(_env_plan)
del _env_plan
