"""Recompile watchdog: catch a program that keeps meeting new shapes.

Port of :mod:`accelerate_tpu.telemetry.watchdog`.  On the card each of the
serving engine's windows and prefill buckets is one CUDA graph, captured
for fixed shapes; a call with a new shape would need another program (in
the reference, a silent retrace).  :class:`RecompileWatchdog` wraps any
callable and keys each call by the signature of its arguments:

* a **new** signature is recorded with the wall time of that first call and
  bumps the ``compile/<name>/count`` gauge in the registry;
* crossing the declared ``budget`` emits ONE ``get_logger`` warning listing
  the distinct signatures seen;
* :meth:`RecompileWatchdog.jit_cache_size` is the number of distinct
  signatures the wrapped program was called with, the counterpart of the
  reference's jit-cache size; attribute access forwards to the wrapped fn.

The signature is computed on the host from the arguments (nested tuples,
lists and dicts walked; a tensor keyed by ``(shape, dtype, device)``), with
no device interaction.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..logging import get_logger
from .metrics import MetricsRegistry, enabled, get_registry

logger = get_logger(__name__)


def arg_signature(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple:
    """Hashable ``(shape, dtype, device)``-level signature of a call's
    arguments.

    Tuples, lists and dicts are walked (their structure is part of the
    signature); tensors contribute ``(shape, dtype, device)``, other
    array-likes ``(shape, dtype)``; hashable non-arrays contribute their value
    (a changed value can mean another program); unhashable leaves contribute
    their type only.
    """
    return _signature((args, kwargs), values=True)


def tensor_signature(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple:
    """:func:`arg_signature` keyed by the tensors alone: every other leaf
    contributes only its place.  For programs that take their scalars as
    launch arguments (a page id, a lane's sampling knobs), where a new value
    needs no new program."""
    return _signature((args, kwargs), values=False)


def _signature(tree: Any, values: bool) -> Tuple:
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_signature(x, values) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _signature(v, values)) for k, v in sorted(tree.items())))
    if isinstance(tree, torch.Tensor):
        return ("arr", tuple(tree.shape), str(tree.dtype), str(tree.device))
    shape = getattr(tree, "shape", None)
    dtype = getattr(tree, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), str(dtype))
    if not values:
        return ("scalar",)
    try:
        hash(tree)
    except TypeError:
        return ("type", type(tree).__name__)
    return ("val", tree)


class RecompileWatchdog:
    """Wrap a (jitted) callable; account one entry per distinct call signature.

    Parameters
    ----------
    fn: the callable to guard (a window's or chunk's program).
    name: metric/log name; defaults to the fn's ``__name__``.
    budget: max distinct signatures before the warning fires (None = just
        count).  The warning fires once per budget crossing, not per call.
    registry: metrics registry for the ``<name>/compile_count`` gauge and
        ``<name>/compile_time_s`` counter (default: the process registry).
    signature: how a call is keyed (:func:`arg_signature`, the default, or
        :func:`tensor_signature`).
    """

    def __init__(
        self,
        fn: Callable,
        name: Optional[str] = None,
        budget: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        signature: Callable[[Tuple[Any, ...], Dict[str, Any]], Tuple] = arg_signature,
    ):
        self._fn = fn
        self._signature = signature
        self.name = name or getattr(fn, "__name__", type(fn).__name__)
        self.budget = budget
        self.signatures: Dict[Tuple, Dict[str, float]] = {}
        self._warned = False
        registry = registry or get_registry()
        self._count_gauge = registry.gauge(
            f"compile/{self.name}/count", help="distinct call signatures observed"
        )
        self._time_counter = registry.counter(
            f"compile/{self.name}/first_call_s",
            help="cumulative wall time of first-signature calls (≈ trace+compile)",
        )

    @property
    def compile_count(self) -> int:
        return len(self.signatures)

    def over_budget(self) -> bool:
        return self.budget is not None and len(self.signatures) > self.budget

    def __call__(self, *args, **kwargs):
        if not enabled():
            return self._fn(*args, **kwargs)
        sig = self._signature(args, kwargs)
        known = sig in self.signatures
        if known:
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        self.signatures[sig] = {"first_call_s": dt, "at": time.time()}
        self._count_gauge.set(len(self.signatures))
        self._time_counter.inc(dt)
        if self.over_budget() and not self._warned:
            self._warned = True
            shapes = "; ".join(
                ", ".join(f"{s[1]}:{s[2]}" for s in _arrays(sig)) or "(no arrays)"
                for sig in list(self.signatures)[:8]
            )
            logger.warning(
                f"RecompileWatchdog[{self.name}]: {len(self.signatures)} distinct "
                f"call signatures exceed the compile budget of {self.budget} — a "
                f"shape or dtype is varying across calls and forcing retraces "
                f"(signatures: {shapes}). Pad or bucket the offending argument."
            )
        return out

    def jit_cache_size(self) -> int:
        """The number of distinct signatures the wrapped program has been
        called with (the reference's jit-cache size).  On the card a serving
        window or chunk is one CUDA graph per signature."""
        return len(self.signatures)

    def __getattr__(self, attr):
        # forward attribute lookups to the wrapped fn
        if attr == "_fn":  # guard pre-__init__ lookups from recursing
            raise AttributeError(attr)
        return getattr(self._fn, attr)

    def report(self) -> Dict[str, Any]:
        """Snapshot: count, budget, total first-call seconds, per-sig timings."""
        return {
            "name": self.name,
            "count": len(self.signatures),
            "budget": self.budget,
            "over_budget": self.over_budget(),
            "first_call_s_total": round(
                sum(s["first_call_s"] for s in self.signatures.values()), 4
            ),
        }


def _arrays(sig: Tuple):
    """The ``("arr", shape, dtype, ...)`` entries of a signature."""
    if sig and sig[0] == "arr":
        yield sig
        return
    for part in sig:
        if isinstance(part, tuple):
            yield from _arrays(part)


def watch_recompiles(
    fn: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    budget: Optional[int] = None,
    registry: Optional[MetricsRegistry] = None,
):
    """Decorator form: ``@watch_recompiles(budget=1)`` above a jitted fn."""
    if fn is None:
        import functools

        return functools.partial(
            watch_recompiles, name=name, budget=budget, registry=registry
        )
    return RecompileWatchdog(fn, name=name, budget=budget, registry=registry)
