"""FLOP and memory accounting for owned executables, and the cards' peaks.

Port of :mod:`accelerate_tpu.telemetry.cost`.  The reference asks XLA's
``cost_analysis`` / ``memory_analysis`` about each compiled executable;
PyTorch has no counterpart, so here the *caller* states each executable's
cost as a formula over the shapes it was called with, and the table keeps
the formula beside the shapes:

- :meth:`CostTable.capture` runs once per executable on its first call. It
  records only the shapes and dtypes of the tensor arguments (no tensor is
  retained) and the caller's ``cost`` formula.
- :meth:`CostTable.analyze` evaluates the formula off the serve loop
  (benches, the debug server's scrape collector) and publishes
  ``cost/<name>/flops`` and ``cost/<name>/bytes_accessed``.
- :meth:`CostTable.set_hbm_peak_bytes` records the card memory an
  executable holds of its own: for the serving engine's CUDA graphs, what
  the key's capture added to the allocator.  Nothing records it on the CPU,
  where ``hbm_peak_bytes`` stays ``None`` (the reference degrades the same
  way where a backend cannot tell).

Every accessor degrades to ``None`` rather than raising.
:data:`HARDWARE_PEAKS` lists the NVIDIA cards the port targets, from their
published data sheets, plus a generic CPU fallback so CPU tests exercise
the whole path.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..logging import get_logger
from .metrics import MetricsRegistry, enabled, get_registry

logger = get_logger(__name__)

__all__ = [
    "DevicePeaks",
    "HARDWARE_PEAKS",
    "CPU_FALLBACK_PEAKS",
    "detect_device_peaks",
    "CostTable",
]


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Peak dense throughput for one card.

    ``flops_per_s`` is the bf16 dense tensor-core peak (the MFU
    denominator); ``hbm_bytes_per_s`` is peak memory bandwidth. ``source``
    distinguishes a data-sheet number from the generic fallback so
    downstream consumers can label MFU figures honestly.
    """

    kind: str
    flops_per_s: float
    hbm_bytes_per_s: float
    source: str = "spec"


# Matched by substring against the lower-cased card name
# (``torch.cuda.get_device_name``); first hit wins, so the more specific
# names come first.  Dense (no sparsity) bf16 tensor-core peaks and HBM
# bandwidths from NVIDIA's H100 Tensor Core GPU data sheet: SXM5 989 TFLOP/s
# and 3.35 TB/s, NVL 835 TFLOP/s and 3.9 TB/s, PCIe 756 TFLOP/s and
# 2.0 TB/s (the sheet's 1979 / 1671 / 1513 are with sparsity).
HARDWARE_PEAKS: Tuple[Tuple[str, DevicePeaks], ...] = (
    ("h100 80gb hbm3", DevicePeaks("nvidia-h100-sxm", 989e12, 3.35e12,
                                   source="spec: NVIDIA H100 data sheet, SXM5")),
    ("h100 nvl", DevicePeaks("nvidia-h100-nvl", 835e12, 3.9e12,
                             source="spec: NVIDIA H100 data sheet, NVL")),
    ("h100 pcie", DevicePeaks("nvidia-h100-pcie", 756e12, 2.0e12,
                              source="spec: NVIDIA H100 data sheet, PCIe")),
)

# A deliberately round generic-CPU number so MFU stays finite (and honest:
# source="fallback") on hosts where we cannot know the real peak. 2 TFLOP/s
# is in the ballpark of a modern many-core AVX-512 server at fp32.
CPU_FALLBACK_PEAKS = DevicePeaks("generic-cpu", 2e12, 0.1e12, source="fallback")


def detect_device_peaks(device: Any = None) -> DevicePeaks:
    """Return peaks for ``device``: a card name, a ``torch.device``, or
    ``None`` (card 0 when one is visible, else the CPU fallback).

    Always returns *something*: unknown names get the CPU fallback entry so
    MFU arithmetic never divides by ``None``.
    """
    if isinstance(device, str) and device not in ("cpu", "cuda") \
            and not device.startswith("cuda:"):
        name = device
    else:
        try:
            device = torch.device(device) if device is not None else (
                torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
            if device.type != "cuda":
                return CPU_FALLBACK_PEAKS
            name = torch.cuda.get_device_name(device)
        except Exception:  # no card behind a cuda device
            return CPU_FALLBACK_PEAKS
    kind = str(name).lower()
    for needle, peaks in HARDWARE_PEAKS:
        if needle in kind:
            return peaks
    return CPU_FALLBACK_PEAKS


def _shapes(tree: Any, out: List[Tuple[Tuple[int, ...], str]]) -> List:
    """The ``(shape, dtype)`` of every tensor in ``tree``, in order."""
    if isinstance(tree, (tuple, list)):
        for x in tree:
            _shapes(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _shapes(tree[k], out)
    elif isinstance(tree, torch.Tensor):
        out.append((tuple(tree.shape), str(tree.dtype)))
    return out


#: an executable's cost formula: the recorded ``(shape, dtype)`` list of its
#: tensor arguments -> ``(flops, bytes moved)`` of one call
CostFormula = Callable[[List[Tuple[Tuple[int, ...], str]]], Tuple[float, float]]


class CostTable:
    """Per-executable FLOP and memory accounting, keyed by a stable name.

    Thread-safe; ``capture`` is safe to call every step (a dict-membership
    check after the first call), ``analyze`` is meant for off-loop callers.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._hbm: Dict[str, float] = {}

    def captured(self, name: str) -> bool:
        return name in self._entries

    def capture(
        self,
        name: str,
        fn: Optional[Callable] = None,
        args: Tuple[Any, ...] = (),
        kwargs: Optional[Dict[str, Any]] = None,
        cost: Optional[CostFormula] = None,
    ) -> bool:
        """Record the shapes of ``fn``'s tensor arguments and its ``cost``
        formula once.

        Returns True iff a new entry was created. Cheap after the first
        call; stores no tensor.
        """
        if not enabled() or name in self._entries:
            return False
        entry: Dict[str, Any] = {
            "name": name,
            "analyzed": False,
            "flops": None,
            "bytes_accessed": None,
            "hbm_peak_bytes": None,
            "memory": None,
            "error": None,
            "shapes": _shapes((tuple(args), dict(kwargs or {})), []),
            "_fn": fn,
            "_cost": cost,
        }
        with self._lock:
            if name in self._entries:
                return False
            self._entries[name] = entry
        return True

    def set_hbm_peak_bytes(self, name: str, nbytes: Optional[float]) -> None:
        """Record the card memory executable ``name`` holds of its own (the
        largest of several calls wins).  ``None`` records nothing."""
        if nbytes is None:
            return
        with self._lock:
            self._hbm[name] = max(float(nbytes), self._hbm.get(name, 0.0))
            entry = self._entries.get(name)
            if entry is not None:
                entry["hbm_peak_bytes"] = self._hbm[name]

    def analyze(self, name: str) -> Optional[Dict[str, Any]]:
        """Evaluate the captured cost formula. Idempotent; returns the
        public entry dict or ``None`` if ``name`` was never captured."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            return None
        if entry["analyzed"]:
            return self._public(entry)
        entry["hbm_peak_bytes"] = self._hbm.get(name)
        cost = entry.get("_cost")
        if cost is None:
            entry["error"] = "no cost formula for this executable"
        else:
            try:
                flops, nbytes = cost(entry["shapes"])
                if flops is not None and flops > 0:
                    entry["flops"] = float(flops)
                if nbytes is not None and nbytes > 0:
                    entry["bytes_accessed"] = float(nbytes)
            except Exception as exc:
                entry["error"] = f"cost formula failed: {exc!r}"
        entry["analyzed"] = True
        self._publish(entry)
        return self._public(entry)

    def analyze_all(self) -> Dict[str, Dict[str, Any]]:
        """Analyze every captured executable; returns the full snapshot."""
        with self._lock:
            names = list(self._entries)
        for name in names:
            self.analyze(name)
        return self.snapshot()

    def flops(self, name: str) -> Optional[float]:
        entry = self._entries.get(name)
        return entry["flops"] if entry is not None else None

    def bytes_accessed(self, name: str) -> Optional[float]:
        entry = self._entries.get(name)
        return entry["bytes_accessed"] if entry is not None else None

    def hbm_peak_bytes(self, name: str) -> Optional[float]:
        entry = self._entries.get(name)
        return entry["hbm_peak_bytes"] if entry is not None else None

    def max_hbm_peak_bytes(self) -> Optional[float]:
        """Largest per-executable card memory across the table."""
        with self._lock:
            peaks = [
                e["hbm_peak_bytes"]
                for e in self._entries.values()
                if e["hbm_peak_bytes"] is not None
            ]
        return max(peaks) if peaks else None

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: self._public(e) for name, e in self._entries.items()}

    def _publish(self, entry: Dict[str, Any]) -> None:
        """Mirror one analyzed entry into ``cost/<name>/*`` gauges."""
        try:
            name = entry["name"]
            if entry["flops"] is not None:
                self.registry.gauge(f"cost/{name}/flops").set(entry["flops"])
            if entry["bytes_accessed"] is not None:
                self.registry.gauge(f"cost/{name}/bytes_accessed").set(
                    entry["bytes_accessed"]
                )
            if entry["hbm_peak_bytes"] is not None:
                self.registry.gauge(f"cost/{name}/hbm_peak_bytes").set(
                    entry["hbm_peak_bytes"]
                )
        except Exception:  # registry disabled mid-flight
            logger.debug("cost gauge publish failed", exc_info=True)

    @staticmethod
    def _public(entry: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in entry.items() if not k.startswith("_")}
