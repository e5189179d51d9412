"""Flight recorder: crash/hang forensics for training and serving loops.

Port of :mod:`accelerate_tpu.telemetry.flight_recorder`.  A hang leaves no
trace by itself — the process spins in a synchronisation or a kernel and
the only recourse is ``py-spy`` from a shell you may not have. This module
is the black box.

Three pieces, all stdlib, all bounded:

- :class:`FlightRecorder` — a ring buffer of structured lifecycle events
  (train steps, serve steps, request admit/finish, data fetches). Appends
  are a deque push under a lock, ~microseconds; when the ring is full the
  oldest event is dropped and a drop counter keeps the loss honest.
- :class:`StallDetector` — a daemon thread that watches the recorder's
  progress heartbeat. If no heartbeat lands for ``timeout_s`` it dumps
  all-thread stacks, the ring tail, and a metrics snapshot through the
  multiprocess logger (and to a JSON artifact when ``ATPU_FLIGHT_DIR`` is
  set), exactly once per stall — the detector re-arms when progress resumes.
  The clock is injectable so tests never sleep.
- :func:`install_crash_hooks` — ``sys.excepthook`` + ``atexit`` writers that
  persist the same dump as a JSON artifact on crash. Auto-installed only
  when ``ATPU_FLIGHT_DIR`` is set, so interactive runs and tests stay
  untouched.

Everything is inert under ``ATPU_TELEMETRY=0`` /
``telemetry.set_enabled(False)``: ``record`` returns on a boolean check and
no threads or hooks are created.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from ..logging import get_logger
from .metrics import MetricsRegistry, enabled, get_registry

logger = get_logger(__name__)

__all__ = [
    "FlightRecorder",
    "StallDetector",
    "get_flight_recorder",
    "install_crash_hooks",
    "all_thread_stacks",
]

#: Environment variable naming the directory for crash/stall JSON artifacts.
FLIGHT_DIR_ENV = "ATPU_FLIGHT_DIR"
#: Environment variable (seconds, float) that auto-starts a stall detector.
STALL_TIMEOUT_ENV = "ATPU_STALL_TIMEOUT"


def all_thread_stacks() -> Dict[str, List[str]]:
    """Formatted stack traces for every live Python thread, keyed by
    ``"<name> (<ident>)"``. Pure stdlib (``sys._current_frames``)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, '?')} ({ident})"
        stacks[label] = [line.rstrip("\n") for line in traceback.format_stack(frame)]
    return stacks


def _json_safe(value: Any, depth: int = 0) -> Any:
    """Best-effort conversion to JSON-encodable types. 0-d tensors become
    floats (a device read — dump paths only), unknowns become ``repr`` strings,
    non-finite floats become strings (``Infinity`` is not valid JSON)."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value if value == value and abs(value) != float("inf") else repr(value)
    if depth > 6:
        return repr(value)
    if isinstance(value, dict):
        return {str(k): _json_safe(v, depth + 1) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v, depth + 1) for v in value]
    try:
        return _json_safe(float(value), depth + 1)
    except Exception:
        return repr(value)


class FlightRecorder:
    """Bounded ring of structured events plus a progress heartbeat."""

    def __init__(
        self,
        capacity: int = 2048,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.capacity = int(capacity)
        self.clock = clock
        self.registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._dropped = 0
        self._events_total = 0
        self._last_beat: Optional[float] = None

    # -- hot path ---------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. Fields may include 0-d tensors; they are read
        only if the ring is ever dumped."""
        if not enabled():
            return
        event = {"t": self.clock(), "kind": kind}
        if fields:
            event.update(fields)
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(event)
            self._events_total += 1

    def heartbeat(self, kind: str, **fields: Any) -> None:
        """Record an event *and* mark forward progress for the stall
        detector / ``/healthz``."""
        if not enabled():
            return
        self.record(kind, **fields)
        self._last_beat = self.clock()

    def tagged(self, **tags: Any) -> "_TaggedRecorder":
        """A view that stamps ``tags`` (e.g. ``engine="e0"``) onto every
        ``record``/``heartbeat``.  Multi-replica runs (router, ``--tp-ab``,
        chaos bench) share the process-global ring; without per-source tags
        their events interleave indistinguishably."""
        return _TaggedRecorder(self, tags)

    # -- introspection ----------------------------------------------------

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the last heartbeat, or ``None`` before the first."""
        beat = self._last_beat
        return None if beat is None else max(0.0, self.clock() - beat)

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def events_total(self) -> int:
        return self._events_total

    def __len__(self) -> int:
        return len(self._ring)

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The newest ``n`` events (all, if ``None``), JSON-safe."""
        with self._lock:
            events = list(self._ring)
        if n is not None:
            events = events[-int(n):]
        return [_json_safe(e) for e in events]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # -- dumps ------------------------------------------------------------

    def dump(self, reason: str, tail: int = 256) -> Dict[str, Any]:
        """Assemble the full forensic dump: stacks, ring tail, metrics."""
        try:
            metrics = _json_safe(self.registry.snapshot())
        except Exception as exc:
            metrics = {"error": repr(exc)}
        return {
            "reason": reason,
            "unix_time": time.time(),
            "pid": os.getpid(),
            "heartbeat_age_s": self.heartbeat_age(),
            "events_total": self._events_total,
            "dropped": self._dropped,
            "events": self.tail(tail),
            "stacks": all_thread_stacks(),
            "metrics": metrics,
        }

    def log_dump(self, dump: Dict[str, Any]) -> None:
        """Emit a dump through the multiprocess logger (every process — a
        stall is usually one straggler host, not the main one)."""
        lines = [f"flight recorder dump: {dump['reason']}"]
        lines.append(
            f"  heartbeat_age={dump['heartbeat_age_s']} events={dump['events_total']} "
            f"dropped={dump['dropped']}"
        )
        for event in dump["events"][-16:]:
            lines.append(f"  event {event}")
        for name, frames in dump["stacks"].items():
            lines.append(f"  -- thread {name} --")
            lines.extend(f"  {frame}" for frame in frames)
        logger.warning("\n".join(lines), main_process_only=False)

    def write_artifact(
        self, dump: Dict[str, Any], directory: Optional[str] = None,
        prefix: str = "flight",
    ) -> Optional[str]:
        """Write ``dump`` as JSON under ``directory`` (default:
        ``$ATPU_FLIGHT_DIR``). Returns the path, or ``None`` when no
        directory is configured or the write fails.  ``prefix`` names the
        artifact kind — stall/crash dumps keep ``flight``; SLO diagnostic
        bundles (:mod:`.diagnostics`) write ``slo`` so an operator can tell
        the two apart in a shared directory."""
        directory = directory or os.environ.get(FLIGHT_DIR_ENV)
        if not directory:
            return None
        try:
            os.makedirs(directory, exist_ok=True)
            stem = f"{prefix}-{os.getpid()}-{int(time.time() * 1000)}"
            path = os.path.join(directory, f"{stem}.json")
            seq = 0
            while os.path.exists(path):  # same-millisecond artifacts
                seq += 1
                path = os.path.join(directory, f"{stem}-{seq}.json")
            with open(path, "w") as fh:
                json.dump(dump, fh, indent=1, default=repr)
            return path
        except Exception:
            logger.warning("flight recorder artifact write failed", exc_info=True)
            return None


class _TaggedRecorder:
    """Thin view over a :class:`FlightRecorder` that stamps fixed fields onto
    every event.  Explicit per-call fields win over the tag on collision, and
    everything else (``tail``, ``dump``, ``heartbeat_age`` …) forwards to the
    underlying recorder, so the view drops in anywhere a recorder is passed."""

    __slots__ = ("_recorder", "_tags")

    def __init__(self, recorder: FlightRecorder, tags: Dict[str, Any]):
        self._recorder = recorder
        self._tags = dict(tags)

    def record(self, kind: str, **fields: Any) -> None:
        self._recorder.record(kind, **{**self._tags, **fields})

    def heartbeat(self, kind: str, **fields: Any) -> None:
        self._recorder.heartbeat(kind, **{**self._tags, **fields})

    def tagged(self, **tags: Any) -> "_TaggedRecorder":
        return _TaggedRecorder(self._recorder, {**self._tags, **tags})

    def __getattr__(self, name: str) -> Any:
        return getattr(self._recorder, name)

    def __len__(self) -> int:
        return len(self._recorder)


class StallDetector:
    """Watches a :class:`FlightRecorder` heartbeat; dumps once per stall.

    ``check()`` is the whole state machine and takes no locks beyond the
    recorder's — tests drive it directly with a fake clock; production runs
    call :meth:`start` for a daemon thread polling every ``interval_s``.
    """

    def __init__(
        self,
        recorder: FlightRecorder,
        timeout_s: float,
        interval_s: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.recorder = recorder
        self.timeout_s = float(timeout_s)
        self.interval_s = (
            float(interval_s) if interval_s is not None else max(0.5, timeout_s / 4.0)
        )
        self.clock = clock if clock is not None else recorder.clock
        self.dumps = 0
        self.last_dump: Optional[Dict[str, Any]] = None
        self._tripped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self) -> bool:
        """Run one detection pass; returns True iff a dump was produced."""
        if not enabled():
            return False
        age = self.recorder.heartbeat_age()
        if age is None:
            # No heartbeat yet — startup/compile, not a stall.
            return False
        if age < self.timeout_s:
            self._tripped = False
            return False
        if self._tripped:
            return False
        self._tripped = True
        self.dumps += 1
        try:
            self.recorder.registry.counter(
                "flight/stalls_total", help="Stall-detector dumps produced."
            ).inc()
        except Exception:
            pass
        dump = self.recorder.dump(
            reason=f"stall: no progress heartbeat for {age:.1f}s "
            f"(timeout {self.timeout_s:.1f}s)"
        )
        self.last_dump = dump
        self.recorder.log_dump(dump)
        self.recorder.write_artifact(dump)
        return True

    def start(self) -> "StallDetector":
        if self._thread is None and enabled():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="atpu-stall-detector", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # never kill the watchdog thread
                logger.warning("stall detector check failed", exc_info=True)


# -- process-wide default -------------------------------------------------

_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_DETECTOR: Optional[StallDetector] = None
_HOOKS_INSTALLED = False
_HOOKS_LOCK = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder. First call honours ``ATPU_FLIGHT_DIR``
    (installs crash hooks) and ``ATPU_STALL_TIMEOUT`` (starts a detector)."""
    global _DEFAULT, _DEFAULT_DETECTOR
    if _DEFAULT is None:
        _DEFAULT = FlightRecorder()
        if enabled():
            if os.environ.get(FLIGHT_DIR_ENV):
                install_crash_hooks(_DEFAULT)
            timeout = os.environ.get(STALL_TIMEOUT_ENV)
            if timeout:
                try:
                    _DEFAULT_DETECTOR = StallDetector(_DEFAULT, float(timeout)).start()
                except (TypeError, ValueError):
                    logger.warning(
                        "ignoring invalid %s=%r", STALL_TIMEOUT_ENV, timeout
                    )
    return _DEFAULT


def install_crash_hooks(recorder: Optional[FlightRecorder] = None) -> bool:
    """Install ``sys.excepthook`` + ``atexit`` writers that persist a flight
    dump to ``ATPU_FLIGHT_DIR`` when the process dies. Idempotent; returns
    True if hooks are (now) installed."""
    global _HOOKS_INSTALLED
    if not enabled():
        return False
    with _HOOKS_LOCK:
        if _HOOKS_INSTALLED:
            return True
        rec = recorder if recorder is not None else get_flight_recorder()
        state = {"written": False}

        def _write(reason: str) -> None:
            if state["written"]:
                return
            state["written"] = True
            dump = rec.dump(reason)
            path = rec.write_artifact(dump)
            if path:
                logger.warning(
                    "flight recorder artifact written to %s",
                    path,
                    main_process_only=False,
                )

        previous_hook = sys.excepthook

        def _excepthook(exc_type, exc, tb):
            try:
                _write(f"uncaught exception: {exc_type.__name__}: {exc}")
            finally:
                previous_hook(exc_type, exc, tb)

        sys.excepthook = _excepthook
        atexit.register(lambda: _write("atexit"))
        _HOOKS_INSTALLED = True
        return True
