"""The driver: single-threaded engine ownership behind a thread-safe inbox.

Port of :mod:`accelerate_tpu.serving.api.frontdoor`.  The engine's host
state (scheduler deques, lane arrays, block tables, the prefix-cache radix
tree) is mutated without locks by design, and every call on the card
(window and chunk replays, migrations, readbacks) happens on ONE thread.  A ``ThreadingHTTPServer`` hands each
request its own thread, so the front door needs a crossing point, and this
module is it: :class:`FrontDoor` owns a driver thread that is the *only*
thread ever calling into the :class:`~accelerate_tpu.serving.router.
ReplicaRouter` or its engines.  Handler threads interact exclusively
through:

* :meth:`submit` / :meth:`cancel` / :meth:`hot_swap` / :meth:`add_replica` /
  :meth:`drain_replica` — synchronous *tickets*: the closure is queued, the
  driver runs it between engine steps, and the caller's thread blocks on an
  event until the result (or the raised ``AdmissionError``) comes back.
* :class:`TokenStream` — a per-request ``queue.Queue`` the driver feeds from
  the engine's ``on_token`` callback and closes when the request reaches
  ``DONE``/``CANCELLED``; handler threads only ever *read* it.

Handler threads therefore make no CUDA call: one made while the driver
captures a CUDA graph would break the capture.  PyTorch keeps the current
device and stream per thread, so the driver thread sets both to its
replicas' card (the device's default stream, where the engines replay)
before its first step.

The driver loop also emits the ``serve/step`` heartbeat while idle (an idle
API server is a healthy one — without this, ``/healthz`` would go stale-503
the moment traffic pauses) and reaps finished requests into their streams.

Over processes (a :class:`ReplicaRouter` whose replicas are tensor-parallel
engines or lie on other ranks, one process a card): every rank builds the
same router and a front door over it.  World rank 0 runs the
:class:`~.server.ApiServer` and the driver thread (:meth:`start`); every
other rank calls :meth:`follow`, which returns when rank 0 stops.  Each
driver iteration that has tickets or work begins with a broadcast from rank
0 of its tickets (what each does, not the closure) and its clock; every
rank then applies them in order and steps the router if it has work, so
every rank makes the same calls.  An idle driver still sends an empty
iteration with each idle heartbeat, every ``heartbeat_interval_s`` (a
follower waits in that broadcast, and a gloo collective times out after 30
minutes).  The tickets whose payload is weights or an engine
(:meth:`hot_swap`, :meth:`add_replica`) run on every rank with what each
rank supplies for itself: pass each follower's front door ``supply(op,
arg)``, which returns the full weights for ``("hot_swap", version)`` and,
for ``("add_replica", n)`` (the n-th replica added, from 0), the engine
where that rank serves it, else its mesh.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ...logging import get_logger
from ...models.generation import GenerationConfig
from ...telemetry import get_flight_recorder, get_reqtrace, slo_tick
from ..errors import AdmissionError, DeadlineExceeded
from ..router import ReplicaRouter
from ..scheduler import Request, RequestState
from .protocol import CompletionCall

logger = get_logger(__name__)

__all__ = ["FrontDoor", "TokenStream"]

#: Sentinel queued into a TokenStream when the producer side closes.
_CLOSED = object()


class TokenStream:
    """One request's token feed across the thread boundary.

    The driver thread is the only producer (``push`` per token, ``close``
    once, at completion/cancellation); any number of handler-side consumers
    may ``get`` or ``wait_done``.  After ``close``, ``final_tokens`` /
    ``final_state`` are the authoritative snapshot — handler threads never
    read the live ``Request`` object the engine is still mutating.
    """

    def __init__(self, rid: int):
        self.rid = rid
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self.final_tokens: List[int] = []
        self.final_state: Optional[RequestState] = None
        self.error: Optional[BaseException] = None

    # ---- driver side -----------------------------------------------------
    def push(self, token: int) -> None:
        self._q.put(int(token))

    def close(self, tokens: List[int], state: Optional[RequestState],
              error: Optional[BaseException] = None) -> None:
        self.final_tokens = list(tokens)
        self.final_state = state
        self.error = error
        self._done.set()
        self._q.put(_CLOSED)

    # ---- handler side ----------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token, or ``None`` when the stream is closed (drain any
        tokens queued before the close first).  Raises ``queue.Empty`` on
        timeout."""
        item = self._q.get(timeout=timeout)
        return None if item is _CLOSED else item

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class _Ticket:
    """One closure to run on the driver thread, plus the rendezvous; over
    processes, ``wire`` says what it does for the followers."""

    __slots__ = ("fn", "admin", "wire", "event", "result", "error")

    def __init__(self, fn: Callable[[], Any], admin: bool, wire: Optional[tuple] = None):
        self.fn = fn
        self.admin = admin
        self.wire = wire
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class FrontDoor:
    """Owns the router + driver thread; the API server's only way in.

    Parameters
    ----------
    router: the (elastic) replica backend.  The front door takes over
        driving it — nothing else may call ``router.step()`` once
        :meth:`start` runs.
    model_name: the id served by ``/v1/models``; requests may pin a weights
        version as ``"<model_name>@<version>"``.
    idle_sleep_s: driver nap between polls when there is no work and no
        tickets (keeps the idle loop off a CPU core).
    heartbeat_interval_s: cadence of the idle ``serve/step`` heartbeat;
        over processes also the longest an idle driver goes without an
        iteration for the followers.
    ticket_timeout_s: how long a handler thread waits for the driver to pick
        up its ticket before giving up (a driver wedged in device work this
        long means the stall detector is about to fire anyway).
    supply: over processes, on a follower: ``supply(op, arg)`` returns this
        rank's weights for a ``hot_swap`` and its entry for an
        ``add_replica`` (the module docstring).
    """

    def __init__(
        self,
        router: ReplicaRouter,
        model_name: str = "accelerate-tpu",
        idle_sleep_s: float = 0.001,
        heartbeat_interval_s: float = 1.0,
        ticket_timeout_s: float = 120.0,
        supply: Optional[Callable[[str, Any], Any]] = None,
    ):
        self.router = router
        #: over processes: the router's world exchange (None in one process)
        self._world = router._world
        self.supply = supply
        self._added = 0
        self.model_name = str(model_name)
        self.idle_sleep_s = float(idle_sleep_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.ticket_timeout_s = float(ticket_timeout_s)
        self.recorder = get_flight_recorder().tagged(engine="frontdoor")
        self._tickets: "queue.Queue[_Ticket]" = queue.Queue()
        # keyed by a front-door-minted id, NOT ``req.rid``: engine rids are
        # per-replica counters (and rewritten by failover adoption), so two
        # replicas' rids collide here and the clobbered entry's stream would
        # never be reaped — its handler would hang until the client timeout
        self._next_key = 0
        self._outstanding: Dict[int, Tuple[Request, TokenStream]] = {}
        self._stop = threading.Event()
        self._in_admin = False
        self._thread: Optional[threading.Thread] = None
        self._last_heartbeat = 0.0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FrontDoor":
        if self._thread is not None:
            raise RuntimeError("FrontDoor already started")
        if self._world is not None and self._world.rank != 0:
            raise RuntimeError(f"rank {self._world.rank} follows the driver on rank 0: call "
                               "follow()")
        self._thread = threading.Thread(
            target=self._drive, name="atpu-frontdoor-driver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # ---------------------------------------------------- handler-side API
    def _call(self, fn: Callable[[], Any], admin: bool = False,
              wire: Optional[tuple] = None) -> Any:
        """Run ``fn`` on the driver thread; block until it completes."""
        if self._thread is None:
            raise RuntimeError("FrontDoor is not running (call start())")
        if threading.current_thread() is self._thread:
            if self._world is not None:
                raise RuntimeError("over processes every router call is a ticket the "
                                   "followers apply too: call it from another thread")
            return fn()  # already on the driver: run inline, never deadlock
        t = _Ticket(fn, admin, wire)
        self._tickets.put(t)
        if not t.event.wait(self.ticket_timeout_s):
            raise TimeoutError(
                f"driver did not service the request within "
                f"{self.ticket_timeout_s}s"
            )
        if t.error is not None:
            raise t.error
        return t.result

    def submit(self, call: CompletionCall,
               model_version: Optional[str] = None) -> Tuple[Request, TokenStream]:
        """Queue one validated call; returns the live request handle plus its
        token stream.  Raises :class:`AdmissionError` exactly as the router
        does (queue full / capacity / no replica for the pinned version)."""
        gen_kw = dict(
            max_new_tokens=int(call.max_tokens),
            do_sample=call.temperature > 0.0,
            temperature=call.temperature if call.temperature > 0.0 else 1.0,
            top_k=call.top_k,
            top_p=call.top_p,
            eos_token_id=call.stop_token_id,
        )
        gen = GenerationConfig(**gen_kw)

        def _do() -> Tuple[Request, TokenStream]:
            stream_box: List[TokenStream] = []

            def on_token(req: Request, token: int) -> None:
                stream_box[0].push(token)

            req = self.router.submit(
                call.prompt, config=gen, on_token=on_token,
                model_version=model_version, deadline_s=call.deadline_s,
                tenant=call.tenant,
            )
            self._next_key += 1
            stream = TokenStream(self._next_key)
            stream_box.append(stream)
            self._outstanding[stream.rid] = (req, stream)
            # the front-door key becomes the trace's authoritative id: it is
            # what the API server echoes as X-Request-Id, and unlike the
            # engine rid it never changes across failover adoption
            get_reqtrace().rekey(req.trace, str(stream.rid))
            return req, stream

        return self._call(_do, wire=("submit", call.prompt, gen_kw, model_version,
                                     call.deadline_s, call.tenant))

    def cancel(self, rid: int) -> bool:
        """Cancel by front-door request id — the ``stream.rid`` handed back
        from :meth:`submit` and echoed to clients (queued or running).  The
        stream closes on the driver's next reap pass."""

        def _do() -> bool:
            entry = self._outstanding.get(rid)
            if entry is None:
                return False
            req, stream = entry
            ok = self.router.cancel(req)
            # a request the engine already finished can't be cancelled, but
            # either way the stream resolves on the next reap
            self._reap()
            return ok

        return self._call(_do, wire=("cancel", rid))

    def hot_swap(self, params: Any, version: Optional[str] = None) -> int:
        """Rolling zero-downtime weight swap across every replica (see
        :meth:`ReplicaRouter.hot_swap`).  Blocks the calling thread until
        the rollout completes; in-flight and newly submitted requests keep
        being served throughout — the drain loop keeps pumping the inbox."""
        return self._call(
            lambda: self.router.hot_swap(params, version=version,
                                         step_fn=self._pump),
            admin=True, wire=("hot_swap", version),
        )

    def add_replica(self, engine) -> int:
        """Attach a replica.  ``engine`` is a built :class:`ServingEngine`,
        or a callable that builds one: it then runs on the driver thread,
        so that the engine's graphs are captured there, with nothing else
        on the card in between.  Over processes: this rank's entry (the
        engine where rank 0 serves the replica, else its mesh); each
        follower's ``supply("add_replica", n)`` gives its own."""
        def _do() -> int:
            built = engine() if callable(engine) else engine
            return self.router.add_replica(built)

        n = self._added
        self._added += 1
        return self._call(_do, admin=True, wire=("add_replica", n))

    def drain_replica(self, replica_id: int) -> None:
        return self._call(
            lambda: self.router.drain_replica(replica_id), admin=True,
            wire=("drain_replica", replica_id),
        )

    def migrate_lane(
        self,
        from_replica: Optional[int] = None,
        to_replica: Optional[int] = None,
        slot: Optional[int] = None,
        reason: str = "rebalance",
    ) -> bool:
        """Live-rebalance one running lane between replicas
        (:meth:`ReplicaRouter.migrate_lane`) — an admin ticket, so the move
        runs on the driver thread between steps, never mid-window."""
        return self._call(
            lambda: self.router.migrate_lane(
                from_replica=from_replica, to_replica=to_replica,
                slot=slot, reason=reason,
            ),
            admin=True, wire=("migrate_lane", from_replica, to_replica, slot, reason),
        )

    def lookup(self, rid: int) -> Optional[Tuple[Request, TokenStream]]:
        """Read-only peek at an outstanding request (DELETE-cancel routing).
        The tuple is a snapshot; only :class:`TokenStream` may be consumed
        from handler threads."""
        return self._outstanding.get(rid)

    def health(self) -> dict:
        """Router aggregation for ``/healthz`` — plain host-side counters
        (ints/bools), safe to read from any thread."""
        return self.router.health()

    def model_versions(self) -> dict:
        return self.router.versions()

    def resolve_model(self, model: Optional[str]) -> Optional[str]:
        """Map the wire ``model`` string to a weights-version pin: ``None``
        or the bare served name routes anywhere; ``"<name>@<version>"``
        (or a bare version label) pins.  Unknown names raise
        :class:`AdmissionError` (non-retriable → 400/404 at the edge)."""
        if model is None or model == "" or model == self.model_name:
            return None
        version = model
        if model.startswith(self.model_name + "@"):
            version = model[len(self.model_name) + 1:]
        if version in self.router.versions():
            return version
        raise AdmissionError(
            f"model {model!r} not found (serving {self.model_name!r}, "
            f"versions {sorted(self.router.versions())})",
            retriable=False,
        )

    # ------------------------------------------------------------- driver
    def _reap(self) -> None:
        """Close the streams of every finished/cancelled request.  Runs on
        the driver thread only."""
        finished = [
            rid for rid, (req, _) in self._outstanding.items()
            if req.state in (RequestState.DONE, RequestState.CANCELLED)
        ]
        for rid in finished:
            req, stream = self._outstanding.pop(rid)
            if stream is None:
                continue  # a follower's: rank 0 streams it
            if req.deadline_exceeded:
                # the engine's deadline sweep cancelled it — close with the
                # typed error so the edge answers 504, not a silent truncation
                stream.close(
                    req.tokens, req.state,
                    error=DeadlineExceeded(
                        f"request {rid} exceeded its {req.deadline_s}s "
                        f"deadline after {len(req.tokens)} tokens",
                        deadline_s=req.deadline_s or 0.0,
                    ),
                )
            else:
                stream.close(req.tokens, req.state)

    def _take_tickets(self, skip_admin: bool) -> List[_Ticket]:
        taken: List[_Ticket] = []
        deferred: List[_Ticket] = []
        while True:
            try:
                t = self._tickets.get_nowait()
            except queue.Empty:
                break
            if skip_admin and t.admin:
                # an admin op is already in progress on this stack (we are
                # inside its drain loop); run nested admin ops after it
                deferred.append(t)
                continue
            taken.append(t)
        for t in deferred:
            self._tickets.put(t)
        return taken

    def _iterate(self, skip_admin: bool = False, always: bool = False) -> bool:
        """One drive iteration: service the inbox, step the replicas if they
        have work, resolve finished requests.  Over processes it first goes
        to the followers (tickets and clock), unless it would do nothing
        (``always``: the idle heartbeat's iteration, and the hot-swap drain
        hook, whose calls the followers count).  Returns whether the router
        stepped."""
        tickets = self._take_tickets(skip_admin)
        if self._world is not None:
            now = time.monotonic()
            self.router._world_now = max(self.router._world_now, now)
            if not (always or tickets or self.router.has_work):
                return False
            self._world.bcast(("run", [t.wire for t in tickets], now), src=0)
        for t in tickets:
            try:
                t.result = t.fn()
            except BaseException as exc:  # propagate to the waiting thread
                t.error = exc
            finally:
                t.event.set()
        worked = False
        if self.router.has_work:
            self.router.step()
            worked = True
        self._reap()
        return worked

    def _pump(self) -> None:
        """One drive iteration with admin ops deferred — the hot-swap drain
        hook, which must keep accepting submits without re-entering another
        rollout."""
        self._iterate(skip_admin=True, always=True)

    # --------------------------------------------------------- followers
    def follow(self) -> None:
        """Over processes, on every rank but 0: apply each iteration rank
        0's driver sends, until it stops (:meth:`stop` there)."""
        if self._world is None or self._world.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a router over "
                               "processes; rank 0 runs start()")
        self._bind_device()
        while self._follow_once():
            pass
        self._outstanding.clear()

    def _follow_once(self) -> bool:
        """One of rank 0's iterations, here; ``False`` once it stopped."""
        msg = self._world.bcast(None, src=0)
        if msg[0] == "stop":
            return False
        _, wires, now = msg
        self.router._world_now = max(self.router._world_now, now)
        for wire in wires:
            try:
                self._apply(wire)
            except Exception as exc:  # noqa: BLE001 (rank 0's caller gets it)
                logger.debug("follower ticket %r failed: %r", wire[0], exc)
        try:
            if self.router.has_work:
                self.router.step()
            self._reap()
        except Exception as exc:  # noqa: BLE001 (raised alike on every rank)
            self._outstanding.clear()
            logger.debug("follower step failed: %r", exc)
        return True

    def _apply(self, wire: tuple) -> None:
        """A ticket rank 0 ran, on a follower: the same router call."""
        op, *args = wire
        if op == "submit":
            prompt, gen_kw, model_version, deadline_s, tenant = args
            req = self.router.submit(prompt, config=GenerationConfig(**gen_kw),
                                     model_version=model_version, deadline_s=deadline_s,
                                     tenant=tenant)
            self._next_key += 1
            self._outstanding[self._next_key] = (req, None)
        elif op == "cancel":
            entry = self._outstanding.get(args[0])
            if entry is not None:
                self.router.cancel(entry[0])
                self._reap()
        elif op == "hot_swap":
            self.router.hot_swap(self._supplied("hot_swap", args[0]), version=args[0],
                                 step_fn=self._follow_once)
        elif op == "add_replica":
            self.router.add_replica(self._supplied("add_replica", args[0]))
        elif op == "drain_replica":
            self.router.drain_replica(args[0])
        elif op == "migrate_lane":
            self.router.migrate_lane(*args)
        else:
            raise ValueError(f"unknown ticket {op!r}")

    def _supplied(self, op: str, arg: Any) -> Any:
        if self.supply is None:
            raise RuntimeError(f"a {op} ticket needs this rank's own payload: pass "
                               "FrontDoor(..., supply=) on every follower")
        return self.supply(op, arg)

    def _fail_outstanding(self, exc: BaseException) -> None:
        """An engine step blew up: every in-flight request's stream is closed
        with the error (handlers turn it into a 500) instead of stranding its
        handler thread until the request timeout.  The driver keeps running —
        later submits get a fresh, fast error rather than a dead socket."""
        logger.exception("front door driver step failed: %r", exc)
        self.recorder.record("serve/driver_error", error=repr(exc),
                             outstanding=len(self._outstanding))
        for rid, (req, stream) in list(self._outstanding.items()):
            stream.close(req.tokens, req.state, error=exc)
            self._outstanding.pop(rid, None)

    def _bind_device(self) -> None:
        """Make the replicas' card this thread's current device, and its
        default stream the current stream (both are per thread)."""
        for engine in self.router.engines:
            if getattr(engine, "device", None) is not None and engine.device.type == "cuda":
                torch.cuda.set_device(engine.device)
                torch.cuda.set_stream(torch.cuda.default_stream(engine.device))
                return

    def _drive(self) -> None:
        self._bind_device()
        while not self._stop.is_set():
            worked = False
            beat = time.monotonic() - self._last_heartbeat >= self.heartbeat_interval_s
            try:
                # the heartbeat's iteration goes to the followers even when
                # idle: they wait in its broadcast
                worked = self._iterate(always=beat)
            except Exception as exc:
                self._fail_outstanding(exc)
            if beat:
                # stepping engines heartbeat on their own; the idle server
                # must too, or /healthz would 503 between requests
                self.recorder.heartbeat(
                    "serve/step",
                    idle=not worked,
                    outstanding=len(self._outstanding),
                )
                self._last_heartbeat = time.monotonic()
                # fleet-health tick rides the heartbeat: samples the
                # time-series ring and re-evaluates installed SLOs even
                # while the server is idle (an idle replica can still be
                # burning availability budget on sheds it just served)
                slo_tick()
            if not worked and self._tickets.empty():
                time.sleep(self.idle_sleep_s)
        if self._world is not None:
            self._world.bcast(("stop",), src=0)
        # drain: fail any still-waiting tickets rather than strand threads
        while True:
            try:
                t = self._tickets.get_nowait()
            except queue.Empty:
                break
            t.error = RuntimeError("front door stopped")
            t.event.set()
        for rid, (req, stream) in list(self._outstanding.items()):
            stream.close(req.tokens, req.state)
            self._outstanding.pop(rid, None)
