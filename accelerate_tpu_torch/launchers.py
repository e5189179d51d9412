"""In-process launchers: ``debug_launcher`` and ``notebook_launcher``.

Port of :mod:`accelerate_tpu.launchers`.  Each spawns its ranks as fresh
interpreters (the ``spawn`` start method) with the reference's rendezvous
environment (``ACCELERATE_COORDINATOR_ADDRESS``, ``ACCELERATE_NUM_PROCESSES``,
``ACCELERATE_PROCESS_ID``, ``ACCELERATE_LOCAL_PROCESS_ID``), so that a plain
``Accelerator()`` or ``PartialState()`` inside the function joins the
process group.  ``debug_launcher`` runs its ranks on the CPU over ``gloo``;
``notebook_launcher`` runs one rank a card (over ``nccl``), and on a machine
without a card raises: the CPU is asked for with ``debug_launcher``.

Each rank joins the process group before the function runs (the
reference initializes its runtime first), so that the function sees the
whole world; a ``PartialState`` made inside takes that group.  A rank that
raises puts its traceback on a queue; the launcher waits a grace period
for the others (which may be blocked in a collective the failed rank never
joins), stops the ones still running, and raises one ``RuntimeError``
naming the failed ranks with their tracebacks; past an optional deadline
the ranks still running are stopped the same way.  Every rank leaves its
process group and resets the state singletons at its end.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import socket
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

#: seconds the other ranks get to finish after one has failed
FAILURE_GRACE_S = 20.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn: Callable, args: Tuple, env: Dict[str, str], cpu: bool, rendezvous: bool,
            error_queue) -> None:
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    from .state import AcceleratorState, GradientState

    try:
        if rendezvous:
            # the process group exists before user code, as the reference
            # initializes its runtime first: the function sees the whole
            # world whether or not it makes a state (which then takes this
            # group as it is)
            if not cpu:
                torch.cuda.set_device(int(env["ACCELERATE_LOCAL_PROCESS_ID"]))
            dist.init_process_group(
                "gloo" if cpu else "nccl",
                init_method=f"tcp://{env['ACCELERATE_COORDINATOR_ADDRESS']}",
                world_size=int(env["ACCELERATE_NUM_PROCESSES"]),
                rank=int(env["ACCELERATE_PROCESS_ID"]))
        fn(*args)
    except BaseException:
        rank = env.get("ACCELERATE_PROCESS_ID", env.get("RANK", "?"))
        error_queue.put(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        GradientState._reset_state()
        AcceleratorState._reset_state(reset_partial_state=True)
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(function: Callable, args: Tuple, envs, cpu: bool, what: str,
           rendezvous: bool = True, deadline_s: Optional[float] = None) -> None:
    """Run ``function(*args)`` in one spawned process per environment (each
    rank's own variables); ``rendezvous=False`` leaves the process group to
    the function (a ``PartialState`` with its own options).  Ranks still
    running ``deadline_s`` seconds after the start are stopped and the
    launch fails (a deadlocked collective fails rather than hangs)."""
    ctx = multiprocessing.get_context("spawn")
    error_queue = ctx.SimpleQueue()
    procs = []
    for env in envs:
        p = ctx.Process(target=_worker, args=(function, args, env, cpu, rendezvous, error_queue))
        p.start()
        procs.append(p)
    stop_at = None if deadline_s is None else time.monotonic() + deadline_s
    failing = timed_out = False
    while any(p.is_alive() for p in procs):
        for p in procs:
            p.join(timeout=0.1)
        if not failing and any(p.exitcode not in (None, 0) for p in procs):
            failing = True
            stop_at = min(stop_at or math.inf, time.monotonic() + FAILURE_GRACE_S)
        if stop_at is not None and time.monotonic() > stop_at:
            timed_out = not failing
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
    failed = [rank for rank, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        errors = []
        while not error_queue.empty():
            errors.append(error_queue.get())
        why = f" (stopped at the {deadline_s} s deadline)" if timed_out else ""
        raise RuntimeError(f"{what} workers {failed} failed{why}:\n" + "\n".join(errors))


def _envs(num_processes: int, coordinator: str, first_rank: int = 0,
          world: Optional[int] = None):
    world = num_processes if world is None else world
    return [{"ACCELERATE_COORDINATOR_ADDRESS": coordinator,
             "ACCELERATE_NUM_PROCESSES": str(world),
             "ACCELERATE_PROCESS_ID": str(first_rank + i),
             "ACCELERATE_LOCAL_PROCESS_ID": str(i)} for i in range(num_processes)]


def debug_launcher(function: Callable, args: Tuple = (), num_processes: int = 2) -> None:
    """Run ``function(*args)`` in ``num_processes`` CPU processes joined in
    one ``gloo`` process group over localhost (``accelerate_tpu/
    launchers.py:59-86``).  ``function`` and ``args`` must pickle (a
    module-level function, numpy arrays)."""
    envs = _envs(num_processes, f"127.0.0.1:{_free_port()}")
    for env in envs:
        env["ACCELERATE_USE_CPU"] = "true"
    _spawn(function, args, envs, cpu=True, what="debug_launcher")


def notebook_launcher(function: Callable, args: Tuple = (), num_processes: Optional[int] = None,
                      mixed_precision: str = "no", use_port: str = "29500",
                      master_addr: str = "127.0.0.1", node_rank: int = 0,
                      num_nodes: int = 1) -> Any:
    """Launch training from a notebook (``accelerate_tpu/launchers.py:89-129``).

    On a machine with cards: ``num_processes`` ranks (default: every card),
    one a card, over ``nccl``; more ranks than cards raises ``ValueError``
    (a rank never shares a card silently).  The kernels are built here
    first, so that the ranks do not all build them.  Across ``num_nodes``
    machines this node's ranks are ``node_rank * num_processes + i`` of a
    world of ``num_nodes * num_processes``, meeting at
    ``master_addr:use_port``.  Without a card, more than one rank raises
    ``RuntimeError`` (the CPU is :func:`debug_launcher`'s).  One
    rank on one node calls the function here (where ``Accelerator()``
    raises without a card)."""
    import torch

    if mixed_precision not in ("no", "bf16", "fp16"):
        raise ValueError(f"Unknown mixed_precision mode: {mixed_precision}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not cards and ((num_processes or 1) > 1 or num_nodes > 1):
        raise RuntimeError(f"notebook_launcher(num_processes={num_processes}, num_nodes="
                           f"{num_nodes}): no card is visible; debug_launcher runs processes "
                           "on the CPU")
    num_processes = num_processes or max(cards, 1)
    if cards and num_processes > cards:
        raise ValueError(f"notebook_launcher(num_processes={num_processes}): this machine "
                         f"has {cards} card(s), and each rank takes one of its own")
    if num_processes == 1 and num_nodes == 1:
        # the function runs here: its Accelerator reads the precision from the environment
        os.environ["ACCELERATE_MIXED_PRECISION"] = mixed_precision
        return function(*args)
    from .ops import _build

    _build.load()
    envs = _envs(num_processes, f"{master_addr}:{use_port}", first_rank=node_rank * num_processes,
                 world=num_nodes * num_processes)
    for env in envs:
        env["ACCELERATE_MIXED_PRECISION"] = mixed_precision
    _spawn(function, args, envs, cpu=False, what="notebook_launcher")
    return None
