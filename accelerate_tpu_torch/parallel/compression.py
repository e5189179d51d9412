"""PowerSGD gradient compression over the ``dp`` axis.

Port of :mod:`accelerate_tpu.parallel.compression` (Vogels et al.,
NeurIPS 2019).  Each data-parallel rank holds its own gradient; instead of
all-reducing it, rank-``r`` factors are::

    M  = local grad as (m, n) + this rank's error feedback
    P  = mean over dp of M @ Q          # (m, r) on the wire
    P  = orthonormalize(P)              # thin QR, f32
    Q' = mean over dp of M^T @ P        # (n, r) on the wire
    G  = P @ Q'^T                       # the same on every rank
    error = M - G                       # stays on this rank

so ``r (m + n)`` floats move per matrix instead of ``m n``.  ``Q`` is warm-
started across steps; ``r >= min(m, n)`` reproduces the exact mean.  Leaves
under ``min_compression_size`` elements and 1-D leaves go uncompressed.

The JAX package runs this inside ``shard_map`` with a per-replica error
buffer sharded over ``dp``; here each process is its replica, so the error
buffer is simply local and the two means are ``all_reduce`` averages over
the ``dp`` group.  The warm-start ``q`` comes from a torch generator seeded
with ``seed`` (the JAX package draws it from ``PRNGKey(0)``, which torch
cannot repeat: tests carry the JAX state across as they carry weights).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import all_reduce_


def _matrix_shape(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(m, n): the trailing dim stays, the leading ones merge."""
    return math.prod(shape[:-1]), shape[-1]


def is_compressible(shape: Tuple[int, ...], rank: int, min_size: int) -> bool:
    """2-D-able leaves of at least ``min_size`` elements compress; 1-D
    leaves (biases, norms) never do."""
    if len(shape) < 2:
        return False
    m, n = _matrix_shape(tuple(shape))
    return m * n >= min_size


def powersgd_init(params: Dict[str, torch.Tensor], *, rank: int = 4,
                  min_compression_size: int = 4096, seed: int = 0
                  ) -> Dict[str, Optional[Dict[str, torch.Tensor]]]:
    """Per-leaf state: ``{"q": (n, r) f32, "error": (m, n) f32 zeros}`` for
    compressible leaves, ``None`` for the others; ``q`` is normal, drawn
    leaf by leaf from one generator seeded with ``seed`` on the leaves'
    device."""
    out: Dict[str, Optional[Dict[str, torch.Tensor]]] = {}
    gens: Dict[torch.device, torch.Generator] = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        if not is_compressible(shape, rank, min_compression_size):
            out[name] = None
            continue
        m, n = _matrix_shape(shape)
        r = min(rank, m, n)
        gen = gens.get(p.device)
        if gen is None:
            gen = gens[p.device] = torch.Generator(device=p.device)
            gen.manual_seed(int(seed))
        out[name] = {"q": torch.randn((n, r), generator=gen, device=p.device),
                     "error": torch.zeros((m, n), dtype=torch.float32, device=p.device)}
    return out


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Thin QR of an (m, r) matrix in f32; the Q factor."""
    q, _ = torch.linalg.qr(p.float(), mode="reduced")
    return q


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return all_reduce_(x, group) / dist.get_world_size(group)


def compressed_pmean(grads: Dict[str, torch.Tensor],
                     comm_state: Dict[str, Optional[Dict[str, torch.Tensor]]], group
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[dict]]]:
    """The mean of ``grads`` over ``group`` (``None``: one rank), through
    rank-r factors for leaves with state and whole for the others.  Returns
    ``(mean grads, new state)``: the means are the same on every rank, the
    error feedback is this rank's."""
    new_grads, new_state = {}, {}
    for name, g in grads.items():
        st = comm_state.get(name)
        if st is None:
            new_grads[name] = _pmean(g.clone(), group)
            new_state[name] = None
            continue
        shape = tuple(g.shape)
        m, n = _matrix_shape(shape)
        mat = g.reshape(m, n).float() + st["error"]
        p = _orthonormalize(_pmean(mat @ st["q"], group))
        q_new = _pmean(mat.T @ p, group)
        approx = p @ q_new.T
        new_grads[name] = approx.reshape(shape).to(g.dtype)
        new_state[name] = {"q": q_new, "error": mat - approx}
    return new_grads, new_state


def compression_stats(params: Dict[str, torch.Tensor],
                      comm_state: Optional[Dict[str, Optional[dict]]]) -> Dict[str, float]:
    """Floats on the wire per step with and without compression."""
    full = compressed = 0
    for name, p in params.items():
        size = int(p.numel())
        full += size
        st = None if comm_state is None else comm_state.get(name)
        if st is None:
            compressed += size
        else:
            n, r = st["q"].shape
            compressed += r * (size // n + n)
    return {"floats_uncompressed": float(full), "floats_compressed": float(compressed),
            "compression_ratio": float(full) / max(float(compressed), 1.0)}


__all__ = ["compressed_pmean", "compression_stats", "is_compressible", "powersgd_init"]
