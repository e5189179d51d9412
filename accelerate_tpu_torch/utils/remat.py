"""Rematerialization (activation checkpointing) with the JAX package's policies.

The reference wraps a layer, or the whole loss, in ``jax.checkpoint`` with a
policy naming which intermediates the backward may keep; the rest is
recomputed.  Here the same wrap is ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``, and a policy other than "save nothing" is a
selective-checkpoint context whose policy function sees every ATen op of
the wrapped forward:

==================================== =================================================
policy                               saved for the backward
==================================== =================================================
``full``, ``nothing_saveable``       nothing inside the wrap (its inputs only)
``dots_saveable``                    the outputs of ``mm``/``addmm``/``bmm``/``_scaled_mm``
``dots_with_no_batch_dims_saveable`` the 2-D products only (``mm``/``addmm``/``_scaled_mm``)
``proj_saveable``                    the products made inside a ``tag("proj_out")``
                                     scope: the projections the model tags (q, k, v,
                                     o, gate, down); ``up_proj`` is tagged
                                     ``"proj_wide"`` and recomputed
``everything_saveable``              everything: no wrap at all
==================================== =================================================

A kernel launched through ``ctypes`` inside an ``autograd.Function`` (the
flash forward, K3) is no ATen op, so no policy can save it: it is launched
again in the recompute, and the tensors it saved come from that launch.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
import torch.utils.checkpoint as torch_checkpoint

_aten = torch.ops.aten
#: the 2-D products (``dots_with_no_batch_dims_saveable``)
_DOTS_2D = frozenset({_aten.mm.default, _aten.addmm.default, _aten._scaled_mm.default})
#: every product (``dots_saveable``, ``proj_saveable`` inside a tag)
_DOTS = _DOTS_2D | {_aten.bmm.default, _aten.baddbmm.default}

#: policy name -> the ops whose outputs it saves (None: save nothing), in the
#: order of the reference's table (``accelerate_tpu/accelerator.py:1130-1143``)
_SAVED_OPS = {
    "full": None,
    "nothing_saveable": None,
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_2D,
    "everything_saveable": None,
    "proj_saveable": _DOTS,
}
#: the policies over the whole loss (``CompilationConfig.remat_policy``,
#: beside ``"none"``)
POLICIES = tuple(_SAVED_OPS)
#: the per-layer policies (``TransformerConfig.remat_policy``): the
#: reference's per-layer table has no ``everything_saveable``
#: (``accelerate_tpu/models/transformer.py:51-69``)
LAYER_POLICIES = tuple(p for p in POLICIES if p != "everything_saveable")

# the innermost tag of this thread (the recompute runs on the backward's
# thread, and tags its ops the same way there)
_local = threading.local()


@contextlib.contextmanager
def tag(name: str):
    """Name the products made inside the block (``checkpoint_name`` of the
    reference): ``"proj_out"`` outputs are what ``proj_saveable`` keeps."""
    outer = getattr(_local, "tag", None)
    _local.tag = name
    try:
        yield
    finally:
        _local.tag = outer


def _policy_fn(name: str, ctx, op, *args, **kwargs):
    ops = _SAVED_OPS[name]
    save = op in ops and (name != "proj_saveable" or getattr(_local, "tag", None) == "proj_out")
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if save
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def check_policy(name: str, per_layer: bool = False) -> None:
    """Raise for a policy name the reference does not know, with its
    message: its ``TransformerConfig``'s (``per_layer``) or its
    ``Accelerator._maybe_remat``'s."""
    if per_layer:
        if name not in LAYER_POLICIES:
            raise ValueError(f"Unknown remat_policy {name!r}; "
                             f"choose from {sorted(LAYER_POLICIES)}")
    elif name not in POLICIES:
        raise ValueError(f"Unknown remat_policy {name!r}; expected one of {['none', *POLICIES]}")


def context_fn(name: str) -> Optional[Callable]:
    """The selective-checkpoint ``context_fn`` of policy ``name`` (None
    where the policy saves nothing inside the wrap)."""
    check_policy(name)
    if _SAVED_OPS[name] is None:
        return None
    return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                             functools.partial(_policy_fn, name))


def remat(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)`` under activation checkpointing with ``policy``: the
    backward recomputes what the policy does not save.  Values and
    gradients are those of ``fn(*args)`` itself."""
    check_policy(policy)
    if policy == "everything_saveable":
        return fn(*args)
    ctx = context_fn(policy)
    kw = {} if ctx is None else {"context_fn": ctx}
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)
