"""Pipeline parallelism: GPipe and 1F1B micro-batch schedules over a ``pp`` mesh axis.

Port of :mod:`accelerate_tpu.parallel.pipeline`.  Each ``pp`` rank holds
one stage's decoder layers (``L / pp`` consecutive ``layers.{i}``: the
Accelerator's ``ShardedLayout`` keeps only those on the rank) and runs the
schedule's slots in step with the others; activations move one stage a
slot with :func:`~accelerate_tpu_torch.parallel.mesh.hop` /
:func:`~accelerate_tpu_torch.parallel.mesh.ppermute` (the reference's
``lax.ppermute`` inside ``lax.scan``).  The embedding and the head are
replicated, as in the reference; the first stage embeds and the last one
runs the head, and the Accelerator sums their gradients over ``pp``.

* ``"gpipe"`` (:func:`pipeline_lm_loss_fn`'s default): ``M + pp - 1``
  slots of one forward unit each; the backward is autograd's, through the
  hops, whose backward is the reverse hop.  Every hop is tied to the one
  before it, so every rank runs the hops' backwards in the same order,
  whether or not it used what it received.
* ``"1f1b"``: one pass over ``M + 2(pp - 1)`` slots in a
  :class:`torch.autograd.Function`'s forward: in each slot a stage runs the
  forward of micro-batch ``t - s`` (kept as its *input*) and the backward
  of micro-batch ``t - 2(pp - 1) + s`` (its stage recomputed from that
  input), the last stage seeding each backward from the head's gradient in
  the slot its forward ends; gradients move back a stage a slot.  A stage
  holds at most ``2(pp - 1 - s) + 1`` inputs.  The function's backward only
  scales the gradients it has by the upstream cotangent.  Cross entropy is
  normalised by the rank's whole count of labelled tokens, so each
  micro-batch's head gradient is exact.

The MoE router's aux term rides the hops with each micro-batch's
activations and enters the loss as ``coef * mean over micro-batches``.
:func:`schedule_slots` is the one source of the slot counts.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from . import mesh as mesh_lib


def schedule_slots(schedule: str, num_microbatches: int, n_stages: int) -> int:
    """Slots of a schedule: GPipe ``M + pp - 1`` (one forward unit each),
    1F1B ``M + 2(pp - 1)`` (a forward and a backward unit each)."""
    if schedule == "gpipe":
        return num_microbatches + n_stages - 1
    if schedule == "1f1b":
        return num_microbatches + 2 * (n_stages - 1)
    raise ValueError(f"Unknown pipeline schedule {schedule!r}; use 'gpipe' or '1f1b'")


def stack_layer_params(params: Dict[str, torch.Tensor], num_layers: int
                       ) -> Dict[str, torch.Tensor]:
    """The per-layer tensors ``layers.{i}.<name>`` of a name -> tensor dict
    stacked on a leading depth dim: ``<name> -> [L, ...]``."""
    names = sorted({k.split(".", 2)[2] for k in params if k.startswith("layers.0.")})
    return {n: torch.stack([params[f"layers.{i}.{n}"] for i in range(num_layers)])
            for n in names}


def layer_stage(name: str, num_layers: int, n_stages: int) -> Optional[int]:
    """The stage owning parameter ``name``: ``layers.{i}.*`` belongs to stage
    ``i // (L / pp)``; anything else to every stage (``None``)."""
    parts = name.split(".")
    if len(parts) < 2 or parts[0] != "layers" or not parts[1].isdigit():
        return None
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers do not split into {n_stages} pipeline stages")
    return int(parts[1]) // (num_layers // n_stages)


def _resolve_mesh(mesh):
    # resolved at call time: a loss built before its Accelerator binds the
    # mesh that is active when the step runs
    if mesh is not None:
        return mesh
    from ..state import PartialState

    return PartialState().mesh


def _resolve_num_microbatches(num_microbatches: Optional[int]) -> int:
    if num_microbatches is not None:
        return num_microbatches
    from ..state import AcceleratorState

    plugin = (AcceleratorState().model_parallel_plugin
              if AcceleratorState._shared_state else None)
    return plugin.num_micro_batches if plugin is not None else 8


class _Tie(torch.autograd.Function):
    """``x`` itself, depending on ``dep`` too (a zero gradient for it), so
    that ``dep``'s producers are in ``x``'s backward."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank of ``group`` (a broadcast);
    the backward keeps the last stage's own gradient (every rank's is the
    same, the output being used alike everywhere)."""

    @staticmethod
    def forward(ctx, x, group, src, is_src):
        ctx.is_src = is_src
        out = x.contiguous().clone()
        torch.distributed.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def _stage_ranks(mesh, axis: str) -> List[int]:
    """The global ranks of this rank's ``axis`` group, by ``axis`` index."""
    coord = mesh.coordinate()
    out = []
    for i in range(mesh.shape[axis]):
        c = dict(coord, **{axis: i})
        out.append(int(mesh.devices[tuple(c[a] for a in mesh.axis_names)]))
    return out


def _gpipe(stage_fn, feed, n_micro: int, act_like: torch.Tensor, group, n: int, idx: int,
           carries_aux: bool):
    """The GPipe slots on this rank.  ``feed(j)`` gives micro-batch ``j``'s
    input (stage 0 only); returns ``(outs, auxes, last)``: the last stage's
    outputs (and aux sums) by micro-batch, ``None`` elsewhere, and the last
    hop's output, which the caller ties into its loss."""
    # leaves that ask for a gradient: a rank idle in the first slot still
    # puts that hop in its backward graph
    grad = torch.is_grad_enabled()
    state = torch.zeros_like(act_like).requires_grad_(grad)
    aux_state = torch.zeros((), dtype=torch.float32, device=act_like.device).requires_grad_(grad)
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    auxes: List[Optional[torch.Tensor]] = [None] * n_micro
    prev = None
    for t in range(schedule_slots("gpipe", n_micro, n)):
        j = t - idx
        if 0 <= j < n_micro:
            inp = feed(j) if idx == 0 else state
            aux_in = torch.zeros_like(aux_state) if idx == 0 else aux_state
            if carries_aux:
                out, aux_stage = stage_fn(inp)
                aux_out = aux_in + aux_stage.float()
            else:
                out, aux_out = stage_fn(inp), aux_in
            if idx == n - 1:
                outs[j], auxes[j] = out, aux_out
        else:  # idle slot: what came in goes on, and is never used
            out, aux_out = state, aux_state
        state, aux_state = mesh_lib.hop([out, aux_out], group, 1, after=prev)
        prev = aux_state
    return outs, auxes, prev


def pipeline_apply(stage_fn: Callable, layer_params, microbatches: torch.Tensor,
                   *broadcast_args, mesh=None, axis: str = "pp", carries_aux: bool = False):
    """``stage_fn(local_layer_params, x, *broadcast_args) -> x`` as a GPipe
    pipeline over ``mesh[axis]`` (``accelerate_tpu/parallel/pipeline.py:83``).

    ``layer_params``: tensors with a leading depth dim (a dict of them, or
    one), which each stage slices to its ``L / pp`` layers;
    ``microbatches [M, mb, ...]`` and the broadcast args are the same on
    every rank.  Returns the outputs ``[M, mb, ...]`` on every rank (the
    last stage's, broadcast); with ``carries_aux`` ``stage_fn`` returns
    ``(x, aux_scalar)``, the aux sums ride the hops with the activations and
    the return value is ``(outputs, aux [M])``.  Differentiable: the
    backward runs the pipeline in reverse through the hops, and each rank's
    gradients are its stage's part — its layers' (zeros elsewhere in the
    stack) and, on the first stage, the micro-batches' — whose sum over
    ``axis`` is the whole gradient (the reference's replicated inputs sum
    them implicitly).  The data axes split nothing here: every data rank
    runs the whole micro-batches."""
    mesh = _resolve_mesh(mesh)
    n = mesh_lib.mesh_axis_size(mesh, axis)
    num_micro = microbatches.shape[0]
    leaves = list(layer_params.values()) if isinstance(layer_params, dict) else [layer_params]
    depth = leaves[0].shape[0]
    if depth % n:
        raise ValueError(f"{depth} layers do not split into {n} pipeline stages")
    idx = mesh.axis_index(axis) if n > 1 else 0
    per = depth // n

    def local(x):
        return x[idx * per:(idx + 1) * per]

    local_params = ({k: local(v) for k, v in layer_params.items()}
                    if isinstance(layer_params, dict) else local(layer_params))

    def run(x):
        return stage_fn(local_params, x, *broadcast_args)

    if n == 1:
        outs = [run(mb) for mb in microbatches]
        if carries_aux:
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1].float() for o in outs]))
        return torch.stack(outs)
    group = mesh.group(axis)
    outs, auxes, last = _gpipe(run, lambda j: microbatches[j], num_micro, microbatches[0],
                               group, n, idx, carries_aux)
    src = _stage_ranks(mesh, axis)[n - 1]
    is_last = idx == n - 1
    have = torch.stack(outs) if is_last else torch.zeros_like(microbatches)
    have = _Tie.apply(have, last)
    out = _FromLast.apply(have, group, src, is_last)
    if not carries_aux:
        return out
    have_aux = (torch.stack(auxes) if is_last
                else torch.zeros(num_micro, dtype=torch.float32, device=microbatches.device))
    return out, _FromLast.apply(have_aux, group, src, is_last)


# ----------------------------------------------------- the flagship model
class _Call(nn.Module):
    """``model.<method>`` as a module, so that ``functional_call`` binds a
    name -> tensor dict to it (names prefixed ``model.``)."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def _bind(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    cut = len(prefix)
    return {k[cut:]: v for k, v in params.items() if k.startswith(prefix)}


def _stage_layers(cfg, mesh, axis: str):
    n = mesh_lib.mesh_axis_size(mesh, axis)
    if cfg.num_layers % n:
        raise ValueError(f"{cfg.num_layers} layers do not split into {n} pipeline stages")
    idx = mesh.axis_index(axis) if n > 1 else 0
    per = cfg.num_layers // n
    return n, idx, range(idx * per, (idx + 1) * per)


def _make_stage_fn(model, params, layers, positions, with_aux: bool):
    """This stage's layers over the hidden states (``with_aux``: also the
    sum of their router aux terms, collected as ``lm_loss_fn`` does)."""
    from .moe import collect_router_aux, router_aux_loss

    def run(x):
        for i in layers:
            x = torch.func.functional_call(model.layers[i], _bind(params, f"layers.{i}."),
                                           (x, positions))
        return x

    if not with_aux:
        return run

    def run_aux(x):
        with collect_router_aux() as sown:
            x = run(x)
        return x, router_aux_loss(sown, 1.0)

    return run_aux


def _pad_rows(x: torch.Tensor, m: int, value) -> torch.Tensor:
    pad = (-x.shape[0]) % m
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), value)])


def _token_nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mask = labels != -100
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(mask, nll, torch.zeros_like(nll)).sum()


def _pipeline_forward(model, params, input_ids, mesh, num_micro: int, axis: str,
                      with_aux: bool):
    """The GPipe forward of the decoder stack: ``(x, auxes, tie, n, idx)``
    with ``x [B, S, H]`` the stack's output on the last stage (``None``
    elsewhere), ragged rows padded to the micro-batch count and cut off
    again."""
    cfg = model.config
    n, idx, layers = _stage_layers(cfg, mesh, axis)
    b, s = input_ids.shape
    ids = _pad_rows(input_ids, num_micro, 0)
    mb = ids.shape[0] // num_micro
    positions = torch.arange(s, device=ids.device)[None, :].expand(mb, -1)
    stage = _make_stage_fn(model, params, layers, positions, with_aux)
    embed = _Call(model, "embed")
    ids_mb = ids.reshape(num_micro, mb, s)

    def feed(j):
        return torch.func.functional_call(embed, {"model." + k: v for k, v in params.items()},
                                          (ids_mb[j], positions))

    if n == 1:
        outs, auxes = [], []
        for j in range(num_micro):
            o = stage(feed(j))
            outs.append(o[0] if with_aux else o)
            if with_aux:
                auxes.append(o[1].float())
        return torch.cat(outs)[:b], auxes, None, n, idx
    act = torch.zeros((mb, s, cfg.hidden_size), dtype=cfg.dtype, device=ids.device)
    outs, auxes, tie = _gpipe(stage, feed, num_micro, act, mesh.group(axis), n, idx, with_aux)
    x = torch.cat(outs)[:b] if idx == n - 1 else None
    return x, auxes, tie, n, idx


def _head_logits(model, params, x):
    head = _Call(model, "head")
    return torch.func.functional_call(head, {"model." + k: v for k, v in params.items()}, (x,))


def prepare_pipeline(model, params=None, mesh=None, num_microbatches: Optional[int] = None,
                     axis: str = "pp", jit: bool = True, with_aux: bool = False):
    """Pipeline-parallel forward of the flagship Transformer (the reference's
    ``prepare_pippy``, ``accelerate_tpu/parallel/pipeline.py:622``): embedding
    (with its norm and learned positions), final norm and head replicated,
    the decoder stack split into ``mesh[axis]`` stages.  Returns
    ``fn(params, input_ids) -> logits`` (f32, on every rank;
    ``(logits, per_microbatch_aux)`` with ``with_aux``).  A batch that does
    not divide into micro-batches is padded and its logits cut back.
    ``params`` and ``jit`` are accepted for the reference's signature."""

    def forward(p, input_ids):
        mesh_r = _resolve_mesh(mesh)
        m = _resolve_num_microbatches(num_microbatches)
        x, auxes, tie, n, idx = _pipeline_forward(model, p, input_ids, mesh_r, m, axis, with_aux)
        if n == 1:
            logits = _head_logits(model, p, x)
            return (logits, torch.stack(auxes)) if with_aux else logits
        group = mesh_r.group(axis)
        src = _stage_ranks(mesh_r, axis)[n - 1]
        is_last = idx == n - 1
        if is_last:
            logits = _head_logits(model, p, x)
        else:
            logits = torch.zeros((*input_ids.shape, model.config.vocab_size),
                                 dtype=torch.float32, device=input_ids.device)
        logits = _FromLast.apply(_Tie.apply(logits, tie), group, src, is_last)
        if not with_aux:
            return logits
        have = torch.stack(auxes) if is_last else torch.zeros(m, device=input_ids.device)
        return logits, _FromLast.apply(have, group, src, is_last)

    return forward


def _check_family(cfg) -> None:
    if getattr(cfg, "embed_norm", False) or getattr(cfg, "positional", "rope") == "learned":
        raise NotImplementedError(
            "pipeline_lm_loss_fn supports rope/alibi configs without an "
            "embedding norm; embed_norm / learned-position families "
            "(BLOOM, GPT-2, OPT) train via fsdp/tp instead")


def pipeline_lm_loss_fn(model, mesh=None, num_microbatches: Optional[int] = None,
                        axis: str = "pp", schedule: str = "gpipe"):
    """Next-token LM loss with the decoder stack pipelined over ``mesh[axis]``
    (``accelerate_tpu/parallel/pipeline.py:262``): a drop-in for
    :func:`~accelerate_tpu_torch.models.transformer.lm_loss_fn` in
    ``Accelerator.compile_train_step``, marked ``_pp_aware``.  ``schedule``
    ``"gpipe"`` or ``"1f1b"``.  The loss is the last stage's, summed over
    ``pp`` (every stage reports it).  For an MoE config the router aux term
    is added as ``coef * mean over micro-batches``."""
    from ..models.transformer import shift_labels

    cfg = model.config
    schedule_slots(schedule, 8, 1)  # the schedule's name, checked now
    _check_family(cfg)
    is_moe = getattr(cfg, "num_experts", 0) > 0 and cfg.router_aux_loss_coef > 0.0
    if schedule == "1f1b":
        return _pipeline_1f1b_lm_loss(model, mesh, num_microbatches, axis)

    def loss_fn(params, batch):
        from .sharding import reduce_forward

        mesh_r = _resolve_mesh(mesh)
        m = _resolve_num_microbatches(num_microbatches)
        labels = shift_labels(batch)
        x, auxes, tie, n, idx = _pipeline_forward(model, params, batch["input_ids"], mesh_r, m,
                                                  axis, is_moe)
        if x is not None:
            logits = _head_logits(model, params, x)
            mask = labels != -100
            loss = _token_nll_sum(logits, labels) / mask.sum().clamp(min=1)
            if is_moe:
                loss = loss + cfg.router_aux_loss_coef * torch.stack(auxes).mean()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=batch["input_ids"].device)
        if n == 1:
            return loss
        return reduce_forward(_Tie.apply(loss, tie), mesh_r.group(axis))

    loss_fn._pp_aware = True
    return loss_fn


class _Precomputed(torch.autograd.Function):
    """A loss whose gradients were computed with it: the backward scales
    them by the upstream cotangent (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, run, *tensors):
        loss, grads = run()
        ctx.grads = grads
        return loss

    @staticmethod
    def backward(ctx, g):
        return (None, *[None if d is None else (d.float() * g).to(d.dtype)
                        for d in ctx.grads])


def _pipeline_1f1b_lm_loss(model, mesh, num_microbatches, axis):
    """1F1B loss: the loss and the gradients of this rank's parameters from
    one interleaved schedule (``accelerate_tpu/parallel/pipeline.py:363``;
    the module docstring has the slot arithmetic).  ``loss_fn.stash_peak``
    is the most stage inputs the last call held at once."""
    from ..models.transformer import scale_embed, shift_labels
    from .sharding import all_reduce_

    cfg = model.config
    is_moe = getattr(cfg, "num_experts", 0) > 0 and cfg.router_aux_loss_coef > 0.0

    def loss_fn(params, batch):
        mesh_r = _resolve_mesh(mesh)
        m = _resolve_num_microbatches(num_microbatches)
        n, idx, layers = _stage_layers(cfg, mesh_r, axis)
        if n == 1:
            raise ValueError(
                "schedule='1f1b' needs a pp axis of size > 1; on a single stage "
                "use schedule='gpipe' (identical computation, no pipeline).")
        group = mesh_r.group(axis)
        first, last = idx == 0, idx == n - 1
        ids, labels = batch["input_ids"], shift_labels(batch)
        ids = _pad_rows(ids, m, 0)
        labels = _pad_rows(labels, m, -100)  # pad rows are ignored tokens
        b, s = ids.shape
        mb = b // m
        ids_mb, labels_mb = ids.reshape(m, mb, s), labels.reshape(m, mb, s)
        positions = torch.arange(s, device=ids.device)[None, :].expand(mb, -1)
        # the tensors this rank uses: its layers, the embedding on the first
        # stage, the head on the last
        used = [k for k in params if any(k.startswith(f"layers.{i}.") for i in layers)]
        if first:
            used += ["embed_tokens.weight"]
        if last:
            used += [k for k in params if k.startswith(("final_norm.", "lm_head."))]
            if cfg.tie_word_embeddings and "embed_tokens.weight" not in used:
                used += ["embed_tokens.weight"]
        inputs = [params[k] for k in used]

        def run():
            leaves = {k: v.detach().requires_grad_() for k, v in zip(used, inputs)}
            acc: Dict[str, Optional[torch.Tensor]] = {k: None for k in used}

            def add(names, grads):
                for k, g in zip(names, grads):
                    if g is not None:
                        acc[k] = g.float() if acc[k] is None else acc[k] + g.float()

            stage_names = [k for k in used if k.startswith("layers.")]
            head_names = [k for k in used if k.startswith(("final_norm.", "lm_head."))]
            if cfg.tie_word_embeddings and last:
                head_names.append("embed_tokens.weight")
            stage = _make_stage_fn(model, leaves, layers, positions, is_moe)

            def run_stage(x):
                out = stage(x)
                return out if is_moe else (out, torch.zeros((), device=x.device))

            def embed(tokens):
                w = leaves["embed_tokens.weight"]
                return scale_embed(cfg, w[tokens].to(cfg.dtype))

            count = (labels != -100).sum().float().clamp(min=1)
            inv_cnt = 1.0 / count
            act = torch.zeros((mb, s, cfg.hidden_size), dtype=cfg.dtype, device=ids.device)
            zero = torch.zeros((), dtype=torch.float32, device=ids.device)
            act_recv, aux_recv, grad_recv = act, zero, act
            stash: Dict[int, torch.Tensor] = {}
            peak = 0
            nll_sum, aux_sum = zero.clone(), zero.clone()
            aux_cot = torch.tensor(cfg.router_aux_loss_coef / m, device=ids.device)
            for t in range(schedule_slots("1f1b", m, n)):
                f, bwd = t - idx, t - 2 * (n - 1) + idx
                dx_head = None
                # ------------------------------------------------ forward unit
                if 0 <= f < m:
                    with torch.no_grad():
                        x_in = embed(ids_mb[f]) if first else act_recv
                        out, aux_stage = run_stage(x_in)
                        aux_out = (zero if first else aux_recv) + aux_stage.float()
                    stash[f] = x_in
                    peak = max(peak, len(stash))
                    if last:
                        out_d = out.detach().requires_grad_()
                        with torch.enable_grad():
                            logits = _head_logits(model, leaves, out_d)
                            nll = _token_nll_sum(logits, labels_mb[f]) * inv_cnt
                            grads = torch.autograd.grad(
                                nll, [out_d] + [leaves[k] for k in head_names],
                                allow_unused=True)
                        dx_head = grads[0].to(cfg.dtype)
                        add(head_names, grads[1:])
                        nll_sum = nll_sum + nll.detach()
                        aux_sum = aux_sum + aux_out
                else:
                    out, aux_out = act, zero
                # ----------------------------------------------- backward unit
                dx = act
                if 0 <= bwd < m:
                    x_b = stash.pop(bwd).detach().requires_grad_()
                    g_in = dx_head if last else grad_recv
                    with torch.enable_grad():
                        out_b, aux_b = run_stage(x_b)
                        outs, cots = [out_b], [g_in.to(out_b.dtype)]
                        if is_moe:
                            outs.append(aux_b)
                            cots.append(aux_cot.to(aux_b.dtype))
                        grads = torch.autograd.grad(
                            outs, [x_b] + [leaves[k] for k in stage_names], cots,
                            allow_unused=True)
                    dx = grads[0].to(cfg.dtype)
                    add(stage_names, grads[1:])
                    if first:
                        with torch.enable_grad():
                            e = embed(ids_mb[bwd])
                            (g_e,) = torch.autograd.grad(e, [leaves["embed_tokens.weight"]], dx)
                        add(["embed_tokens.weight"], [g_e])
                # ------------------------------------------------------- hops
                act_recv, aux_recv = mesh_lib.ppermute([out, aux_out], group, 1)
                (grad_recv,) = mesh_lib.ppermute([dx], group, -1)
            loss_fn.stash_peak = peak
            loss = nll_sum
            if is_moe:
                loss = loss + cfg.router_aux_loss_coef * aux_sum / m
            loss = all_reduce_(loss if last else zero.clone(), group)
            grads = [None if acc[k] is None else acc[k].to(v.dtype)
                     for k, v in zip(used, inputs)]
            return loss, grads

        return _Precomputed.apply(run, *inputs)

    loss_fn._pp_aware = True
    loss_fn._pipeline_schedule = "1f1b"
    loss_fn.stash_peak = 0
    return loss_fn


__all__ = ["layer_stage", "pipeline_apply", "pipeline_lm_loss_fn", "prepare_pipeline",
           "schedule_slots", "stack_layer_params"]
