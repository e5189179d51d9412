"""Mixture-of-Experts on one card: the port of :mod:`accelerate_tpu.parallel.moe`.

The GShard/Switch dense formulation: routing makes static ``[tokens,
experts, capacity]`` dispatch and combine tensors, the experts' input and
output are products with them, and the experts are a stacked leading axis
run as batched products (``torch.bmm``) — no ragged gather, no shape that
depends on the data, no read back to the host, so the layer replays inside
a CUDA graph.  The router runs in f32 and the Switch load-balancing loss is
collected for the loss function (:func:`collect_router_aux`, the reference's
``sow``).

Expert parallelism over a mesh's ``ep`` axis: ``ep`` is not a data axis,
so every ``ep`` rank routes the same tokens; the experts' leading dim is
cut over ``ep`` (:func:`~accelerate_tpu_torch.parallel.sharding.
expert_partition_spec`, composed with ``fsdp``; :func:`shard_moe_params`
places a name -> tensor dict so, and the Accelerator its train state).  A
layer marked with its ``ep`` block (``_atpu_ep``, set by the Accelerator's
``ShardedLayout``) computes only its own experts' ``[E/ep, C, H]`` buffers
from the same dispatch, and the combine is summed over ``ep``: forward an
all-reduce, backward the identity, since every ``ep`` rank already holds the
whole output's gradient.  The expert input and the combine weights take the
converse (identity forward, the sum over ``ep`` backward), so each rank's
gradient of the tokens and of the router is the whole one and the replicated
parameters stay equal across ``ep`` without a gradient reduction.

When the tokens are cut over processes — the data axes, and ``sp`` under
ring attention (a :func:`~accelerate_tpu_torch.parallel.ring_attention.
sequence_sharded` forward) — the Switch statistics are the whole batch's,
as the reference's global arrays give them: the routed fractions and mean
probabilities are summed over those ranks (``_global_aux``).  Capacity is
decided on each rank's tokens (a token past it is dropped there).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
from torch import nn

from ..ops.fp8 import bwd_dtype_of, fp8_matmul


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``one_hot`` by comparison: ``F.one_hot`` reads the max back to the
    host, which a CUDA graph cannot capture."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k_dispatch(router_probs: torch.Tensor, num_experts_per_tok: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-k routing -> dense ``dispatch [N, E, C]`` (0/1), ``combine
    [N, E, C]`` (gate-weighted) and the Switch aux loss ``E * sum_e f_e *
    P_e`` over the top-1 assignments (``accelerate_tpu/parallel/moe.py:26-63``)."""
    dispatch, combine, routed, mass = _route(router_probs, num_experts_per_tok, capacity)
    return dispatch, combine, switch_loss(routed, mass, router_probs.shape[0])


def switch_loss(routed: torch.Tensor, mass: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e f_e * P_e`` of ``n_tokens``
    tokens from their top-1 counts ``routed [E]`` and probability sums
    ``mass [E]``; means as sum / N, the reference's division (torch's mean
    multiplies by 1 / N)."""
    return routed.shape[0] * ((routed / n_tokens) * (mass / n_tokens)).sum()


def _route(router_probs: torch.Tensor, num_experts_per_tok: int, capacity: int):
    """:func:`top_k_dispatch`'s routing: ``(dispatch, combine, routed,
    mass)``, the last two :func:`switch_loss`'s statistics.

    Each token's choices are placed in choice order, a token's position in
    its expert's buffer counting the tokens placed before it; a token past
    an expert's capacity is dropped (combine weight 0: the residual carries
    it).  Ties between experts go to the lower index, as ``lax.top_k``
    breaks them: a stable descending sort."""
    n_tokens, n_experts = router_probs.shape
    order = torch.sort(router_probs, dim=-1, descending=True, stable=True)
    gates = order.values[:, :num_experts_per_tok]
    expert_idx = order.indices[:, :num_experts_per_tok]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    dtype = router_probs.dtype
    dispatch = router_probs.new_zeros(n_tokens, n_experts, capacity)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=router_probs.device)
    for j in range(num_experts_per_tok):
        onehot = _one_hot(expert_idx[:, j], n_experts, torch.int32)          # [N, E]
        pos_in_expert = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1 + counts[None, :]
        counts = counts + onehot.sum(dim=0, dtype=torch.int32)
        keep = (pos_in_expert < capacity) & (onehot > 0)                      # [N, E]
        pos = torch.where(keep, pos_in_expert, 0).sum(dim=1)                  # [N]
        disp_j = keep.to(dtype)[:, :, None] * _one_hot(pos, capacity, dtype)[:, None, :]
        dispatch = dispatch + disp_j
        combine = combine + gates[:, j][:, None, None] * disp_j
    routed = _one_hot(expert_idx[:, 0], n_experts, dtype).sum(dim=0)
    return dispatch, combine, routed, router_probs.sum(dim=0)


#: the active collectors of :func:`collect_router_aux`
_SOWN: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def collect_router_aux():
    """Collect the aux loss of every :class:`MoEMLP` call inside the block,
    in call order (the reference's ``mutable=["intermediates"]``)."""
    sown: List[torch.Tensor] = []
    _SOWN.append(sown)
    try:
        yield sown
    finally:
        _SOWN.remove(sown)


def router_aux_loss(sown, coef: float) -> torch.Tensor:
    """``coef`` times the sum of the collected aux losses
    (``accelerate_tpu/parallel/moe.py:145``), summed in call order from an
    f32 zero."""
    device = sown[0].device if sown else None
    total = torch.zeros((), dtype=torch.float32, device=device)
    for aux in sown:
        total = total + aux.sum()
    return coef * total


class ExpertLinear(nn.Module):
    """One projection of ``E`` stacked experts: ``weight [E, in, out]`` (the
    layout ``torch.bmm`` takes, and the reference's vmapped kernel), an
    optional ``bias [E, out]``, ``[E, C, in] -> [E, C, out]`` in
    ``compute_dtype``.  Under fp8 each expert's product is an fp8 product
    with its own per-tensor scales, as the reference's vmap gives."""

    def __init__(self, experts: int, in_features: int, out_features: int, bias: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, fp8=None, device=None, dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(experts, in_features, out_features,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(experts, out_features, device=device, dtype=dtype))
                     if bias else None)
        #: ``(margin, gradient format)`` of the fp8 arm, else None
        self.fp8 = None if fp8 is None else (int(fp8[0]), bwd_dtype_of(fp8[1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dt)
        x = x.to(dt)
        if self.fp8 is None:
            y = torch.bmm(x, w)
        else:
            margin, bwd = self.fp8
            y = torch.stack([fp8_matmul(x[e], w[e], margin=margin, bwd_dtype=bwd)
                             for e in range(w.shape[0])])
        return y if self.bias is None else y + self.bias.to(dt)[:, None, :]


class MoEMLP(nn.Module):
    """Drop-in MoE replacement for the dense MLP (``accelerate_tpu/parallel/
    moe.py:66-116``): an f32 ``router`` (``nn.Linear``, no bias), top-k
    dispatch at ``cfg.resolved_expert_capacity(tokens)`` — the tokens of the
    call, dead lanes and padded tails included — and ``experts``, the
    config's MLP with every projection stacked ``[E, ...]`` (quantized
    under ``cfg.quantization``, fp8 under ``cfg.use_fp8``)."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        from ..models.transformer import MLP

        self.config = cfg
        self.router = nn.Linear(cfg.hidden_size, cfg.num_experts, bias=False,
                                device=device, dtype=torch.float32)
        self.experts = MLP(cfg, device=device, dtype=dtype, experts=cfg.num_experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, h = x.shape
        n_tokens = b * s
        xf = x.reshape(n_tokens, h)
        logits = torch.nn.functional.linear(xf.float(), self.router.weight.float())
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, routed, mass = _route(probs, cfg.num_experts_per_tok,
                                                 cfg.resolved_expert_capacity(n_tokens))
        if _SOWN:
            _SOWN[-1].append(_global_aux(self, routed, mass, n_tokens))
        dt = cfg.dtype
        ep = getattr(self, "_atpu_ep", None)
        if ep is None:
            expert_in = torch.einsum("nec,nh->ech", dispatch.to(dt), xf.to(dt))
            expert_out = self.experts(expert_in)                              # [E, C, H]
            y = torch.einsum("nec,ech->nh", combine.to(dt), expert_out.to(dt))
            return y.reshape(b, s, h).to(x.dtype)
        from .sharding import reduce_backward, reduce_forward

        group, size, rank = ep
        per = cfg.num_experts // size
        mine = slice(rank * per, (rank + 1) * per)
        xf = reduce_backward(xf.to(dt), group)
        combine = reduce_backward(combine.to(dt), group)
        expert_in = torch.einsum("nec,nh->ech", dispatch[:, mine].to(dt), xf)
        expert_out = self.experts(expert_in)                                  # [E/ep, C, H]
        y = torch.einsum("nec,ech->nh", combine[:, mine], expert_out.to(dt))
        return reduce_forward(y, group).reshape(b, s, h).to(x.dtype)


def _global_aux(module, routed: torch.Tensor, mass: torch.Tensor, n_tokens: int
                ) -> torch.Tensor:
    """The aux term to sow: the Switch loss of one rank's tokens, or the
    whole batch's when the tokens are cut over processes — the data axes
    the Accelerator marks the layer with (``_atpu_data_groups``) and, in a
    sequence-sharded forward, ``sp``: the routed counts summed over them
    (they carry no gradient), the probabilities with one (their sum's
    backward is the sum over the ranks, as every rank's loss holds the
    term).  Under ``sp``, whose losses are summed, each rank sows ``1/sp``
    of it; the data ranks' losses are averaged."""
    from .ring_attention import active_shard

    groups = list(getattr(module, "_atpu_data_groups", ()))
    share = 1
    shard = active_shard()
    if shard is not None and shard["mesh"].shape.get(shard["axis"], 1) > 1:
        share = shard["mesh"].shape[shard["axis"]]
        groups.append((shard["mesh"].group(shard["axis"]), share))
    if not groups:
        return switch_loss(routed, mass, n_tokens)
    from .sharding import all_reduce_, reduce_both

    for group, size in groups:
        all_reduce_(routed, group)
        mass = reduce_both(mass, group)
        n_tokens *= size
    return switch_loss(routed, mass, n_tokens) / share


def shard_moe_params(params, mesh, *, marker: str = "experts"):
    """This rank's block of every stacked expert tensor of a name -> tensor
    dict (a name with ``marker`` among its dot-separated parts): the expert
    dim cut over the mesh's ``ep`` axis, composed with ``fsdp`` on the
    largest remaining dim (:func:`~accelerate_tpu_torch.parallel.sharding.
    expert_partition_spec`, the JAX package's placement,
    ``accelerate_tpu/parallel/moe.py:119``); each block carries its
    ``atpu_sharding``.  Other tensors are left as they are, and so is the
    dict on a mesh without an ``ep`` axis above 1 (``mesh``: a
    :class:`~accelerate_tpu_torch.parallel.mesh.Mesh`, an axes dict, or
    ``None``)."""
    from .mesh import Mesh, NamedSharding, local_slice
    from .sharding import expert_partition_spec

    ep = int(dict(getattr(mesh, "shape", mesh) or {}).get("ep", 1))
    if ep <= 1:
        return params
    if not isinstance(mesh, Mesh):
        mesh = Mesh(dict(mesh))
    fsdp = int(mesh.shape.get("fsdp", 1))
    out = {}
    for name, x in params.items():
        if marker in name.split(".") and hasattr(x, "shape"):
            spec = expert_partition_spec(tuple(x.shape), ep, fsdp)
            block = x[local_slice(mesh, spec, tuple(x.shape))].clone()
            block.atpu_sharding = NamedSharding(mesh, spec)
            out[name] = block
        else:
            out[name] = x
    return out


__all__ = ["ExpertLinear", "MoEMLP", "collect_router_aux", "router_aux_loss",
           "shard_moe_params", "top_k_dispatch"]
