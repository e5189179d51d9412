"""Mixture-of-Experts on one card: the port of :mod:`accelerate_tpu.parallel.moe`.

The GShard/Switch dense formulation: routing makes static ``[tokens,
experts, capacity]`` dispatch and combine tensors, the experts' input and
output are products with them, and the experts are a stacked leading axis
run as batched products (``torch.bmm``) — no ragged gather, no shape that
depends on the data, no read back to the host, so the layer replays inside
a CUDA graph.  The router runs in f32 and the Switch load-balancing loss is
collected for the loss function (:func:`collect_router_aux`, the reference's
``sow``).

Expert parallelism (``ep`` > 1) needs a device mesh: :func:`shard_moe_params`
raises for it (ROADMAP Queue 1 item 9e-ii).
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
    P_e`` over the top-1 assignments (``accelerate_tpu/parallel/moe.py:26-63``).

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

    # means as sum / N, the reference's division (torch's mean multiplies
    # by 1 / N)
    top1 = _one_hot(expert_idx[:, 0], n_experts, dtype)
    fraction_routed = top1.sum(dim=0) / n_tokens
    mean_prob = router_probs.sum(dim=0) / n_tokens
    aux_loss = n_experts * (fraction_routed * mean_prob).sum()
    return dispatch, combine, aux_loss


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
        dispatch, combine, aux = top_k_dispatch(probs, cfg.num_experts_per_tok,
                                                cfg.resolved_expert_capacity(n_tokens))
        if _SOWN:
            _SOWN[-1].append(aux)
        dt = cfg.dtype
        expert_in = torch.einsum("nec,nh->ech", dispatch.to(dt), xf.to(dt))
        expert_out = self.experts(expert_in)                                  # [E, C, H]
        y = torch.einsum("nec,ech->nh", combine.to(dt), expert_out.to(dt))
        return y.reshape(b, s, h).to(x.dtype)


def shard_moe_params(params, mesh=None, *, marker: str = "experts"):
    """Expert placement over a mesh's ``ep`` axis (``mesh``: anything with
    a ``shape`` mapping of axis sizes, or that mapping): the identity when
    there is no ``ep`` axis above 1 (one card); an ``ep`` mesh raises."""
    shape = getattr(mesh, "shape", mesh) or {}
    ep = int(dict(shape).get("ep", 1))
    if ep <= 1:
        return params
    raise NotImplementedError(
        f"shard_moe_params over ep={ep}: expert parallelism needs a device mesh, "
        "ROADMAP Queue 1 item 9e-ii (parallel/moe.py across cards)")


__all__ = ["ExpertLinear", "MoEMLP", "collect_router_aux", "router_aux_loss",
           "shard_moe_params", "top_k_dispatch"]
