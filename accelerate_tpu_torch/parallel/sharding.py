"""Parameter and state sharding: FSDP and ZeRO as placement rules, and the collectives that serve them.

Port of :mod:`accelerate_tpu.parallel.sharding`.  The rules are the JAX
package's, over the same *logical* shapes: :func:`fsdp_partition_spec`
shards the largest divisible dim over ``fsdp`` (the first one on a tie,
JAX's stable sort), parameters below ``min_weight_size`` stay replicated.
A JAX ``Dense`` kernel is ``[in, out]`` where an ``nn.Linear`` weight is
``[out, in]``, so every rule here takes the parameter's name, computes the
JAX spec on the logical shape (:func:`logical_permutation`) and maps it
back onto the torch dims: a square projection shards its ``in`` features,
dim 1 of the torch weight, as the reference shards dim 0 of its kernel.

Where the JAX package hands the specs to XLA, which then all-gathers
parameters on use and reduce-scatters gradients, the port runs those
collectives itself (the Accelerator's train step):
:func:`gather_for_compute` is the all-gather whose backward reduce-scatters
(over data axes) or takes the rank's block (over ``tp``, whose ranks hold
the same gradient); :func:`all_gather_along` / :func:`reduce_scatter_along`
/ :func:`all_reduce_` are the plain ones over one mesh axis, the same
calls on every backend.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.dataclasses import FullyShardedDataParallelPlugin
from . import mesh as mesh_lib
from .mesh import Mesh, NamedSharding, PartitionSpec, spec_axes


def fsdp_partition_spec(shape: Sequence[int], fsdp_size: int, min_weight_size: int = 2**12,
                        axis_name: str = "fsdp") -> PartitionSpec:
    """Shard the largest divisible dim over the fsdp axis; small params stay
    replicated (the JAX package's rule, on a logical shape)."""
    if fsdp_size <= 1 or not shape or math.prod(shape) < min_weight_size:
        return PartitionSpec()
    order = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
    for d in order:
        if shape[d] % fsdp_size == 0:
            spec: list = [None] * len(shape)
            spec[d] = axis_name
            return PartitionSpec(*spec)
    return PartitionSpec()


def expert_partition_spec(shape: Sequence[int], ep_size: int, fsdp_size: int = 1,
                          min_weight_size: int = 2**12) -> PartitionSpec:
    """Stacked-expert kernels: the expert dim (``ndim - 3``) over ``ep``, the
    largest matmul dim over ``fsdp`` when large enough (the JAX package's
    rule)."""
    if not shape or ep_size <= 1:
        return fsdp_partition_spec(shape, fsdp_size, min_weight_size)
    expert_dim = max(0, len(shape) - 3)
    if shape[expert_dim] % ep_size != 0:
        return fsdp_partition_spec(shape, fsdp_size, min_weight_size)
    spec: list = [None] * len(shape)
    spec[expert_dim] = "ep"
    if fsdp_size > 1 and math.prod(shape) >= min_weight_size:
        rest = sorted(range(expert_dim + 1, len(shape)), key=lambda d: shape[d], reverse=True)
        for d in rest:
            if shape[d] % fsdp_size == 0:
                spec[d] = "fsdp"
                break
    return PartitionSpec(*spec)


# ------------------------------------------------------------- torch layout
def is_linear_weight(name: str, ndim: int) -> bool:
    """Whether a parameter is an ``nn.Linear`` weight (``[out, in]``, the
    transpose of the JAX kernel): a 2-D ``weight`` outside an embedding."""
    parts = name.split(".")
    return ndim == 2 and parts[-1] == "weight" and not any("embed" in p for p in parts[:-1])


def logical_permutation(name: str, ndim: int) -> Tuple[int, ...]:
    """For each torch dim of parameter ``name``, the JAX package's dim."""
    return (1, 0) if is_linear_weight(name, ndim) else tuple(range(ndim))


def logical_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The JAX package's shape of the parameter (a linear weight transposed)."""
    perm = logical_permutation(name, len(shape))
    out = [0] * len(shape)
    for torch_dim, jax_dim in enumerate(perm):
        out[jax_dim] = shape[torch_dim]
    return tuple(out)


def to_torch_spec(name: str, spec: PartitionSpec, ndim: int) -> PartitionSpec:
    """A spec over the JAX package's dims mapped onto the torch dims."""
    perm = logical_permutation(name, ndim)
    entries = list(spec) + [None] * (ndim - len(spec))
    return PartitionSpec(*(entries[perm[d]] for d in range(ndim)))


def to_logical_spec(name: str, spec: PartitionSpec, ndim: int) -> PartitionSpec:
    """The inverse of :func:`to_torch_spec`."""
    perm = logical_permutation(name, ndim)
    entries = list(spec) + [None] * (ndim - len(spec))
    out: list = [None] * ndim
    for torch_dim, jax_dim in enumerate(perm):
        out[jax_dim] = entries[torch_dim]
    return PartitionSpec(*out)


def supports_host_offload(mesh: Mesh) -> bool:
    """The port's offload tiers (pinned host memory, files) work on every
    device, the CPU included (the JAX package's need the TPU runtime)."""
    return True


def make_param_sharding_fn(mesh: Mesh, plugin: Optional[FullyShardedDataParallelPlugin] = None
                           ) -> Callable[..., NamedSharding]:
    """``rule(x, name="") -> NamedSharding`` for parameters, in torch dims
    (``name`` gives the layout: see the module docstring).  With
    ``plugin.cpu_offload`` the placement's ``memory_kind`` is
    ``"pinned_host"``."""
    fsdp_size = mesh_lib.mesh_axis_size(mesh, "fsdp")
    shards_params = plugin is not None and plugin.shards_params and fsdp_size > 1
    memory_kind = "pinned_host" if (plugin is not None and plugin.cpu_offload) else None

    def rule(x, name: str = "") -> NamedSharding:
        shape = tuple(getattr(x, "shape", ()))
        spec = (fsdp_partition_spec(logical_shape(name, shape), fsdp_size,
                                    plugin.min_weight_size) if shards_params else PartitionSpec())
        return NamedSharding(mesh, to_torch_spec(name, spec, len(shape)), memory_kind)

    return rule


def make_opt_sharding_fn(mesh: Mesh, plugin: Optional[FullyShardedDataParallelPlugin] = None
                         ) -> Callable[..., NamedSharding]:
    """``rule(x, name="") -> NamedSharding`` for the optimizer state of a
    parameter shaped like ``x``: sharded whenever the strategy shards
    optimizer state (ZeRO >= 1); ``"pinned_host"`` under
    ``offload_optimizer`` (not under the nvme tier, whose state is in
    files)."""
    fsdp_size = mesh_lib.mesh_axis_size(mesh, "fsdp")
    shards_opt = plugin is not None and plugin.shards_opt_state and fsdp_size > 1
    min_size = plugin.min_weight_size if plugin is not None else 2**12
    on_disk = plugin is not None and getattr(plugin, "offload_optimizer_nvme_path", None)
    memory_kind = ("pinned_host" if (plugin is not None and plugin.offload_optimizer
                                     and not on_disk) else None)

    def rule(x, name: str = "") -> NamedSharding:
        shape = tuple(getattr(x, "shape", ()))
        spec = (fsdp_partition_spec(logical_shape(name, shape), fsdp_size, min_size)
                if shards_opt else PartitionSpec())
        return NamedSharding(mesh, to_torch_spec(name, spec, len(shape)), memory_kind)

    return rule


def shard_pytree(tree: Dict[str, torch.Tensor], rule: Callable[..., NamedSharding]):
    """``(blocks, shardings)``: each tensor of a name -> tensor dict cut to
    the block this process holds under ``rule(x, name)``."""
    shardings = {name: rule(x, name) for name, x in tree.items()}
    blocks = {name: x[mesh_lib.local_slice(s.mesh, s.spec, x.shape)].clone()
              for (name, x), s in zip(tree.items(), shardings.values())}
    return blocks, shardings


def shard_pytree_with_path(tree: Dict[str, torch.Tensor], rule: Callable[..., NamedSharding]):
    """:func:`shard_pytree` for path-aware rules ``(name, x) -> NamedSharding``
    (:func:`~accelerate_tpu_torch.parallel.tensor_parallel.make_tp_sharding_fn`)."""
    return shard_pytree(tree, lambda x, name: rule(name, x))


def sharding_of(tree):
    """The :class:`NamedSharding` each tensor of a tree was placed with
    (``None`` for one the accelerator did not place)."""
    if isinstance(tree, dict):
        return {k: sharding_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sharding_of(v) for v in tree)
    return getattr(tree, "atpu_sharding", None)


# -------------------------------------------------------------- collectives
def all_gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` from every rank of ``group``,
    concatenated in rank order."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps its block
    along ``dim``."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=x.dtype, device=x.device)
    # torch 2.13 renames reduce_scatter_tensor reduce_scatter_single
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns it."""
    dist.all_reduce(x, group=group)
    return x


class _GatherForCompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return all_gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            return reduce_scatter_along(grad, ctx.dim, ctx.group), None, None, None
        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None, None


def gather_for_compute(x: torch.Tensor, dim: int, group, reduce_grad: bool) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group``, differentiably: the
    backward reduce-scatters (``reduce_grad``: the group's ranks saw
    different data) or takes this rank's block (they computed the same
    gradient)."""
    return _GatherForCompute.apply(x, dim, group, reduce_grad)


class _ReduceForward(torch.autograd.Function):
    """Megatron's ``g``: the sum over ``group`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    """Megatron's ``f``: identity forward, the sum over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceBoth(torch.autograd.Function):
    """The sum over ``group`` forward and backward (every rank's output is
    used by its own loss, and each loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceBoth.apply(x, group)


def reduce_forward(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceForward.apply(x, group)


def reduce_backward(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceBackward.apply(x, group)


def gather_axes_order(spec: PartitionSpec, keep: Sequence[str] = ()) -> list:
    """``(dim, axis)`` pairs to all-gather, minor axes first, so that each
    gather concatenates contiguous blocks; axes in ``keep`` stay split."""
    out = []
    for d, entry in enumerate(spec):
        for axis in reversed(spec_axes(entry)):
            if axis not in keep:
                out.append((d, axis))
    return out


__all__ = [
    "all_gather_along", "all_reduce_", "expert_partition_spec", "fsdp_partition_spec",
    "gather_for_compute", "is_linear_weight", "logical_permutation", "logical_shape",
    "make_opt_sharding_fn", "make_param_sharding_fn", "reduce_backward", "reduce_both",
    "reduce_forward",
    "reduce_scatter_along", "shard_pytree", "shard_pytree_with_path", "sharding_of",
    "supports_host_offload", "to_logical_spec", "to_torch_spec",
]


# ------------------------------------------------------- the train state's
class ShardedLayout:
    """How a model's parameters, gradients and optimizer state sit on the
    mesh, and the collectives of a train step over them.

    Built once by the Accelerator from a parameter rule and an optimizer
    rule (``name, x -> NamedSharding``).  For each parameter:

    - the module keeps the block of its *parameter* spec (``p.data`` is
      cut to it; ``p.atpu_sharding`` records the placement);
    - the optimizer updates the block of its *optimizer* spec, which
      refines the parameter's (ZeRO-1/2 and SHARD_GRAD_OP: parameters whole,
      state sharded): then a separate f32 ``master`` holds that block, and
      after each update the masters are all-gathered back into the module;
    - :meth:`compute_params` all-gathers each block to what the forward
      uses — the whole tensor, or under tensor-parallel compute the rank's
      ``tp`` block of a column/row-parallel weight — differentiably, so the
      backward reduce-scatters the gradient over the data axes it was
      sharded on;
    - :meth:`reduce_fresh` sums a micro-step's gradient over the remaining
      data axes (``dp``, and ``fsdp`` for a parameter not sharded over it),
      as XLA reduces the reference's every micro-step; under
      ``shards_grads`` a mastered parameter's gradient is reduce-scattered
      into its master's block instead (ZeRO-2), so its buffer is that block.

    Gradients are *sums* over the data ranks; the step divides by
    :attr:`n_data` (every rank's loss is the mean over its rows, and the
    data shards are equal).  ``reduce_dtype`` is the dtype those
    reductions ride in: the compute dtype, as XLA reduces the reference's
    (``CollectiveKwargs.grad_reduce_dtype`` when given); the buffers keep
    the parameters' dtype.

    The other model-parallel axes (the JAX package's ``_train_state_
    shardings`` pp and ep branches, ``accelerate_tpu/accelerator.py:911-958``):

    - ``pp``: ``stage_of(name)`` names the pipeline stage that owns a
      parameter (a decoder layer's: ``layers.{i}`` belongs to stage ``i //
      (L / pp)``, the role of the reference's ``wrap_with_pp_rule`` for an
      unstacked layer list), ``None`` for one every stage holds (the
      embedding, the final norm, the head).  A rank keeps only its own
      stage's layers: another stage's parameter is an empty tensor here, with
      no gradient and no optimizer state.  The replicated ones' gradients
      are summed over ``pp`` (each stage computes its own part of them, and
      zeros where it has none), so their replicas stay equal;
    - ``sp``: every rank computes its share of the sequence's loss, so
      every gradient is summed over ``sp``, as over a data axis but not
      divided (the shares add up to the loss);
    - ``ep``: a stacked expert tensor whose spec cuts the expert dim over
      ``ep`` keeps it cut in the forward (:meth:`install_moe` marks its
      MoE layer), and needs no reduction over ``ep``: the ``ep`` ranks see
      the same tokens, and the layer's collectives give every rank the
      whole gradient of what they share."""

    def __init__(self, mesh: Mesh, model, param_rule, opt_rule, *, shards_grads: bool,
                 tp_compute: bool = False, reduce_dtype: Optional[torch.dtype] = None,
                 stage_of: Optional[Callable[[str], Optional[int]]] = None,
                 ep_compute: bool = False):
        from .tensor_parallel import tp_kind

        self.mesh = mesh
        self.shards_grads = shards_grads
        self.reduce_dtype = reduce_dtype
        self.data_axes = tuple(a for a in mesh_lib.DATA_AXES if mesh.shape.get(a, 1) > 1)
        self.n_data = math.prod(mesh.shape[a] for a in self.data_axes)
        self.world = mesh.size
        self.tp = mesh_lib.mesh_axis_size(mesh, "tp")
        self.tp_compute = tp_compute and self.tp > 1
        self.pp = mesh_lib.mesh_axis_size(mesh, "pp")
        self.ep = mesh_lib.mesh_axis_size(mesh, "ep")
        self.coordinate = mesh.coordinate()
        self.entries: Dict[str, dict] = {}
        sums = ["sp"] if mesh_lib.mesh_axis_size(mesh, "sp") > 1 else []
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            pspec = _full_spec(param_rule(name, p).spec, len(shape))
            ospec = _full_spec(opt_rule(name, p).spec, len(shape))
            extra = _refinement(pspec, ospec)
            if extra is None:  # the optimizer's block is not inside the module's
                ospec, extra = pspec, PartitionSpec(*([None] * len(shape)))
            kind = tp_kind(name, shape, self.tp) if self.tp > 1 else None
            stage = stage_of(name) if (stage_of is not None and self.pp > 1) else None
            owned = stage is None or stage == self.coordinate.get("pp", 0)
            with torch.no_grad():
                p.data = (p.data[mesh_lib.local_slice(mesh, pspec, shape, self.coordinate)].clone()
                          if owned else p.data.new_empty((0,)))
            p.atpu_sharding = NamedSharding(mesh, pspec)
            master = None
            if owned and any(spec_axes(e) for e in extra):
                block = p.data[mesh_lib.local_slice(mesh, extra, p.shape, self.coordinate)]
                master = torch.nn.Parameter(block.detach().clone(), requires_grad=False)
                master.atpu_sharding = NamedSharding(mesh, ospec)
            keep = ("tp",) if self.tp_compute and kind in ("out", "in") else ()
            if ep_compute and _splits(pspec, "ep"):
                keep += ("ep",)
            # replicated over pp: each stage holds a part of the gradient
            across = sums + (["pp"] if self.pp > 1 and stage is None else [])
            self.entries[name] = dict(
                shape=shape, pspec=pspec, ospec=ospec, extra=extra, kind=kind, master=master,
                stage=stage, owned=owned, gather=gather_axes_order(pspec, keep),
                # fsdp before dp: PowerSGD compresses a replica's (fsdp-summed) gradient
                reduce=[a for a in reversed(self.data_axes) if not _splits(pspec, a)] + across,
                opt_reduce=[a for a in reversed(self.data_axes) if not _splits(ospec, a)]
                + across)

    # ----------------------------------------------------------- placement
    def optimizer_params(self, model) -> list:
        """What the optimizer binds to, in the model's order: each master,
        else the parameter itself."""
        return [self.entries[n]["master"] if self.entries[n]["master"] is not None else p
                for n, p in model.named_parameters()]

    def compute_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The tensors the forward runs with, from the (cast) blocks (another
        pipeline stage's parameters stay empty)."""
        out = {}
        for name, t in params.items():
            if not self.entries[name]["owned"]:
                out[name] = t
                continue
            for d, axis in self.entries[name]["gather"]:
                t = gather_for_compute(t, d, self.mesh.group(axis),
                                       reduce_grad=axis in mesh_lib.DATA_AXES)
            out[name] = t
        return out

    def install_tp(self, model) -> None:
        """Mark each column/row-parallel linear with its ``tp`` style, which
        ``models/transformer.py``'s ``_dense`` reads: ``(kind, group, size,
        rank, gather_output)`` (``lm_head``'s output is gathered for the
        loss)."""
        if not self.tp_compute:
            return
        group, rank = self.mesh.group("tp"), self.coordinate["tp"]
        for name, e in self.entries.items():
            if e["kind"] in ("out", "in"):
                module = model.get_submodule(name.rsplit(".", 1)[0])
                module._atpu_tp = (e["kind"], group, self.tp, rank,
                                   name.split(".")[-2] == "lm_head")

    def install_moe(self, model) -> None:
        """Mark each MoE layer (``parallel/moe.py``'s ``MoEMLP`` reads the
        marks) with the data axes' groups its router statistics sum over
        (``_atpu_data_groups``), and, where this rank holds a block of its
        experts over ``ep``, with ``(group, ep, rank)`` (``_atpu_ep``)."""
        from .moe import MoEMLP

        data = [(self.mesh.group(a), self.mesh.shape[a]) for a in self.data_axes]
        for module in model.modules():
            if isinstance(module, MoEMLP) and data:
                module._atpu_data_groups = data
        if self.ep <= 1:
            return
        group, rank = self.mesh.group("ep"), self.coordinate["ep"]
        for name, e in self.entries.items():
            if "ep" in e["gather"] or not _splits(e["pspec"], "ep"):
                continue
            parts = name.split(".")
            if "experts" in parts:
                owner = ".".join(parts[:parts.index("experts")])
                model.get_submodule(owner)._atpu_ep = (group, self.ep, rank)

    # ----------------------------------------------------------- gradients
    def _wire(self, g: torch.Tensor) -> torch.Tensor:
        return g if self.reduce_dtype is None else g.to(self.reduce_dtype)

    def reduce_fresh(self, model, fresh: Dict[str, torch.Tensor], compress=None,
                     into_masters: bool = True) -> Dict[str, torch.Tensor]:
        """One micro-step's gradients (blocks, name -> tensor) summed over the
        data ranks; a mastered parameter's come back as its master's block
        under ``shards_grads`` (unless not ``into_masters``).
        ``compress(name, g) -> g`` replaces the ``dp`` sum (PowerSGD)."""
        out = {}
        for name, p in model.named_parameters():
            e = self.entries[name]
            g = fresh.get(name)
            if g is None:
                if "pp" not in e["reduce"]:
                    continue
                # a replicated parameter this stage did not use: its part is 0
                g = torch.zeros_like(p)
            dtype = g.dtype
            axes = e["reduce"]
            to_master = e["master"] is not None and self.shards_grads and into_masters
            if axes or to_master:
                g = self._wire(g)
            if to_master and compress is None:
                for d, axis in gather_axes_order(e["extra"]):
                    g = reduce_scatter_along(g, d, self.mesh.group(axis))
                axes = e["opt_reduce"]
            else:
                g = g.clone()
            for axis in axes:
                if compress is not None and axis == "dp":
                    g = compress(name, g)
                else:
                    all_reduce_(g, self.mesh.group(axis))
            if to_master and compress is not None:
                # PowerSGD compresses whole matrices: the master's block after
                g = g[mesh_lib.local_slice(self.mesh, e["extra"], g.shape, self.coordinate)]
            out[name] = g.to(dtype).contiguous()
        return out

    def accumulate(self, model, reduced: Dict[str, torch.Tensor],
                   stash: Dict[str, Optional[torch.Tensor]]) -> None:
        """Add a micro-step's reduced gradients to the buffers (``stash``:
        each parameter's buffer as it was before the backward)."""
        for name, p in model.named_parameters():
            if name not in reduced:
                p.grad = stash.get(name)
                continue
            e = self.entries[name]
            holder = p
            if e["master"] is not None and self.shards_grads:
                holder, p.grad = e["master"], None
                prev = holder.grad
            else:
                prev = stash.get(name)
            g = reduced[name].to(holder.dtype)
            holder.grad = g if prev is None else prev.add_(g)

    def add_to_buffers(self, model, grads: Dict[str, torch.Tensor]) -> None:
        """Add whole-parameter-block gradients (already reduced) into the
        buffers; a master's buffer takes its block of them."""
        for name, p in model.named_parameters():
            e = self.entries[name]
            g = grads[name]
            holder = p
            if e["master"] is not None and self.shards_grads:
                holder = e["master"]
                g = g[mesh_lib.local_slice(self.mesh, e["extra"], p.shape, self.coordinate)]
            g = g.to(holder.dtype)
            holder.grad = g.clone() if holder.grad is None else holder.grad.add_(g)

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data ranks (a loss, a metric)."""
        t = t.detach().clone()
        for axis in self.data_axes:
            all_reduce_(t, self.mesh.group(axis))
        return t / self.n_data

    def full_tensor(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """A parameter's whole value from every rank's block (a collective:
        every rank calls it); another stage's parameter comes from that
        stage."""
        e = self.entries[name]
        t = block.detach()
        if e["owned"]:
            for d, axis in gather_axes_order(e["pspec"]):
                t = all_gather_along(t, d, self.mesh.group(axis))
        if e["stage"] is not None:
            if not e["owned"]:
                t = torch.empty(e["shape"], dtype=block.dtype, device=block.device)
            owner = dict(self.coordinate, pp=e["stage"])
            src = int(self.mesh.devices[tuple(owner[a] for a in self.mesh.axis_names)])
            t = t.contiguous()
            dist.broadcast(t, src=src, group=self.mesh.group("pp"))
        return t

    def buffers(self, model) -> Dict[str, torch.Tensor]:
        """The accumulation buffers by name: the master's gradient under
        ``shards_grads``, else the parameter's."""
        out = {}
        for name, p in model.named_parameters():
            e = self.entries[name]
            holder = e["master"] if (e["master"] is not None and self.shards_grads) else p
            if holder.grad is not None:
                out[name] = holder.grad
        return out

    def _replicas(self, name: str, spec: PartitionSpec) -> int:
        """How many ranks hold the same block under ``spec``."""
        split = math.prod(self.mesh.shape[a] for entry in spec for a in spec_axes(entry))
        if self.entries[name]["stage"] is not None:
            split *= self.pp
        return self.world // split

    def global_norm(self, model) -> torch.Tensor:
        """The L2 norm of the whole (summed) gradient: each rank's blocks'
        squares, each counted once over the ranks that hold it (the counts
        are powers of two on the usual meshes, so the division is exact),
        summed over every rank.  A world of one takes the single-card
        formula (each buffer's norm, then their vector's), so its step is
        bitwise the card's."""
        bufs = self.buffers(model)
        device = next(model.parameters()).device
        if self.world == 1:
            norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in bufs.values()]
            total = (torch.linalg.vector_norm(torch.stack(norms)) if norms
                     else torch.zeros((), dtype=torch.float32, device=device))
            return all_reduce_(total, None) if dist.is_initialized() else total
        total = torch.zeros((), dtype=torch.float32, device=device)
        for name, g in bufs.items():
            e = self.entries[name]
            spec = e["ospec"] if (e["master"] is not None and self.shards_grads) else e["pspec"]
            total = total + torch.linalg.vector_norm(g, dtype=torch.float32).square() / \
                self._replicas(name, spec)
        all_reduce_(total, None)
        return total.sqrt()

    def all_finite(self, model) -> bool:
        """Every element of every rank's buffers is finite."""
        bufs = list(self.buffers(model).values())
        device = next(model.parameters()).device
        bad = torch.zeros((), dtype=torch.float32, device=device)
        for g in bufs:
            bad = bad + (~torch.isfinite(g)).sum().float()
        if dist.is_initialized():
            all_reduce_(bad, None)
        return bool(bad.item() == 0)

    def to_masters(self, model) -> None:
        """Before an update: each master's gradient from the parameter's
        buffer (unless reduce-scattered there already)."""
        for name, p in model.named_parameters():
            e = self.entries[name]
            m = e["master"]
            if m is None or self.shards_grads:
                continue
            m.grad = None if p.grad is None else p.grad[
                mesh_lib.local_slice(self.mesh, e["extra"], p.shape, self.coordinate)
            ].to(m.dtype).clone()

    def from_masters(self, model) -> None:
        """After an update: each master all-gathered back into its
        parameter's block."""
        with torch.no_grad():
            for name, p in model.named_parameters():
                e = self.entries[name]
                m = e["master"]
                if m is None:
                    continue
                t = m.data
                for d, axis in gather_axes_order(e["extra"]):
                    t = all_gather_along(t, d, self.mesh.group(axis))
                p.data.copy_(t.to(p.dtype))

    def zero_grad(self, model) -> None:
        for name, p in model.named_parameters():
            p.grad = None
            if self.entries[name]["master"] is not None:
                self.entries[name]["master"].grad = None


def _full_spec(spec: PartitionSpec, ndim: int) -> PartitionSpec:
    return PartitionSpec(*(list(spec) + [None] * (ndim - len(spec))))


def _splits(spec: PartitionSpec, axis: str) -> bool:
    return any(axis in spec_axes(e) for e in spec)


def _refinement(pspec: PartitionSpec, ospec: PartitionSpec) -> Optional[PartitionSpec]:
    """The axes ``ospec`` adds to ``pspec`` on each dim (the optimizer's
    block within the module's), or ``None`` when ``ospec`` does not refine
    ``pspec`` (each dim's parameter axes a major prefix of its optimizer
    axes)."""
    extra = []
    for pe, oe in zip(pspec, ospec):
        pa, oa = spec_axes(pe), spec_axes(oe)
        if oa[:len(pa)] != pa:
            return None
        rest = oa[len(pa):]
        extra.append(None if not rest else (rest[0] if len(rest) == 1 else rest))
    return PartitionSpec(*extra)
