"""Process meshes: the named axes every parallelism strategy is a placement over.

Port of :mod:`accelerate_tpu.parallel.mesh`.  The axes and their order are
the JAX package's (``dp``, ``fsdp``, ``tp``, ``sp``, ``pp``, ``ep``); a
mesh's positions are processes (one device each) instead of devices of one
process.  :class:`Mesh` holds the axes, the ranks laid out over them and,
once a process group exists, the ``torch.distributed.device_mesh.
DeviceMesh`` over those ranks (its per-axis groups carry the collectives).

A sharding is a :class:`PartitionSpec` — per tensor dim, the mesh axes
that split it, major first, as in JAX — over a mesh (:class:`NamedSharding`);
:meth:`NamedSharding.placements` gives the DTensor placements of the same
layout where DTensor can say it.  :func:`local_slice` is the block a rank
holds.

``shard_map`` has no counterpart: the port's step is eager, each process
runs its own shard of the program, and the collectives are explicit
(``utils/operations.py``, ``parallel/sharding.py``).  :func:`ppermute` is
``lax.ppermute`` over one axis's group: every rank sends its tensors
``shift`` places along the group and receives its predecessor's.  It is an
``all_to_all_single`` whose only non-empty split is the one to the
receiver: gloo writes a card tensor's device pointer to its socket on a
point-to-point send (its TCP pair fails with "Bad address"), while every
backend takes that collective on card tensors, so one call serves both.
:func:`hop` is its differentiable form, whose backward is the reverse hop.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")

# batch (dim 0) is split over every data axis
DATA_AXES = ("dp", "fsdp")


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, one mesh axis, or a tuple of axes (major
    first) — ``jax.sharding.PartitionSpec``'s meaning."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __reduce__(self):
        return PartitionSpec, tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes of one :class:`PartitionSpec` entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """Named axes over process ranks.  ``devices`` is the array of ranks in
    the mesh's shape (the JAX mesh's device array); ``device_mesh`` the
    ``DeviceMesh`` over them when a process group exists."""

    def __init__(self, axes: Dict[str, int], ranks: Optional[np.ndarray] = None,
                 device_type: str = "cpu"):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        size = math.prod(self.shape.values())
        self.devices = (np.arange(size) if ranks is None else np.asarray(ranks)).reshape(
            tuple(self.shape.values()))
        self.device_type = device_type
        self.device_mesh = None
        self._host_group = None
        self._span_group = None
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            from torch.distributed.device_mesh import DeviceMesh

            self.device_mesh = DeviceMesh(device_type, torch.as_tensor(self.devices),
                                          mesh_dim_names=self.axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The mesh's ranks in mesh order (its first is its lead rank)."""
        return tuple(int(r) for r in self.devices.reshape(-1))

    def __contains__(self, rank: int) -> bool:
        return int(rank) in self.ranks

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis -> index of ``rank`` (this process's by default)."""
        if rank is None:
            rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str) -> int:
        return self.coordinate()[axis] if axis in self.shape else 0

    def group(self, axis: str):
        """This process's group along ``axis``; ``None`` when the axis has
        size 1 (or is absent), so no collective is needed over it."""
        if self.shape.get(axis, 1) <= 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def span_group(self):
        """The process group over every rank of the mesh, on the world's
        backend (a one-axis mesh's group along that axis).  A mesh of the
        whole world takes its ``DeviceMesh``'s (the default group when the
        world is one process); a replica's mesh (:func:`replica_meshes`)
        was given its group, of one rank too, when the meshes were made."""
        if self._span_group is not None:
            return self._span_group
        if self.device_mesh is not None and len(self.axis_names) == 1:
            return self.device_mesh.get_group(self.axis_names[0])
        return None

    def host_group(self):
        """A gloo group over every rank of the mesh, made on the first call
        and kept: collectives of host tensors whatever the card's backend
        (the serving engines' per-step plan exchange).  Every rank makes the
        first call together (``dist.new_group`` is collective); a replica's
        mesh has its group from :func:`replica_meshes`."""
        if self._host_group is None:
            self._host_group = dist.new_group(ranks=self.devices.reshape(-1).tolist(),
                                              backend="gloo")
        return self._host_group

    def __repr__(self):
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def _resolve_axis_sizes(axes: Dict[str, int], n_devices: int) -> Dict[str, int]:
    """Fill the -1 axis with the remaining process count; validate the product."""
    sizes = dict(axes)
    fixed = 1
    wild = [k for k, v in sizes.items() if v in (-1, None)]
    for v in sizes.values():
        if v not in (-1, None):
            fixed *= v
    if n_devices % fixed != 0:
        raise ValueError(f"Mesh axes {axes} do not divide device count {n_devices}")
    if len(wild) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {wild}")
    if wild:
        sizes[wild[0]] = n_devices // fixed
    elif fixed > n_devices:
        raise ValueError(f"Mesh axes {axes} multiply to {fixed} > device count {n_devices}")
    return sizes


def _world() -> Tuple[int, str]:
    from ..state import PartialState

    state = PartialState()
    return state.num_processes, state.device.type


def build_mesh(axes: Optional[Dict[str, int]] = None, *, devices: Optional[Sequence[int]] = None,
               dcn_axes: Optional[Dict[str, int]] = None,
               allow_split_physical_axes: bool = False) -> Mesh:
    """A named mesh over the processes (``devices``: the ranks, all of them
    by default), with the JAX package's rules: no axes means every process
    on ``dp``; axes of size 1 other than ``dp`` drop out; one -1 axis takes
    what the others leave.  ``dcn_axes`` (the hybrid mesh) names the outer
    part of an axis that spans nodes: it is validated as the reference
    does, and since ranks are numbered node by node, the axes' order lays
    that part across nodes.  Every process must call this together (the
    ``DeviceMesh`` makes its groups)."""
    n, device_type = _world()
    ranks = list(range(n)) if devices is None else list(devices)
    n = len(ranks)
    if not axes:
        axes = {"dp": n}
    axes = {k: v for k, v in axes.items() if v != 1 or k == "dp"} or {"dp": 1}
    axes = _resolve_axis_sizes(axes, n)
    used = math.prod(axes.values())
    if used < n:
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if world > 1:
            raise ValueError(f"Mesh axes {axes} cover {used} of the {world} processes: "
                             "with one device a process, a mesh covers them all")
        ranks = ranks[:used]
    names = tuple(axes)
    if dcn_axes:
        unknown = set(dcn_axes) - set(names)
        if unknown:
            raise ValueError(f"dcn_axes {sorted(unknown)} not present in mesh axes {names}")
        for k, dcn in dcn_axes.items():
            if dcn <= 0 or axes[k] % dcn != 0:
                raise ValueError(f"dcn size {dcn} for axis {k!r} must divide its total "
                                 f"size {axes[k]}")
    return Mesh(axes, np.asarray(ranks).reshape(tuple(axes.values())), device_type)


def replica_meshes(n_replicas: int, axes: Optional[Dict[str, int]] = None, *,
                   devices: Optional[Sequence[int]] = None) -> List[Mesh]:
    """The ranks split into ``n_replicas`` disjoint groups, one mesh of
    ``axes`` each (one rank each with ``axes=None``).  These meshes carry
    no ``DeviceMesh``: a router's replicas do not share a program.  With a
    process group up, each mesh gets its groups here, in mesh order: the
    group over its ranks on the world's backend (:meth:`Mesh.span_group`,
    a serving engine's ``tp`` group) and a gloo one (:meth:`Mesh.
    host_group`, its plan exchange; the same group when the world runs
    gloo).  ``dist.new_group`` is collective over the world, even for a
    rank outside the new group, so every rank calls this alike."""
    n, device_type = _world()
    ranks = list(range(n)) if devices is None else list(devices)
    if n_replicas <= 0:
        raise ValueError(f"n_replicas must be positive, got {n_replicas}")
    axes = dict(axes) if axes else {"dp": 1}
    per = math.prod(axes.values())
    if per * n_replicas > len(ranks):
        raise ValueError(f"{n_replicas} replicas x {per} devices/replica exceeds "
                         f"{len(ranks)} available devices")
    out = []
    for i in range(n_replicas):
        mesh = Mesh.__new__(Mesh)
        mesh.shape, mesh.axis_names = dict(axes), tuple(axes)
        mesh.devices = np.asarray(ranks[i * per:(i + 1) * per]).reshape(tuple(axes.values()))
        mesh.device_type, mesh.device_mesh = device_type, None
        mesh._host_group = mesh._span_group = None
        if dist.is_available() and dist.is_initialized():
            members = mesh.ranks
            mesh._span_group = dist.new_group(ranks=list(members))
            mesh._host_group = (mesh._span_group if dist.get_backend() == "gloo"
                                else dist.new_group(ranks=list(members), backend="gloo"))
        out.append(mesh)
    return out


_WORLD_HOST: Dict[str, object] = {}


def world_host_group():
    """A gloo group over every rank of the world: host exchanges whatever
    the card's backend (a router over processes).  The default group when
    it runs gloo; else one made on the first call of this process group
    (collective: every rank calls it together) and kept with it."""
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _WORLD_HOST.get("world") is not world:
        _WORLD_HOST.update(world=world, group=dist.new_group(backend="gloo"))
    return _WORLD_HOST["group"]


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh` (``jax.sharding.
    NamedSharding``'s counterpart); ``memory_kind`` ``"pinned_host"`` marks
    state the offload tiers keep on the host."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, memory_kind: Optional[str] = None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        self.memory_kind = memory_kind

    @property
    def placements(self):
        """The DTensor placements of this layout, one per mesh axis:
        ``Shard(d)`` where an axis splits dim ``d``, else ``Replicate()``.
        A dim split by several axes is expressible only with the axes in
        mesh order (DTensor nests them that way); otherwise this raises."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in self.mesh.axis_names]
        for d, entry in enumerate(self.spec):
            axes = spec_axes(entry)
            order = [self.mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"{self.spec}: dim {d} splits over {axes}, major first, "
                                 "which DTensor nests in mesh order only")
            for i in order:
                out[i] = Shard(d)
        return out

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec)
                and other.memory_kind == self.memory_kind)

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r}, memory_kind={self.memory_kind})"


def shard_count(mesh: Mesh, entry) -> int:
    return math.prod(mesh.shape.get(a, 1) for a in spec_axes(entry))


def local_slice(mesh: Mesh, spec: PartitionSpec, shape: Sequence[int],
                coordinate: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The block of a ``shape`` tensor that the rank at ``coordinate`` (this
    process by default) holds under ``spec``: along each dim split by axes
    ``(a1, a2, ...)`` (major first), block ``i_a1 * |a2| * ... + i_a2 * ...``
    of ``|a1| * |a2| * ...`` equal blocks, as JAX lays out a sharded array."""
    coordinate = mesh.coordinate() if coordinate is None else coordinate
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = spec_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        block, k = 0, 1
        for a in axes:
            block = block * mesh.shape[a] + coordinate.get(a, 0)
            k *= mesh.shape[a]
        chunk = size // k
        out.append(slice(block * chunk, (block + 1) * chunk))
    return tuple(out)


def present_data_axes(mesh: Mesh) -> tuple:
    """The data axes this mesh actually has (size > 1)."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names and mesh.shape[a] > 1)


def data_partition_spec(mesh: Mesh) -> PartitionSpec:
    """Batch dim 0 split over every data axis present."""
    present = present_data_axes(mesh)
    return PartitionSpec(present) if present else PartitionSpec()


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, data_partition_spec(mesh))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def num_data_shards(mesh: Mesh) -> int:
    spec = data_partition_spec(mesh)
    return shard_count(mesh, spec[0]) if spec else 1


def data_shard_index(mesh: Mesh, coordinate: Optional[Dict[str, int]] = None) -> int:
    """Which of the :func:`num_data_shards` batch blocks a rank holds (the
    mesh position of the same index in the JAX package)."""
    spec = data_partition_spec(mesh)
    if not spec:
        return 0
    return local_slice(mesh, PartitionSpec(spec[0]), (num_data_shards(mesh),),
                       coordinate)[0].start


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.axis_names else 1


def ppermute(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """Each tensor sent ``shift`` ranks ahead in ``group`` (wrapping); the
    returned tensors are the ones that arrived from ``shift`` ranks behind.
    Every rank of the group calls it with tensors of the same shapes and
    dtypes.  ``group`` ``None`` (a one-rank axis) returns the tensors."""
    if group is None:
        return list(tensors)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    if shift % n == 0:
        return list(tensors)
    dst, src = (me + shift) % n, (me - shift) % n
    out = []
    for x in tensors:
        x = x.contiguous()
        got = torch.empty_like(x)
        numel = x.numel()
        dist.all_to_all_single(
            got.view(-1), x.view(-1),
            output_split_sizes=[numel if r == src else 0 for r in range(n)],
            input_split_sizes=[numel if r == dst else 0 for r in range(n)], group=group)
        out.append(got)
    return out


class _Hop(torch.autograd.Function):
    """:func:`ppermute` forward, the reverse hop backward.  ``after`` ties
    the call to an earlier hop's output, so that every rank runs the hops'
    backwards in the reverse order of their forwards (the collectives must
    meet), whether or not a rank used what it received."""

    @staticmethod
    def forward(ctx, group, shift, after, *xs):
        ctx.group, ctx.shift = group, shift
        ctx.after = None if after is None else (after.shape, after.dtype, after.device)
        return tuple(ppermute(xs, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        back = ppermute(grads, ctx.group, -ctx.shift)
        after = None if ctx.after is None else torch.zeros(
            ctx.after[0], dtype=ctx.after[1], device=ctx.after[2])
        return (None, None, after, *back)


def hop(tensors: Sequence[torch.Tensor], group, shift: int = 1,
        after: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """:func:`ppermute`, differentiable: the gradients travel ``-shift``.
    ``after`` (an earlier hop's output) orders the backward."""
    if group is None:
        return list(tensors)
    return list(_Hop.apply(group, shift, after, *tensors))


def sp_shardable(mesh: Mesh, batch: int, seq: int) -> bool:
    """Whether a ``[batch, seq, ...]`` activation can split batch over the
    data axes and seq over ``sp`` (the reference's gate for ring attention)."""
    if mesh_axis_size(mesh, "sp") <= 1:
        return False
    data_size = math.prod(mesh.shape[a] for a in present_data_axes(mesh)) or 1
    return batch % data_size == 0 and seq % mesh.shape["sp"] == 0
