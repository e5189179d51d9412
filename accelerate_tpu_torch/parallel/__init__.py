"""Parallelism of the port: process meshes, sharding rules, tensor parallelism,
PowerSGD and the Mixture-of-Experts layer.

Port of :mod:`accelerate_tpu.parallel`'s exports for the modules ported so
far: :mod:`.mesh`, :mod:`.sharding`, :mod:`.tensor_parallel`,
:mod:`.compression` and :mod:`.moe` (one card's experts).  The collectives
are explicit ``torch.distributed`` calls over the mesh's groups; the
pipeline and ring attention, and experts over ``ep``, are ROADMAP Queue 1
item 9e-ii.
"""

from .compression import compressed_pmean, compression_stats, powersgd_init
from .mesh import (
    DATA_AXES,
    MESH_AXES,
    build_mesh,
    data_partition_spec,
    data_sharding,
    mesh_axis_size,
    num_data_shards,
    replicated_sharding,
)
from .moe import MoEMLP, router_aux_loss, shard_moe_params, top_k_dispatch

__all__ = ["DATA_AXES", "MESH_AXES", "MoEMLP", "build_mesh", "compressed_pmean",
           "compression_stats", "data_partition_spec", "data_sharding", "mesh_axis_size",
           "num_data_shards", "powersgd_init", "replicated_sharding", "router_aux_loss",
           "shard_moe_params", "top_k_dispatch"]
