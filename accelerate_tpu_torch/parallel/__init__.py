"""Parallelism of the port: process meshes, sharding rules, tensor, pipeline,
sequence and expert parallelism, and PowerSGD.

Port of :mod:`accelerate_tpu.parallel`'s exports: :mod:`.mesh`,
:mod:`.sharding`, :mod:`.tensor_parallel`, :mod:`.pipeline`,
:mod:`.ring_attention`, :mod:`.compression` and :mod:`.moe`.  The
collectives are explicit ``torch.distributed`` calls over the mesh's
groups.
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
from .pipeline import (
    pipeline_apply,
    pipeline_lm_loss_fn,
    prepare_pipeline,
    schedule_slots,
    stack_layer_params,
)
from .ring_attention import (
    ring_attention,
    ring_attention_sharded,
    ring_attention_zigzag,
    zigzag_permutation,
)

__all__ = ["DATA_AXES", "MESH_AXES", "MoEMLP", "build_mesh", "compressed_pmean",
           "compression_stats", "data_partition_spec", "data_sharding", "mesh_axis_size",
           "num_data_shards", "pipeline_apply", "pipeline_lm_loss_fn", "powersgd_init",
           "prepare_pipeline", "replicated_sharding", "ring_attention",
           "ring_attention_sharded", "ring_attention_zigzag", "router_aux_loss",
           "schedule_slots", "shard_moe_params", "stack_layer_params", "top_k_dispatch",
           "zigzag_permutation"]
