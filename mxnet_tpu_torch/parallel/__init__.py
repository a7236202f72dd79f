"""Parallelism on a single-controller device mesh (counterpart of
``mxnet_tpu/parallel``): the mesh, sharding rules and collectives
(``mesh``), branch selection by platform (``_compat``), sequence-parallel
ring and Ulysses attention (``ring_attention``), tensor parallelism
(``tensor_parallel``), expert parallelism (``moe``) and pipeline
parallelism (``pipeline``).  One process drives every device of a mesh;
the multi-process layer (``comm``, the data-parallel trainer, kvstores,
elastic runs) is not ported yet.
"""
from .mesh import (make_mesh, data_parallel_sharding, replicated_sharding,
                   ShardingRules, megatron_rules, Mesh, NamedSharding,
                   PartitionSpec, P)
from . import tensor_parallel
from . import ring_attention
from . import pipeline
from .pipeline import Pipeline, pipeline_apply
from . import moe
from .moe import moe_ffn, top_k_gating, init_moe_params

__all__ = ["make_mesh", "data_parallel_sharding", "replicated_sharding",
           "ShardingRules", "megatron_rules", "Mesh", "NamedSharding",
           "PartitionSpec", "P", "tensor_parallel", "ring_attention",
           "pipeline", "Pipeline", "pipeline_apply", "moe", "moe_ffn",
           "top_k_gating", "init_moe_params"]
