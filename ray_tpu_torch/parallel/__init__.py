"""Parallelism primitives of the port: the mesh and its logical-dim
sharding rules (``mesh``), the tensor-parallel pieces the model's blocks
use under the sharded train step (``tensor_parallel``), the pipeline
schedules and ``pipeline_apply`` (``pipeline``), ring and Ulysses
attention (``ring_attention``), the wire between the ranks of one axis
they share (``_wire``), and the two-tier ``SliceTopology`` (``topology``)."""

from ray_tpu_torch.parallel.mesh import (
    AXES,
    DEFAULT_RULES,
    LogicalRules,
    LogicalSpec,
    MeshSpec,
    auto_shard_specs,
    fsdp_extend_spec,
    shard_batch,
    single_host_mesh,
    transformer_tp_rules,
)
from ray_tpu_torch.parallel.topology import SliceTopology

__all__ = [
    "AXES",
    "DEFAULT_RULES",
    "LogicalRules",
    "LogicalSpec",
    "MeshSpec",
    "SliceTopology",
    "auto_shard_specs",
    "fsdp_extend_spec",
    "shard_batch",
    "single_host_mesh",
    "transformer_tp_rules",
]
