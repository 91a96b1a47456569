"""Parallelism primitives of the port: the mesh and its logical-dim
sharding rules (``mesh``), the tensor-parallel pieces the model's blocks
use under the sharded train step (``tensor_parallel``), the pipeline
schedules and ``pipeline_apply`` (``pipeline``), ring and Ulysses
attention (``ring_attention``), and the wire between the ranks of one
axis they share (``_wire``). The multi-slice ``SliceTopology`` waits for
ROADMAP Queue A item 4a, two-tier."""

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

__all__ = [
    "AXES",
    "DEFAULT_RULES",
    "LogicalRules",
    "LogicalSpec",
    "MeshSpec",
    "auto_shard_specs",
    "fsdp_extend_spec",
    "shard_batch",
    "single_host_mesh",
    "transformer_tp_rules",
]
