"""Parallelism primitives of the port: the mesh and its logical-dim
sharding rules (``mesh``), and the tensor-parallel pieces the model's
blocks use under the sharded train step (``tensor_parallel``). The
pipeline schedulers and sequence-parallel attention of the JAX package's
``parallel/`` are not ported yet (ROADMAP Queue A item 5)."""

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
