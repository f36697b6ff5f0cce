"""Parallelism of the port (counterpart of ray_tpu/parallel/).

JAX shards with `jax.sharding.Mesh` + NamedSharding and lets XLA insert
the collectives from one process. Here each rank is a process
(`train.backend.launch`), the mesh is a torch `DeviceMesh`
(`build_mesh`), the rule table shards modules with FSDP2 and DTensor
plans (`shard_module`), and the sequence and pipeline axes run their
own P2P schedules (ops/ring_attention.py, pipeline*.py).
"""
from .mesh import AXIS_ORDER, MeshSpec, build_mesh, local_mesh_spec
from .pipeline import pipeline_apply, pipeline_reference, stack_stage_params
from .pipeline_train import (PipelinedLM, PipelinedLMState,
                             make_pipeline_train_step)
from .precision import BF16, FP32, Precision
from .sharding import (DEFAULT_RULES, P, ShardingRules, batch_sharding,
                       partition_spec_for, shard_module, shard_pytree)

__all__ = ["MeshSpec", "build_mesh", "local_mesh_spec", "AXIS_ORDER",
           "ShardingRules", "DEFAULT_RULES", "partition_spec_for",
           "shard_module", "shard_pytree", "batch_sharding", "P", "Precision", "BF16",
           "FP32", "pipeline_apply", "PipelinedLM", "PipelinedLMState",
           "make_pipeline_train_step", "pipeline_reference",
           "stack_stage_params"]
