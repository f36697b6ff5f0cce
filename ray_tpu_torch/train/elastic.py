"""Elastic training (counterpart of ray_tpu/train/elastic.py): so far
`reshard_mesh_spec`, a pure function. The gang supervisor and the
elastic trainer need the runtime's actors and wait for a later slice.
"""
from __future__ import annotations

import dataclasses

from ..parallel.mesh import MeshSpec


def reshard_mesh_spec(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """Scale a MeshSpec onto a different global device count by scaling
    the dp axis: mesh layout is a re-derivable FUNCTION of the surviving
    world, not fixed job state. Model-parallel axes (tp/sp/fsdp/ep/pp)
    keep their shape; only data parallelism stretches or shrinks."""
    if spec.size == n_devices:
        return spec
    per_dp = spec.size // spec.dp       # devices consumed by other axes
    if per_dp <= 0 or n_devices % per_dp != 0 or n_devices < per_dp:
        raise ValueError(
            f"cannot reshard MeshSpec {spec.axis_sizes()} onto "
            f"{n_devices} devices: non-dp axes need multiples of "
            f"{per_dp} devices")
    return dataclasses.replace(spec, dp=n_devices // per_dp)


__all__ = ["reshard_mesh_spec"]
