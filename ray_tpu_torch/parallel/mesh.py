"""Device mesh construction (counterpart of ray_tpu/parallel/mesh.py).

Axes (any may be 1):
  dp    data parallel, params replicated
  fsdp  data parallel with params, grads and moments sharded (FSDP2)
  tp    tensor parallel (heads / hidden sharded; DTensor plans)
  sp    sequence / context parallel (ring attention over this axis)
  ep    expert parallel (MoE experts sharded; tokens move by all-to-all)
  pp    pipeline parallel (layer stages)

JAX sees every device from one process; here each rank is a process
(`train.backend.launch` starts them) and the mesh is a torch
`DeviceMesh` over the default process group's world, every axis present
even where its size is 1, in the reference's order: tp and sp innermost
(nearest neighbours, NVLink peers on one host), dp and fsdp outermost.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def axis_sizes(self) -> dict:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def nontrivial_axes(self) -> Sequence[str]:
        return [a for a in AXIS_ORDER if getattr(self, a) > 1]

    def validate(self, n_devices: int) -> None:
        if self.size != n_devices:
            raise ValueError(
                f"MeshSpec {self.axis_sizes()} needs {self.size} devices, "
                f"got {n_devices}")


def _world_size() -> int:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a process group: run under "
            "train.backend.launch or call train.backend.setup_worker first")
    return dist.get_world_size()


def build_mesh(spec: MeshSpec, device: str = "cuda"):
    """A `DeviceMesh` over the world with `mesh_dim_names=AXIS_ORDER`;
    `spec.size` must equal the world size. `device` is the mesh's device
    type: "cuda" (NCCL) or "cpu" (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    spec.validate(_world_size())
    dev = torch.device(device).type
    shape = tuple(getattr(spec, a) for a in AXIS_ORDER)
    return init_device_mesh(dev, shape, mesh_dim_names=AXIS_ORDER)


def local_mesh_spec(tp: Optional[int] = None) -> MeshSpec:
    """A single-host default: tensor-parallel over the world."""
    return MeshSpec(tp=tp or _world_size())


def fsdp_mesh_spec(n_devices: Optional[int] = None) -> MeshSpec:
    return MeshSpec(fsdp=n_devices or _world_size())


__all__ = ["AXIS_ORDER", "MeshSpec", "build_mesh", "local_mesh_spec",
           "fsdp_mesh_spec"]
