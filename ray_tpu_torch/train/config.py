"""Training configuration dataclasses (counterpart of
ray_tpu/train/config.py).

Reference parity: python/ray/air/config.py (ScalingConfig, RunConfig,
FailureConfig, CheckpointConfig). ScalingConfig speaks in workers and a
MeshSpec: one worker process a card here (`train.backend.launch`),
where the reference runs one worker a host driving every local chip.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """How to scale the job across workers/cards.

    num_workers: worker processes.
    mesh: MeshSpec for the global device mesh (dp/fsdp/tp/sp/ep/pp).
    use_gpu: claim a GPU in the worker (False -> the CPU, for tests);
      the counterpart of the reference's use_tpu.
    resources_per_worker: extra custom resources per worker.
    """
    num_workers: int = 1
    mesh: Optional[MeshSpec] = None
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0          # worker-group restarts before giving up


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = 2
    checkpoint_frequency: int = 0  # steps between automatic checkpoints


@dataclasses.dataclass
class RunConfig:
    name: str = "ray_tpu_run"
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    verbose: int = 1
    # tune: stop condition (dict | callable | Stopper) and lifecycle
    # callbacks (reference: air.RunConfig(stop=..., callbacks=[...]))
    stop: Optional[Any] = None
    callbacks: Optional[list] = None

    def run_dir(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        path = os.path.join(base, self.name)
        os.makedirs(path, exist_ok=True)
        return path


__all__ = ["ScalingConfig", "FailureConfig", "CheckpointConfig",
           "RunConfig"]
