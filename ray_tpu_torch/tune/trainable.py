"""Class-based Trainable API (counterpart of
ray_tpu/tune/trainable.py).

Reference counterpart: python/ray/tune/trainable/trainable.py — the
setup/step/save_checkpoint/load_checkpoint contract, driven by the trial
actor: step() results are reported through the same scheduler channel as
function trainables, so ASHA/PBT/stoppers work identically.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Trainable:
    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- override points --
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        """One training iteration; return a metrics dict. Set key
        'done': True to finish the trial."""
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- driver loop --
    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def stop(self) -> None:
        self.cleanup()
