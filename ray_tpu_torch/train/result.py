"""Result of a training run (counterpart of ray_tpu/train/result.py;
reference: python/ray/air/result.py)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    path: str = ""
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []

    def metrics_dataframe(self):
        import pandas as pd
        return pd.DataFrame(self.metrics_history)


__all__ = ["Result"]
