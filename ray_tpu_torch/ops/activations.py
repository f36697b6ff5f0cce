"""Gated activations (counterpart of ray_tpu/ops/activations.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
