"""Activations (counterpart of ray_tpu/ops/activations.py).

`gelu` is GELU as `jax.nn.gelu` and `flax.linen.gelu` compute it by
default: the tanh approximation, not the exact erf form of torch's
default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return gelu(gate) * up
