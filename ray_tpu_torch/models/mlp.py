"""Small dense nets: MLP and ResNet-lite (counterpart of
ray_tpu/models/mlp.py).

flax infers input widths at init; here they are given: `MLP(cfg,
in_dim)`, `ResNetLite(channels=3)`. Images are NHWC at the interface.
GroupNorm keeps flax's epsilon (1e-6; torch's default is 1e-5) and its
parameter names (`scale`, `bias`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gelu
from ..ops.linear import Conv, Dense
from ..util.device import DeviceLike, resolve_device
from .vit import _flax_init_


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden: Sequence[int] = (64, 64)
    out_dim: int = 1
    activation: str = "tanh"     # "tanh" | "relu" | "gelu"
    dtype: torch.dtype = torch.float32


_ACTS = {"tanh": torch.tanh, "relu": F.relu, "gelu": gelu}


class MLP(nn.Module):
    """x (..., in_dim) -> (..., out_dim)."""

    def __init__(self, cfg: MLPConfig, in_dim: int, *,
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.activation not in _ACTS:
            raise ValueError(f"activation={cfg.activation!r}; valid: "
                             f"{sorted(_ACTS)}")
        with torch.device("meta"):
            widths = [in_dim, *cfg.hidden]
            for i, (a, b) in enumerate(zip(widths, widths[1:])):
                setattr(self, f"fc_{i}", Dense(a, b, dtype=cfg.dtype))
            self.head = Dense(widths[-1], cfg.out_dim, dtype=cfg.dtype)
        self.to_empty(device=dev)
        _flax_init_(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _ACTS[self.cfg.activation]
        for i in range(len(self.cfg.hidden)):
            x = act(getattr(self, f"fc_{i}")(x))
        return self.head(x)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm on NHWC: `num_groups` groups of consecutive
    channels, epsilon 1e-6, parameters `scale` and `bias`."""

    def __init__(self, channels: int, num_groups: int = 8,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), self.num_groups,
                         self.scale, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class ResNetLite(nn.Module):
    """Tiny pre-activation residual conv net for 32x32-ish images:
    images (B, H, W, C) -> logits (B, num_classes)."""

    def __init__(self, num_classes: int = 10, width: int = 32,
                 n_blocks: int = 3, channels: int = 3, *,
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.n_blocks = n_blocks
        with torch.device("meta"):
            self.stem = Conv(channels, width, 3)
            c = width
            for i in range(n_blocks):
                w = width * (2 ** i)
                setattr(self, f"block{i}_gn1", GroupNorm(c))
                setattr(self, f"block{i}_conv1", Conv(c, w, 3))
                setattr(self, f"block{i}_gn2", GroupNorm(w))
                setattr(self, f"block{i}_conv2", Conv(w, w, 3))
                if c != w:
                    setattr(self, f"block{i}_skip", Conv(c, w, 1))
                c = w
            self.head = Dense(c, num_classes)
        self.to_empty(device=dev)
        _flax_init_(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(self.n_blocks):
            m = {n: getattr(self, f"block{i}_{n}", None)
                 for n in ("gn1", "conv1", "gn2", "conv2", "skip")}
            h = m["conv1"](F.relu(m["gn1"](x)))
            h = m["conv2"](F.relu(m["gn2"](h)))
            if m["skip"] is not None:
                x = m["skip"](x)
            x = x + h
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return self.head(x.mean(dim=(1, 2)))
