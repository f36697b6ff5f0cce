"""Rotary position embeddings (counterpart of ray_tpu/ops/rotary.py).

The rotation splits each head vector into halves (x1 = first half,
x2 = second half); it does not interleave pairs.
"""
from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 500000.0,
                     dtype: torch.dtype = torch.float32,
                     device=None):
    """cos/sin tables of shape (max_len, head_dim // 2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (max_len, head_dim // 2);
    positions: optional (..., seq) integer positions (decode steps,
    packed sequences) gathered from the tables."""
    seq = x.shape[-3]
    if positions is None:
        c, s = cos[:seq], sin[:seq]
        c = c[None, :, None, :] if x.dim() == 4 else c[:, None, :]
        s = s[None, :, None, :] if x.dim() == 4 else s[:, None, :]
    else:
        c = cos[positions.long()][..., :, None, :]
        s = sin[positions.long()][..., :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = c.to(x.dtype)
    s = s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
