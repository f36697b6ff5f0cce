"""Layer equations shared by the references: RMSNorm, rotary embeddings
(each head vector split into halves, as Hugging Face's Mistral and
Mixtral rotate), causal grouped-query attention in query blocks, SwiGLU,
and the float8 (e4m3) rounding of a matrix product's operands that the
lower-precision control applies."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0   # largest finite float8 e4m3 value


@contextlib.contextmanager
def fp32_exact():
    """Float32 products in float32: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (its largest magnitude maps to 448), back in x's type. The gradient
    passes straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back; the gradient passes straight
    through (a witness of what bf16 operands alone cost)."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


def low(x: torch.Tensor, control, dim: int = -1) -> torch.Tensor:
    """x as the control's precision has it: float8 (control True or
    "fp8"), bfloat16 ("bf16"), or unchanged (False)."""
    if not control:
        return x
    return bf16_round(x) if control == "bf16" else fp8_round(x, dim)


def mm(x: torch.Tensor, w: torch.Tensor, control) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T; the control rounds x per row and w
    per output row to its precision first."""
    return low(x, control, -1) @ low(w, control, -1).t()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin of (S, head_dim / 2), computed in float64."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float64,
                            device=positions.device) / head_dim
    inv = 1.0 / (theta ** exponent)
    ang = positions.double()[:, None] * inv[None]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (S, H, D): the first and second halves of each head rotated."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _attend_block(q, k, v, q0: int, control):
    """Queries q (n, H, D) at positions q0.. against keys 0..q0+n-1."""
    n, h, d = q.shape
    q, k = low(q, control, -1), low(k, control, -1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * d ** -0.5
    qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
    kpos = torch.arange(k.shape[0], device=q.device)[None]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p, v = low(p, control, -1), low(v, control, 0)
    return torch.einsum("hqk,khd->qhd", p, v)


def causal_attention(q, k, v, control=False, block: int = 1024,
                     recompute: bool = False):
    """Causal attention, q (S, H, D), k and v (S, Hkv, D); query head h
    reads kv head h // (H / Hkv). Blocks of `block` queries bound the
    score matrix; with `recompute` each block is checkpointed, so a
    backward holds one block's scores at a time."""
    s, h, _ = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    outs = []
    for q0 in range(0, s, block):
        q1 = min(s, q0 + block)
        args = (q[q0:q1], k[:q1], v[:q1], q0, control)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if recompute else _attend_block(*args))
    return torch.cat(outs, dim=0)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
