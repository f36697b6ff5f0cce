"""Dense products and convolutions (the port's counterparts of flax's
nn.Dense and nn.Conv, and of the reference's
`preferred_element_type=float32` products).

`Dense` is nn.Dense(dtype=...): input, kernel and bias cast to the
compute type, the parameters stored in their own type. `Conv` is
nn.Conv(dtype=...) on NHWC tensors with flax's default "SAME" padding.
`logits_fp32` is a product with operands in the input's type and an
fp32 result, never rounded to that type (the LM heads, the int8
projections).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard


class Dense(nn.Linear):
    """y = x W^T + b in `dtype`; W is (out, in), the nn.Linear layout
    (flax stores its kernel (in, out))."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(d_in, d_out, bias=bias, dtype=param_dtype)
        self.compute_dtype = dtype
        # weight -> the weight the product uses (LoRA's merge over a
        # sharded base, train/lora.py), applied after FSDP2's gather
        self.weight_fn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        w = self.weight if self.weight_fn is None else self.weight_fn(
            self.weight)
        return F.linear(x.to(dt), w.to(dt), b)


class Conv(nn.Conv2d):
    """NHWC in, NHWC out; weight (out, in, kh, kw), the torch layout
    (flax stores its kernel (kh, kw, in, out)). "SAME" padding as XLA
    pads: out = ceil(size / stride), the odd pixel of padding at the
    end."""

    def __init__(self, d_in: int, d_out: int, kernel: int, *,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(d_in, d_out, kernel, stride=stride,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        pads = []
        for size, k, s in ((x.shape[3], self.kernel_size[1], self.stride[1]),
                           (x.shape[2], self.kernel_size[0], self.stride[0])):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        y = F.conv2d(x, self.weight.to(dt), self.bias.to(dt), self.stride)
        return y.permute(0, 2, 3, 1)


class _MatmulFp32Out(torch.autograd.Function):
    """x (N, d) @ w (V, d)^T on CUDA with low-precision operands and an
    fp32 result (`torch.mm(out_dtype=float32)`, which has no derivative
    of its own). The backward rounds the fp32 output gradient to the
    operands' type and runs the two products on the tensor cores, as
    autocast does for a bf16 matmul; dx and dw come back in that type."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.mm(g, w) if ctx.needs_input_grad[0] else None
        dw = torch.mm(g.t(), x) if ctx.needs_input_grad[1] else None
        return dx, dw


def logits_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (V, d)^T with w cast to x's type and fp32
    accumulation, returned in fp32 (never rounded to x's type). A w
    sharded over its rows (vocab) on a one-axis mesh (a DTensor from
    parallel/sharding.py under tp) gives the same logits: each rank's
    rows from the local shard, gathered over the mesh."""
    if isinstance(w, DTensor):
        return _vocab_parallel(x, w)
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        out = _MatmulFp32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[0])
    # a bf16 value is exact in fp32, so this is the same product
    return x.float() @ w.float().t()




def _vocab_parallel(x: torch.Tensor, w: "DTensor") -> torch.Tensor:
    """logits_fp32 with w (V, d) sharded on dim 0: x is the same on
    every rank of the mesh, so its gradient sums the ranks' parts, and
    the gathered logits' gradient is this rank's columns."""
    from ..parallel.collectives import copy_to_group, gather_from_group
    if w.device_mesh.ndim != 1 or w.placements[0] != Shard(0):
        raise ValueError(f"logits_fp32: a DTensor weight must be sharded "
                         f"on dim 0 over one axis, got {w.placements}")
    group = w.device_mesh.get_group()
    local = logits_fp32(copy_to_group(x, group), w.to_local())
    return gather_from_group(local, group, dim=-1)
