"""K4: fused RMSNorm forward, a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `ray_tpu/ops/pallas/rmsnorm.py`
(`_rmsnorm_kernel`, launched by `_fwd`). The CUDA source is
`ray_tpu_torch/csrc/rmsnorm.cu`; its header note says what bounds it on
the card and how its grid differs from the TPU's.

`fused_rms_norm` is the counterpart of the reference's public
`fused_rms_norm`: a drop-in for `ops.norms.rms_norm` whose forward is the
kernel and whose backward runs autograd through the plain math, as the
reference's `jax.custom_vjp` does (there is no backward kernel there
either). It is opt-in: no model calls it, as in the reference.

`rmsnorm_fwd` routes by device: a CPU tensor takes `rms_norm_plain`, a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..norms import rms_norm
from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# The plain version: fp32 mean of x^2, rsqrt(ms + eps), x weight, cast to
# x's type; the same function the model's norms call.
rms_norm_plain = rms_norm


def _lib():
    fn = build.load("rmsnorm").rtt_rmsnorm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(x2d: torch.Tensor, weight: torch.Tensor) -> None:
    if x2d.dim() != 2 or weight.shape != (x2d.shape[1],):
        raise ValueError(f"rmsnorm: x {tuple(x2d.shape)}, weight "
                         f"{tuple(weight.shape)}; want (rows, d) and (d,)")
    if x2d.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: dtypes {x2d.dtype}/{weight.dtype}; the "
                        f"kernel takes float32, bfloat16 or float16")
    if weight.device != x2d.device:
        raise ValueError(f"rmsnorm: weight on {weight.device}, x on "
                         f"{x2d.device}")
    for name, t in (("x", x2d), ("weight", weight)):
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} is not contiguous")


def rmsnorm_fwd(x2d: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x2d (rows, d), weight (d,) -> (rows, d) in x's type. CPU tensors
    take the plain version; CUDA tensors launch K4."""
    if x2d.device.type == "cpu":
        return rms_norm_plain(x2d, weight, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x2d.device}")
    _check_inputs(x2d, weight)
    out = torch.empty_like(x2d)
    if x2d.shape[0] == 0:
        return out
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    status = _lib()(x2d.data_ptr(), weight.data_ptr(), out.data_ptr(),
                    x2d.shape[0], x2d.shape[1], float(eps),
                    _DTYPES[x2d.dtype], _DTYPES[weight.dtype], stream)
    build.check(status, "rmsnorm")
    rmsnorm_fwd.launches += 1
    return out


rmsnorm_fwd.launches = 0


class _FusedRMSNorm(torch.autograd.Function):
    """Counterpart of the `jax.custom_vjp` `_rmsnorm`: the forward is K4
    and saves (x, weight); the backward is autograd through the plain
    math, as `_rmsnorm_vjp_bwd` takes `jax.vjp` of it. Each gradient
    comes back in its input's type."""

    @staticmethod
    def forward(ctx, x2d, weight, eps):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        return rmsnorm_fwd(x2d, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, weight = ctx.saved_tensors
        with torch.enable_grad():
            x = x2d.detach().requires_grad_()
            w = weight.detach().requires_grad_()
            gx, gw = torch.autograd.grad(rms_norm_plain(x, w, ctx.eps),
                                         (x, w), g)
        return gx, gw, None


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Drop-in for `ops.norms.rms_norm` with the K4 forward. x: (..., d);
    weight: (d,). Leading dims are flattened into rows, as the reference
    does. The reference's `block_rows` and `interpret` are not taken:
    the tensor's device picks the route, and the launch its grid and
    rows a stage from the card's SM count and shared memory."""
    d = x.shape[-1]
    out = _FusedRMSNorm.apply(x.reshape(-1, d).contiguous(),
                              weight.contiguous(), eps)
    return out.reshape(x.shape)
