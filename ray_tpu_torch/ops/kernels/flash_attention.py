"""K1: flash-attention forward, a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `ray_tpu/ops/pallas/flash_attention.py`
(`_fwd_kernel`, launched by `_flash_fwd`, wrapped by `flash_attention`).
The CUDA source is `ray_tpu_torch/csrc/flash_fwd.cu`; its header note
says what bounds it on the card and how its grid differs from the TPU's.
Forward only: the backward kernels (K2a/K2b) come with the training
slice.

`flash_attention_fwd` routes by device: a CPU tensor takes
`flash_attention_plain` (fp32 scores, explicit masks, softmax), a CUDA
tensor launches the kernel or raises. There is no fallback from the
kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)      # head sizes the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D), Hq % Hkv == 0.
    Returns (out (B, Sq, Hq, D) in q's type, lse (B*Hq, Sq) fp32).
    Causal masking compares absolute indices (key j <= query i); a row
    with no valid key gives 0 (the kernel's `safe_l` rule)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    rep = hq // hkv
    kk = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vv = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        valid = (k_pos <= q_pos)[None, None]
    else:
        valid = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.float()) / \
        safe_l.permute(0, 2, 1, 3)
    lse = (m + torch.log(safe_l))[..., 0].reshape(b * hq, sq)
    return out.to(q.dtype), lse


def _lib():
    lib = build.load("flash_fwd")
    fn = lib.rtt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q/k/v must be (B, S, H, D)")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={hq} not a multiple of "
                         f"Hkv={k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        f"all alike")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the kernel loads 16-byte vectors)")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) as `flash_attention_plain` returns them. CPU tensors
    take the plain version; CUDA tensors launch K1."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b * hq, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, sq, sk, hq, hkv, d, int(bool(causal)),
                float(scale), _DTYPES[q.dtype], stream)
    build.check(status, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). Returns (B, Sq, Hq, D).
    GQA is mapped inside the kernel (query head h reads kv head
    h // (Hq / Hkv)); K/V are never repeated in memory."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
