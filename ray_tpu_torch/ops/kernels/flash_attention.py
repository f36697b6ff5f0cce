"""Flash attention, forward (K1) and backward (K2a dQ, K2b dK/dV), as
hand-written CUDA kernels for Hopper.

Replaces the Pallas TPU kernels of `ray_tpu/ops/pallas/flash_attention.py`:
`_fwd_kernel` (launched by `_flash_fwd`) is K1, in
`ray_tpu_torch/csrc/flash_fwd.cu`; `_bwd_dq_kernel` and `_bwd_dkv_kernel`
(launched by `_flash_bwd`) are K2a and K2b, in
`ray_tpu_torch/csrc/flash_bwd.cu`. Each source's header note says what
bounds it on the card and how its grid differs from the TPU's.
`_FlashAttention`, the counterpart of the `jax.custom_vjp` `_flash`,
ties them together: `flash_attention` is differentiable through it.

The wrappers route by device: a CPU tensor takes the plain version
(`flash_attention_plain`, `flash_attention_bwd_plain`: fp32 scores,
explicit masks), a CUDA tensor launches the kernels or raises. There is
no fallback from a kernel to a plain version.
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


# ---- backward (K2a, K2b) -------------------------------------------------

def _causal_valid(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    if not causal:
        return torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    return (k_pos <= q_pos)[None, None]


def _plain_p_ds(q, k, v, do, lse, delta, causal, scale):
    """Counterpart of `_bwd_p_ds`: P rebuilt from the saved lse under the
    forward's masks, dS = P * (dO V^T - delta) * scale, both fp32
    (B, Hq, Sq, Sk). Also returns K expanded to the query heads."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    kk = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vv = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    valid = _causal_valid(sq, sk, causal, q.device)
    p = torch.where(valid, torch.exp(s - lse.reshape(b, hq, sq, 1)),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vv.float())
    ds = p * (dp - delta.reshape(b, hq, sq, 1)) * scale
    return p, ds, kk


def _sum_groups(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Sk, Hq, D) per query head -> (B, Sk, Hkv, D), each kv head the
    sum over its Hq/Hkv query heads."""
    b, sk, hq, d = x.shape
    return x.reshape(b, sk, hkv, hq // hkv, d).sum(dim=3)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """K2a's plain version: dQ = dS K with dS rounded to K's type, as
    `_bwd_dq_kernel` does. Returns dQ in q's type."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _, ds, kk = _plain_p_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kk.float())
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b's plain version: dK = dS^T Q and dV = P^T dO, with P rounded
    to dO's type and dS to Q's (`_bwd_dkv_kernel`), summed in fp32 over
    the query heads of each kv head. Returns (dK, dV) in k's type."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds, _ = _plain_p_ds(q, k, v, do, lse, delta, causal, scale)
    hkv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return _sum_groups(dk, hkv).to(k.dtype), _sum_groups(dv, hkv).to(v.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, laid out (B*Hq, Sq) like lse."""
    b, sq, hq, _ = out.shape
    delta = (do.float() * out.float()).sum(dim=-1)          # (B, Sq, Hq)
    return delta.permute(0, 2, 1).reshape(b * hq, sq).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain backward (counterpart of `_flash_bwd`): (dQ, dK, dV) of
    `flash_attention` for output gradient `do`, from the forward's out
    and lse. dK/dV are per kv head."""
    delta = attention_delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                            scale=scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                 scale=scale)
    return dq, dk, dv


def _bwd_fn(name: str):
    lib = build.load("flash_bwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr = 7 if name == "rtt_flash_bwd_dq" else 8
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_bwd_inputs(q, k, v, do, lse, delta):
    """What K2a/K2b take: K1's q/k/v checks, dO like q, lse and delta
    (B*Hq, Sq) fp32, all contiguous, 16-byte aligned and on one CUDA
    device."""
    _check_inputs(q, k, v)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)} "
                         f"{do.dtype}, want q's {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b * hq, sq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype}, want "
                             f"({b * hq}, {sq}) float32")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} is not "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} is not 16-byte "
                             f"aligned")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: the kernels take CUDA "
                         f"tensors, not {q.device}")


def _bwd_args(q, k, causal, scale):
    b, sq, hq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return ([b, sq, k.shape[1], hq, k.shape[2], d, int(bool(causal))],
            [float(scale), _DTYPES[q.dtype], stream])


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch K2a: dQ (in q's type) from CUDA tensors, delta as
    `attention_delta` gives it."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    ints, tail = _bwd_args(q, k, causal, scale)
    status = _bwd_fn("rtt_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *ints, *tail)
    build.check(status, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2b: dK, dV (per kv head, in k's type) from CUDA tensors,
    delta as `attention_delta` gives it."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ints, tail = _bwd_args(q, k, causal, scale)
    status = _bwd_fn("rtt_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *ints, *tail)
    build.check(status, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) as `flash_attention_bwd_plain` returns them. CPU
    tensors take the plain version; CUDA tensors launch K2a
    (`flash_bwd_dq`) and K2b (`flash_bwd_dkv`), each counting its
    launches."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"want q's {tuple(q.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = attention_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                           scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the `jax.custom_vjp` `_flash`: the forward is K1 and
    saves (q, k, v, out, lse); the backward is K2a + K2b."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.to(q.dtype).contiguous(),
            causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). Returns (B, Sq, Hq, D),
    differentiable in q, k and v. GQA is mapped inside the kernels
    (query head h reads kv head h // (Hq / Hkv)); K/V are never repeated
    in memory."""
    return _FlashAttention.apply(q, k, v, causal, scale)
