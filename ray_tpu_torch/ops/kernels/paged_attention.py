"""K3: single-token decode attention over a paged KV pool, a hand-written
CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `ray_tpu/ops/pallas/paged_attention.py`
(`_decode_kernel`, launched by `paged_decode_attention`). The CUDA
source is `ray_tpu_torch/csrc/paged_decode.cu`; its header note says
what bounds it on the card and how its grid differs from the TPU's.

Keys count at positions below `min(lengths, qpos + 1)` (the causal bound
a replayed query at an earlier position needs) and below the page
table's width. A row with no valid key gives 0.

`paged_decode_attention` routes by device: a CPU tensor takes
`paged_decode_attention_plain`, a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)      # head sizes the kernel is built for
MAX_REP = 16                       # query heads per kv head it takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_plain(q, k_flat, v_flat, page_table, lengths,
                                 page_size: int, qpos=None,
                                 scale: Optional[float] = None):
    """q: (S, Hq, D), one decode token per sequence; k_flat/v_flat:
    (N_flat, Hkv, D) page pools; page_table: (S, P) page ids; lengths:
    (S,) keys valid at positions < lengths; qpos: (S,) query positions
    (default lengths - 1). Returns (S, Hq, D) in q's type."""
    s_n, hq, d = q.shape
    hkv = k_flat.shape[1]
    rep = hq // hkv
    if scale is None:
        scale = d ** -0.5
    if qpos is None:
        qpos = lengths - 1
    n_pages = page_table.shape[1]
    L = n_pages * page_size
    idx = (page_table.long()[:, :, None] * page_size
           + torch.arange(page_size, device=q.device)[None, None, :]
           ).reshape(s_n, L)
    kk = k_flat[idx].float()                        # (S, L, Hkv, D)
    vv = v_flat[idx].float()
    qg = q.float().reshape(s_n, hkv, rep, d)
    scores = torch.einsum("shrd,slhd->shrl", qg, kk) * scale
    bound = torch.minimum(lengths.long(), qpos.long() + 1)
    valid = (torch.arange(L, device=q.device)[None, :]
             < bound[:, None])[:, None, None, :]    # (S, 1, 1, L)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("shrl,slhd->shrd", p, vv) / safe_l
    return out.reshape(s_n, hq, d).to(q.dtype)


def _lib():
    lib = build.load("paged_decode")
    fn = lib.rtt_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k_flat, v_flat, page_table, lengths, qpos,
                  page_size):
    if q.dim() != 3 or k_flat.dim() != 3 or k_flat.shape != v_flat.shape:
        raise ValueError(f"paged_decode: q={tuple(q.shape)} "
                         f"pools={tuple(k_flat.shape)}/"
                         f"{tuple(v_flat.shape)}")
    s_n, hq, d = q.shape
    n_flat, hkv, dk = k_flat.shape
    if dk != d or hq % hkv or hq // hkv > MAX_REP:
        raise ValueError(f"paged_decode: Hq={hq}, Hkv={hkv}, D={d}/{dk}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head dim {d} not in {HEAD_DIMS}")
    if page_size <= 0 or n_flat % page_size:
        raise ValueError(f"paged_decode: pool rows {n_flat} not a "
                         f"multiple of page size {page_size}")
    if q.dtype not in _DTYPES or k_flat.dtype != q.dtype \
            or v_flat.dtype != q.dtype:
        raise TypeError(f"paged_decode: dtypes {q.dtype}/{k_flat.dtype}/"
                        f"{v_flat.dtype}; the kernel takes float32 or "
                        f"bfloat16, all alike")
    if page_table.dim() != 2 or page_table.shape[0] != s_n:
        raise ValueError(f"paged_decode: page_table {tuple(page_table.shape)}"
                         f" for {s_n} sequences")
    for name, t in (("page_table", page_table), ("lengths", lengths),
                    ("qpos", qpos)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode: {name} must be int32")
    if lengths.shape != (s_n,) or qpos.shape != (s_n,):
        raise ValueError("paged_decode: lengths/qpos must be (S,)")
    for name, t in (("q", q), ("k_flat", k_flat), ("v_flat", v_flat),
                    ("page_table", page_table), ("lengths", lengths),
                    ("qpos", qpos)):
        if t.device != q.device:
            raise ValueError(f"paged_decode: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} is not contiguous")
    for name, t in (("k_flat", k_flat), ("v_flat", v_flat)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} is not 16-byte aligned "
                             f"(the kernel loads 16-byte vectors)")


def paged_decode_attention(q, k_flat, v_flat, page_table, lengths,
                           page_size: int, qpos=None,
                           scale: Optional[float] = None):
    """Same arguments and result as `paged_decode_attention_plain`. CPU
    tensors take the plain version; CUDA tensors launch K3."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_flat, v_flat, page_table, lengths, page_size, qpos=qpos,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    if qpos is None:
        qpos = (lengths - 1).to(torch.int32)
    _check_inputs(q, k_flat, v_flat, page_table, lengths, qpos, page_size)
    s_n, hq, d = q.shape
    hkv = k_flat.shape[1]
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if s_n == 0:
        return out
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), qpos.data_ptr(),
                out.data_ptr(), s_n, hq, hkv, d, page_size,
                page_table.shape[1], k_flat.shape[0], float(scale),
                _DTYPES[q.dtype], stream)
    build.check(status, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
