"""Ring attention: sequence / context parallelism over the `sp` mesh axis
(counterpart of ray_tpu/ops/ring_attention.py).

Each rank of the sp axis holds one sequence chunk of q, k and v. The
k/v chunks rotate around the ring (rank r sends to r + 1 and receives
from r - 1, one batch of P2P ops a step) while a running fp32 online
softmax (m, l, acc) accumulates the output, so after sp steps every
query chunk has attended over the whole sequence and no rank holds an
(S, S) score matrix. Causality is a mask by global position, and K/V
ride the ring at Hkv width (GQA's saving applies to the traffic too).

The reference gets its backward from `jax.grad` through `ppermute`;
torch's P2P calls have no derivative, so the backward is a ring of its
own: each rank recomputes a chunk's probabilities from the saved
log-sum-exp, accumulates dQ locally, and the chunk's dK/dV accumulators
travel with it around the ring and one hop more, back to the chunk's
owner. At sp == 1 the ring is the whole sequence and the call is
`multi_head_attention` (K1/K2a/K2b on a CUDA tensor), as the
reference's degenerate ring is its dense attention.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)  # finite: no inf-inf


def _logits(q, k, q_offset, k_offset, scale, causal):
    """Scores of q (B, Sq, Hkv, R, D) against k (B, Sk, Hkv, D), fp32,
    (B, Hkv, R, Sq, Sk), masked by global position when causal."""
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q, k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits,
                             torch.full_like(logits, _NEG_BIG))
    return logits


def _online_chunk(q, k, v, m, l, acc, q_offset, k_offset, scale, causal):
    """One block of online-softmax attention, grouped-query layout.

    q: (B, Sq, Hkv, R, D) local query chunk at global offset q_offset;
    k/v: (B, Sk, Hkv, D) visiting chunk at k_offset; m/l: (B, Hkv, R,
    Sq) running max / denominator; acc: (B, Sq, Hkv, R, D) running
    numerator. All fp32."""
    logits = _logits(q, k, q_offset, k_offset, scale, causal)
    new_m = torch.maximum(m, logits.amax(dim=-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])
    new_l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    new_acc = acc * correction.permute(0, 3, 1, 2)[..., None] + pv
    return new_m, new_l, new_acc


def _shift(tensors, group):
    from ..parallel.collectives import shift  # noqa: PLC0415
    return shift(tensors, group)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal, scale):
        b, sq, hq, d = q.shape
        hkv = k.shape[2]
        rep = hq // hkv
        q32 = q.float().reshape(b, sq, hkv, rep, d)
        m = torch.full((b, hkv, rep, sq), _NEG_BIG, device=q.device)
        l = torch.zeros((b, hkv, rep, sq), device=q.device)
        acc = torch.zeros((b, sq, hkv, rep, d), device=q.device)
        kc, vc = k, v
        for s in range(n):
            # after s hops this rank holds the chunk of rank idx - s
            m, l, acc = _online_chunk(
                q32, kc.float(), vc.float(), m, l, acc, idx * sq,
                ((idx - s) % n) * sq, scale, causal)
            if s < n - 1:
                kc, vc = _shift((kc, vc), group)
        out = acc / l.permute(0, 3, 1, 2)[..., None]
        lse = m + torch.log(l)                          # (B, Hkv, R, Sq)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, n, idx, causal, scale)
        return out.reshape(b, sq, hq, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, idx, causal, scale = ctx.args
        b, sq, hq, d = q.shape
        hkv = k.shape[2]
        rep = hq // hkv
        q32 = q.float().reshape(b, sq, hkv, rep, d)
        do = dout.float().reshape(b, sq, hkv, rep, d)
        delta = (do * out).sum(-1).permute(0, 2, 3, 1)   # (B, Hkv, R, Sq)
        dq = torch.zeros_like(q32)
        kc, vc = k, v
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for s in range(n):
            k32, v32 = kc.float(), vc.float()
            logits = _logits(q32, k32, idx * sq, ((idx - s) % n) * sq,
                             scale, causal)
            p = torch.exp(logits - lse[..., None])
            dv += torch.einsum("bhrqk,bqhrd->bkhd", p, do)
            dp = torch.einsum("bqhrd,bkhd->bhrqk", do, v32)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bhrqk,bkhd->bqhrd", ds, k32) * scale
            dk += torch.einsum("bhrqk,bqhrd->bkhd", ds, q32) * scale
            # the accumulators travel with their chunk
            if s < n - 1:
                kc, vc, dk, dv = _shift((kc, vc, dk, dv), group)
        # this rank now holds chunk idx + 1's: one more hop to its owner
        if n > 1:
            dk, dv = _shift((dk, dv), group)
        return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention over `axis_name` of `mesh` (a
    DeviceMesh from parallel/mesh.py).

    Each rank passes its own sequence chunk, the chunks in rank order
    along the axis: q (B, S/n, Hq, D), k/v (B, S/n, Hkv, D), Hq % Hkv
    == 0. Returns this rank's chunk of the output (B, S/n, Hq, D).
    Differentiable in q, k and v."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"n_heads {hq} % n_kv_heads {hkv} != 0")
    from ..parallel.collectives import axis_group, axis_size  # noqa: PLC0415
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = axis_size(mesh, axis_name)
    if n == 1:
        from .attention import multi_head_attention  # noqa: PLC0415
        return multi_head_attention(q, k, v, causal=causal, scale=scale)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"q and k/v chunks differ: {q.shape[1]} vs "
                         f"{k.shape[1]}")
    return _RingAttention.apply(q, k, v, axis_group(mesh, axis_name), n,
                                mesh.get_local_rank(axis_name), causal,
                                scale)


__all__ = ["ring_attention"]
