"""Llama-3-style decoder (counterpart of ray_tpu/models/llama.py).

Same configuration fields and presets as the JAX model, with torch
dtypes, and the same parameter names: `layer_{i}.attention.q_proj`,
`layer_{i}.attn_norm`, `layer_{i}.mlp_norm`, `final_norm`,
`token_embed`, `lm_head`. `models/convert.py` maps a flax parameter tree
onto this module's state_dict.

Weights are made on the target device from a seeded `torch.Generator`,
following flax's distributions (normal(0.02) for the embedding,
lecun-normal for the dense layers, ones for the norms) but not its
values. Logits are fp32 with the head's operands in the compute type
and fp32 accumulation; they are never rounded to bf16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import (apply_rotary, cached_attention, multi_head_attention,
                   rms_norm, rope_frequencies, swiglu)
from ..util.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 5632
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Activation checkpointing of each block, on the cache-less forward
    # with grad enabled (the training forward). "full": recompute the
    # whole block in the backward (most memory saved, ~1.33x the
    # forward's operations). "dots": save the projections' matrix
    # products and recompute only the cheap elementwise ops and
    # attention, the counterpart of jax's dots_with_no_batch_dims_saveable.
    remat: bool = False
    remat_policy: str = "full"
    dtype: torch.dtype = torch.bfloat16
    # storage type of the embedding and projection weights; the norm
    # weights stay fp32
    param_dtype: torch.dtype = torch.float32
    # The port routes attention by device (kernels on CUDA, plain
    # versions on the CPU); only "auto" exists.
    attn_impl: str = "auto"
    # weight-only int8 projections: not ported yet
    quant: Optional[str] = None

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model={self.d_model} must be divisible by "
                f"n_heads={self.n_heads}")
        if (self.d_model // self.n_heads) % 2:
            raise ValueError(
                f"head_dim={self.d_model // self.n_heads} must be even "
                f"(RoPE rotates dimension pairs)")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must be divisible by "
                f"n_kv_heads={self.n_kv_heads} (GQA groups)")
        if self.quant not in (None, "int8"):
            raise ValueError(f"quant={self.quant!r}; valid: None, 'int8'")
        if self.quant is not None:
            raise NotImplementedError("quant='int8' is not ported yet")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy={self.remat_policy!r}; "
                             f"valid: 'full', 'dots'")
        if self.attn_impl != "auto":
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port routes attention "
                f"by device; only 'auto' exists")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # presets follow the public Llama-3 family; kwargs override
    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=8192, remat=True),
            **kw})

    @staticmethod
    def llama3_1b(**kw) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=128256, d_model=2048, n_layers=16, n_heads=32,
            n_kv_heads=8, d_ff=8192, max_seq_len=8192), **kw})

    @staticmethod
    def debug(**kw) -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, d_model=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, d_ff=128,
                           max_seq_len=128, **kw)


def _dense(cfg: LlamaConfig, d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=cfg.param_dtype)


def _apply_dense(layer: nn.Linear, x: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=...): operands cast to the compute type."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


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
    accumulation, returned in fp32 (never rounded to x's type)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:
        out = _MatmulFp32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[0])
    # a bf16 value is exact in fp32, so this is the same product
    return x.float() @ w.float().t()


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _dense(cfg, cfg.d_model, cfg.n_heads * hd)
        self.k_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd)
        self.v_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd)
        self.o_proj = _dense(cfg, cfg.n_heads * hd, cfg.d_model)

    def forward(self, x, cos, sin, cache=None, positions=None):
        cfg = self.cfg
        hd = cfg.head_dim
        b, s, _ = x.shape
        q = _apply_dense(self.q_proj, x, cfg.dtype).view(b, s, cfg.n_heads,
                                                         hd)
        k = _apply_dense(self.k_proj, x, cfg.dtype).view(b, s,
                                                         cfg.n_kv_heads, hd)
        v = _apply_dense(self.v_proj, x, cfg.dtype).view(b, s,
                                                         cfg.n_kv_heads, hd)
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
        new_cache = None
        if cache is None:
            out = multi_head_attention(q, k, v, causal=True)
        else:
            out, new_cache = cached_attention(q, k, v, cache, positions)
        out = out.reshape(b, s, cfg.n_heads * hd)
        return _apply_dense(self.o_proj, out, cfg.dtype), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.up_proj = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.down_proj = _dense(cfg, cfg.d_ff, cfg.d_model)

    def forward(self, x):
        dt = self.cfg.dtype
        gate = _apply_dense(self.gate_proj, x, dt)
        up = _apply_dense(self.up_proj, x, dt)
        return _apply_dense(self.down_proj, swiglu(gate, up), dt)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.mlp_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.attention = LlamaAttention(cfg)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin, cache=None, positions=None):
        eps = self.cfg.norm_eps
        h, new_cache = self.attention(rms_norm(x, self.attn_norm, eps),
                                      cos, sin, cache, positions)
        x = x + h
        x = x + self.mlp(rms_norm(x, self.mlp_norm, eps))
        return x, new_cache


class _LMHead(nn.Module):
    """Untied head. flax stores its kernel as (d, V); here it is
    `weight` (V, d), the nn.Linear layout."""

    def __init__(self, d_model: int, vocab_size: int,
                 param_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, d_model,
                                               dtype=param_dtype))

    def forward(self, x):
        return logits_fp32(x, self.weight)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat_policy="dots": keep the
    outputs of matrix products with no batch dims (the projections'
    `mm`), recompute everything else; attention's batched products are
    recomputed, as under jax's dots_with_no_batch_dims_saveable."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block: "LlamaBlock", policy: str, x, cos, sin):
    """block(x, cos, sin) under activation checkpointing."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)
    return checkpoint(block, x, cos, sin, use_reentrant=False, **kw)


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax lecun_normal: truncated normal (+-2 std) with variance
    1/fan_in; fan_in is the input width, dim 1 of a (out, in) weight.
    Drawn in fp32, then stored in the weight's type."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=gen)
    w.copy_(tmp)


class Llama(nn.Module):
    """forward(tokens, cache=None, positions=None) -> (logits, new_cache).

    tokens: (B, S) integer ids. cache: None (plain causal forward) or a
    list of per-layer entries, (k, v, lengths) or PagedKV. Logits are
    (B, S, vocab) fp32."""

    def __init__(self, cfg: LlamaConfig, *, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                            dtype=cfg.param_dtype)
            for i in range(cfg.n_layers):
                setattr(self, f"layer_{i}", LlamaBlock(cfg))
            self.final_norm = nn.Parameter(torch.ones(cfg.d_model))
            if not cfg.tie_embeddings:
                self.lm_head = _LMHead(cfg.d_model, cfg.vocab_size,
                                       cfg.param_dtype)
        self.to_empty(device=dev)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name == "token_embed.weight":
                tmp = torch.empty(p.shape, dtype=torch.float32,
                                  device=p.device)
                tmp.normal_(0.0, 0.02, generator=gen)
                p.copy_(tmp)
            else:
                _lecun_normal_(p, gen)

    @property
    def blocks(self) -> List[LlamaBlock]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor, cache=None,
                positions: Optional[torch.Tensor] = None):
        cfg = self.cfg
        # remat trades recompute for memory on the train path only; the
        # cached (serving) path never checkpoints
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        x = F.embedding(tokens.long(), self.token_embed.weight).to(cfg.dtype)
        new_cache = []
        for i, block in enumerate(self.blocks):
            if remat:
                x, c = _remat_block(block, cfg.remat_policy, x,
                                    self.rope_cos, self.rope_sin)
            else:
                x, c = block(x, self.rope_cos, self.rope_sin,
                             None if cache is None else cache[i], positions)
            new_cache.append(c)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = logits_fp32(x, self.token_embed.weight)
        else:
            logits = self.lm_head(x)
        return logits, (new_cache if cache is not None else None)

    def empty_cache(self, batch: int, max_len: int,
                    dtype: Optional[torch.dtype] = None):
        """Contiguous per-layer (k, v, lengths) cache on the model's
        device."""
        cfg = self.cfg
        dev = self.final_norm.device
        dtype = dtype or cfg.dtype
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros((batch,), dtype=torch.int32, device=dev))
                for _ in range(cfg.n_layers)]
