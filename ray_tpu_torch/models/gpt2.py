"""GPT-2 family (counterpart of ray_tpu/models/gpt2.py).

Learned positional embeddings (`wpe`, positions clamped to
max_seq_len - 1), pre-LN blocks with a fused `qkv` projection with
bias, the tanh-approximate GELU MLP, and the head tied to `wte` with
the compute type's operands and an fp32 result. Parameter names are the
flax ones: `h_{i}.ln_1_scale`, `h_{i}.qkv.weight`, `wte.weight`, ...
`models/convert.py` maps a flax tree onto them and `train/adapters.py`
an HF checkpoint.

forward returns plain logits when `cache` is None (the training
callers) and (logits, cache) otherwise (the engine's contract).

Under tp (parallel/sharding.py) `qkv`'s weight and bias are DTensors
with `_StridedShard(0, split_factor=3)`: rank t holds rows [q_t; k_t;
v_t], whole heads of q, of k and of v, and the block computes on those
local rows (`GPT2Block._qkv`: the replicated input's gradient summed
over tp), the attention on its heads, and `attn_out` sums the heads'
products over tp as a `RowwiseParallel` plan. The strided placement
rather than a row permutation undone by a state-dict hook: a
permutation would show in `named_parameters()`, and so in the train
step's state, the optimizer's moments and every checkpoint written from
them; the strided DTensor is the unpermuted (3 d, d) weight everywhere
(`parallel.sharding.full_tensor`, FSDP2 over its columns,
`restore_pytree(shardings=)`). Under fsdp the bias stays out of FSDP2,
whole over fsdp as the reference's table (P()) has it: FSDP2 would
split again the one dim that tp splits three ways.
Under a published sp mesh the input is this rank's sequence chunk:
`wpe` at its global positions, attention over the K/V gathered over sp.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor

from ..ops import (cached_attention, gelu, layer_norm, multi_head_attention,
                   sequence_parallel_attention)
from ..ops.attention import check_attn_impl
from ..ops.linear import Dense, logits_fp32
from ..util.device import DeviceLike, resolve_device
from .llama import _lecun_normal_, _normal_, _remat_block


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # storage type of the embeddings and projections; LayerNorm scales
    # and biases stay fp32
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    attn_impl: str = "auto"         # "auto" | "xla" | "dpa" | "pallas"

    def __post_init__(self):
        check_attn_impl(self.attn_impl)

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads   # MHA: the serving engine sizes KV by this

    @staticmethod
    def small(**kw) -> "GPT2Config":      # 124M
        return GPT2Config(**kw)

    @staticmethod
    def medium(**kw) -> "GPT2Config":     # 350M
        return GPT2Config(**{**dict(d_model=1024, n_layers=24, n_heads=16),
                             **kw})

    @staticmethod
    def large(**kw) -> "GPT2Config":      # 774M
        return GPT2Config(**{**dict(d_model=1280, n_layers=36, n_heads=20),
                             **kw})

    @staticmethod
    def debug(**kw) -> "GPT2Config":
        return GPT2Config(**{**dict(vocab_size=256, d_model=64, n_layers=2,
                                    n_heads=4, max_seq_len=64), **kw})


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        d, dt, pd = cfg.d_model, cfg.dtype, cfg.param_dtype
        self.ln_1_scale = nn.Parameter(torch.ones(d))
        self.ln_1_bias = nn.Parameter(torch.zeros(d))
        self.ln_2_scale = nn.Parameter(torch.ones(d))
        self.ln_2_bias = nn.Parameter(torch.zeros(d))
        self.qkv = Dense(d, 3 * d, dtype=dt, param_dtype=pd)
        self.attn_out = Dense(d, d, dtype=dt, param_dtype=pd)
        self.fc_in = Dense(d, cfg.d_ff, dtype=dt, param_dtype=pd)
        self.fc_out = Dense(cfg.d_ff, d, dtype=dt, param_dtype=pd)

    def _qkv(self, h):
        """The fused projection; under tp on this rank's rows [q_t; k_t;
        v_t] (module docstring)."""
        w = self.qkv.weight
        if not isinstance(w, DTensor):
            return self.qkv(h)
        from ..parallel.collectives import copy_to_group
        if self.qkv.weight_fn is not None:
            raise NotImplementedError("a weight_fn (LoRA) over GPT-2's "
                                      "qkv under tp")
        dt = self.qkv.compute_dtype
        b = self.qkv.bias
        return F.linear(copy_to_group(h, w.device_mesh.get_group()).to(dt),
                        w.to_local().to(dt),
                        None if b is None else b.to_local().to(dt))

    def forward(self, x, cache=None, positions=None):
        from ..parallel.collectives import all_gather_seq
        from ..parallel.sharding import sequence_shard
        cfg = self.cfg
        b, s, _ = x.shape
        h = layer_norm(x, self.ln_1_scale, self.ln_1_bias, cfg.norm_eps)
        # head count from the projection's width: this rank's under tp
        q, k, v = self._qkv(h).view(b, s, 3, -1, cfg.head_dim).unbind(2)
        new_cache = None
        sp = sequence_shard() if cache is None else None
        if sp is not None:
            att = sequence_parallel_attention(
                q, all_gather_seq(k, sp.group), all_gather_seq(v, sp.group),
                sp.index, impl=cfg.attn_impl)
        elif cache is None:
            att = multi_head_attention(q, k, v, causal=True,
                                       impl=cfg.attn_impl)
        else:
            att, new_cache = cached_attention(q, k, v, cache, positions,
                                              impl=cfg.attn_impl)
        x = x + self.attn_out(att.reshape(b, s, -1))
        h = layer_norm(x, self.ln_2_scale, self.ln_2_bias, cfg.norm_eps)
        x = x + self.fc_out(gelu(self.fc_in(h)))
        return x, new_cache


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                    dtype=cfg.param_dtype)
            self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model,
                                    dtype=cfg.param_dtype)
            for i in range(cfg.n_layers):
                setattr(self, f"h_{i}", GPT2Block(cfg))
            self.ln_f_scale = nn.Parameter(torch.ones(cfg.d_model))
            self.ln_f_bias = nn.Parameter(torch.zeros(cfg.d_model))
        self.to_empty(device=dev)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's initializers: normal(0.02) for wte, normal(0.01) for
        wpe, lecun-normal kernels, zero biases, LayerNorm ones/zeros."""
        for name, p in self.named_parameters():
            if name.endswith("_scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "wte.weight":
                _normal_(p, 0.02, gen)
            elif name == "wpe.weight":
                _normal_(p, 0.01, gen)
            else:
                _lecun_normal_(p, gen)

    @property
    def blocks(self) -> List[GPT2Block]:
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor, cache=None,
                positions: Optional[torch.Tensor] = None, graphs=None):
        """tokens (B, S) -> logits (B, S, V) fp32 with no cache, else
        (logits, new_cache) with the per-layer cache entries of Llama;
        `positions` also select the positional embeddings. `graphs`: as
        `Llama.forward`'s."""
        from ..parallel.sharding import sequence_shard
        if graphs is not None:
            out = graphs.replay(self, tokens, cache, positions)
            if out is not None:
                return out
        cfg = self.cfg
        b, s = tokens.shape
        if positions is None:
            # under a published sp mesh, this chunk's global positions
            sp = sequence_shard() if cache is None else None
            start = 0 if sp is None else sp.index * s
            positions = torch.arange(start, start + s,
                                     device=tokens.device)[None].expand(b, s)
        pos = positions.long().clamp(0, cfg.max_seq_len - 1)
        # through the modules, so a vocab-parallel plan's hooks run
        x = (self.wte(tokens.long()).to(cfg.dtype)
             + self.wpe(pos).to(cfg.dtype))
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        new_cache = []
        for i, block in enumerate(self.blocks):
            if remat:
                x, c = _remat_block(block, "full", x)
            else:
                x, c = block(x, None if cache is None else cache[i],
                             positions)
            new_cache.append(c)
        x = layer_norm(x, self.ln_f_scale, self.ln_f_bias, cfg.norm_eps)
        logits = logits_fp32(x, self.wte.weight)
        if cache is None:
            return logits
        return logits, new_cache
