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
and fp32 accumulation; they are never rounded to bf16. Under
quant="int8" each projection is a `QuantDense` (`kernel_q`, `scale`),
loaded from `ops.quant.quantize_llama_params`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..observability.profiler import annotate
from ..ops import (apply_rotary, cached_attention, multi_head_attention,
                   rms_norm, rope_frequencies, sequence_parallel_attention,
                   swiglu)
from ..ops.attention import check_attn_impl
from ..ops.linear import Dense, logits_fp32
from ..ops.quant import QuantDense
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
    attn_impl: str = "auto"         # "auto" | "xla" | "dpa" | "pallas"
    # None = fp projections; "int8" = weight-only int8 projections
    # (ops/quant.py QuantDense; weights from quantize_llama_params)
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
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy={self.remat_policy!r}; "
                             f"valid: 'full', 'dots'")
        check_attn_impl(self.attn_impl)

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


def _dense(cfg: LlamaConfig, d_in: int, d_out: int) -> nn.Module:
    """A projection: `Dense`, or `QuantDense` under quant='int8' (same
    place in the state_dict; `weight` becomes `kernel_q` and `scale`)."""
    if cfg.quant == "int8":
        return QuantDense(d_in, d_out, dtype=cfg.dtype)
    return Dense(d_in, d_out, bias=False, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _dense(cfg, cfg.d_model, cfg.n_heads * hd)
        self.k_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd)
        self.v_proj = _dense(cfg, cfg.d_model, cfg.n_kv_heads * hd)
        self.o_proj = _dense(cfg, cfg.n_heads * hd, cfg.d_model)
        # under tp (parallel/sharding.py) a rank holds n_heads / tp query
        # heads, and where tp does not divide the kv heads, all of them:
        # then these are the kv heads its query heads read, and the tp
        # group over which the ranks' parts of their gradients sum
        self.kv_index: Optional[torch.Tensor] = None
        self.kv_group = None

    def forward(self, x, cos, sin, cache=None, positions=None):
        with annotate("attn"):
            return self._forward(x, cos, sin, cache, positions)

    def _forward(self, x, cos, sin, cache, positions):
        from ..parallel.collectives import all_gather_seq
        from ..parallel.sharding import sequence_shard
        hd = self.cfg.head_dim
        b, s, _ = x.shape
        # under a published sp mesh x is this rank's sequence chunk: RoPE
        # at its global positions, attention over the gathered K/V
        sp = sequence_shard() if cache is None else None
        if sp is not None and positions is None:
            positions = torch.arange(sp.index * s, (sp.index + 1) * s,
                                     device=x.device)
        # head counts from the projections' widths: this rank's under tp
        q = self.q_proj(x).view(b, s, -1, hd)
        k = self.k_proj(x).view(b, s, -1, hd)
        v = self.v_proj(x).view(b, s, -1, hd)
        if self.kv_index is not None:
            from ..parallel.collectives import copy_to_group
            k = copy_to_group(k, self.kv_group).index_select(2, self.kv_index)
            v = copy_to_group(v, self.kv_group).index_select(2, self.kv_index)
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
        new_cache = None
        if sp is not None:
            out = sequence_parallel_attention(
                q, all_gather_seq(k, sp.group), all_gather_seq(v, sp.group),
                sp.index, impl=self.cfg.attn_impl)
        elif cache is None:
            out = multi_head_attention(q, k, v, causal=True,
                                       impl=self.cfg.attn_impl)
        else:
            out, new_cache = cached_attention(q, k, v, cache, positions,
                                              impl=self.cfg.attn_impl)
        out = out.reshape(b, s, -1)
        return self.o_proj(out), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.gate_proj = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.up_proj = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.down_proj = _dense(cfg, cfg.d_ff, cfg.d_model)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


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


def _remat_block(block: nn.Module, policy: str, *args):
    """block(*args) with its forward under activation checkpointing.

    The block is called through its hooks, so a wrapper's pre-forward
    work (FSDP2 gathering the block's shards) runs once, around the
    checkpointed body. The body and its recompute in the backward run
    with the tensors the block holds when the body starts: the gathered
    weights under FSDP2, the merged ones under
    `torch.func.functional_call` (LoRA), not whatever the module holds by
    the time the backward runs (the call has returned and restored the
    module's own parameters by then)."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)
    body = type(block).forward

    def forward(*a):
        bound = dict(block.named_parameters())

        def run(*b):
            with _reparametrize_module(block, bound):
                return body(block, *b)

        return checkpoint(run, *a, use_reentrant=False, **kw)

    block.forward = forward       # this call only; the hooks wrap it
    try:
        return block(*args)
    finally:
        del block.forward


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator,
                   fan_in: Optional[int] = None) -> None:
    """flax lecun_normal: truncated normal (+-2 std) with variance
    1/fan_in; fan_in is the input width, dim 1 of a (out, in) weight,
    unless given (flax counts a stacked (E, in, out) kernel's fan-in as
    E * in). Drawn in fp32, then stored in the weight's type."""
    fan_in = fan_in or w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=gen)
    w.copy_(tmp)


def _normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """flax normal(std), drawn in fp32, stored in the weight's type."""
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    tmp.normal_(0.0, std, generator=gen)
    w.copy_(tmp)


class Llama(nn.Module):
    """forward(tokens, cache=None, positions=None, graphs=None) ->
    (logits, new_cache).

    tokens: (B, S) integer ids. cache: None (plain causal forward) or a
    list of per-layer entries, (k, v, lengths) or PagedKV. Logits are
    (B, S, vocab) fp32. graphs: a `decode_graph.DecodeGraphs` (the
    serving engine's), whose captured forward a one-token paged decode
    step replays where it has one; every other call runs eagerly."""

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
                _normal_(p, 0.02, gen)
            else:
                _lecun_normal_(p, gen)
        for m in self.modules():
            if isinstance(m, QuantDense):
                m.reset_parameters()

    @property
    def blocks(self) -> List[LlamaBlock]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor, cache=None,
                positions: Optional[torch.Tensor] = None, graphs=None):
        if graphs is not None:
            out = graphs.replay(self, tokens, cache, positions)
            if out is not None:
                return out
        cfg = self.cfg
        # remat trades recompute for memory on the train path only; the
        # cached (serving) path never checkpoints
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        # through the module, so a vocab-parallel plan's hooks run
        x = self.token_embed(tokens.long()).to(cfg.dtype)
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
