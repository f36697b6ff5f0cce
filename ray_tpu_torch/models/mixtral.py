"""Mixtral-style sparse-MoE decoder (counterpart of
ray_tpu/models/mixtral.py).

The MoE MLP routes through `ops.moe.moe_dispatch_combine`, the GShard
dispatch of the reference: capacity comes from the call's B * S tokens
(on a mesh, the global batch's, its sequence over sp under a published
sp mesh), so the tokens an expert drops depend on the shape the caller
runs (the engine's bucket padding and idle decode slots included). On
a mesh the experts are sharded over ep, their ff dim over tp and, by
FSDP2, their d dim over fsdp (parallel/sharding.py): FSDP2 gathers the
d dim in the block's pre-forward, so `MoEMLP.forward` reads this rank's
experts whole over d; each tp rank runs the same dispatch and its ff
slice of every expert, and the down product's partial sums are
all-reduced over tp. The stacked
expert weights keep flax's layout, `experts_{gate,up}_kernel` (E, d,
ff) and `experts_down_kernel` (E, ff, d), and the router is
`router_kernel` (d, E); its product runs in fp32.

Attention, RoPE and the norms reuse the Llama blocks through
`MixtralConfig.attn_cfg()`, so the paged engine routes K1 and K3 for
Mixtral exactly as for Llama. The LM head is a full fp32 product on the
fp32 activations, as the reference's `nn.Dense(dtype=float32)`.

Each MoE layer keeps its router loss (aux_coef * load balance + z_coef
* z-loss) from the last forward; `Mixtral.aux_loss()` sums them. The
train step's `next_token_loss` leaves it out, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..observability.profiler import annotate
from ..ops import rms_norm, rope_frequencies, swiglu
from ..ops.linear import Dense
from ..ops.attention import check_attn_impl
from ..ops.moe import moe_dispatch_combine
from ..util.device import DeviceLike, resolve_device
from .llama import (LlamaAttention, LlamaConfig, _lecun_normal_, _normal_,
                    _remat_block)


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 5632
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 2048
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16
    # storage type of the embedding, projection, expert and head
    # weights; the norm weights stay fp32
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"         # "auto" | "xla" | "dpa" | "pallas"

    def __post_init__(self):
        check_attn_impl(self.attn_impl)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self) -> LlamaConfig:
        """The attention sub-config shared with the Llama blocks."""
        return LlamaConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            norm_eps=self.norm_eps, dtype=self.dtype,
            param_dtype=self.param_dtype, attn_impl=self.attn_impl)

    @staticmethod
    def mixtral_8x7b(**kw) -> "MixtralConfig":
        return MixtralConfig(**{**dict(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, n_experts=8, experts_per_token=2,
            max_seq_len=8192, remat=True), **kw})

    @staticmethod
    def debug(**kw) -> "MixtralConfig":
        return MixtralConfig(**{**dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, n_experts=4, experts_per_token=2, max_seq_len=128),
            **kw})


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with stacked (E, ...) weights."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.cfg = cfg
        e, d, ff, pd = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.router_kernel = nn.Parameter(torch.empty(d, e, dtype=pd))
        self.experts_gate_kernel = nn.Parameter(torch.empty(e, d, ff,
                                                            dtype=pd))
        self.experts_up_kernel = nn.Parameter(torch.empty(e, d, ff,
                                                          dtype=pd))
        self.experts_down_kernel = nn.Parameter(torch.empty(e, ff, d,
                                                            dtype=pd))
        self.router_loss: Optional[torch.Tensor] = None
        # the DeviceMesh of parallel.sharding.shard_module: the capacity
        # and queue positions of the global batch, and the ep group of
        # the exchange (that of the experts' own (fsdp, ep[, tp]) mesh)
        self.moe_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.collectives import copy_to_group, reduce_from_group
        from ..parallel.sharding import sequence_shard
        cfg = self.cfg
        dt = cfg.dtype
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        with annotate("moe.route"):
            router_logits = tokens.float() @ self.router_kernel.float()

        def local(w):   # this rank's experts (and ff slice) when sharded
            return (w.to_local() if isinstance(w, DTensor) else w).to(dt)

        # under tp each rank holds every expert's ff slice: the batch is
        # replicated over tp, the down product's partial sums all-reduced
        w = self.experts_gate_kernel
        tp = (w.device_mesh.get_group("tp") if isinstance(w, DTensor)
              and "tp" in w.device_mesh.mesh_dim_names else None)

        def expert_fn(batch):   # (E, C, d) -> (E, C, d)
            batch = batch.to(dt)
            if tp is not None:
                batch = copy_to_group(batch, tp)
            gate = torch.bmm(batch, local(self.experts_gate_kernel))
            up = torch.bmm(batch, local(self.experts_up_kernel))
            out = torch.bmm(swiglu(gate, up), local(self.experts_down_kernel))
            return out if tp is None else reduce_from_group(out, tp)

        out, aux = moe_dispatch_combine(
            tokens, router_logits, expert_fn, k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor, mesh=self.moe_mesh, rows=b,
            seq_sharded=sequence_shard() is not None)
        self.router_loss = (cfg.router_aux_coef * aux.load_balance_loss
                            + cfg.router_z_coef * aux.router_z_loss)
        return out.reshape(b, s, d).to(dt)


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.mlp_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.attention = LlamaAttention(cfg.attn_cfg())
        self.moe = MoEMLP(cfg)

    def forward(self, x, cos, sin, cache=None, positions=None):
        eps = self.cfg.norm_eps
        h, new_cache = self.attention(rms_norm(x, self.attn_norm, eps),
                                      cos, sin, cache, positions)
        x = x + h
        x = x + self.moe(rms_norm(x, self.mlp_norm, eps))
        return x, new_cache


class Mixtral(nn.Module):
    """forward(tokens, cache=None, positions=None, graphs=None) ->
    (logits, new_cache), the calling convention of `Llama` (graphs
    included), so the engine and the train step take either. Logits are
    (B, S, vocab) fp32."""

    def __init__(self, cfg: MixtralConfig, *, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                            dtype=cfg.param_dtype)
            for i in range(cfg.n_layers):
                setattr(self, f"layer_{i}", MixtralBlock(cfg))
            self.final_norm = nn.Parameter(torch.ones(cfg.d_model))
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, bias=False,
                                 dtype=torch.float32,
                                 param_dtype=cfg.param_dtype)
        self.to_empty(device=dev)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's initializers: ones for the norms, normal(0.02) for the
        embedding and the router, lecun-normal elsewhere (a stacked
        expert kernel's fan-in is E x its input width)."""
        e = self.cfg.n_experts
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif (name == "token_embed.weight"
                  or name.endswith("router_kernel")):
                _normal_(p, 0.02, gen)
            elif name.endswith("_kernel"):
                _lecun_normal_(p, gen, fan_in=e * p.shape[1])
            else:
                _lecun_normal_(p, gen)

    @property
    def blocks(self) -> List[MixtralBlock]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor, cache=None,
                positions: Optional[torch.Tensor] = None, graphs=None):
        if graphs is not None:
            out = graphs.replay(self, tokens, cache, positions)
            if out is not None:
                return out
        cfg = self.cfg
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        x = self.token_embed(tokens.long()).to(cfg.dtype)
        new_cache = []
        for i, block in enumerate(self.blocks):
            if remat:
                x, c = _remat_block(block, "full", x, self.rope_cos,
                                    self.rope_sin)
            else:
                x, c = block(x, self.rope_cos, self.rope_sin,
                             None if cache is None else cache[i], positions)
            new_cache.append(c)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = self.lm_head(x.float())
        return logits, (new_cache if cache is not None else None)

    def aux_loss(self) -> torch.Tensor:
        """The summed router losses of the last forward (0 before one)."""
        losses = [b.moe.router_loss for b in self.blocks
                  if b.moe.router_loss is not None]
        if not losses:
            return torch.zeros((), device=self.final_norm.device)
        return torch.stack(losses).sum()

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
