"""Vision Transformer classifier (counterpart of ray_tpu/models/vit.py).

Images are NHWC at the interface, as the reference's are. Patchify is
one strided `Conv` (kernel = stride = patch, no padding); the encoder
blocks are pre-norm multi-head attention (non-causal, through
`multi_head_attention`: K1 on the GPU where it takes the shape) and a
tanh-GELU MLP. The same block with causal=True is CLIP's text block.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import gelu, layer_norm, multi_head_attention
from ..ops.linear import Conv, Dense
from ..util.device import DeviceLike, resolve_device
from .llama import _lecun_normal_, _normal_


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    channels: int = 3
    pool: str = "cls"            # "cls" | "mean"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def base(**kw) -> "ViTConfig":
        return ViTConfig(**kw)

    @staticmethod
    def debug(**kw) -> "ViTConfig":
        return ViTConfig(**{**dict(image_size=32, patch_size=8,
                                   num_classes=10, d_model=64, n_layers=2,
                                   n_heads=4, d_ff=128), **kw})


class ViTBlock(nn.Module):
    """Pre-norm MHA + GELU MLP; causal=True makes it CLIP's text block
    (the only difference between the towers)."""

    def __init__(self, cfg: ViTConfig, causal: bool = False):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        d, dt, pd = cfg.d_model, cfg.dtype, cfg.param_dtype
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.ln1_bias = nn.Parameter(torch.zeros(d))
        self.q_proj = Dense(d, d, dtype=dt, param_dtype=pd)
        self.k_proj = Dense(d, d, dtype=dt, param_dtype=pd)
        self.v_proj = Dense(d, d, dtype=dt, param_dtype=pd)
        self.o_proj = Dense(d, d, dtype=dt, param_dtype=pd)
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.ln2_bias = nn.Parameter(torch.zeros(d))
        self.fc_in = Dense(d, cfg.d_ff, dtype=dt, param_dtype=pd)
        self.fc_out = Dense(cfg.d_ff, d, dtype=dt, param_dtype=pd)

    def forward(self, x):
        cfg = self.cfg
        b, s, d = x.shape
        h = layer_norm(x, self.ln1_scale, self.ln1_bias)
        shape = (b, s, cfg.n_heads, cfg.head_dim)
        att = multi_head_attention(self.q_proj(h).view(shape),
                                   self.k_proj(h).view(shape),
                                   self.v_proj(h).view(shape),
                                   causal=self.causal)
        x = x + self.o_proj(att.reshape(b, s, d))
        h = layer_norm(x, self.ln2_scale, self.ln2_bias)
        return x + self.fc_out(gelu(self.fc_in(h)))


class ViTTrunk(nn.Module):
    """Patchify -> [cls | patches] + pos -> encoder blocks -> final LN.
    Returns the whole (B, n_patches + 1, d_model) sequence; ViT pools it,
    CLIP projects x[:, 0]."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch_size
        self.patch_embed = Conv(cfg.channels, d, p, stride=p,
                                dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.n_patches + 1, d))
        for i in range(cfg.n_layers):
            setattr(self, f"layer_{i}", ViTBlock(cfg))
        self.ln_f_scale = nn.Parameter(torch.ones(d))
        self.ln_f_bias = nn.Parameter(torch.zeros(d))

    def forward(self, images):
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch_embed(images).reshape(b, -1, cfg.d_model)
        cls = self.cls_token.expand(b, 1, cfg.d_model).to(cfg.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x)
        return layer_norm(x, self.ln_f_scale, self.ln_f_bias)


@torch.no_grad()
def _flax_init_(module: nn.Module, gen: torch.Generator) -> None:
    """flax's default initializers by parameter name, for ViT, CLIP, MLP
    and ResNetLite: ones for norm scales, zeros for biases and
    cls_token, normal(0.02) for position and token embeddings, 2.6592
    for CLIP's logit_scale, lecun-normal for kernels (a conv's fan-in is
    in x kh x kw)."""
    for name, p in module.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf == "logit_scale":
            p.fill_(2.6592)
        elif leaf.endswith("scale"):
            p.fill_(1.0)
        elif leaf.endswith("bias") or leaf == "cls_token":
            p.zero_()
        elif leaf.endswith("pos_embed") or name == "token_embed.weight":
            _normal_(p, 0.02, gen)
        else:
            _lecun_normal_(p, gen, fan_in=p[0].numel())


class ViT(nn.Module):
    """images (B, H, W, C) float -> logits (B, num_classes) fp32."""

    def __init__(self, cfg: ViTConfig, *, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.trunk = ViTTrunk(cfg)
            self.head = Dense(cfg.d_model, cfg.num_classes,
                              dtype=torch.float32,
                              param_dtype=cfg.param_dtype)
        self.to_empty(device=dev)
        _flax_init_(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.trunk(images)
        feat = x[:, 0] if self.cfg.pool == "cls" else x.mean(dim=1)
        return self.head(feat.float())
