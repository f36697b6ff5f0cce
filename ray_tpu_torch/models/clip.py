"""CLIP-style dual encoder (counterpart of ray_tpu/models/clip.py).

The image tower is the ViT trunk with a linear projection of its cls
token; the text tower is causal ViT blocks pooled at each row's EOT
token (`tokens.argmax(-1)`, the OpenAI convention: EOT is the highest
id). Both project into one space, L2-normalised in fp32, with a
learnable logit temperature.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layer_norm
from ..ops.linear import Dense
from ..util.device import DeviceLike, resolve_device
from .vit import ViTBlock, ViTConfig, ViTTrunk, _flax_init_


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_d_model: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    vocab_size: int = 49408
    max_text_len: int = 77
    text_d_model: int = 512
    text_layers: int = 12
    text_heads: int = 8
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def vision_cfg(self) -> ViTConfig:
        return ViTConfig(image_size=self.image_size,
                         patch_size=self.patch_size,
                         num_classes=self.embed_dim,
                         d_model=self.vision_d_model,
                         n_layers=self.vision_layers,
                         n_heads=self.vision_heads,
                         d_ff=self.vision_d_model * 4,
                         dtype=self.dtype, param_dtype=self.param_dtype)

    def text_cfg(self) -> ViTConfig:
        """Shape-only config of the text blocks (ViTBlock)."""
        return ViTConfig(d_model=self.text_d_model, n_heads=self.text_heads,
                         d_ff=self.text_d_model * 4, dtype=self.dtype,
                         param_dtype=self.param_dtype)

    @staticmethod
    def debug(**kw) -> "CLIPConfig":
        return CLIPConfig(**{**dict(
            embed_dim=32, image_size=32, patch_size=8, vision_d_model=64,
            vision_layers=2, vision_heads=4, vocab_size=256,
            max_text_len=16, text_d_model=48, text_layers=2, text_heads=4),
            **kw})


class CLIP(nn.Module):
    """(images (B, H, W, C), tokens (B, T)) -> (img_emb, txt_emb,
    logit_scale), the embeddings (B, embed_dim) fp32 and L2-normalised,
    logit_scale = exp of the learned temperature."""

    def __init__(self, cfg: CLIPConfig, *, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d_t = cfg.text_d_model
        with torch.device("meta"):
            self.vision_trunk = ViTTrunk(cfg.vision_cfg())
            self.vision_proj = Dense(cfg.vision_d_model, cfg.embed_dim,
                                     bias=False, dtype=torch.float32,
                                     param_dtype=cfg.param_dtype)
            self.token_embed = nn.Embedding(cfg.vocab_size, d_t,
                                            dtype=cfg.param_dtype)
            self.text_pos_embed = nn.Parameter(
                torch.zeros(1, cfg.max_text_len, d_t))
            for i in range(cfg.text_layers):
                setattr(self, f"text_layer_{i}",
                        ViTBlock(cfg.text_cfg(), causal=True))
            self.text_ln_scale = nn.Parameter(torch.ones(d_t))
            self.text_ln_bias = nn.Parameter(torch.zeros(d_t))
            self.text_proj = Dense(d_t, cfg.embed_dim, bias=False,
                                   dtype=torch.float32,
                                   param_dtype=cfg.param_dtype)
            self.logit_scale = nn.Parameter(torch.zeros(()))
        self.to_empty(device=dev)
        _flax_init_(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        cfg = self.cfg
        x = self.vision_trunk(images)
        img_emb = self.vision_proj(x[:, 0].float())

        t = F.embedding(tokens.long(), self.token_embed.weight).to(cfg.dtype)
        t = t + self.text_pos_embed[:, :tokens.shape[1]].to(cfg.dtype)
        for i in range(cfg.text_layers):
            t = getattr(self, f"text_layer_{i}")(t)
        t = layer_norm(t, self.text_ln_scale, self.text_ln_bias)
        eot = tokens.argmax(dim=-1)
        pooled = t[torch.arange(tokens.shape[0], device=t.device), eot]
        txt_emb = self.text_proj(pooled.float())

        img_emb = img_emb / (img_emb.norm(dim=-1, keepdim=True) + 1e-8)
        txt_emb = txt_emb / (txt_emb.norm(dim=-1, keepdim=True) + 1e-8)
        return img_emb, txt_emb, torch.exp(self.logit_scale)


def contrastive_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor,
                     logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives (fp32)."""
    logits = logit_scale * img_emb @ txt_emb.T
    diag = torch.arange(logits.shape[0], device=logits.device)
    li = -torch.log_softmax(logits, dim=-1)[diag, diag].mean()
    lt = -torch.log_softmax(logits.T, dim=-1)[diag, diag].mean()
    return 0.5 * (li + lt)
