"""The Llama block in plain PyTorch, float32, as Mistral-7B-v0.3 uses
it (Jiang et al. 2023, arXiv:2310.06825; Hugging Face
`MistralForCausalLM` with `sliding_window` null): pre-norm blocks of
grouped-query attention with rotary embeddings and a SwiGLU MLP, an
untied head, and next-token cross-entropy averaged over the tokens.

`train` runs the first steps of the benchmark's training recipe on it:
AdamW as optax computes it (bias-corrected moments, eps outside the
square root, decoupled decay at the step's rate on every tensor but the
norms and the embedding), after a clip of the global gradient norm,
under a linear warm-up then cosine decay of the rate. Each layer is
checkpointed, and attention's query blocks inside it, so the backward
holds one layer's activations at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness.weights import Group, make_named
from reference.common import (causal_attention, fp32_exact, mm, rms_norm,
                              rope, rope_tables, swiglu)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_groups(cfg: Dict) -> List[Group]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, v = d // h, cfg["vocab_size"]
    wdt = DTYPES[cfg["weights"]["dtype"]]
    ndt = DTYPES[cfg["weights"]["norm_dtype"]]
    std = cfg["initializer_range"]
    groups: List[Group] = [("embed", wdt, [("token_embed.weight", (v, d),
                                            std, 0.0)])]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layer_{i}."
        groups.append((f"layer_{i}", wdt, [
            (p + "attention.q_proj.weight", (h * hd, d), d ** -0.5, 0.0),
            (p + "attention.k_proj.weight", (hkv * hd, d), d ** -0.5, 0.0),
            (p + "attention.v_proj.weight", (hkv * hd, d), d ** -0.5, 0.0),
            (p + "attention.o_proj.weight", (d, h * hd), (h * hd) ** -0.5,
             0.0),
            (p + "mlp.gate_proj.weight", (ff, d), d ** -0.5, 0.0),
            (p + "mlp.up_proj.weight", (ff, d), d ** -0.5, 0.0),
            (p + "mlp.down_proj.weight", (d, ff), ff ** -0.5, 0.0)]))
        groups.append((f"layer_{i}.norms", ndt, [
            (p + "attn_norm", (d,), 0.1, 1.0),
            (p + "mlp_norm", (d,), 0.1, 1.0)]))
    groups.append(("head", wdt, [("lm_head.weight", (v, d), d ** -0.5, 0.0)]))
    groups.append(("head.norm", ndt, [("final_norm", (d,), 0.1, 1.0)]))
    return groups


_LAYER_KEYS = ("attn_norm", "attention.q_proj.weight",
               "attention.k_proj.weight", "attention.v_proj.weight",
               "attention.o_proj.weight", "mlp_norm", "mlp.gate_proj.weight",
               "mlp.up_proj.weight", "mlp.down_proj.weight")


def _block(x, cos, sin, cfg, control, *w):
    w = dict(zip(_LAYER_KEYS, w))
    s, d = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    eps = cfg["rms_norm_eps"]
    y = rms_norm(x, w["attn_norm"], eps)
    q = rope(mm(y, w["attention.q_proj.weight"], control).view(s, h, hd),
             cos, sin)
    k = rope(mm(y, w["attention.k_proj.weight"], control).view(s, hkv, hd),
             cos, sin)
    v = mm(y, w["attention.v_proj.weight"], control).view(s, hkv, hd)
    a = causal_attention(q, k, v, control, recompute=True).reshape(s, h * hd)
    x = x + mm(a, w["attention.o_proj.weight"], control)
    y = rms_norm(x, w["mlp_norm"], eps)
    g = mm(y, w["mlp.gate_proj.weight"], control)
    u = mm(y, w["mlp.up_proj.weight"], control)
    return x + mm(swiglu(g, u), w["mlp.down_proj.weight"], control)


def loss_of(params: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
            control=False) -> torch.Tensor:
    """Mean next-token cross-entropy of one row of tokens (S + 1,)."""
    inputs, targets = tokens[:-1].long(), tokens[1:].long()
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    cos, sin = rope_tables(torch.arange(inputs.numel(), device=tokens.device),
                           hd, cfg["rope_theta"])
    x = params["token_embed.weight"][inputs]
    for i in range(cfg["num_hidden_layers"]):
        w = [params[f"layer_{i}.{k}"] for k in _LAYER_KEYS]
        x = checkpoint(_block, x, cos, sin, cfg, control, *w,
                       use_reentrant=False)
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    logits = mm(x, params["lm_head.weight"], control)
    return F.cross_entropy(logits, targets)


def learning_rate(opt: Dict, count: int) -> float:
    """Linear warm-up from 0 to the peak, then cosine decay to
    end_lr_frac of it at total_steps, at the update count before it is
    incremented."""
    peak, warm = opt["peak_lr"], max(1, opt["warmup_steps"])
    if count < warm:
        return peak * count / warm
    decay = max(2, opt["total_steps"]) - warm
    c = min(count - warm, decay)
    frac = opt["end_lr_frac"]
    return peak * ((1 - frac) * 0.5 * (1 + math.cos(math.pi * c / decay))
                   + frac)


def decays(name: str) -> bool:
    return not any(t in name for t in ("norm", "embed"))


def train(cfg: Dict, opt: Dict, seed: int, batches: List[torch.Tensor],
          device, control=False) -> Dict:
    """len(batches) steps from the seeded weights; each batch is one row
    (S + 1,) of token ids. Returns each step's loss, each leaf's norm of
    the first step's gradient after the clip, and each leaf's norm of
    its change over all the steps."""
    groups = weight_groups(cfg)
    with fp32_exact():
        params = {}
        for name, *_ in groups:
            for k, t in make_named(groups, name, seed, device).items():
                params[k] = t.float().requires_grad_()
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        b1, b2, eps, clip = opt["b1"], opt["b2"], opt["eps"], opt["grad_clip"]
        losses, first_grad = [], {}
        for t, tokens in enumerate(batches, start=1):
            loss = loss_of(params, cfg, tokens.to(device), control)
            loss.backward()
            losses.append(float(loss.detach()))
            del loss
            with torch.no_grad():
                norm = torch.sqrt(sum(p.grad.square().sum()
                                      for p in params.values()))
                scale = float(clip / norm) if float(norm) >= clip else 1.0
                lr = learning_rate(opt, t - 1)
                for k, p in params.items():
                    g = p.grad.mul_(scale)
                    if t == 1:
                        first_grad[k] = float(g.norm())
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[k] / (1 - b1 ** t)) / (
                        (v[k] / (1 - b2 ** t)).sqrt() + eps)
                    if decays(k):
                        upd.add_(p, alpha=opt["weight_decay"])
                    p.sub_(lr * upd)
                    p.grad = None
        del m, v
        change = {}
        with torch.no_grad():
            for name, *_ in groups:
                for k, t0 in make_named(groups, name, seed, device).items():
                    change[k] = float((params[k] - t0.float()).norm())
    return {"losses": losses, "first_grad": first_grad, "change": change}


__all__ = ["weight_groups", "loss_of", "train", "learning_rate", "decays"]
