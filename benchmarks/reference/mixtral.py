"""Mixtral-8x7B's decoder in plain PyTorch, float32 (Jiang et al. 2024,
arXiv:2401.04088; Hugging Face `MixtralForCausalLM`): pre-norm blocks of
grouped-query attention with rotary embeddings and a sparse MoE of
SwiGLU experts, each token sent to its top-2 experts by a linear router,
their outputs weighted by a softmax over the two chosen logits. Nothing
is dropped (the published model is dropless). Departure: ties among
router logits rank the lower expert first.

Weight layout (the port's parameter names, shared through
`weight_groups`): projections (out, in); experts stacked (E, d, ff) for
gate and up and (E, ff, d) for down; the router (d, E).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from harness.weights import Group, make_named
from reference.common import (causal_attention, fp32_exact, mm,
                              rms_norm, rope, rope_tables, swiglu)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_groups(cfg: Dict) -> List[Group]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, e, v = d // h, cfg["num_local_experts"], cfg["vocab_size"]
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
            (p + "moe.router_kernel", (d, e), d ** -0.5, 0.0),
            (p + "moe.experts_gate_kernel", (e, d, ff), d ** -0.5, 0.0),
            (p + "moe.experts_up_kernel", (e, d, ff), d ** -0.5, 0.0),
            (p + "moe.experts_down_kernel", (e, ff, d), ff ** -0.5, 0.0)]))
        groups.append((f"layer_{i}.norms", ndt, [
            (p + "attn_norm", (d,), 0.1, 1.0),
            (p + "mlp_norm", (d,), 0.1, 1.0)]))
    groups.append(("head", wdt, [("lm_head.weight", (v, d), d ** -0.5, 0.0)]))
    groups.append(("head.norm", ndt, [("final_norm", (d,), 0.1, 1.0)]))
    return groups


def _f32(ws: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: t.float() for k, t in ws.items()}


def _moe(x, w, k: int, control):
    router = w["moe.router_kernel"]
    logits = mm(x, router.t(), control)                       # (S, E)
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(top[:, :k], dim=-1)
    idx = idx[:, :k]
    out = torch.zeros_like(x)
    for e in range(router.shape[1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        gate = mm(xe, w["moe.experts_gate_kernel"][e].t(), control)
        up = mm(xe, w["moe.experts_up_kernel"][e].t(), control)
        y = mm(swiglu(gate, up), w["moe.experts_down_kernel"][e].t(), control)
        out.index_add_(0, rows, weights[rows, slot, None] * y)
    return out


def _block(x, w, cfg, cos, sin, control):
    s, d = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    eps = cfg["rms_norm_eps"]
    y = rms_norm(x, w["attn_norm"], eps)
    q = rope(mm(y, w["attention.q_proj.weight"], control).view(s, h, hd),
             cos, sin)
    kk = rope(mm(y, w["attention.k_proj.weight"], control).view(s, hkv, hd),
              cos, sin)
    vv = mm(y, w["attention.v_proj.weight"], control).view(s, hkv, hd)
    a = causal_attention(q, kk, vv, control).reshape(s, h * hd)
    x = x + mm(a, w["attention.o_proj.weight"], control)
    y = rms_norm(x, w["mlp_norm"], eps)
    return x + _moe(y, w, cfg["num_experts_per_tok"], control)


@torch.no_grad()
def logits(cfg: Dict, seed: int, seqs: List[torch.Tensor],
           starts: List[int], device, control=False
           ) -> List[torch.Tensor]:
    """Float32 logits of each sequence (1-D token ids) at positions
    starts[i]..len-1, layer by layer over all sequences, each layer's
    weights made again from the seed. control=True rounds every matrix
    product's operands to float8 e4m3 (the lower-precision control),
    "bf16" to bfloat16."""
    groups = weight_groups(cfg)
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    with fp32_exact():
        emb = make_named(groups, "embed", seed, device)["token_embed.weight"]
        hs = [emb[s.to(device).long()].float() for s in seqs]
        del emb
        tables = [rope_tables(torch.arange(s.numel(), device=device), hd,
                              cfg["rope_theta"]) for s in seqs]
        for i in range(cfg["num_hidden_layers"]):
            p = f"layer_{i}."
            w = _f32(make_named(groups, f"layer_{i}", seed, device), p)
            w.update(_f32(make_named(groups, f"layer_{i}.norms", seed,
                                     device), p))
            hs = [_block(x, w, cfg, c, s_, control)
                  for x, (c, s_) in zip(hs, tables)]
            del w
        head = _f32(make_named(groups, "head", seed, device), "")
        norm = _f32(make_named(groups, "head.norm", seed, device), "")
        out = []
        for x, start in zip(hs, starts):
            y = rms_norm(x[start:], norm["final_norm"], cfg["rms_norm_eps"])
            out.append(mm(y, head["lm_head.weight"], control))
        return out


def position_readings(cfg: Dict, seed: int, served, device,
                      control=False):
    """served: [(prompt ids, served token ids)]. For each request and
    each served position: the gap by which the served token's reference
    logit lies below the reference's best there, and the token's rank
    among the reference's logits (0: the best). With a control (True:
    float8; "bf16") the token at each position is the one the control
    puts first, and its gap and rank are read in the float32 reference.
    Returns [(gaps, ranks)] per request."""
    seqs, starts = [], []
    for prompt, toks in served:
        ids = torch.as_tensor(list(prompt) + list(toks[:-1]),
                              dtype=torch.long)
        seqs.append(ids)
        starts.append(len(prompt) - 1)
    ref = logits(cfg, seed, seqs, starts, device)
    if control:
        low = logits(cfg, seed, seqs, starts, device, control=control)
        picks = [lo.argmax(-1) for lo in low]
        del low
    else:
        picks = [torch.as_tensor(list(t), dtype=torch.long, device=device)
                 for _, t in served]
    out = []
    for r, pick in zip(ref, picks):
        mine = r.gather(1, pick[:, None])
        out.append((r.max(-1).values - mine[:, 0], (r > mine).sum(-1)))
    return out


__all__ = ["weight_groups", "logits", "position_readings"]
