"""Llama-block models (Mistral-7B) through the port's `models/llama.py`,
trained by its `make_train_step` and `make_optimizer`."""
from __future__ import annotations

from typing import Dict

from harness.weights import load_into
from reference.llama import DTYPES, weight_groups

ANNOTATE: Dict[str, str] = {}


def build(cfg: Dict, device, seed: int):
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    w, t = cfg["weights"], cfg["train"]
    lc = LlamaConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"],
        max_seq_len=cfg["max_position_embeddings"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        remat=t["remat"] != "none",
        remat_policy="full" if t["remat"] == "none" else t["remat"],
        dtype=DTYPES[w["compute_dtype"]], param_dtype=DTYPES[w["dtype"]])
    model = Llama(lc, device=device, seed=0)
    load_into(model, weight_groups(cfg), seed, device)
    return model


def optimizer(cfg: Dict):
    from ray_tpu_torch.train.optim import make_optimizer, warmup_cosine
    o = cfg["train"]["optimizer"]
    sched = warmup_cosine(o["peak_lr"], o["warmup_steps"], o["total_steps"],
                          o["end_lr_frac"])
    return make_optimizer(o["name"], weight_decay=o["weight_decay"],
                          b1=o["b1"], b2=o["b2"], grad_clip=o["grad_clip"],
                          schedule=sched)
