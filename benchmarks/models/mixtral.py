"""Mixtral through the port's `models/mixtral.py`, served by its
`LLMEngine`."""
from __future__ import annotations

from typing import Dict

from harness.weights import load_into
from reference.mixtral import DTYPES, weight_groups

# record_function ranges put around modules of these classes (forward
# hooks), for the per-layer metrics that read them
ANNOTATE = {"bench.moe": "MoEMLP"}


def build(cfg: Dict, device, seed: int):
    from ray_tpu_torch.models.mixtral import Mixtral, MixtralConfig
    w = cfg["weights"]
    mc = MixtralConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], n_experts=cfg["num_local_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        capacity_factor=cfg["serve"]["capacity_factor"],
        max_seq_len=cfg["max_position_embeddings"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        dtype=DTYPES[w["compute_dtype"]], param_dtype=DTYPES[w["dtype"]])
    model = Mixtral(mc, device=device, seed=0)
    load_into(model, weight_groups(cfg), seed, device)
    return model


def engine(model, cfg: Dict, device, seed: int):
    from ray_tpu_torch.serve.llm.engine import LLMEngine, LLMEngineConfig
    e = dict(cfg["serve"]["engine"])
    e["prefill_buckets"] = tuple(e["prefill_buckets"])
    return LLMEngine(model, None, LLMEngineConfig(**e), device=device,
                     seed=seed)
