"""Operation and byte counts of the serving path, beside
`harness/roofline.py`'s peaks and kernel counts: a MoE decoder's
parameters that take part in a matrix product per token, K3's bytes,
and the model FLOPs of what the engine dispatched, from the program's
counters (`harness/program.py`).
"""
from __future__ import annotations

from typing import Dict


def moe_active_params(cfg: dict) -> int:
    """Parameters a token's matrix products read in a top-k MoE decoder
    (Mixtral): every attention projection, the router and the k experts
    it is routed to (three SwiGLU products each), in every layer, and
    the untied head. The embedding is a lookup and is left out."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // hq
    attn = d * hd * (2 * hq + 2 * hkv)
    router = d * cfg["num_local_experts"]
    experts = cfg["num_experts_per_tok"] * 3 * d * ff
    return cfg["num_hidden_layers"] * (attn + router + experts) \
        + cfg["vocab_size"] * d


def k3_cost(keys: int, hq: int, hkv: int, d: int):
    """(flops, bytes) of K3 (csrc/paged_decode.cu) over `keys` keys,
    summed over its launches: per key the two products of each query
    head, and its K and V rows of every kv head read once in bf16. At
    hq / hkv query heads a kv head it is bound by the bytes."""
    return 4.0 * keys * hq * d, 2.0 * 2 * keys * hkv * d


def serve_flops(cfg: dict, counts: Dict[str, int]) -> float:
    """Model FLOPs of the prefills and decode steps the engine
    dispatched: 2 x active parameters a token, and each causal (query,
    key) pair's two products (4 x d) in every layer. Padding, dropped
    and idle rows are not counted."""
    tokens = counts["llm.prefill_tokens"] + counts["llm.decode_tokens"]
    pairs = counts["llm.prefill_pairs"] + counts["llm.decode_keys"]
    return 2.0 * moe_active_params(cfg) * tokens \
        + 4.0 * cfg["hidden_size"] * cfg["num_hidden_layers"] * pairs
