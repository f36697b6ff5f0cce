"""Published peaks of one NVIDIA H100 SXM (dense, 700 W) and the
operation and byte counts of the port's kernels and model steps, frozen
with the benchmark.

The kernel counts are the ones the port's kernel checks use: K1 (the
flash-attention forward) does the two products of every causal (query,
key) pair, K2a (dQ) three and K2b (dK, dV) four; bytes count each input
read once and each output written once.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def _pairs(s: int, causal: bool) -> float:
    return s * (s + 1) / 2 if causal else float(s * s)


def k1_cost(b: int, s: int, hq: int, hkv: int, d: int, causal: bool = True):
    """(flops, bytes) of one K1 launch in bf16: q, k, v read, the output
    written in bf16 and the fp32 log-sum-exp per query row."""
    flops = 4.0 * b * hq * d * _pairs(s, causal)
    nbytes = 2.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d) \
        + 4.0 * b * hq * s
    return flops, nbytes


def k2a_cost(b: int, s: int, hq: int, hkv: int, d: int, causal: bool = True):
    """(flops, bytes) of one K2a (dQ) launch: three products per pair;
    reads q, k, v, dO, lse and delta, writes dQ."""
    prod = 2.0 * b * hq * d * _pairs(s, causal)
    n_q, n_kv = float(b * s * hq * d), float(b * s * hkv * d)
    stats = 4.0 * 2 * b * hq * s
    return 3 * prod, 2 * (3 * n_q + 2 * n_kv) + stats


def k2b_cost(b: int, s: int, hq: int, hkv: int, d: int, causal: bool = True):
    """(flops, bytes) of one K2b (dK, dV) launch: four products per
    pair; reads q, k, v, dO, lse and delta, writes dK and dV."""
    prod = 2.0 * b * hq * d * _pairs(s, causal)
    n_q, n_kv = float(b * s * hq * d), float(b * s * hkv * d)
    stats = 4.0 * 2 * b * hq * s
    return 4 * prod, 2 * (2 * n_q + 4 * n_kv) + stats


def dense_matmul_params(cfg: dict) -> int:
    """Parameters that take part in a matrix product per token of a
    dense (Llama-block) model: every projection of every layer and the
    untied head. The embedding is a lookup and is left out."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    attn = d * hd * (2 * cfg["num_attention_heads"]
                     + 2 * cfg["num_key_value_heads"])
    return cfg["num_hidden_layers"] * (attn + 3 * d * ff) \
        + cfg["vocab_size"] * d


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of a dense causal decoder:
    6 * matmul parameters * tokens, plus causal attention's two
    products forward and four backward per (query, key) pair and head.
    Recomputation (remat) is not counted."""
    tokens = batch * seq
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    attn_fwd = 4.0 * batch * h * (d // h) * _pairs(seq, True)
    return 6.0 * dense_matmul_params(cfg) * tokens \
        + 3.0 * attn_fwd * cfg["num_hidden_layers"]
