"""Tensor ops of the port (counterpart of ray_tpu/ops/)."""
from .activations import geglu, gelu, swiglu
from .attention import (PagedKV, cached_attention, causal_attention_mask,
                        einsum_attention, multi_head_attention,
                        paged_cached_attention, sequence_parallel_attention)
from .moe import MoEAux, expert_capacity, moe_dispatch_combine, top_k_routing
from .norms import layer_norm, rms_norm
from .ring_attention import ring_attention
from .rotary import apply_rotary, rope_frequencies

__all__ = ["swiglu", "geglu", "gelu", "PagedKV", "cached_attention",
           "sequence_parallel_attention",
           "causal_attention_mask",
           "einsum_attention", "multi_head_attention",
           "paged_cached_attention", "rms_norm", "layer_norm",
           "apply_rotary", "rope_frequencies", "moe_dispatch_combine",
           "top_k_routing", "expert_capacity", "MoEAux", "ring_attention"]
