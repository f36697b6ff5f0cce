"""Tensor ops of the port (counterpart of ray_tpu/ops/)."""
from .activations import swiglu
from .attention import (PagedKV, cached_attention, einsum_attention,
                        multi_head_attention, paged_cached_attention)
from .norms import rms_norm
from .rotary import apply_rotary, rope_frequencies

__all__ = ["swiglu", "PagedKV", "cached_attention", "einsum_attention",
           "multi_head_attention", "paged_cached_attention", "rms_norm",
           "apply_rotary", "rope_frequencies"]
