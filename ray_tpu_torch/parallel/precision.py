"""Mixed-precision policy: bf16 compute, fp32 master weights and optimizer
state (counterpart of ray_tpu/parallel/precision.py).

On the H100 as on the TPU, bf16 is the tensor cores' input type and the
products accumulate in fp32 inside them, so the policy is a choice of
storage types only. `LlamaConfig(dtype=..., param_dtype=...)` applies
it to the model; `cast_for_compute` applies it to a tree of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32     # master copy
    compute_dtype: torch.dtype = torch.bfloat16  # matmul inputs
    output_dtype: torch.dtype = torch.float32    # logits / loss

    def cast_for_compute(self, tree: Any) -> Any:
        """Floating tensors of a dict/list/tuple tree cast to the compute
        type; everything else is returned as it is."""
        if isinstance(tree, torch.Tensor):
            return (tree.to(self.compute_dtype)
                    if tree.is_floating_point() else tree)
        if isinstance(tree, dict):
            return {k: self.cast_for_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_for_compute(v) for v in tree)
        return tree


BF16 = Precision()
FP32 = Precision(compute_dtype=torch.float32)
