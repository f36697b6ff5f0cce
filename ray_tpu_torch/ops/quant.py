"""Weight-only int8 quantization for serving (counterpart of
ray_tpu/ops/quant.py).

Per-output-channel symmetric int8 weights with fp32 scales. The layout
is the port's: `kernel_q` is (out, in) int8, the nn.Linear layout, and
`scale` is (out,) fp32 (the reference stores kernel_q (in, out)). The
product runs as the reference's does: operands in the compute type,
fp32 result, times the scale in fp32, then cast to the compute type.
Here the int8 kernel becomes a transient copy in the compute type that
cuBLAS reads, about 5 bytes moved per weight at decode where a bf16
weight moves 2 (XLA fuses the convert into the product's operand read
instead).
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from .linear import logits_fp32


class QuantDense(nn.Module):
    """Drop-in for Dense(bias=False) with int8 weights: buffers
    `kernel_q` (out, in) int8 and `scale` (out,) fp32, made by
    `quantize_dense` / `quantize_llama_params`, never trained. Under tp
    `kernel_q` is a DTensor sharded by the rule table; `scale` stays
    whole."""

    def __init__(self, d_in: int, d_out: int, *,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(d_out, d_in,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(d_out,
                                                 dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The reference's init: zeros and ones."""
        self.kernel_q.zero_()
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        wq = self.kernel_q
        if not isinstance(wq, DTensor):
            y = logits_fp32(x.to(dt), wq)
            return (y * self.scale).to(dt)
        # sharded over tp (parallel/sharding.py): on dim 0 this rank's
        # output channels, on dim 1 its input features, whose fp32
        # partial products sum over the mesh before the scale
        local = wq.to_local()
        y = logits_fp32(x.to(dt), local)
        if wq.placements[0] == Shard(0):
            n = local.shape[0]
            r = wq.device_mesh.get_local_rank()
            return (y * self.scale[r * n:(r + 1) * n]).to(dt)
        dist.all_reduce(y, group=wq.device_mesh.get_group())
        return (y * self.scale).to(dt)


def quantize_dense(weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """weight (out, in), any floating type, on any device -> {kernel_q
    int8 (out, in), scale fp32 (out,)}, symmetric per output channel.
    On the same fp32 values it gives the reference's numpy result bit
    for bit: fp32 division, round half to even (np.rint and
    torch.round), clip to +-127."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=1).clamp(min=1e-8)              # (out,)
    scale = amax / 127.0
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


_DENSE_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj")


def quantize_llama_params(state: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A Llama state_dict -> the state_dict a quant='int8' Llama loads:
    each projection's `<path>.weight` becomes `<path>.kernel_q` and
    `<path>.scale`, quantized where the weight lies; norms, the
    embedding and the LM head stay as they are (the head feeds
    sampling)."""
    out = {}
    for name, t in state.items():
        path, _, leaf = name.rpartition(".")
        if leaf == "weight" and path.rpartition(".")[2] in _DENSE_NAMES:
            for k, v in quantize_dense(t).items():
                out[f"{path}.{k}"] = v
        else:
            out[name] = t
    return out


def quantized_bytes(state: Union[nn.Module, Mapping[str, torch.Tensor]]
                    ) -> int:
    """Total bytes of a (possibly quantized) state_dict or module."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    return sum(t.numel() * t.element_size() for t in state.values())


__all__ = ["QuantDense", "quantize_dense", "quantize_llama_params",
           "quantized_bytes"]
