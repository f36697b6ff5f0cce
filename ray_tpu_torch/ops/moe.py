"""Mixture-of-Experts routing and capacity-factor dispatch (counterpart
of ray_tpu/ops/moe.py).

The same GShard/Switch formulation as the reference, not a grouped GEMM
over a gather: each token's top-k experts come from the router's logits,
its weights are a softmax over those k logits only (Mixtral), and its
place in each expert's queue is a slot-major int32 cumsum, so that every
token's first choice is queued before any second choice. An expert takes
at most `capacity` tokens; the rest of its queue is dropped (that
expert's share of the token's output is 0). Dispatch and combine are
one-hot (G, E, C) tensors and the expert batches come from einsums, so
which tokens are dropped depends on G, the number of tokens in the call.
The aux losses are fp32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar, Switch-style
    router_z_loss: torch.Tensor       # scalar
    expert_load: torch.Tensor         # (E,) fraction of tokens per expert


def expert_capacity(n_tokens: int, n_experts: int, k: int,
                    capacity_factor: float) -> int:
    cap = int(n_tokens * k * capacity_factor / n_experts)
    return max(cap, 1)


def top_k_routing(router_logits: torch.Tensor, k: int):
    """router_logits: (G, E). Returns (weights (G, k) fp32, indices
    (G, k) int64), weights = softmax over the selected top-k logits.
    Equal logits rank the lower expert index first, as jax.lax.top_k
    does (a stable descending sort; torch.topk promises no order among
    ties)."""
    top_logits, top_idx = torch.sort(router_logits, dim=-1, descending=True,
                                     stable=True)
    top_logits, top_idx = top_logits[:, :k], top_idx[:, :k]
    weights = torch.softmax(top_logits.float(), dim=-1)
    return weights, top_idx


def moe_dispatch_combine(x: torch.Tensor, router_logits: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor],
                         *, k: int = 2, capacity_factor: float = 1.25,
                         capacity: Optional[int] = None):
    """x: (G, d) flattened tokens; router_logits: (G, E).

    expert_fn: (E, C, d) -> (E, C, d_out), the experts applied to their
    batches. Returns (out (G, d_out), MoEAux)."""
    g = x.shape[0]
    e = router_logits.shape[-1]
    c = capacity if capacity is not None else expert_capacity(
        g, e, k, capacity_factor)

    weights, top_idx = top_k_routing(router_logits, k)          # (G, k)
    assign = F.one_hot(top_idx, e).float()                       # (G, k, E)
    # queue position of each (token, slot) at its expert, slot-major so
    # slot 0 wins capacity; int32 keeps it exact past 2**24 assignments
    slot_major = assign.transpose(0, 1).reshape(k * g, e).to(torch.int32)
    pos_slot_major = torch.cumsum(slot_major, dim=0,
                                  dtype=torch.int32) - slot_major
    pos = pos_slot_major.reshape(k, g, e).transpose(0, 1)       # (G, k, E)
    keep = assign * (pos < c)                                    # (G, k, E)
    slot_pos = (pos * keep).sum(-1).to(torch.int64)              # (G, k)

    cap_onehot = F.one_hot(slot_pos, c).float()                  # (G, k, C)
    dispatch = torch.einsum("gke,gkc->gec", keep, cap_onehot)
    combine = torch.einsum("gke,gk,gkc->gec", keep, weights, cap_onehot)

    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(x.dtype), x)
    expert_out = expert_fn(expert_in)                            # (E, C, do)
    out = torch.einsum("gec,ecd->gd", combine.to(expert_out.dtype),
                       expert_out)

    # aux losses (fp32): Switch load balance E * sum(frac_tokens *
    # frac_prob) / k, and the router z-loss
    logits32 = router_logits.float()
    frac_prob = torch.softmax(logits32, dim=-1).mean(dim=0)      # (E,)
    frac_tokens = assign.sum(dim=1).mean(dim=0)                  # (E,)
    lb = e * torch.sum(frac_prob * frac_tokens) / k
    z = torch.mean(torch.logsumexp(logits32, dim=-1) ** 2)
    return out, MoEAux(lb, z, frac_tokens)
