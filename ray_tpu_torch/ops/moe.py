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
which tokens are dropped depends on G, the number of tokens in the call
(on a mesh, the global batch's: see `moe_dispatch_combine`). The aux
losses are fp32.
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


def _queue_positions(assign: torch.Tensor, mesh) -> torch.Tensor:
    """Each (token, slot)'s position in its expert's queue, slot-major
    so that every first choice queues before any second choice, int32
    (exact past 2**24 assignments). assign: (G, k, E) one-hot.

    On a mesh the queue is the global batch's, as the reference's jit
    sees it: the data ranks' tokens in row order (dp-major), so a slot-k
    assignment counts every slot before k on all ranks, then slot k on
    the ranks before this one."""
    from ..parallel import collectives as col  # noqa: PLC0415
    slot_major = assign.transpose(0, 1).to(torch.int32)         # (k, G, E)
    pos = torch.cumsum(slot_major, dim=1,
                       dtype=torch.int32) - slot_major          # within slot
    counts = slot_major.sum(dim=1, dtype=torch.int32)            # (k, E)
    if mesh is None or col.data_size(mesh) == 1:
        offset = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    else:
        every = col.all_gather_axes(counts, mesh,
                                    col.data_axes(mesh))        # (R, k, E)
        total = every.sum(0, dtype=torch.int32)
        offset = (torch.cumsum(total, 0, dtype=torch.int32) - total
                  + every[:col.data_rank(mesh)].sum(0, dtype=torch.int32))
    return (pos + offset[:, None, :]).transpose(0, 1)            # (G, k, E)


def moe_dispatch_combine(x: torch.Tensor, router_logits: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor],
                         *, k: int = 2, capacity_factor: float = 1.25,
                         capacity: Optional[int] = None, mesh=None):
    """x: (G, d) flattened tokens; router_logits: (G, E).

    expert_fn: (E, C, d) -> (E, C, d_out), the experts applied to their
    batches. Returns (out (G, d_out), MoEAux).

    With `mesh` (a DeviceMesh from parallel/mesh.py) x holds this data
    rank's tokens: the capacity comes from the global token count and
    the queue positions from the global order (`_queue_positions`), so
    the same tokens drop as under the reference's jit of the global
    batch. Under ep > 1 expert_fn applies this rank's E / ep experts
    (E / ep, C, d): each expert's capacity slots go to its ep rank by
    all-to-all, and its outputs come back the same way. The aux losses
    and `expert_load` are the global batch's, the same on every rank:
    the probability and assignment sums, the z-loss's sum and the token
    count are all-reduced over the data ranks before the means, with a
    gradient (see `collectives.all_reduce_sum`)."""
    from ..parallel import collectives as col  # noqa: PLC0415
    g = x.shape[0]
    e = router_logits.shape[-1]
    n_data = 1 if mesh is None else col.data_size(mesh)
    c = capacity if capacity is not None else expert_capacity(
        g * n_data, e, k, capacity_factor)

    weights, top_idx = top_k_routing(router_logits, k)          # (G, k)
    assign = F.one_hot(top_idx, e).float()                       # (G, k, E)
    pos = _queue_positions(assign, mesh)                         # (G, k, E)
    keep = assign * (pos < c)                                    # (G, k, E)
    slot_pos = (pos * keep).sum(-1).to(torch.int64)              # (G, k)

    cap_onehot = F.one_hot(slot_pos, c).float()                  # (G, k, C)
    dispatch = torch.einsum("gke,gkc->gec", keep, cap_onehot)
    combine = torch.einsum("gke,gk,gkc->gec", keep, weights, cap_onehot)

    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(x.dtype), x)
    ep = 1 if mesh is None else col.axis_size(mesh, "ep")
    if ep == 1:
        expert_out = expert_fn(expert_in)                        # (E, C, do)
    else:
        # a slot is filled on one rank at most: summing the ep ranks'
        # buffers gathers each of this rank's experts' batch
        group = col.axis_group(mesh, "ep")
        mine = col.all_to_all(expert_in.reshape(ep, e // ep, c, -1),
                              group).sum(0)
        out = expert_fn(mine)                                    # (E/ep, C, do)
        expert_out = col.all_to_all(
            out.unsqueeze(0).expand(ep, *out.shape).contiguous(),
            group).reshape(e, c, -1)
    out = torch.einsum("gec,ecd->gd", combine.to(expert_out.dtype),
                       expert_out)

    # aux losses (fp32): Switch load balance E * sum(frac_tokens *
    # frac_prob) / k, and the router z-loss, over the global batch: on a
    # mesh the sums and the token count are summed over the data ranks
    # before the means (all_reduce_sum carries the gradient)
    logits32 = router_logits.float()
    sums = torch.cat([torch.softmax(logits32, dim=-1).sum(0),     # (E,)
                      assign.sum(dim=(0, 1)),                     # (E,)
                      (torch.logsumexp(logits32, dim=-1) ** 2).sum()[None],
                      logits32.new_full((1,), float(g))])
    if n_data > 1:
        sums = col.all_reduce_sum(sums, mesh, col.data_axes(mesh))
    n = sums[-1]
    frac_prob, frac_tokens = sums[:e] / n, sums[e:2 * e] / n
    lb = e * torch.sum(frac_prob * frac_tokens) / k
    z = sums[2 * e] / n
    return out, MoEAux(lb, z, frac_tokens)
