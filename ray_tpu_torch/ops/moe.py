"""Mixture-of-Experts routing and capacity-factor dispatch (counterpart
of ray_tpu/ops/moe.py).

The same GShard/Switch semantics as the reference: each token's top-k
experts come from the router's logits, its weights are a softmax over
those k logits only (Mixtral), and its place in each expert's queue is
a slot-major int32 cumsum, so that every token's first choice is queued
before any second choice. An expert takes at most `capacity` tokens;
the rest of its queue is dropped (that expert's share of the token's
output is 0). The capacity and the queue are the call's tokens' (on a
mesh, the global batch's in its row-major order: see
`moe_dispatch_combine`), so which tokens drop depends on the shape the
caller runs.

Where the reference builds one-hot (G, E, C) dispatch and combine
tensors and einsums, the port moves rows by index: each kept (token,
slot) is copied into its expert's batch, and its output gathered back
and weighted; the fp32 products and the sum over k are the einsum's,
bit for bit up to that sum's order. On one rank the expert batches are
the reference's (E, C, d). On a mesh a rank holds only its own kept
rows, E batches of the longest of its experts' queues; under ep it
sends each expert rank only the rows for that rank's experts
(`all_to_all_v` on the mesh's ep group, the split sizes exchanged
first), and the outputs come back the same way. That group is the ep
dim of the experts' own (fsdp, ep) mesh (parallel/sharding.py), and
FSDP2 has gathered each rank's experts whole over d before `expert_fn`
runs. The aux losses are fp32.

While a profiler capture runs on the calling thread
(observability/profiler.py), a call's parts are spans: `moe.route`
(top-k and queue positions), `moe.dispatch`, `moe.experts` (expert_fn),
`moe.combine` and `moe.aux` (the aux losses' sums); and the counter
`moe.rows_computed` adds the rows the experts ran, E x n_slots a call
(zeros and dropped slots' rows included).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..observability.profiler import annotate, count


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


def _queue_positions(assign: torch.Tensor, rows: int, mesh,
                     axes) -> torch.Tensor:
    """Each (token, slot)'s position in its expert's queue, slot-major
    so that every first choice queues before any second choice, int32
    (exact past 2**24 assignments). assign: (G, k, E) one-hot int32 of
    this rank's G tokens, `rows` rows of G / rows tokens each.

    On a mesh the queue is the global batch's, as the reference's jit
    sees it: (B, S) in row-major order, the rows over the data ranks
    (dp-major) and, when `axes` (`_token_axes`) holds sp, each row's
    sequence over the sp ranks. Each rank's counts per (slot, row,
    expert) are gathered, and a (slot, row, chunk)'s offset is
    everything before it in that order."""
    from ..parallel import collectives as col  # noqa: PLC0415
    g, k, e = assign.shape
    per_row = assign.view(rows, g // rows, k, e)
    within = torch.cumsum(per_row, dim=1, dtype=torch.int32) - per_row
    counts = per_row.sum(dim=1, dtype=torch.int32).transpose(0, 1)  # (k, rows, E)
    if not axes:
        flat = counts.reshape(-1, e)
        offset = (torch.cumsum(flat, 0, dtype=torch.int32) - flat
                  ).view(k, rows, e)
    else:
        every = col.all_gather_axes(counts, mesh, axes)     # (R, k, rows, E)
        sp = "sp" in axes
        n_seq = col.axis_size(mesh, "sp") if sp else 1
        # (data rank, chunk, slot, row, E) -> slot, data rank, row, chunk
        order = every.view(-1, n_seq, k, rows, e).permute(2, 0, 3, 1, 4)
        flat = order.reshape(-1, e)
        before = (torch.cumsum(flat, 0, dtype=torch.int32) - flat
                  ).view(order.shape)
        seq = col.axis_rank(mesh, "sp") if sp else 0
        offset = before[:, col.data_rank(mesh), :, seq]      # (k, rows, E)
    pos = within + offset.transpose(0, 1)[:, None]           # (rows, c, k, E)
    return pos.view(g, k, e)


def _dispatch(x, flat_idx, n_rows):
    """(n_rows, d) zeros with x[g] copied to row flat_idx[g, j] for each
    (token, slot); the caller points the dropped slots at a trash row."""
    buf = x.new_zeros((n_rows, x.shape[-1]))
    for j in range(flat_idx.shape[1]):
        buf[flat_idx[:, j]] = x
    return buf


def _combine(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum over j of weights[:, j] * rows[:, j] (rows (G, k, d_out)):
    the einsum's products, the weights rounded to the rows' type first,
    summed in fp32 in slot order, then cast to the rows' type."""
    w = weights.to(rows.dtype).float()
    out = w[:, 0, None] * rows[:, 0].float()
    for j in range(1, rows.shape[1]):
        out = out + w[:, j, None] * rows[:, j].float()
    return out.to(rows.dtype)


def _exchange(x, top_idx, keep, expert_fn, e, ep, group):
    """Under ep: this rank's kept rows, sorted by expert (queue order
    within each), sent to the ranks holding their experts; each expert
    rank's batch holds the rows it received, the rows of its experts
    from every source one after another; the outputs return the same
    way. Returns (G, k, d_out) with zeros at the dropped slots."""
    from ..parallel import collectives as col  # noqa: PLC0415
    g, k = top_idx.shape
    e_local = e // ep
    order_key = torch.where(keep, top_idx * (g * k) + torch.arange(
        k, device=x.device)[None] * g + torch.arange(g, device=x.device)
        [:, None], torch.full_like(top_idx, e * g * k))
    order = torch.argsort(order_key.t().reshape(-1))        # slot-major ids
    n_kept = int(keep.sum())
    order = order[:n_kept]
    tok, slot = order % g, order // g
    counts = torch.bincount(top_idx[tok, slot], minlength=e)  # (E,)
    recv_counts = torch.empty_like(counts)
    torch.distributed.all_to_all_single(recv_counts, counts, group=group)
    send_splits = counts.view(ep, e_local).sum(1).tolist()
    recv = recv_counts.view(ep, e_local)                     # (src, expert)
    recv_splits = recv.sum(1).tolist()
    rows_in = col.all_to_all_v(x[tok], recv_splits, send_splits, group)
    # each received row's local expert and its row in that expert's batch
    lens = recv.reshape(-1)
    expert = torch.repeat_interleave(
        torch.arange(e_local, device=x.device).repeat(ep), lens)
    start = torch.cumsum(lens, 0) - lens
    src_off = (torch.cumsum(recv, 0) - recv).reshape(-1)
    within = (torch.arange(sum(recv_splits), device=x.device)
              - torch.repeat_interleave(start, lens))
    row = torch.repeat_interleave(src_off, lens) + within
    n_slots = int(recv.sum(0).max())
    flat = expert * n_slots + row
    batch = rows_in.new_zeros((e_local * n_slots, x.shape[-1]))
    batch[flat] = rows_in
    with annotate("moe.experts"):                          # (E/ep, n, do)
        out = expert_fn(batch.view(e_local, n_slots, x.shape[-1]))
    count("moe.rows_computed", e_local * n_slots)
    rows_out = out.reshape(e_local * n_slots, out.shape[-1])[flat]
    back = col.all_to_all_v(rows_out, send_splits, recv_splits, group)
    gathered = back.new_zeros((g * k, back.shape[-1]))
    gathered[tok * k + slot] = back
    return gathered.view(g, k, -1)


class Routing(NamedTuple):
    weights: torch.Tensor    # (G, k) fp32, softmax over the top-k logits
    top_idx: torch.Tensor    # (G, k) int64, the chosen experts
    slot: torch.Tensor       # (G, k) int32, queue position at that expert
    keep: torch.Tensor       # (G, k) bool, slot < capacity
    assign: torch.Tensor     # (G, k, E) int32 one-hot of top_idx


def _token_axes(mesh, seq_sharded: bool) -> list:
    """The mesh axes over which the global batch's tokens are spread:
    the data axes, and sp when the sequence is sharded."""
    from ..parallel import collectives as col  # noqa: PLC0415
    if mesh is None:
        return []
    axes = col.data_axes(mesh)
    if seq_sharded and col.axis_size(mesh, "sp") > 1:
        axes.append("sp")
    return axes


def route(router_logits: torch.Tensor, k: int, capacity: int, *, mesh=None,
          rows: int = 1, seq_sharded: bool = False) -> Routing:
    """Top-k routing and each (token, slot)'s place in its expert's
    queue of the global batch (`_queue_positions`); the slots at or past
    `capacity` drop."""
    weights, top_idx = top_k_routing(router_logits, k)          # (G, k)
    g, e = router_logits.shape
    assign = torch.zeros((g, k, e), dtype=torch.int32,
                         device=router_logits.device)
    assign.scatter_(2, top_idx[..., None], 1)                    # (G, k, E)
    pos = _queue_positions(assign, rows, mesh,
                           _token_axes(mesh, seq_sharded))
    slot = pos.gather(2, top_idx[..., None])[..., 0]
    return Routing(weights, top_idx, slot, slot < capacity, assign)


def moe_dispatch_combine(x: torch.Tensor, router_logits: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor],
                         *, k: int = 2, capacity_factor: float = 1.25,
                         capacity: Optional[int] = None, mesh=None,
                         rows: int = 1, seq_sharded: bool = False):
    """x: (G, d) flattened tokens, `rows` rows of G / rows each (the
    model's (B, S) reshaped); router_logits: (G, E).

    expert_fn: (E, n, d) -> (E, n, d_out), the experts applied to their
    batches (each row on its own). Returns (out (G, d_out), MoEAux).

    With `mesh` (a DeviceMesh from parallel/mesh.py) x holds this data
    rank's rows, and with `seq_sharded` (a published sp mesh) this sp
    rank's chunk of each: the capacity comes from the global token count
    and the queue positions from the global order (`route`), so the
    same tokens drop as under the reference's jit of the global batch.
    Under ep > 1 expert_fn applies this rank's E / ep experts to the
    rows every ep rank kept for them (`_exchange`). The aux losses and
    `expert_load` are the global batch's, the same on every rank: the
    probability and assignment sums, the z-loss's sum and the token
    count are all-reduced over the data ranks (and sp) before the means,
    with a gradient (see `collectives.all_reduce_sum`)."""
    from ..parallel import collectives as col  # noqa: PLC0415
    g = x.shape[0]
    e = router_logits.shape[-1]
    axes = _token_axes(mesh, seq_sharded)
    n_ranks = 1
    for a in axes:
        n_ranks *= col.axis_size(mesh, a)
    c = capacity if capacity is not None else expert_capacity(
        g * n_ranks, e, k, capacity_factor)
    with annotate("moe.route"):
        weights, top_idx, slot, keep, assign = route(
            router_logits, k, c, mesh=mesh, rows=rows,
            seq_sharded=seq_sharded)
        w_kept = torch.where(keep, weights, torch.zeros_like(weights))

    ep = 1 if mesh is None else col.axis_size(mesh, "ep")
    if ep > 1:
        gathered = _exchange(x, top_idx, keep, expert_fn, e, ep,
                             col.axis_group(mesh, "ep"))
    else:
        with annotate("moe.dispatch"):
            if n_ranks == 1:
                # one rank holds every token: the reference's (E, C)
                # batches
                n_slots = c
            else:
                # this rank's kept rows only: each expert's batch is as
                # long as its longest queue here, each row at its place
                # among this rank's kept rows
                kept = assign * keep[..., None]
                slot = _queue_positions(kept, 1, None, []).gather(
                    2, top_idx[..., None])[..., 0]
                n_slots = int(kept.sum(dim=(0, 1)).max())
            trash = e * n_slots
            flat_idx = torch.where(keep, top_idx * n_slots + slot,
                                   torch.full_like(top_idx, trash))
            batch = _dispatch(x, flat_idx, trash + 1)[:trash]
        with annotate("moe.experts"):
            out = expert_fn(batch.view(e, n_slots, x.shape[-1]))
        count("moe.rows_computed", trash)
        with annotate("moe.combine"):
            out = out.reshape(trash, out.shape[-1])
            # a dropped slot reads some row with weight 0
            gathered = (out[flat_idx.clamp(max=trash - 1)] if trash
                        else out.new_zeros((g, k, out.shape[-1])))
    with annotate("moe.combine"):
        out = _combine(gathered, w_kept)

    # aux losses (fp32): Switch load balance E * sum(frac_tokens *
    # frac_prob) / k, and the router z-loss, over the global batch: on a
    # mesh the sums and the token count are summed over the data ranks
    # (and sp) before the means (all_reduce_sum carries the gradient)
    with annotate("moe.aux"):
        logits32 = router_logits.float()
        sums = torch.cat([torch.softmax(logits32, dim=-1).sum(0),   # (E,)
                          assign.sum(dim=(0, 1)).float(),           # (E,)
                          (torch.logsumexp(logits32, dim=-1) ** 2)
                          .sum()[None],
                          logits32.new_full((1,), float(g))])
        if n_ranks > 1:
            sums = col.all_reduce_sum(sums, mesh, axes)
        n = sums[-1]
        frac_prob, frac_tokens = sums[:e] / n, sums[e:2 * e] / n
        lb = e * torch.sum(frac_prob * frac_tokens) / k
        z = sums[2 * e] / n
    return out, MoEAux(lb, z, frac_tokens)
