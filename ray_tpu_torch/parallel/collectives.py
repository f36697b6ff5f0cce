"""Collectives with derivatives, and the mesh's axis groups.

XLA inserts the collectives of the reference's sharded programs and
differentiates through them (`ppermute`, `psum`). In eager PyTorch a
collective is a call, and `torch.distributed`'s calls have no
derivative, so the port's parallel paths use these autograd functions.
Their backwards assume what the reference's layouts imply: a tensor
that is the same on every rank of the group (replicated) has the same
gradient on every rank, so

  copy_to_group      forward identity,   backward all-reduce (sum)
  reduce_from_group  forward all-reduce, backward identity
  gather_from_group  forward all-gather, backward this rank's slice
  all_gather_seq     forward all-gather, backward reduce-scatter (sum)
  all_to_all         forward all-to-all, backward all-to-all back
  all_to_all_v       the same with uneven splits
  all_reduce_sum     forward all-reduce, backward all-reduce (sum)

(`copy_to_group` and `reduce_from_group` are Megatron's f and g
operators: a tensor-parallel product's replicated input and its partial
sums. `all_gather_seq` gathers a sequence-sharded K/V for the ranks'
query chunks: each rank's loss reads every key, so a chunk's gradient
is the sum of every rank's gradient of it.) `shift` is the ring's hop
(send to rank + 1, receive from rank - 1), with no derivative: ring
attention writes its backward's hops out. Every buffer a collective
writes is contiguous: it fills memory in row-major order, whatever
strides its input had. The plain helpers below name the groups of a
`DeviceMesh` by axis and reduce plain tensors over several axes.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

DATA_AXES = ("dp", "fsdp", "ep")


# ---- the mesh's axes -------------------------------------------------------

def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def group_ranks(group) -> List[int]:
    """Global ranks of a group, in the group's own rank order."""
    return dist.get_process_group_ranks(group)


def data_axes(mesh) -> List[str]:
    """The axes that split the batch's rows, outermost first: dp, fsdp
    and ep (the port gives each ep rank its own rows; see ops/moe.py)."""
    return [a for a in DATA_AXES if axis_size(mesh, a) > 1]


def data_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def data_rank(mesh) -> int:
    """This rank's index among the data ranks, dp-major (the row order
    of the global batch)."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * axis_size(mesh, a) + axis_rank(mesh, a)
    return idx


def all_reduce_axes_(tensors: Sequence[torch.Tensor], mesh,
                     axes: Sequence[str]) -> None:
    """Sum plain tensors (in place) over the product of `axes`: one
    flat bucket, reduced over each axis's group in turn."""
    axes = [a for a in axes if axis_size(mesh, a) > 1]
    tensors = [t for t in tensors if t is not None]
    if not axes or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        for a in axes:
            dist.all_reduce(flat, group=axis_group(mesh, a))
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def all_gather_axes(t: torch.Tensor, mesh, axes: Sequence[str]
                    ) -> torch.Tensor:
    """(R, *t.shape): `t` from every rank of the product of `axes`, in
    the axes' row-major order (outermost axis first). No derivative."""
    out = t.contiguous()[None]
    for a in reversed([a for a in axes if axis_size(mesh, a) > 1]):
        group = axis_group(mesh, a)
        parts = [torch.empty_like(out) for _ in range(axis_size(mesh, a))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts)
    return out


# ---- collectives with derivatives -------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.n = group, dim, n
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[r].contiguous(), None, None


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.n = group, dim, n
        # gathered along dim 0 (one contiguous block a rank), then moved
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // ctx.n, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        x = x.contiguous()
        out = x.new_empty((sum(out_splits), *x.shape[1:]))
        dist.all_to_all_single(out, x, out_splits, in_splits, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        g = g.contiguous()
        out = g.new_empty((sum(in_splits), *g.shape[1:]))
        dist.all_to_all_single(out, g, in_splits, out_splits, group=ctx.group)
        return out, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def _shift(tensors, group, step: int):
    """Send each tensor to group rank (r + step) % n and receive the one
    from (r - step) % n, all in one batch of P2P ops."""
    ranks = group_ranks(group)
    n = len(ranks)
    r = dist.get_rank(group)
    dst, src = ranks[(r + step) % n], ranks[(r - step) % n]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def all_gather_seq(x, group, dim: int = 1):
    """x's chunks from every rank of `group` concatenated along `dim`,
    in the group's rank order; the gradient of the result is summed over
    the ranks and each rank keeps its own chunk's (a reduce-scatter)."""
    return _AllGatherSeq.apply(x, group, dim % x.ndim)


def gather_from_group(x, group, dim: int = -1):
    return _GatherFromGroup.apply(x, group, dim % x.ndim)


def all_to_all(x, group):
    """x (n, ...): chunk i goes to group rank i; returns (n, ...) whose
    chunk j came from group rank j."""
    return _AllToAll.apply(x, group)


def all_to_all_v(x, out_splits: Sequence[int], in_splits: Sequence[int],
                 group):
    """Rows of x (sum(in_splits), ...): the i-th run of in_splits[i] rows
    goes to group rank i; returns (sum(out_splits), ...), the j-th run
    of out_splits[j] rows from group rank j. The backward sends the
    gradients back the same way."""
    return _AllToAllV.apply(x, list(map(int, out_splits)),
                            list(map(int, in_splits)), group)


def all_reduce_sum(x, mesh, axes: Sequence[str]):
    """x summed over the ranks of the product of `axes`, the same value
    on every one of them, with a derivative. Its backward is the sum's
    adjoint: each rank's x receives the sum over those ranks of the
    gradients of their outputs, so the gradient of a loss that every
    rank computes from the sum is counted once per rank that uses it.
    That is what the mesh train step needs: it sums each parameter's
    gradient over the data ranks and divides by the global token count
    (train/spmd.py), each rank's loss weighted by its own tokens, so a
    term built from an all-reduced sum gets the weight sum(tokens) / N
    = 1 there and its gradient is the global term's."""
    groups = [axis_group(mesh, a) for a in axes if axis_size(mesh, a) > 1]
    return _AllReduceSum.apply(x, groups) if groups else x


def shift(tensors, group, step: int = 1):
    """Each tensor sent to group rank (r + step) % n; returns those
    received from (r - step) % n. No derivative."""
    return _shift(list(tensors), group, step)


__all__ = ["DATA_AXES", "axis_size", "axis_rank", "axis_group",
           "group_ranks", "data_axes", "data_size", "data_rank",
           "all_reduce_axes_", "all_gather_axes", "copy_to_group",
           "reduce_from_group", "gather_from_group", "all_gather_seq",
           "all_to_all", "all_to_all_v", "all_reduce_sum", "shift"]
