"""Pipeline parallelism: a GPipe micro-batch schedule over the `pp` mesh
axis (counterpart of ray_tpu/parallel/pipeline.py).

The reference runs the schedule as one XLA program: a `lax.scan` of
M + pp - 1 ticks inside `shard_map`, activations hopping to the next
stage with `ppermute`, and `jax.grad` through it is the backward
pipeline. Here each pp rank is a process that owns one stage: it runs
its M micro-batches in order, receiving each input from stage - 1 and
sending each output to stage + 1 (P2P), so micro-batch m reaches stage
s at tick m + s and the last leaves after M + pp - 1 ticks, the
reference's schedule. The backward is the reverse schedule, written out
(torch's P2P has no derivative): after every forward, each stage takes
its micro-batches' output gradients from stage + 1 (the last stage from
the caller), backpropagates through its own graph and sends the input
gradients to stage - 1.

Constraints, as the reference's: stage_fn maps activations (mb, ...)
-> (mb, ...) with one tree of per-stage params; the token embedding and
the LM head live outside the pipelined region. The output is the same
on every pp rank (the reference's psum), and so is the gradient of the
input.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: Dict[str, torch.Tensor]):
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stage_params(params_list):
    """Stack per-stage param trees (dicts of tensors) along a new leading
    stage axis."""
    flat = [_flatten(p) for p in params_list]
    return _unflatten({k: torch.stack([f[k] for f in flat])
                       for k in flat[0]})


def pipeline_reference(stage_fn: Callable, stacked_params, x: torch.Tensor):
    """Sequential (no-mesh) semantics: stage_{n-1}(...stage_0(x))."""
    n = next(iter(_flatten(stacked_params).values())).shape[0]
    h = x
    for i in range(n):
        h = stage_fn(_map(lambda a: a[i], stacked_params), h)
    return h


def _buffer(like: torch.Tensor) -> torch.Tensor:
    """A contiguous receive buffer of like's shape and type (a received
    tensor fills memory in row-major order, whatever like's strides)."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage_fn, keys, group, n, idx, n_micro, *leaves):
        ranks = dist.get_process_group_ranks(group)
        prev, nxt = ranks[(idx - 1) % n], ranks[(idx + 1) % n]
        x_grad = ctx.needs_input_grad[0]
        params = [t.detach().requires_grad_(ctx.needs_input_grad[7 + i])
                  for i, t in enumerate(leaves)]
        tree = _unflatten(dict(zip(keys, params)))
        x_mb = x.chunk(n_micro)
        ins: List[torch.Tensor] = []
        outs: List[torch.Tensor] = []
        sends = []
        with torch.enable_grad():
            for m in range(n_micro):
                if idx == 0:
                    h = x_mb[m].detach()
                else:
                    h = _buffer(x_mb[0])
                    dist.recv(h, src=prev, group=group)
                h.requires_grad_(x_grad or idx > 0)
                o = stage_fn(tree, h)
                if idx < n - 1:
                    sends.append(dist.isend(o.detach().contiguous(), dst=nxt,
                                            group=group))
                ins.append(h)
                outs.append(o)
        for req in sends:
            req.wait()
        result = (torch.cat([o.detach() for o in outs]) if idx == n - 1
                  else torch.zeros_like(x))
        dist.all_reduce(result, group=group)   # the last stage's, on all
        ctx.state = (ins, outs, params, group, n, idx, prev, nxt, ranks,
                     x_grad)
        return result

    @staticmethod
    def backward(ctx, g):
        ins, outs, params, group, n, idx, prev, nxt, ranks, x_grad = \
            ctx.state
        del ctx.state
        n_micro = len(outs)
        g_mb = g.contiguous().chunk(n_micro)
        want = [p for p in params if p.requires_grad]
        dparams = [torch.zeros_like(p) for p in want]
        dx, sends = [], []
        for m in range(n_micro):
            if idx == n - 1:
                go = g_mb[m]
            else:
                go = _buffer(outs[m])
                dist.recv(go, src=nxt, group=group)
            inputs = ([ins[m]] if ins[m].requires_grad else []) + want
            grads = torch.autograd.grad(outs[m], inputs, go,
                                        allow_unused=True)
            if ins[m].requires_grad:
                gin, grads = grads[0], grads[1:]
                if idx == 0:
                    dx.append(gin)
                elif idx > 1 or x_grad:     # stage 0 wants it
                    sends.append(dist.isend(gin.contiguous(), dst=prev,
                                            group=group))
            for acc, gp in zip(dparams, grads):
                if gp is not None:
                    acc.add_(gp)
        for req in sends:
            req.wait()
        dx_full = None
        if x_grad:
            dx_full = torch.cat(dx).contiguous() if idx == 0 else _buffer(g)
            dist.broadcast(dx_full, src=ranks[0], group=group)
        it = iter(dparams)
        leaf_grads = [next(it) if p.requires_grad else None for p in params]
        return (dx_full, None, None, None, None, None, None, *leaf_grads)


def _local_stage(leaf: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    """This rank's stage of a stacked leaf: the local shard of a DTensor
    sharded over pp on dim 0, or row `idx` of a whole stack."""
    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a pp-sharded stack must hold one stage a "
                             f"rank, got {local.shape[0]}")
        return local[0]
    if leaf.shape[0] != n:
        raise ValueError(
            f"stacked stage axis is {leaf.shape[0]} but the mesh's pp "
            f"axis has {n} ranks; they must match (fold extra layers "
            f"inside stage_fn)")
    return leaf[idx]


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, *,
                   mesh, axis_name: str = "pp",
                   n_microbatches: int) -> torch.Tensor:
    """Run x (B, ...) through the staged pipeline on `mesh`.

    stacked_params: a tree (dicts) of per-stage params stacked on a
    leading axis of size pp, either whole on every rank or DTensors
    sharded over `axis_name` (each rank holding its stage). Each rank of
    the pp axis passes the same x (its data rank's rows); B must divide
    into n_microbatches. Returns (B, ...), the same on every pp rank.
    Differentiable in x and in this rank's stage params."""
    from .collectives import axis_group, axis_size
    n = axis_size(mesh, axis_name)
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} % n_microbatches "
                         f"{n_microbatches} != 0")
    if n == 1:
        return pipeline_reference(stage_fn, _map(
            lambda a: a.to_local() if isinstance(a, DTensor) else a,
            stacked_params), x)
    idx = mesh.get_local_rank(axis_name)
    flat = _flatten(stacked_params)
    keys = tuple(flat)
    leaves = [_local_stage(flat[k], n, idx) for k in keys]
    return _Pipeline.apply(x, stage_fn, keys, axis_group(mesh, axis_name),
                           n, idx, n_microbatches, *leaves)


__all__ = ["stack_stage_params", "pipeline_reference", "pipeline_apply"]
