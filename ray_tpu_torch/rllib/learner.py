"""Learner / LearnerGroup: gradient updates, optionally data-parallel
over a mesh (counterpart of ray_tpu/rllib/learner.py).

Reference counterpart: rllib/core/learner/ (Learner, LearnerGroup). The
reference's LearnerGroup is one jitted update whose batch XLA shards
over a jax Mesh's dp axis. In the port a mesh is a process world
(`parallel.build_mesh` under `train.backend.launch`, one rank a card):
every rank holds the replicated params and calls `update` with the same
minibatch; the group pads it by cycling rows as the reference does,
trains on this rank's dp share and sums the gradients over dp. The
loss's batch reductions are the padded minibatch's: the group publishes
its mesh while the loss runs (`parallel.sharding.activation_mesh`, as
the train step does), and a loss takes its means through `batch_mean` /
`batch_std`, which gather the whole column over the published mesh's
data axis and reduce it as one device would.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..train.optim import global_norm
from .rl_module import tree_leaves


def adam(lr: float, grad_clip: Optional[float] = None):
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, no decay), behind
    optax.clip_by_global_norm(grad_clip) when given: a factory over
    named parameters, as `make_optimizer` returns."""
    from ..train.optim import make_optimizer  # noqa: PLC0415
    return make_optimizer("adam", learning_rate=lr, b1=0.9, b2=0.999,
                          grad_clip=grad_clip)


def _whole_batch(x: torch.Tensor) -> torch.Tensor:
    """x's rows from every data rank of the published mesh, in rank
    order: the padded minibatch's whole column while a LearnerGroup on a
    mesh runs the loss (`collectives.gather_from_group`: its gradient is
    this rank's rows'), else x."""
    from ..parallel.collectives import (axis_group, data_axes,  # noqa: PLC0415
                                        gather_from_group)
    from ..parallel.sharding import published_mesh  # noqa: PLC0415
    mesh = published_mesh()
    for axis in reversed([] if mesh is None else data_axes(mesh)):
        x = gather_from_group(x, axis_group(mesh, axis), dim=0)
    return x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the whole minibatch: over the rows of every dp rank
    while a LearnerGroup on a mesh runs the loss, else this batch's."""
    return _whole_batch(x).mean()


def batch_std(x: torch.Tensor) -> torch.Tensor:
    """The population deviation (jnp.std) of x over the whole
    minibatch."""
    return _whole_batch(x).std(correction=0)


def to_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Batch columns as tensors on `device`: floats as fp32, ints and
    bools kept (actions index, terminateds mask)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        out[k] = torch.as_tensor(a, device=device)
    return out


class Learner:
    """Owns params (a tree of leaf tensors, updated in place) and their
    optimizer; `loss_fn(params, batch, extra) -> (loss, stats)`; `tx` is
    a factory over named parameters (`adam`, `make_optimizer`)."""

    def __init__(self, params, *, loss_fn: Callable, tx):
        self.params = params
        self._named = tree_leaves(params)
        self.device = self._named[0][1].device
        self.tx = tx
        self.opt_state = tx(self._named)
        self._loss_fn = loss_fn

    def update(self, batch: Dict[str, Any], extra: Any = 0.0,
               reduce_grads: Optional[Callable] = None) -> Dict[str, float]:
        """One step on `batch`; `reduce_grads(grads)`, where given, acts
        on the gradients between the backward and the optimizer (a
        LearnerGroup's average over its ranks)."""
        tensors = [p for _, p in self._named]
        for p in tensors:
            p.grad = None
        loss, stats = self._loss_fn(self.params,
                                    to_tensors(batch, self.device), extra)
        loss.backward()
        if reduce_grads is not None:
            reduce_grads([p.grad for p in tensors if p.grad is not None])
        gnorm = global_norm(torch.zeros_like(p) if p.grad is None
                            else p.grad for p in tensors)
        self.opt_state.step()
        for p in tensors:
            p.grad = None
        stats = dict(stats, total_loss=loss.detach(), grad_norm=gnorm)
        return {k: float(v) for k, v in stats.items()}


class LearnerGroup:
    """The reference's data-parallel learner.

    `mesh`: None (a plain Learner, as the reference on one device), or a
    `DeviceMesh` from `parallel.build_mesh` whose world runs this group
    on every rank, each calling `update` with the same minibatch (a mesh
    of one rank is a plain Learner too). The group pads it to a multiple
    of the mesh's size by cycling rows (the reference's `_pad_to`),
    trains on this rank's share of the `dp_axis` and sums the gradients
    over it: each rank's backward of the loss built from the gathered
    columns (`batch_mean`) is the whole minibatch's gradient at its own
    rows. A mesh that also splits rows over another data axis (fsdp,
    ep) raises ValueError. On the first update the ranks' minibatches
    are compared by checksum, and a difference raises."""

    def __init__(self, learner: Learner, mesh=None, dp_axis: str = "dp"):
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(
                f"LearnerGroup(mesh=): a DeviceMesh from "
                f"parallel.build_mesh (a process world, one rank a card), "
                f"not {type(mesh).__name__}; pass mesh=None for one device")
        if mesh is not None:
            from ..parallel.collectives import data_axes  # noqa: PLC0415
            if set(data_axes(mesh)) - {dp_axis}:
                raise ValueError(
                    f"LearnerGroup shards the minibatch over {dp_axis!r} "
                    f"only; the mesh also splits rows over "
                    f"{data_axes(mesh)}")
        self.learner = learner
        self.mesh = mesh
        self.dp_axis = dp_axis
        self._checked = False

    @property
    def params(self):
        return self.learner.params

    def update(self, batch: Dict[str, Any],
               extra: Any = 0.0) -> Dict[str, float]:
        if self.mesh is None or self.mesh.size() == 1:
            # one rank pads nothing and reduces nothing
            return self.learner.update(batch, extra)
        from ..parallel.collectives import all_reduce_axes_  # noqa: PLC0415
        from ..parallel.sharding import activation_mesh  # noqa: PLC0415
        mesh, axis = self.mesh, self.dp_axis
        batch = {k: self._pad_to(np.asarray(v), mesh.size())
                 for k, v in batch.items()}
        if not self._checked:
            self._check_same(batch)
            self._checked = True
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        r = mesh.get_local_rank(axis)
        local = {k: v[r * (len(v) // n):(r + 1) * (len(v) // n)]
                 for k, v in batch.items()}

        def total(grads):
            all_reduce_axes_(grads, mesh, [axis])

        with activation_mesh(mesh):
            return self.learner.update(local, extra, reduce_grads=total)

    def _check_same(self, batch: Dict[str, np.ndarray]) -> None:
        """Raise unless every rank of the dp axis holds this minibatch
        (a checksum of each column, all-gathered)."""
        from ..parallel.collectives import all_gather_axes  # noqa: PLC0415
        sums = torch.tensor(
            [zlib.crc32(np.ascontiguousarray(batch[k]).tobytes())
             for k in sorted(batch)], dtype=torch.int64,
            device=self.learner.device)
        every = all_gather_axes(sums, self.mesh, [self.dp_axis])
        if not bool((every == sums).all()):
            raise ValueError(
                "LearnerGroup: the ranks were given different minibatches; "
                "every rank must run the same rollouts (same seeds) and "
                "call update with the same batch")

    @staticmethod
    def _pad_to(x: np.ndarray, mult: int) -> np.ndarray:
        rem = len(x) % mult
        if rem == 0:
            return x
        # cycle rows so any batch size pads up, even len(x) < mult
        idx = np.arange(mult - rem) % len(x)
        return np.concatenate([x, x[idx]])
