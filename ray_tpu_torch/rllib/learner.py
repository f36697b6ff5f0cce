"""Learner / LearnerGroup: gradient updates on one device (counterpart
of ray_tpu/rllib/learner.py).

Reference counterpart: rllib/core/learner/ (Learner, LearnerGroup). The
reference's LearnerGroup shards each batch over a jax Mesh's dp axis;
on one device it is a plain Learner, and that is what the port has.
Data parallelism over several cards (a LearnerGroup over the port's
DeviceMesh) is not ported yet (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

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

    def update(self, batch: Dict[str, Any],
               extra: Any = 0.0) -> Dict[str, float]:
        tensors = [p for _, p in self._named]
        for p in tensors:
            p.grad = None
        loss, stats = self._loss_fn(self.params,
                                    to_tensors(batch, self.device), extra)
        loss.backward()
        gnorm = global_norm(torch.zeros_like(p) if p.grad is None
                            else p.grad for p in tensors)
        self.opt_state.step()
        for p in tensors:
            p.grad = None
        stats = dict(stats, total_loss=loss.detach(), grad_norm=gnorm)
        return {k: float(v) for k, v in stats.items()}


class LearnerGroup:
    """The reference's data-parallel learner, on one device.

    `mesh`: None, or the sequence of devices to shard each batch over.
    One device is the reference's "degrades to a plain Learner"; more
    raise NotImplementedError."""

    def __init__(self, learner: Learner, mesh=None, dp_axis: str = "dp"):
        del dp_axis     # the reference's batch axis name; one device here
        if mesh is not None and len(mesh) > 1:
            raise NotImplementedError(
                f"LearnerGroup over {len(mesh)} devices: data "
                f"parallelism over a mesh is not ported yet (ROADMAP "
                f"queue 1, item 9); pass mesh=None or one device")
        self.learner = learner
        self.mesh = mesh

    @property
    def params(self):
        return self.learner.params

    def update(self, batch: Dict[str, Any],
               extra: Any = 0.0) -> Dict[str, float]:
        return self.learner.update(batch, extra)

