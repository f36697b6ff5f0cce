"""The train step (counterpart of ray_tpu/train/spmd.py).

Single-device for now: the step runs the model, its backward and the
optimizer on the device that holds the model. The mesh, the sharding
rules and state donation of the JAX step wait for the parallelism slice
(FSDP2 / DTensor over a torch DeviceMesh).

Params live in the module and are updated in place; a `TrainState`
names them with the optimizer and the step count. Where the JAX step is
one jitted function, this one is eager PyTorch: forward, backward (the
flash-attention kernels K1/K2a/K2b on the GPU), then the optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .optim import global_norm

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]    # the module's parameters, live
    opt_state: torch.optim.Optimizer   # holds the optimizer's moments

    @staticmethod
    def create(model: nn.Module, tx) -> "TrainState":
        named = list(model.named_parameters())
        return TrainState(step=0, params=dict(named), opt_state=tx(named))

    def state_dict(self) -> Dict[str, Any]:
        """Everything a checkpoint needs to resume: step, params and the
        optimizer's state (tensors on their devices)."""
        return {"step": self.step,
                "params": {k: v.detach() for k, v in self.params.items()},
                "opt_state": self.opt_state.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for k, v in state["params"].items():
                self.params[k].copy_(v)
        self.opt_state.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def next_token_loss(apply_fn: Callable, batch: Batch):
    """Causal LM loss. batch: {"tokens": (B, S)} or {"inputs",
    "targets"}; an optional "loss_mask" zeroes out padding/prompt
    positions. `apply_fn(inputs)` returns logits or (logits, cache).
    The cross-entropy runs on fp32 logits."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    out = apply_fn(inputs)
    logits = (out[0] if isinstance(out, tuple) else out).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction="none"
                          ).reshape(targets.shape)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    detached = loss.detach()
    return loss, {"loss": detached, "ntokens": denom.detach(),
                  "ppl": torch.exp(torch.clamp(detached, max=20.0))}


def _micro_batches(batch: Batch, n: int):
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} rows does not split into "
                         f"accum_steps={n} micro-batches")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model: nn.Module, tx, *,
                    loss_fn: Optional[Callable] = None,
                    accum_steps: int = 1) -> Callable:
    """Build the train step for `model` with the optimizer builder `tx`
    (from `make_optimizer`).

    Returns init_fn; `init_fn(example_batch)` gives (TrainState, step)
    and `step(state, batch)` returns (state, metrics) with metrics
    `loss`, `ntokens`, `ppl` (from the loss function) and `grad_norm`,
    the global norm of the gradients before clipping, as 0-d tensors on
    the model's device.

    `loss_fn(model, batch) -> (loss, metrics)` defaults to
    `next_token_loss`. With accum_steps > 1 the batch's leading dim
    splits into that many micro-batches, each run forward and backward
    in turn (activation memory scales with the micro-batch); their
    gradients accumulate in fp32, each weighted by its token count
    ("ntokens"; 1 when the loss function reports none), and one
    optimizer update applies at the end: numerically a large-batch step.
    """
    loss_fn = loss_fn or next_token_loss

    def grads_and_metrics(params, batch):
        if accum_steps <= 1:
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            return metrics
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        ms = []
        for mb in _micro_batches(batch, accum_steps):
            loss, m = loss_fn(model, mb)
            nt = torch.as_tensor(m.get("ntokens", 1.0), dtype=torch.float32,
                                 device=loss.device)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for acc, g in zip(gsum, grads):
                if g is not None:
                    acc.add_(g.float() * nt)
            ms.append((m, nt))
        nts = torch.stack([nt for _, nt in ms])
        total = nts.sum()
        for p, acc in zip(params, gsum):
            p.grad = (acc / torch.clamp(total, min=1.0)).to(p.dtype)
        # metrics: token-weighted means (ntokens itself sums); ppl from
        # the aggregated loss
        w = nts / torch.clamp(total, min=1.0)
        metrics = {k: sum(wi * m[k] for wi, (m, _) in zip(w, ms))
                   for k in ms[0][0]}
        if "ntokens" in metrics:
            metrics["ntokens"] = total
        if "ppl" in metrics and "loss" in metrics:
            metrics["ppl"] = torch.exp(torch.clamp(metrics["loss"],
                                                   max=20.0))
        return metrics

    def step(state: TrainState, batch: Batch):
        params = list(state.params.values())
        for p in params:
            p.grad = None
        metrics = dict(grads_and_metrics(params, batch))
        metrics["grad_norm"] = global_norm(
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params)
        state.opt_state.step()
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    def init_fn(example_batch: Batch) -> Tuple[TrainState, Callable]:
        if accum_steps > 1:
            _micro_batches(example_batch, accum_steps)   # checks the split
        return TrainState.create(model, tx), step

    return init_fn


__all__ = ["TrainState", "next_token_loss", "make_train_step"]
