"""The train step (counterpart of ray_tpu/train/spmd.py).

Without a mesh the step runs the model, its backward and the optimizer
on the device that holds the model. With a mesh (parallel/mesh.py) it
is the counterpart of the reference's one jitted SPMD function: every
rank of the world runs it on its share of the batch, the model sharded
by the rule table (`parallel.sharding.shard_module`: FSDP2 over fsdp,
replicas over dp, DTensor plans over tp, experts over ep and tp, the
sequence over sp), and the collectives are FSDP2's, DTensor's and the
few the step and the models make themselves.

Params live in the module and are updated in place (the counterpart of
donating the state); a `TrainState` names them with the optimizer and
the step count. Where the JAX step is one jitted function, this one is
eager PyTorch: forward, backward (the flash-attention kernels K1/K2a/K2b
on the GPU), then the optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

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


@dataclasses.dataclass
class SpmdStep:
    """The step on a mesh, with the shardings it uses: `state_shardings`
    the layout of `TrainState.state_dict()` on the mesh, as
    `restore_pytree(shardings=)` takes it (`state_layout`);
    `batch_shardings` this rank's share of a global batch."""
    step_fn: Callable[[TrainState, Batch], Tuple[TrainState, Dict]]
    mesh: Any
    state_shardings: Dict[str, Any]
    batch_shardings: Any

    def __call__(self, state, batch):
        return self.step_fn(state, batch)


def make_train_step(model: nn.Module, tx, mesh=None, *,
                    loss_fn: Optional[Callable] = None,
                    rules=None, donate_state: bool = True,
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

    With `mesh`, `init_fn(example_batch)` shards the model (`rules`,
    default the table) and gives (TrainState, SpmdStep); see
    `_mesh_train_step`. The state is always updated in place, so
    `donate_state` changes nothing here.
    """
    loss_fn = loss_fn or next_token_loss
    if mesh is not None:
        return _mesh_train_step(model, tx, mesh, loss_fn, rules,
                                accum_steps)

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


def token_count(batch: Batch, metrics: Dict, device) -> torch.Tensor:
    """The tokens a loss averaged over, fp32: the batch's `loss_mask`
    sum where it has one (rows with no masked token count 0, where
    next_token_loss's own denominator is at least 1), else the loss
    function's "ntokens", else 1. On a mesh the ranks' counts add up to
    the global batch's."""
    if "loss_mask" in batch:
        return batch["loss_mask"].float().sum().to(device)
    return torch.as_tensor(metrics.get("ntokens", 1.0), dtype=torch.float32,
                           device=device)


def state_layout(state: TrainState) -> Dict[str, Any]:
    """The tree of `state.state_dict()`'s keys whose leaves give each
    tensor's layout: every parameter (a DTensor on a mesh), and under
    "opt_state" / "state", at each parameter's optimizer index (the
    optimizer's own order of its groups' parameters, the keys of
    `Optimizer.state_dict()["state"]`), the tensor its moments take the
    layout of, as the optimizer reports it (`state_like`: the parameter
    for adamw, sgd and lion; a whole tensor for adafactor's moments of a
    DTensor). An optimizer that does not report keeps its moments in
    its parameter's layout, as torch's own do."""
    opt = state.opt_state
    like = getattr(opt, "state_like", lambda p: p)
    order = [p for g in opt.param_groups for p in g["params"]]
    return {"params": dict(state.params),
            "opt_state": {"state": {i: like(p) for i, p in enumerate(order)}}}


def _summed_over(p) -> Tuple[str, ...]:
    """The mesh axes a parameter's gradient is already summed (or, by
    FSDP2, averaged) over when the backward ends: those of its DTensor's
    mesh. FSDP2's parameters live on meshes with its data axes (fsdp,
    and dp under HSDP), which it reduces; the stacked experts also on
    ep, whose exchange brought every ep rank's tokens to the rank that
    holds them; tp splits the work of one batch and is no data axis. A
    parameter outside FSDP2 (GPT-2's tp-strided qkv bias) lives on the
    tp mesh alone and is reduced over every data axis by the step."""
    return (tuple(p.device_mesh.mesh_dim_names) if isinstance(p, DTensor)
            else ())


def _mesh_train_step(model, tx, mesh, loss_fn, rules, accum_steps):
    """The step on a mesh. Every rank calls `step(state, batch)` with the
    same global batch and trains on its share (`batch_shardings`), or
    with a `LocalBatch` of that sharding (`data.device_put_iterator`
    with `sharding=`), which holds the share already and is taken as it
    is: the same rows, so the same step. Under sp a `tokens` batch is
    shifted into `inputs` and `targets` before the sequence is cut
    (`BatchSharding.shift_tokens`), and the step publishes the mesh
    (`activation_mesh`) around the forward and the backward, so the
    model takes its input as this rank's chunk of each row.

    The loss is the reference's: the masked mean over the global batch.
    Each rank's backward runs on its local masked sum (per micro-batch
    under accum_steps, weighted by `token_count`); the token count N is
    all-reduced over the data ranks and sp, and every gradient scaled
    so that it is d(sum)/N over the whole batch, whatever each rank's
    mask holds. FSDP2 averages over its data mesh (dp x fsdp), hence the
    factor of that mesh's size; ep and sp ranks hold their own tokens,
    so each gradient is then summed over the data axes and sp that it
    is not summed over yet (`_summed_over`): a dense parameter's over ep
    and sp, an expert's over sp (ep was its exchange's), and one outside
    FSDP2 over dp, fsdp, ep and sp. Metrics (loss, ntokens, ppl and
    grad_norm) are the global values on every rank."""
    from ..parallel.collectives import all_reduce_axes_
    from ..parallel.sharding import (activation_mesh, batch_sharding,
                                     data_mesh, shard_module)
    shard_module(model, mesh, rules)
    bsh = batch_sharding(mesh)
    fsdp_ranks = data_mesh(mesh).size()

    def step(state: TrainState, batch: Batch):
        params = list(state.params.values())
        for p in params:
            p.grad = None
        local = bsh.shard(batch)
        micro = (_micro_batches(local, accum_steps) if accum_steps > 1
                 else [local])
        totals, keys = None, None
        with activation_mesh(mesh):
            for mb in micro:
                loss, m = loss_fn(model, mb)
                nt = token_count(mb, m, loss.device)
                (loss * nt).backward()
                keys = keys or [k for k in m if k not in ("ntokens", "ppl")]
                row = torch.stack([nt] + [torch.as_tensor(
                    m[k], dtype=torch.float32, device=loss.device) * nt
                    for k in keys])
                totals = row if totals is None else totals + row
        all_reduce_axes_([totals], mesh, ("dp", "fsdp", "ep", "sp"))
        n_tok = torch.clamp(totals[0], min=1.0)
        # each gradient summed over the axes it is not summed over yet,
        # then scaled to d(sum)/N (FSDP2's means back to sums)
        by_axes: Dict[Tuple[str, ...], list] = {}
        for p in params:
            if p.grad is not None:
                done = _summed_over(p)
                g = p.grad
                by_axes.setdefault(tuple(
                    a for a in ("dp", "fsdp", "ep", "sp") if a not in done),
                    []).append((g.to_local() if isinstance(g, DTensor)
                                else g, fsdp_ranks if "fsdp" in done else 1))
        with torch.no_grad():
            for axes, grads in by_axes.items():
                all_reduce_axes_([g for g, _ in grads], mesh, axes)
                for g, scale in grads:
                    g.mul_(scale / n_tok)
        metrics = {k: totals[i + 1] / n_tok for i, k in enumerate(keys)}
        metrics["ntokens"] = totals[0]
        if "loss" in metrics:
            metrics["ppl"] = torch.exp(torch.clamp(metrics["loss"],
                                                   max=20.0))
        metrics["grad_norm"] = global_norm(
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params)
        state.opt_state.step()
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    def init_fn(example_batch: Batch) -> Tuple[TrainState, SpmdStep]:
        bsh.shard(example_batch)                 # checks the split
        if accum_steps > 1:
            _micro_batches(bsh.shard(example_batch), accum_steps)
        state = TrainState.create(model, tx)
        return state, SpmdStep(step, mesh, state_layout(state), bsh)

    return init_fn


__all__ = ["TrainState", "SpmdStep", "next_token_loss", "make_train_step",
           "token_count", "state_layout"]
