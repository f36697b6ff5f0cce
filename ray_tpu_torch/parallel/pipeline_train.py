"""Pipeline-parallel training: a full train step over the `pp` mesh axis
(counterpart of ray_tpu/parallel/pipeline_train.py).

Layout, as the reference's: the token embedding and the tied LM head
live outside the pipelined region (replicated); the decoder blocks'
params are stacks of shape (pp, layers_per_stage, ...), sharded over pp
on their leading axis (a DTensor: each rank holds its stage). The
data axes shard the batch's rows, so each data rank runs its own
pipeline on its rows and pp composes with dp on one mesh.

The reference's step is loss(pipeline(x)) under `value_and_grad`; here
the forward and backward run `parallel.pipeline.pipeline_apply`'s GPipe
schedule, the loss is the mean over the global batch's tokens (the
local sums over the all-reduced count), and the gradients are summed
over the data ranks before the optimizer. Params are a dict
{"embed": (V, d), "stages": {name: (pp, L, ...)}, "final_norm": (d,)},
the stage names a `LlamaBlock`'s parameter names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.func import functional_call

from ..models.llama import Llama, LlamaBlock, LlamaConfig
from ..ops.linear import logits_fp32
from ..ops.norms import rms_norm
from ..ops.rotary import rope_frequencies
from ..util.device import DeviceLike, resolve_device
from .collectives import all_reduce_axes_, axis_size
from .pipeline import _flatten, pipeline_apply
from .sharding import batch_sharding


@dataclasses.dataclass
class PipelinedLMState:
    step: int
    params: Dict[str, Any]
    opt_state: torch.optim.Optimizer


class PipelinedLM:
    """Llama-family decoder whose block stack is pipelined over `pp`; the
    head is tied to the embedding."""

    def __init__(self, cfg: LlamaConfig, mesh, *, n_microbatches: int,
                 device: DeviceLike = "cuda"):
        pp = axis_size(mesh, "pp")
        if cfg.n_layers % pp:
            raise ValueError(
                f"n_layers ({cfg.n_layers}) must be divisible by the "
                f"mesh's pp axis ({pp})")
        self.cfg = cfg
        self.mesh = mesh
        self.pp = pp
        self.layers_per_stage = cfg.n_layers // pp
        self.n_microbatches = n_microbatches
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.block = LlamaBlock(cfg)
        self.block.to_empty(device=self.device)
        self.cos, self.sin = rope_frequencies(
            cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
            device=self.device)

    # ---- params -------------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Whole params on this rank's device, drawn as `Llama` draws
        its weights from `seed` (the same on every rank)."""
        cfg = dataclasses.replace(self.cfg, tie_embeddings=True)
        sd = Llama(cfg, device=self.device, seed=seed).state_dict()
        return self.from_layers(sd)

    def from_layers(self, sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """A tied Llama state_dict ("layer_{i}.<name>") restacked."""
        lps = self.layers_per_stage
        names = [k[len("layer_0."):] for k in sd if k.startswith("layer_0.")]
        stages = {n: torch.stack([torch.stack(
            [sd[f"layer_{s * lps + j}.{n}"] for j in range(lps)])
            for s in range(self.pp)]) for n in names}
        return {"embed": sd["token_embed.weight"], "stages": stages,
                "final_norm": sd["final_norm"]}

    def shard(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Trainable params on the mesh: the stage stacks sharded over pp
        on their leading axis, embed and final_norm replicated."""
        def leaf(t, sharded):
            t = t.detach().to(self.device)
            if sharded and self.pp > 1:
                t = distribute_tensor(t, self.mesh["pp"], [Shard(0)])
            return nn.Parameter(t)
        return {"embed": leaf(params["embed"], False),
                "stages": {k: leaf(v, True)
                           for k, v in params["stages"].items()},
                "final_norm": leaf(params["final_norm"], False)}

    # ---- forward ------------------------------------------------------
    def apply(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg

        def stage_fn(stage, h):
            for j in range(self.layers_per_stage):
                h, _ = functional_call(
                    self.block, {k: v[j] for k, v in stage.items()},
                    (h, self.cos, self.sin))
            return h

        h = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
        h = pipeline_apply(stage_fn, params["stages"], h, mesh=self.mesh,
                           n_microbatches=self.n_microbatches)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return logits_fp32(h, params["embed"])


def named_leaves(params: Dict[str, Any]):
    """(name, tensor) of every param: "embed", "stages/<name>",
    "final_norm"."""
    return list(_flatten(params).items())


def make_pipeline_train_step(model: PipelinedLM, tx, *,
                             loss_fn: Optional[Callable] = None):
    """init_fn(params_or_seed, example_batch) -> (state, step), like
    train.spmd.make_train_step, but the forward and backward run the
    GPipe schedule over the mesh's pp axis. `params_or_seed` is a whole
    params dict (e.g. from `models.convert.pipelined_lm_params_from_flax`)
    or a seed for `model.init_params`. Every rank calls
    `step(state, batch)` with the same global batch.

    `loss_fn(params, batch) -> (loss, metrics)` defaults to the
    reference's: the mean next-token cross-entropy; a metrics
    "ntokens" weights its rank's loss (1 when absent)."""
    mesh = model.mesh
    bsh = batch_sharding(mesh)

    def default_loss(params, batch):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = model.apply(params, inputs)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                              targets.reshape(-1).long())
        return nll, {"loss": nll.detach(),
                     "ntokens": torch.tensor(float(targets.numel()),
                                             device=nll.device)}

    loss_fn = loss_fn or default_loss

    def step(state: PipelinedLMState, batch):
        leaves = [p for _, p in named_leaves(state.params)]
        for p in leaves:
            p.grad = None
        loss, metrics = loss_fn(state.params, bsh.shard(batch))
        nt = torch.as_tensor(metrics.get("ntokens", 1.0),
                             dtype=torch.float32, device=loss.device)
        (loss * nt).backward()
        totals = torch.stack([nt, metrics["loss"].float() * nt])
        grads = [p.grad.to_local() if isinstance(p.grad, DTensor)
                 else p.grad for p in leaves]
        all_reduce_axes_([totals] + grads, mesh, ("dp", "fsdp", "ep"))
        n_tok = torch.clamp(totals[0], min=1.0)
        with torch.no_grad():
            for g in grads:
                g.div_(n_tok)
        out_loss = totals[1] / n_tok
        state.opt_state.step()
        for p in leaves:
            p.grad = None
        state.step += 1
        return state, {"loss": out_loss,
                       "ppl": torch.exp(torch.clamp(out_loss, max=20.0))}

    def init_fn(params_or_seed, example_batch):
        bsh.shard(example_batch)                    # checks the split
        params = (model.init_params(params_or_seed)
                  if isinstance(params_or_seed, int) else params_or_seed)
        params = model.shard(params)
        return PipelinedLMState(step=0, params=params,
                                opt_state=tx(named_leaves(params))), step

    return init_fn


__all__ = ["PipelinedLM", "PipelinedLMState", "make_pipeline_train_step",
           "named_leaves"]
