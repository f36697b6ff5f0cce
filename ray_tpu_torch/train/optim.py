"""Optimizers and schedules (counterpart of ray_tpu/train/optim.py).

The JAX package builds its optimizers from optax. Here each follows its
optax chain step for step:

- adamw: `torch.optim.AdamW` (fused on CUDA) computes optax's
  `scale_by_adam` (eps outside the sqrt, eps_root 0) ->
  `add_decayed_weights` under the decay mask -> -lr; the mask becomes
  two param groups. adam is the same with no decay.
- sgd: `torch.optim.SGD(momentum=0.9)` keeps optax's `trace(0.9)`
  (t = g + 0.9 t) -> -lr.
- lion (written out: torch has none): sign((1 - b1) g + b1 m) -> decay
  on every parameter (optax.lion gets no mask) -> -lr; then
  m = b2 m + (1 - b2) g.
- adafactor (written out: torch's differs from optax's): optax's
  defaults, factored second moments for parameters with two dims
  >= 128, decay 1 - (t+1)^-0.8, eps 1e-30, update clipped to block
  rms 1, times lr, times the parameter's rms (at least 1e-3), no
  momentum.
- grad_clip: `clip_by_global_norm_`, which scales by max_norm / norm
  only when norm >= max_norm (`torch.nn.utils.clip_grad_norm_` would
  scale by max_norm / (norm + 1e-6) always).

A schedule is evaluated at the optimizer's step count before it is
incremented, as `scale_by_schedule` does, so `warmup_cosine` gives lr 0
on the first step. Parameters and moments are updated in place (the
counterpart of optax returning new trees).

`make_optimizer` returns a builder: call it on a module's
`named_parameters()` to get the `torch.optim.Optimizer`. The names are
needed for the decay mask.
"""
from __future__ import annotations

import math
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]
NamedParams = Iterable[Tuple[str, torch.Tensor]]


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr_frac: float = 0.1) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak_lr, max(1, warmup),
    max(2, total), peak_lr * end_lr_frac): linear warm-up from 0, then a
    cosine decay to the end value at `total_steps`."""
    warmup = max(1, warmup_steps)
    decay = max(2, total_steps) - warmup
    if decay <= 0:
        raise ValueError(f"warmup_cosine: total_steps={total_steps} must "
                         f"exceed warmup_steps={warmup}")
    alpha = 0.0 if peak_lr == 0.0 else end_lr_frac

    def schedule(count: int) -> float:
        if count < warmup:
            return peak_lr * min(max(count, 0), warmup) / warmup
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _decay_mask(names: Sequence[str]) -> List[bool]:
    """No weight decay on norms/biases/embeddings (standard LLM recipe);
    the same name tests as the JAX package, on the port's names."""
    return [not any(t in n.lower() for t in ("norm", "bias", "scale",
                                             "embed", "wpe", "ln_"))
            for n in names]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    global_norm)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: scale by max_norm / norm only
    when norm >= max_norm."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))


class _Chain:
    """Mixin before a `torch.optim.Optimizer`: each `step` fills missing
    gradients with zeros (optax updates every leaf), clips them, sets
    every group's lr to the schedule at the current count, runs the
    optimizer's own step, then counts. `count` is saved with the state
    dict."""

    def __init__(self, params, lr: LearningRate,
                 grad_clip: Optional[float], **kw):
        self.schedule = lr
        self.grad_clip = grad_clip
        self.count = 0
        super().__init__(params, lr=self.learning_rate(), **kw)

    def learning_rate(self) -> float:
        return (self.schedule(self.count) if callable(self.schedule)
                else self.schedule)

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in params], self.grad_clip)
        lr = self.learning_rate()
        for group in self.param_groups:
            group["lr"] = lr
        super().step()
        self.count += 1

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


class AdamW(_Chain, torch.optim.AdamW):
    """optax.adamw (adam when every group's weight_decay is 0): torch's
    AdamW does p *= 1 - lr wd, then p -= lr / (1 - b1^t) * m /
    (sqrt(v) / sqrt(1 - b2^t) + eps), optax's update."""


class SGD(_Chain, torch.optim.SGD):
    """optax.sgd with momentum: torch's SGD with dampening 0 keeps
    t = g + momentum t and does p -= lr t."""


class _PerParameter(torch.optim.Optimizer):
    """Base of the optimizers written out here: `step` applies
    `_update(p, grad, state, group)` to every parameter."""

    def __init__(self, params, **defaults):
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                self._update(p, p.grad, self.state[p], group)

    def _update(self, p, g, state, group):
        raise NotImplementedError


class Lion(_Chain, _PerParameter):
    """optax.lion: sign update, decay on every parameter."""

    def __init__(self, params, lr: LearningRate, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 1e-3,
                 grad_clip: Optional[float] = None):
        super().__init__(params, lr, grad_clip, b1=b1, b2=b2,
                         weight_decay=weight_decay)

    def _update(self, p, g, state, group):
        b1, b2, lr = group["b1"], group["b2"], group["lr"]
        if not state:
            state["mu"] = torch.zeros_like(p)
        mu = state["mu"]
        update = mu.mul(b1).add_(g, alpha=1.0 - b1).sign_()
        p.mul_(1.0 - lr * group["weight_decay"])
        p.add_(update, alpha=-lr)
        mu.mul_(b2).add_(g, alpha=1.0 - b2)


def _factored_dims(shape, min_dim_size_to_factor: int = 128
                   ) -> Optional[Tuple[int, int]]:
    """The two largest dims (second largest, largest) to factor over, or
    None when the second largest is below `min_dim_size_to_factor`."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor(_Chain, _PerParameter):
    """optax.adafactor with its defaults (see the module docstring)."""

    def __init__(self, params, lr: LearningRate, decay_rate: float = 0.8,
                 eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3,
                 grad_clip: Optional[float] = None):
        super().__init__(params, lr, grad_clip, decay_rate=decay_rate,
                         eps=eps, clipping_threshold=clipping_threshold,
                         min_scale=min_scale)

    def _update(self, p, g, state, group):
        dims = _factored_dims(p.shape)
        if not state:
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(p.select(d0, 0))
                state["v_col"] = torch.zeros_like(p.select(d1, 0))
        decay_t = 1.0 - (self.count + 1.0) ** -group["decay_rate"]
        g2 = g * g + group["eps"]
        if dims is None:
            v = state["v"]
            v.mul_(decay_t).add_(g2, alpha=1.0 - decay_t)
            update = g * v.rsqrt()
        else:
            d1, d0 = dims
            v_row, v_col = state["v_row"], state["v_col"]
            v_row.mul_(decay_t).add_(g2.mean(dim=d0), alpha=1.0 - decay_t)
            v_col.mul_(decay_t).add_(g2.mean(dim=d1), alpha=1.0 - decay_t)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)
                          ).rsqrt()
            update = (g * row_factor.unsqueeze(d0)
                      * v_col.rsqrt().unsqueeze(d1))
        del g2
        # clip_by_block_rms, then lr, then the parameter's block rms
        rms = update.square().mean().sqrt()
        update.div_(torch.clamp(rms / group["clipping_threshold"], min=1.0))
        p_rms = p.square().mean().sqrt()
        scale = torch.where(p_rms <= group["min_scale"],
                            torch.full_like(p_rms, group["min_scale"]),
                            p_rms)
        p.sub_(update.mul_(scale * group["lr"]))


def make_optimizer(name: str = "adamw", *, learning_rate: float = 3e-4,
                   weight_decay: float = 0.1, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: Optional[float] = 1.0,
                   schedule: Optional[Schedule] = None
                   ) -> Callable[[NamedParams], torch.optim.Optimizer]:
    """The JAX package's optimizer menu. Returns `build(named_params)`,
    which makes the optimizer over those parameters."""
    lr = schedule if schedule is not None else learning_rate
    clip = grad_clip or None
    if name not in ("adamw", "adam", "sgd", "lion", "adafactor"):
        raise ValueError(f"unknown optimizer {name!r}")

    def build(named_params: NamedParams) -> torch.optim.Optimizer:
        named = list(named_params)
        params = [p for _, p in named]
        if name in ("adamw", "adam"):
            mask = (_decay_mask([n for n, _ in named]) if name == "adamw"
                    else [False] * len(params))
            groups: List[Dict] = [
                {"params": [p for p, m in zip(params, mask) if m],
                 "weight_decay": weight_decay},
                {"params": [p for p, m in zip(params, mask) if not m],
                 "weight_decay": 0.0}]
            # one fused kernel over all parameters when they are on CUDA
            fused = all(p.is_cuda for p in params) or None
            return AdamW([g for g in groups if g["params"]], lr, clip,
                         betas=(b1, b2), eps=1e-8, fused=fused)
        if name == "sgd":
            return SGD(params, lr, clip, momentum=0.9)
        if name == "lion":
            return Lion(params, lr, weight_decay=weight_decay,
                        grad_clip=clip)
        return Adafactor(params, lr, grad_clip=clip)

    return build
