"""RLModule: policy (+ value) networks and action distributions
(counterpart of ray_tpu/rllib/rl_module.py).

Reference counterpart: rllib/core/rl_module/ (RLModule, catalog-built
encoder + pi/vf heads) and rllib/models/distributions. As in the
reference, the module is a function of (params, obs): params are a tree
of tensors {"pi": {...}, "vf": {...}[, "log_std"]} over the port's
`models/mlp.py` MLP, run by `torch.func.functional_call`. Sampling
draws from an explicit `torch.Generator`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..models.mlp import MLP, MLPConfig
from ..util.device import DeviceLike, resolve_device
from .env import Space


class Categorical:
    """Discrete action distribution over logits."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        probs = torch.softmax(self.logits.float(), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=gen).reshape(
            probs.shape[:-1])

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        logp_all = torch.log_softmax(self.logits, dim=-1)
        return logp_all.gather(-1, actions[..., None].long()).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        lp = torch.log_softmax(self.logits, -1)
        lq = torch.log_softmax(other.logits, -1)
        return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)


class DiagGaussian:
    """Continuous action distribution: independent normals."""

    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean = mean
        self.log_std = log_std

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        eps = torch.randn(self.mean.shape, generator=gen,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(self.log_std) * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2 * self.log_std)
        ll = -0.5 * ((actions - self.mean) ** 2 / var
                     + 2 * self.log_std + math.log(2 * math.pi))
        return torch.sum(ll, dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std
                         + 0.5 * math.log(2 * math.pi * math.e), dim=-1)

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        v0 = torch.exp(2 * self.log_std)
        v1 = torch.exp(2 * other.log_std)
        return torch.sum(other.log_std - self.log_std
                         + (v0 + (self.mean - other.mean) ** 2) / (2 * v1)
                         - 0.5, dim=-1)


@dataclasses.dataclass(frozen=True)
class RLModuleSpec:
    """Reference: rllib/core/rl_module/rl_module.py::RLModuleSpec."""
    obs_dim: int
    action_space: Space
    hidden: Sequence[int] = (64, 64)
    activation: str = "tanh"
    free_log_std: bool = True     # continuous: state-independent log-std


def _mlp_params(net: MLP) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in net.named_parameters()}


class RLModule:
    """Separate policy and value MLP towers + a dist head, on `device`.

    forward(params, obs) -> (dist_inputs, value)."""

    def __init__(self, spec: RLModuleSpec, *, device: DeviceLike = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        sp = spec.action_space
        if sp.kind == "discrete":
            self.pi_out = sp.n
            self.is_discrete = True
        else:
            self.pi_out = int(np.prod(sp.shape))
            self.is_discrete = False
        self.pi_cfg = MLPConfig(hidden=tuple(spec.hidden),
                                out_dim=self.pi_out,
                                activation=spec.activation)
        self.vf_cfg = MLPConfig(hidden=tuple(spec.hidden), out_dim=1,
                                activation=spec.activation)
        # the towers' modules: functional_call runs them on any params
        self.pi_net = MLP(self.pi_cfg, spec.obs_dim, device=self.device)
        self.vf_net = MLP(self.vf_cfg, spec.obs_dim, device=self.device)

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Fresh params (flax's initialisers, drawn from generators
        seeded `seed` and `seed + 1`), leaves that require grad."""
        params: Dict[str, Any] = {
            "pi": _mlp_params(MLP(self.pi_cfg, self.spec.obs_dim,
                                  device=self.device, seed=seed)),
            "vf": _mlp_params(MLP(self.vf_cfg, self.spec.obs_dim,
                                  device=self.device, seed=seed + 1)),
        }
        if not self.is_discrete and self.spec.free_log_std:
            params["log_std"] = torch.zeros(
                (self.pi_out,), device=self.device, requires_grad=True)
        return params

    def obs(self, obs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    def forward(self, params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        dist_in = functional_call(self.pi_net, params["pi"], (obs,))
        value = functional_call(self.vf_net, params["vf"], (obs,)).squeeze(-1)
        return dist_in, value

    def dist(self, params, dist_in):
        if self.is_discrete:
            return Categorical(dist_in)
        log_std = params.get("log_std")
        if log_std is None:
            log_std = torch.zeros(dist_in.shape[-1:], device=dist_in.device)
        return DiagGaussian(dist_in, torch.broadcast_to(log_std,
                                                        dist_in.shape))

    @torch.no_grad()
    def explore_action(self, params, obs, gen: torch.Generator):
        """One sampling step: obs -> (action, logp, value)."""
        dist_in, value = self.forward(params, obs)
        d = self.dist(params, dist_in)
        a = d.sample(gen)
        return a, d.logp(a), value

    @torch.no_grad()
    def deterministic_action(self, params, obs):
        dist_in, _ = self.forward(params, obs)
        return self.dist(params, dist_in).mode()


def spec_for_env(env, hidden: Sequence[int] = (64, 64),
                 activation: str = "tanh") -> RLModuleSpec:
    obs_dim = int(np.prod(env.observation_space.shape))
    return RLModuleSpec(obs_dim=obs_dim, action_space=env.action_space,
                        hidden=hidden, activation=activation)


def tree_leaves(tree, prefix: str = "") -> list:
    """[(name, tensor)] of a nested dict / tuple of tensors, names joined
    by "/" (the names an optimizer takes)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = []
    for k, v in items:
        out += tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_copy_(dst, src) -> None:
    """Copy `src` (a tree of tensors or arrays with dst's names) into the
    tensors of `dst`, in place, leaf by name."""
    src = dict(tree_leaves(_as_tensors(src)))
    dst = tree_leaves(dst)
    if set(src) != {name for name, _ in dst}:
        raise KeyError(f"trees differ: {sorted(src)} vs "
                       f"{sorted(name for name, _ in dst)}")
    with torch.no_grad():
        for name, d in dst:
            d.copy_(src[name])


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return torch.as_tensor(np.asarray(tree) if not torch.is_tensor(tree)
                           else tree)


def tree_to_cpu(tree):
    """A detached CPU copy of a tree of tensors (checkpoints)."""
    if isinstance(tree, dict):
        return {k: tree_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_cpu(v) for v in tree)
    return tree.detach().cpu().clone()


def tree_clone(tree, requires_grad: Optional[bool] = None):
    """A detached copy on the same device."""
    if isinstance(tree, dict):
        return {k: tree_clone(v, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_clone(v, requires_grad) for v in tree)
    out = tree.detach().clone()
    return out.requires_grad_(True) if requires_grad else out
