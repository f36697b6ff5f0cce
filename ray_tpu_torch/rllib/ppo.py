"""PPO: clipped surrogate + GAE + entropy/KL regularization
(counterpart of ray_tpu/rllib/ppo.py).

Reference counterpart: rllib/algorithms/ppo/ (ppo.py, ppo_learner,
torch policy). Each minibatch update (forward, ratio, clip, value loss,
entropy, adaptive KL, grads, adam behind a global-norm clip) runs on
the learner's device; epochs and minibatches iterate in Python. With
`use_mesh=True` inside a process group (`train.backend.launch`) the
learner group is data-parallel over `MeshSpec(dp=world)`: every rank
runs the same PPO from the same seeds, and the loss's means are the
whole minibatch's (`batch_mean`); outside one it is a world of one, as
the reference's mesh on one device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .learner import Learner, LearnerGroup, adam, batch_mean, batch_std
from .sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.2        # adaptive-KL penalty initial coeff
        self.kl_target = 0.01
        self.num_epochs = 8
        self.minibatch_size = 128
        self.grad_clip = 0.5
        self.use_mesh = False      # dp-shard minibatches over the world
        self.algo_class = PPO


def ppo_loss(module, cfg: PPOConfig):
    """loss_fn(params, batch, kl_coeff) -> (loss, stats), the
    reference's; its means are the whole minibatch's under a mesh
    (`batch_mean`)."""
    def loss_fn(params, batch, kl_coeff):
        dist_in, values = module.forward(params, batch[sb.OBS])
        dist = module.dist(params, dist_in)
        logp = dist.logp(batch[sb.ACTIONS])
        ratio = torch.exp(logp - batch[sb.LOGPS])
        adv = batch[sb.ADVANTAGES]
        # jnp.std: the population deviation
        adv = (adv - batch_mean(adv)) / (batch_std(adv) + 1e-8)
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        pi_loss = -batch_mean(surr)
        # clipped value loss (reference: ppo_torch_policy vf_clip)
        vf_err = (values - batch[sb.RETURNS]) ** 2
        vf_clipped = batch[sb.VALUES] + torch.clamp(
            values - batch[sb.VALUES], -cfg.vf_clip_param,
            cfg.vf_clip_param)
        vf_err2 = (vf_clipped - batch[sb.RETURNS]) ** 2
        vf_loss = 0.5 * batch_mean(torch.maximum(vf_err, vf_err2))
        entropy = batch_mean(dist.entropy())
        approx_kl = batch_mean((ratio - 1) - torch.log(ratio))
        loss = (pi_loss + cfg.vf_loss_coeff * vf_loss
                - cfg.entropy_coeff * entropy + kl_coeff * approx_kl)
        return loss, {"policy_loss": pi_loss.detach(),
                      "vf_loss": vf_loss.detach(),
                      "entropy": entropy.detach(),
                      "kl": approx_kl.detach()}
    return loss_fn


class PPO(Algorithm):
    def __init__(self, config: PPOConfig):
        super().__init__(config)
        cfg = config
        learner = Learner(self.params, loss_fn=ppo_loss(self.module, cfg),
                          tx=adam(cfg.lr, cfg.grad_clip))
        mesh = None
        if cfg.use_mesh and dist.is_available() and dist.is_initialized():
            from ..parallel.mesh import MeshSpec, build_mesh  # noqa: PLC0415
            mesh = build_mesh(MeshSpec(dp=dist.get_world_size()),
                              device=self.device.type)
        self.learner_group = LearnerGroup(learner, mesh=mesh)
        self.kl_coeff = cfg.kl_coeff

    def training_step(self, batch: SampleBatch) -> Dict[str, Any]:
        cfg: PPOConfig = self.config
        stats: Dict[str, float] = {}
        kls = []
        for epoch in range(cfg.num_epochs):
            shuffled = batch.shuffle(seed=cfg.seed + self.iteration * 131
                                     + epoch)
            for mb in shuffled.minibatches(min(cfg.minibatch_size,
                                               batch.count)):
                stats = self.learner_group.update(mb.as_numpy(),
                                                  self.kl_coeff)
                kls.append(stats["kl"])
        # adaptive KL coefficient (reference: ppo.py update_kl)
        mean_kl = float(np.mean(kls)) if kls else 0.0
        if mean_kl > 2.0 * cfg.kl_target:
            self.kl_coeff = min(self.kl_coeff * 1.5, 100.0)
        elif mean_kl < 0.5 * cfg.kl_target:
            self.kl_coeff = max(self.kl_coeff * 0.5, 1e-8)
        stats["kl_coeff"] = self.kl_coeff
        stats["mean_kl"] = mean_kl
        return stats

    def _save_extra(self):
        return {"kl_coeff": self.kl_coeff,
                "opt_state": self.learner_group.learner.opt_state
                .state_dict()}

    def _restore_extra(self, extra):
        if extra:
            self.kl_coeff = extra["kl_coeff"]
            self.learner_group.learner.opt_state.load_state_dict(
                extra["opt_state"])
