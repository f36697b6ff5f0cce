"""Soft Actor-Critic: off-policy continuous control (counterpart of
ray_tpu/rllib/sac.py).

Reference counterpart: rllib/algorithms/sac/ (twin soft-Q critics, a
tanh-squashed Gaussian actor, a learned entropy temperature against a
target entropy, polyak target updates). One update advances the
critics, then the actor (against the updated critics), then alpha, each
with its own adam, then the polyak targets, as the reference's jitted
step does. The Gaussian noise of a step comes from the algorithm's
generator, or is passed in (`update(batch, noise=...)`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..models.mlp import MLP, MLPConfig
from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .learner import adam, to_tensors
from .replay import ReplayBuffer
from .rl_module import _mlp_params, tree_clone, tree_copy_, tree_to_cpu
from .sample_batch import SampleBatch

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.buffer_size = 100_000
        self.learning_starts = 1500
        self.train_batch_size = 256
        self.num_gradient_steps = 32      # per training iteration
        self.tau = 0.005                  # polyak target coefficient
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.initial_alpha = 0.1
        self.target_entropy: Any = "auto"  # "auto" = -act_dim
        self.algo_class = SAC


class SAC(Algorithm):
    def __init__(self, config: SACConfig):
        if config.num_env_runners > 0:
            raise ValueError("SAC collects via its local runner; "
                             "num_env_runners>0 is not supported")
        super().__init__(config)
        if self.module.is_discrete:
            raise ValueError("SAC needs a continuous (Box) action space")
        cfg = config
        dev = self.device
        space = self.local_runner.vec.envs[0].action_space
        self.act_dim = int(np.prod(space.shape))
        # per-dimension affine map from tanh's [-1, 1] to [low, high]
        high = np.broadcast_to(np.asarray(space.high, np.float32),
                               space.shape).reshape(-1)
        low = np.broadcast_to(np.asarray(space.low, np.float32),
                              space.shape).reshape(-1)
        if not (np.all(np.isfinite(high)) and np.all(np.isfinite(low))):
            raise ValueError(
                f"SAC needs finite Box bounds; got low={space.low} "
                f"high={space.high}")
        if np.any(high <= low):
            # a zero-width dim would make the log|scale| Jacobian term
            # -inf and NaN every update — reject loudly instead
            raise ValueError(
                f"SAC needs high > low on every action dim; got "
                f"low={space.low} high={space.high}")
        self.act_scale = (high - low) / 2.0     # (act_dim,)
        self.act_offset = (high + low) / 2.0    # (act_dim,)
        self._scale = torch.as_tensor(self.act_scale, device=dev)
        self._offset = torch.as_tensor(self.act_offset, device=dev)
        obs_dim = self.module.spec.obs_dim
        hidden = tuple(cfg.model["hidden"])
        act = cfg.model["activation"]

        # actor outputs (mean, log_std) per action dim; critics score
        # concat(obs, action)
        pi_cfg = MLPConfig(hidden=hidden, out_dim=2 * self.act_dim,
                           activation=act)
        q_cfg = MLPConfig(hidden=hidden, out_dim=1, activation=act)
        self.pi_net = MLP(pi_cfg, obs_dim, device=dev, seed=cfg.seed)
        self.q_net = MLP(q_cfg, obs_dim + self.act_dim, device=dev,
                         seed=cfg.seed + 1)
        self.pi_params = _mlp_params(self.pi_net)
        self.q_params = (
            _mlp_params(self.q_net),
            _mlp_params(MLP(q_cfg, obs_dim + self.act_dim, device=dev,
                            seed=cfg.seed + 2)))
        self.target_q_params = tree_clone(self.q_params)
        self.log_alpha = torch.tensor(math.log(cfg.initial_alpha),
                                      dtype=torch.float32, device=dev,
                                      requires_grad=True)
        self.target_entropy = (-float(self.act_dim)
                               if cfg.target_entropy == "auto"
                               else float(cfg.target_entropy))
        self.pi_opt = adam(cfg.actor_lr)(list(self.pi_params.items()))
        self.q_opt = adam(cfg.critic_lr)(
            [(f"q{i}/{k}", v) for i, q in enumerate(self.q_params)
             for k, v in q.items()])
        self.a_opt = adam(cfg.alpha_lr)([("log_alpha", self.log_alpha)])
        self._gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self._np_rng = np.random.default_rng(cfg.seed + 1)

    def _noise(self, n: int) -> torch.Tensor:
        return torch.randn((n, self.act_dim), generator=self._gen,
                           device=self.device)

    def squashed(self, pi_params, obs, eps) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """tanh-squashed Gaussian action from noise `eps`, with its
        log-prob in the ENV action space (the affine a * scale + offset
        Jacobian is part of the change of variables)."""
        out = functional_call(self.pi_net, pi_params, (obs,))
        mean, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        std = torch.exp(log_std)
        pre = mean + std * eps
        a = torch.tanh(pre)
        # Gaussian logp minus tanh + affine change-of-variables
        logp = (-0.5 * (((pre - mean) / std) ** 2
                        + 2 * log_std + math.log(2 * math.pi))
                - torch.log(1.0 - a ** 2 + 1e-6)).sum(-1) \
            - torch.log(self._scale).sum()
        return a * self._scale + self._offset, logp

    def _q_val(self, qp, obs, act) -> torch.Tensor:
        x = torch.cat([obs, act], dim=-1)
        return functional_call(self.q_net, qp, (x,)).squeeze(-1)

    @staticmethod
    def _step(opt, params) -> None:
        opt.step()
        for p in params:
            p.grad = None

    def update(self, batch: Dict[str, Any],
               noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Dict[str, float]:
        """One SAC update on a replay minibatch. `noise` = (eps for the
        next actions, eps for the actor's actions), each (B, act_dim);
        drawn from the generator when None."""
        cfg: SACConfig = self.config
        b = to_tensors(batch, self.device)
        obs, acts, nxt = b[sb.OBS], b[sb.ACTIONS], b[sb.NEXT_OBS]
        n = obs.shape[0]
        eps1, eps2 = noise if noise is not None else (self._noise(n),
                                                      self._noise(n))
        alpha = self.log_alpha.detach().exp()
        nonterminal = 1.0 - b[sb.TERMINATEDS].float()
        tq1, tq2 = self.target_q_params
        with torch.no_grad():
            a2, logp2 = self.squashed(self.pi_params, nxt, eps1)
            tq = torch.minimum(self._q_val(tq1, nxt, a2),
                               self._q_val(tq2, nxt, a2))
            y = b[sb.REWARDS] + cfg.gamma * nonterminal * (tq - alpha * logp2)

        q1, q2 = self.q_params
        q_loss = (torch.mean((self._q_val(q1, obs, acts) - y) ** 2)
                  + torch.mean((self._q_val(q2, obs, acts) - y) ** 2))
        q_loss.backward()
        self._step(self.q_opt, [*q1.values(), *q2.values()])

        a, logp = self.squashed(self.pi_params, obs, eps2)
        qmin = torch.minimum(self._q_val(q1, obs, a),
                             self._q_val(q2, obs, a))
        pi_loss = torch.mean(alpha * logp - qmin)
        pi_loss.backward()
        for p in (*q1.values(), *q2.values()):
            p.grad = None          # the actor's loss trains the actor only
        self._step(self.pi_opt, self.pi_params.values())

        a_loss = -torch.mean(self.log_alpha
                             * (logp.detach() + self.target_entropy))
        a_loss.backward()
        self._step(self.a_opt, [self.log_alpha])

        with torch.no_grad():
            for t, q in zip(self.target_q_params, self.q_params):
                for k in t:
                    t[k].mul_(1.0 - cfg.tau).add_(q[k], alpha=cfg.tau)
        return {"q_loss": float(q_loss.detach()),
                "pi_loss": float(pi_loss.detach()), "alpha": float(alpha),
                "entropy": float(-logp.detach().mean())}

    # -- rollouts: squashed-Gaussian exploration on the vec env --
    def _collect(self):
        cfg: SACConfig = self.config
        runner = self.local_runner
        vec = runner.vec
        T = cfg.rollout_fragment_length
        cols = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS,
                                sb.TERMINATEDS, sb.NEXT_OBS)}
        obs = runner._obs
        for _ in range(T):
            if self._timesteps_total < cfg.learning_starts:
                # uniform warmup like the reference's initial random
                # exploration
                acts = self._np_rng.uniform(
                    self.act_offset - self.act_scale,
                    self.act_offset + self.act_scale,
                    size=(vec.num_envs, self.act_dim)).astype(np.float32)
            else:
                with torch.no_grad():
                    a, _ = self.squashed(self.pi_params,
                                         self.module.obs(obs),
                                         self._noise(vec.num_envs))
                acts = a.cpu().numpy().astype(np.float32)
            nxt, r, tm, tr, infos = vec.step(acts)
            runner._ep_ret += r
            runner._ep_len += 1
            nxt_true = nxt.copy()
            for i in np.nonzero(tm | tr)[0]:
                nxt_true[i] = infos[i]["final_obs"]
                runner.completed_returns.append(float(runner._ep_ret[i]))
                runner.completed_lengths.append(int(runner._ep_len[i]))
                runner._ep_ret[i] = 0.0
                runner._ep_len[i] = 0
            cols[sb.OBS].append(obs.copy())
            cols[sb.ACTIONS].append(acts)
            cols[sb.REWARDS].append(r.astype(np.float32))
            cols[sb.TERMINATEDS].append(tm)
            cols[sb.NEXT_OBS].append(nxt_true)
            obs = nxt
        runner._obs = obs
        flat = {k: np.concatenate(v) for k, v in cols.items()}
        return SampleBatch(flat), runner.pop_episode_stats()

    def training_step(self, batch: SampleBatch) -> Dict[str, Any]:
        cfg: SACConfig = self.config
        if not hasattr(self, "buffer"):
            self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self.buffer.add(batch)
        if len(self.buffer) < cfg.learning_starts:
            return {"q_loss": None, "buffer_size": len(self.buffer)}
        stats = {}
        for _ in range(cfg.num_gradient_steps):
            stats = self.update(
                self.buffer.sample(cfg.train_batch_size).as_numpy())
        return {**stats, "buffer_size": len(self.buffer)}

    # -- evaluation with the squashed deterministic policy --
    @torch.no_grad()
    def compute_single_action(self, obs, *, explore: bool = False):
        obs = self.module.obs(np.asarray(obs, np.float32)[None])
        if explore:
            a, _ = self.squashed(self.pi_params, obs, self._noise(1))
        else:
            out = functional_call(self.pi_net, self.pi_params, (obs,))
            a = torch.tanh(torch.chunk(out, 2, dim=-1)[0]) * self._scale \
                + self._offset
        return a[0].cpu().numpy()

    def evaluate(self) -> Dict[str, float]:
        from .env import make_env  # noqa: PLC0415
        if not hasattr(self, "_eval_env"):
            self._eval_env = make_env(self.config.env,
                                      **self.config.env_config)
        env = self._eval_env
        rets = []
        for ep in range(self.config.evaluation_num_episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            done, total = False, 0.0
            while not done:
                a = self.compute_single_action(obs)
                obs, r, tm, tr, _ = env.step(a)
                total += r
                done = tm or tr
            rets.append(total)
        return {"episode_return_mean": float(np.mean(rets)),
                "episodes": len(rets)}

    _STATE = ("pi_params", "q_params", "target_q_params", "log_alpha")
    _OPTS = ("pi_opt", "q_opt", "a_opt")

    def _save_extra(self):
        out = {k: tree_to_cpu(getattr(self, k)) for k in self._STATE}
        out.update({k: getattr(self, k).state_dict() for k in self._OPTS})
        return out

    def _restore_extra(self, extra):
        if extra:
            for k in self._STATE:
                tree_copy_(getattr(self, k), extra[k])
            for k in self._OPTS:
                getattr(self, k).load_state_dict(extra[k])
