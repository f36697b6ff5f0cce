"""DQN: replay buffer + double-Q target, TD update (counterpart of
ray_tpu/rllib/dqn.py).

Reference counterpart: rllib/algorithms/dqn/. EnvRunner fragments feed a
ReplayBuffer; updates sample uniformly; the target net is a copy of the
Q net refreshed every `target_update_freq` gradient steps.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.func import functional_call

from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .learner import adam, to_tensors
from .replay import ReplayBuffer
from .rl_module import tree_clone, tree_copy_, tree_to_cpu
from .sample_batch import SampleBatch


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.buffer_size = 50_000
        self.learning_starts = 1000
        self.target_update_freq = 500     # in gradient steps
        self.train_batch_size = 64
        self.num_gradient_steps = 32      # per training iteration
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_timesteps = 10_000
        self.double_q = True
        self.lr = 1e-3
        self.algo_class = DQN


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        if config.num_env_runners > 0:
            raise ValueError("DQN collects via its local epsilon-greedy "
                             "runner; num_env_runners>0 is not supported")
        super().__init__(config)
        if not self.module.is_discrete:
            raise ValueError("DQN needs a discrete action space")
        cfg = config
        # re-use the pi tower as the Q net: dist_in are Q-values (the
        # same tensors as params["pi"], trained in place)
        self.q_params = self.params["pi"]
        self.target_params = tree_clone(self.q_params)
        self.opt_state = adam(cfg.lr)(list(self.q_params.items()))
        self._grad_steps = 0
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)

    def _q(self, qp, obs) -> torch.Tensor:
        return functional_call(self.module.pi_net, qp, (obs,))

    def td_update(self, batch: Dict[str, Any]) -> float:
        """One TD step on a replay minibatch; returns the loss."""
        cfg: DQNConfig = self.config
        b = to_tensors(batch, self.device)
        with torch.no_grad():
            q_next_t = self._q(self.target_params, b[sb.NEXT_OBS])
            if cfg.double_q:
                a_star = torch.argmax(self._q(self.q_params,
                                              b[sb.NEXT_OBS]), dim=-1)
                q_next = q_next_t.gather(-1, a_star[:, None]).squeeze(-1)
            else:
                q_next = q_next_t.max(dim=-1).values
            nonterminal = 1.0 - b[sb.TERMINATEDS].float()
            target = b[sb.REWARDS] + cfg.gamma * nonterminal * q_next
        for p in self.q_params.values():
            p.grad = None
        q = self._q(self.q_params, b[sb.OBS])
        qa = q.gather(-1, b[sb.ACTIONS][:, None].long()).squeeze(-1)
        loss = torch.mean((qa - target) ** 2)
        loss.backward()
        self.opt_state.step()
        for p in self.q_params.values():
            p.grad = None
        return float(loss.detach())

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(1.0, self._timesteps_total
                   / max(1, cfg.epsilon_decay_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    @torch.no_grad()
    def _q_values(self, obs) -> np.ndarray:
        return self._q(self.q_params, self.module.obs(obs)).cpu().numpy()

    def _collect(self):
        """Epsilon-greedy rollout via the local runner's vec env."""
        cfg: DQNConfig = self.config
        runner = self.local_runner
        vec = runner.vec
        T, B = cfg.rollout_fragment_length, vec.num_envs
        cols = {k: [] for k in (sb.OBS, sb.ACTIONS, sb.REWARDS,
                                sb.TERMINATEDS, sb.NEXT_OBS)}
        obs = runner._obs
        eps = self._epsilon()
        for _ in range(T):
            q = self._q_values(obs)
            greedy = q.argmax(axis=-1)
            rand = self._rng.integers(0, q.shape[-1], size=B)
            explore = self._rng.random(B) < eps
            actions = np.where(explore, rand, greedy).astype(np.int32)
            nxt, r, tm, tr, infos = vec.step(actions)
            runner._ep_ret += r
            runner._ep_len += 1
            # store the TRUE next obs (not the auto-reset obs); truncation
            # keeps terminateds=0 so the target bootstraps through it.
            nxt_true = nxt.copy()
            for i in np.nonzero(tm | tr)[0]:
                nxt_true[i] = infos[i]["final_obs"]
                runner.completed_returns.append(float(runner._ep_ret[i]))
                runner.completed_lengths.append(int(runner._ep_len[i]))
                runner._ep_ret[i] = 0.0
                runner._ep_len[i] = 0
            cols[sb.OBS].append(obs.copy())
            cols[sb.ACTIONS].append(actions)
            cols[sb.REWARDS].append(r)
            cols[sb.TERMINATEDS].append(tm)
            cols[sb.NEXT_OBS].append(nxt_true)
            obs = nxt
        runner._obs = obs
        flat = {k: np.concatenate(v) for k, v in cols.items()}
        return SampleBatch(flat), runner.pop_episode_stats()

    def training_step(self, batch: SampleBatch) -> Dict[str, Any]:
        cfg: DQNConfig = self.config
        self.buffer.add(batch)
        if len(self.buffer) < cfg.learning_starts:
            return {"td_loss": None, "buffer_size": len(self.buffer),
                    "epsilon": self._epsilon()}
        losses = []
        for _ in range(cfg.num_gradient_steps):
            losses.append(self.td_update(
                self.buffer.sample(cfg.train_batch_size).as_numpy()))
            self._grad_steps += 1
            if self._grad_steps % cfg.target_update_freq == 0:
                tree_copy_(self.target_params, self.q_params)
        # params["pi"] are the Q net's tensors, so evaluation (which
        # reads self.params) sees the trained Q net
        return {"td_loss": float(np.mean(losses)),
                "buffer_size": len(self.buffer),
                "epsilon": self._epsilon()}

    def compute_single_action(self, obs, *, explore: bool = False):
        q = self._q_values(np.asarray(obs, np.float32)[None])[0]
        if explore and self._rng.random() < self._epsilon():
            return int(self._rng.integers(0, len(q)))
        return int(q.argmax())

    # evaluate() is inherited: Categorical.mode() == argmax Q — the
    # greedy policy.

    def _save_extra(self):
        return {"target_params": tree_to_cpu(self.target_params),
                "opt_state": self.opt_state.state_dict(),
                "grad_steps": self._grad_steps}

    def _restore_extra(self, extra):
        if extra:
            tree_copy_(self.target_params, extra["target_params"])
            self.opt_state.load_state_dict(extra["opt_state"])
            self._grad_steps = extra["grad_steps"]
