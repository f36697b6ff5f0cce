"""EnvRunner: vectorized rollout collection (counterpart of
ray_tpu/rllib/env_runner.py).

Reference counterpart: rllib/env/env_runner.py + rllib/evaluation/
rollout_worker.py. Runners step numpy envs on the host and sample
actions through the policy on the runner's device, from a generator
seeded `seed`. A runner runs in-process, or as an actor of the port's
runtime on its CPU when the algorithm asks for `num_env_runners > 0`
(algorithm.py), as the reference's remote runners do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..util.device import DeviceLike
from . import sample_batch as sb
from .env import VectorEnv, make_env
from .rl_module import RLModule, spec_for_env
from .sample_batch import SampleBatch, compute_gae


class EnvRunner:
    """Collects fixed-length [T, B] rollout fragments with auto-reset."""

    def __init__(self, env_spec, *, num_envs: int = 1,
                 rollout_length: int = 128, seed: int = 0,
                 env_config: Optional[Dict[str, Any]] = None,
                 hidden=(64, 64), activation: str = "tanh",
                 gamma: float = 0.99, lam: float = 0.95,
                 device: DeviceLike = "cuda"):
        env_config = env_config or {}
        self._env_spec, self._env_config = env_spec, env_config
        self._eval_env = None      # built lazily; never shared with vec
        self.vec = VectorEnv(
            [lambda: make_env(env_spec, **env_config)
             for _ in range(num_envs)])
        self.module = RLModule(spec_for_env(self.vec.envs[0],
                                            hidden=hidden,
                                            activation=activation),
                               device=device)
        self.device = self.module.device
        self.rollout_length = rollout_length
        self.gamma, self.lam = gamma, lam
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._obs, _ = self.vec.reset(seed=seed)
        # episode-return bookkeeping (per sub-env)
        self._ep_ret = np.zeros(self.vec.num_envs, np.float64)
        self._ep_len = np.zeros(self.vec.num_envs, np.int64)
        self.completed_returns: List[float] = []
        self.completed_lengths: List[int] = []

    @torch.no_grad()
    def _value_only(self, params, obs) -> np.ndarray:
        return self.module.forward(params, self.module.obs(obs))[1] \
            .cpu().numpy()

    def sample(self, params) -> SampleBatch:
        """Roll T steps; returns a flat [T*B] batch with GAE columns."""
        T, B = self.rollout_length, self.vec.num_envs
        obs_buf = np.zeros((T, B) + self._obs.shape[1:], np.float32)
        act_shape = () if self.module.is_discrete else (self.module.pi_out,)
        acts = np.zeros((T, B) + act_shape,
                        np.int32 if self.module.is_discrete else np.float32)
        rews = np.zeros((T, B), np.float32)
        terms = np.zeros((T, B), bool)
        vals = np.zeros((T, B), np.float32)
        logps = np.zeros((T, B), np.float32)

        for t in range(T):
            a, lp, v = self.module.explore_action(
                params, self.module.obs(self._obs), self._gen)
            a_np = a.cpu().numpy()
            obs_buf[t] = self._obs
            acts[t], logps[t], vals[t] = a_np, lp.cpu().numpy(), \
                v.cpu().numpy()
            nxt, r, tm, tr, infos = self.vec.step(a_np)
            self._ep_ret += r
            self._ep_len += 1
            # Truncation ends the GAE recursion like a termination, but the
            # episode continues value-wise: fold gamma*V(final_obs) into the
            # reward (the auto-reset obs in `nxt` must NOT leak into GAE).
            trunc_only = tr & ~tm
            if trunc_only.any():
                fobs = nxt.copy()
                for i in np.nonzero(trunc_only)[0]:
                    fobs[i] = infos[i]["final_obs"]
                fv = self._value_only(params, fobs)
                r = r + self.gamma * fv * trunc_only
            rews[t], terms[t] = r, tm | tr
            done = tm | tr
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_ret[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
            self._obs = nxt

        last_val = self._value_only(params, self._obs)
        adv, ret = compute_gae(rews, vals, terms, last_val,
                               gamma=self.gamma, lam=self.lam)
        flat = lambda x: x.reshape((T * B,) + x.shape[2:])  # noqa: E731
        return SampleBatch({
            sb.OBS: flat(obs_buf), sb.ACTIONS: flat(acts),
            sb.REWARDS: flat(rews), sb.TERMINATEDS: flat(terms),
            sb.VALUES: flat(vals), sb.LOGPS: flat(logps),
            sb.ADVANTAGES: flat(adv), sb.RETURNS: flat(ret),
        })

    def pop_episode_stats(self) -> Dict[str, Any]:
        rets, lens = self.completed_returns, self.completed_lengths
        self.completed_returns, self.completed_lengths = [], []
        return {
            "episodes_this_iter": len(rets),
            "episode_return_mean": float(np.mean(rets)) if rets else None,
            "episode_len_mean": float(np.mean(lens)) if lens else None,
        }

    def evaluate(self, params, *, num_episodes: int = 5,
                 max_steps: int = 1000) -> Dict[str, float]:
        """Deterministic-policy eval rollouts (reference: evaluation
        workers, rllib/evaluation/)."""
        returns = []
        if self._eval_env is None:
            self._eval_env = make_env(self._env_spec, **self._env_config)
        env = self._eval_env
        for _ in range(num_episodes):
            obs, _ = env.reset()
            total, steps = 0.0, 0
            while steps < max_steps:
                a = self.module.deterministic_action(
                    params, self.module.obs(obs[None]))[0].cpu().numpy()
                obs, r, tm, tr, _ = env.step(a)
                total += r
                steps += 1
                if tm or tr:
                    break
            returns.append(total)
        return {"evaluation_return_mean": float(np.mean(returns)),
                "evaluation_episodes": num_episodes}
