"""Algorithm / AlgorithmConfig: the config-driven RL training loop
(counterpart of ray_tpu/rllib/algorithm.py).

Reference counterpart: rllib/algorithms/algorithm.py +
algorithm_config.py. Fluent config (.environment().env_runners()
.training().evaluation()) -> .build() -> Algorithm with .train()
iterations, .save()/.restore(), periodic deterministic evaluation.

Rollouts run on the local EnvRunner, or with `num_env_runners > 0` on
that many EnvRunner actors of the runtime; the learner update runs on
the config's device (`.resources(device=...)`, CUDA unless the caller
asks for the CPU). A remote runner reserves no GPU and builds its
policy on the CPU; it gets the learner's params as CPU tensors.
"""
from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .env_runner import EnvRunner
from .rl_module import tree_copy_, tree_to_cpu
from .sample_batch import SampleBatch, concat_samples

STATE_NAME = "algorithm_state.pt"


class AlgorithmConfig:
    """Fluent builder. Subclasses add their hyperparameters in
    .training(**kwargs)."""

    algo_class: Optional[type] = None

    def __init__(self):
        self.env = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 4
        self.rollout_fragment_length = 128
        self.seed = 0
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_batch_size = 512
        self.model: Dict[str, Any] = {"hidden": (64, 64),
                                      "activation": "tanh"}
        self.evaluation_interval: Optional[int] = None
        self.evaluation_num_episodes = 5
        self.device = "cuda"

    # -- fluent sections (mirror reference names) --
    def environment(self, env=None, *, env_config=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training param {k!r}")
            setattr(self, k, v)
        return self

    def rl_module(self, *, model=None) -> "AlgorithmConfig":
        if model is not None:
            self.model.update(model)
        return self

    def evaluation(self, *, evaluation_interval=None,
                   evaluation_num_episodes=None) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_episodes is not None:
            self.evaluation_num_episodes = evaluation_num_episodes
        return self

    def debugging(self, *, seed=None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def resources(self, *, device=None) -> "AlgorithmConfig":
        """The port's: the device of the policy and the learner."""
        if device is not None:
            self.device = device
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use a subclass "
                             "like PPOConfig")
        return self.algo_class(self)


def _make_runner(cfg: AlgorithmConfig, seed_offset: int) -> EnvRunner:
    return EnvRunner(
        cfg.env, num_envs=cfg.num_envs_per_env_runner,
        rollout_length=cfg.rollout_fragment_length,
        seed=cfg.seed + seed_offset, env_config=cfg.env_config,
        hidden=tuple(cfg.model["hidden"]),
        activation=cfg.model["activation"], gamma=cfg.gamma,
        lam=getattr(cfg, "lambda_", 0.95), device=cfg.device)


class _RemoteRunner:
    """Actor wrapper so EnvRunner runs over the core runtime
    (reference: RolloutWorker as a ray actor). The actor holds no GPU
    (its process sees none), so its policy runs on the CPU whatever the
    learner's device."""

    def __init__(self, cfg_bytes: bytes, seed_offset: int):
        cfg = pickle.loads(cfg_bytes)
        cfg.device = "cpu"
        self.runner = _make_runner(cfg, seed_offset)

    def sample(self, params):
        batch = self.runner.sample(params)
        return batch.as_numpy(), self.runner.pop_episode_stats()


class Algorithm:
    """Base training loop. Subclasses implement training_step(batch)."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        if config.env is None:
            raise ValueError("config.environment(env=...) is required")
        # local runner always exists: module spec source + evaluation
        self.local_runner = _make_runner(config, 0)
        self.module = self.local_runner.module
        self.device = self.module.device
        self.params = self.module.init(config.seed)
        self._remote_runners: List[Any] = []
        if config.num_env_runners > 0:
            import ray_tpu_torch
            if not ray_tpu_torch.is_initialized():
                raise RuntimeError(
                    "num_env_runners>0 needs ray_tpu_torch.init() first")
            RemoteCls = ray_tpu_torch.remote(_RemoteRunner)
            blob = pickle.dumps(config)
            self._remote_runners = [RemoteCls.remote(blob, i + 1)
                                    for i in range(config.num_env_runners)]
        self.iteration = 0
        self._timesteps_total = 0

    # -- rollout collection --
    def _collect(self) -> (SampleBatch, Dict[str, Any]):
        if self._remote_runners:
            import ray_tpu_torch
            host_params = tree_to_cpu(self.params)
            outs = ray_tpu_torch.get([r.sample.remote(host_params)
                                      for r in self._remote_runners])
            batches = [SampleBatch(b) for b, _ in outs]
            stats_list = [s for _, s in outs]
            rets = [s["episode_return_mean"] for s in stats_list
                    if s["episode_return_mean"] is not None]
            lens = [s["episode_len_mean"] for s in stats_list
                    if s["episode_len_mean"] is not None]
            stats = {
                "episodes_this_iter": sum(s["episodes_this_iter"]
                                          for s in stats_list),
                "episode_return_mean": float(np.mean(rets)) if rets
                else None,
                "episode_len_mean": float(np.mean(lens)) if lens else None,
            }
            return concat_samples(batches), stats
        batch = self.local_runner.sample(self.params)
        return batch, self.local_runner.pop_episode_stats()

    def training_step(self, batch: SampleBatch) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        """One iteration: collect -> update -> (maybe) evaluate."""
        t0 = time.monotonic()
        batch, ep_stats = self._collect()
        learner_stats = self.training_step(batch)
        self.iteration += 1
        self._timesteps_total += batch.count
        result = {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": time.monotonic() - t0,
            **ep_stats,
            "learner": learner_stats,
        }
        ei = self.config.evaluation_interval
        if ei and self.iteration % ei == 0:
            # through self.evaluate() so algorithms with their own
            # policy nets (SAC's squashed actor) evaluate correctly
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self) -> Dict[str, float]:
        return self.local_runner.evaluate(
            self.params, num_episodes=self.config.evaluation_num_episodes)

    def compute_single_action(self, obs, *, explore: bool = False):
        obs = self.module.obs(np.asarray(obs, np.float32)[None])
        if explore:
            a, _, _ = self.module.explore_action(self.params, obs,
                                                 self.local_runner._gen)
        else:
            a = self.module.deterministic_action(self.params, obs)
        a = a[0].cpu().numpy()
        return int(a) if self.module.is_discrete else a

    # -- checkpointing (reference: Algorithm.save/restore) --
    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        state = {"params": tree_to_cpu(self.params),
                 "iteration": self.iteration,
                 "timesteps_total": self._timesteps_total,
                 "extra": self._save_extra()}
        torch.save(state, os.path.join(path, STATE_NAME))
        return path

    def restore(self, path: str) -> None:
        """Load a saved state into this algorithm's tensors in place (its
        optimizers keep their references)."""
        state = torch.load(os.path.join(path, STATE_NAME),
                           map_location=self.device, weights_only=True)
        tree_copy_(self.params, state["params"])
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self._restore_extra(state.get("extra"))

    def _save_extra(self):
        return None

    def _restore_extra(self, extra):
        pass

    def stop(self):
        for r in self._remote_runners:
            try:
                import ray_tpu_torch
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._remote_runners = []
