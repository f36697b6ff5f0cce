"""ray_tpu_torch.rllib — RL on the port (counterpart of ray_tpu/rllib/).

Reference counterpart: rllib/ (Algorithm, PPO, DQN, SAC, EnvRunner,
RLModule, SampleBatch, replay buffers, the GRPO post-training path).
Rollouts step numpy envs on the host; policies and learner updates run
on the config's device (CUDA unless the caller asks for the CPU). GRPO
samples through the port's serve engine and trains full parameters or
LoRA adapters (train/lora.py).

Not ported: remote env runners (`num_env_runners > 0`, actors of the
runtime; ROADMAP's "rllib's remote env runners") and a LearnerGroup
over several devices (ROADMAP's "LearnerGroup over a mesh"); both
raise.
"""
from .algorithm import Algorithm, AlgorithmConfig
from .dqn import DQN, DQNConfig
from .env import (BanditEnv, CartPole, Env, GridWorld, Pendulum,
                  Space, VectorEnv,
                  make_env, register_env)
from .env_runner import EnvRunner
from .grpo import (EngineSampler, GRPOConfig, GRPOLearner, GRPOTrainer,
                   make_lora_grpo_trainer,
                   group_relative_advantages)
from .learner import Learner, LearnerGroup
from .ppo import PPO, PPOConfig
from .sac import SAC, SACConfig
from .replay import EpisodeReplayBuffer, ReplayBuffer
from .rl_module import (Categorical, DiagGaussian, RLModule, RLModuleSpec,
                        spec_for_env)
from .sample_batch import SampleBatch, compute_gae, concat_samples

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "SAC", "SACConfig",
    "Pendulum", "DQN", "DQNConfig",
    "EngineSampler", "GRPOConfig", "GRPOLearner", "GRPOTrainer",
    "make_lora_grpo_trainer",
    "group_relative_advantages",
    "Env", "Space", "CartPole", "GridWorld", "BanditEnv", "VectorEnv",
    "make_env", "register_env", "EnvRunner", "Learner", "LearnerGroup",
    "ReplayBuffer", "EpisodeReplayBuffer", "RLModule", "RLModuleSpec",
    "spec_for_env", "Categorical", "DiagGaussian", "SampleBatch",
    "concat_samples", "compute_gae",
]
