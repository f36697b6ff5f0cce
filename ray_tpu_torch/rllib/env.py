"""Builtin lightweight RL environments (no gym dependency); a copy of
ray_tpu/rllib/env.py, which imports no JAX.

Reference counterpart: rllib/env/ + the gym envs its examples lean on
(rllib/examples/envs/). We ship in-repo numpy envs with the gymnasium
step API — reset() -> (obs, info); step(a) -> (obs, reward, terminated,
truncated, info) — plus a vectorized wrapper and an optional gymnasium
adapter when that package is importable.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Space:
    """Minimal space descriptor (reference: gym.spaces)."""

    def __init__(self, kind: str, *, n: int = 0, shape: Tuple[int, ...] = (),
                 low: float = -np.inf, high: float = np.inf):
        self.kind = kind          # "discrete" | "box"
        self.n = n
        self.shape = shape
        self.low = low
        self.high = high

    @staticmethod
    def discrete(n: int) -> "Space":
        return Space("discrete", n=n, shape=())

    @staticmethod
    def box(shape: Tuple[int, ...], low: float = -np.inf,
            high: float = np.inf) -> "Space":
        return Space("box", shape=shape, low=low, high=high)

    def sample(self, rng: np.random.Generator):
        if self.kind == "discrete":
            return int(rng.integers(self.n))
        lo = self.low if np.isfinite(self.low) else -1.0
        hi = self.high if np.isfinite(self.high) else 1.0
        return rng.uniform(lo, hi, size=self.shape).astype(np.float32)

    def __repr__(self):
        if self.kind == "discrete":
            return f"Discrete({self.n})"
        return f"Box{self.shape}"


class Env:
    """Base env. Subclasses set observation_space / action_space."""

    observation_space: Space
    action_space: Space

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool,
                                    Dict[str, Any]]:
        raise NotImplementedError

    def close(self):
        pass


class CartPole(Env):
    """Classic cart-pole balance (dynamics per Barto-Sutton-Anderson).

    Matches gym CartPole-v1: 4-dim obs, 2 actions, +1 reward per step,
    500-step horizon, terminate on |x|>2.4 or |theta|>12deg.
    """

    observation_space = Space.box((4,), -4.8, 4.8)
    action_space = Space.discrete(2)
    max_steps = 500

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float32)
        self._t = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self._t = 0
        return self._state.copy(), {}

    def step(self, action):
        x, x_dot, th, th_dot = self._state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(th), np.sin(th)
        masspole, masscart, length = 0.1, 1.0, 0.5
        total_mass = masspole + masscart
        pml = masspole * length
        temp = (force + pml * th_dot**2 * sinth) / total_mass
        th_acc = (9.8 * sinth - costh * temp) / (
            length * (4.0 / 3.0 - masspole * costh**2 / total_mass))
        x_acc = temp - pml * th_acc * costh / total_mass
        tau = 0.02
        self._state = np.array(
            [x + tau * x_dot, x_dot + tau * x_acc,
             th + tau * th_dot, th_dot + tau * th_acc], np.float32)
        self._t += 1
        terminated = bool(abs(self._state[0]) > 2.4
                          or abs(self._state[2]) > 0.2095)
        truncated = self._t >= self.max_steps
        return self._state.copy(), 1.0, terminated, truncated, {}


class GridWorld(Env):
    """NxN grid; start top-left, goal bottom-right; -0.01/step, +1 at goal."""

    def __init__(self, n: int = 5, max_steps: int = 100,
                 seed: Optional[int] = None):
        self.n = n
        self.max_steps = max_steps
        self.observation_space = Space.box((2,), 0.0, float(n - 1))
        self.action_space = Space.discrete(4)   # up/down/left/right
        self._pos = np.zeros(2, np.int64)
        self._t = 0

    def reset(self, *, seed: Optional[int] = None):
        self._pos = np.zeros(2, np.int64)
        self._t = 0
        return self._pos.astype(np.float32), {}

    def step(self, action):
        d = {0: (-1, 0), 1: (1, 0), 2: (0, -1), 3: (0, 1)}[int(action)]
        self._pos = np.clip(self._pos + d, 0, self.n - 1)
        self._t += 1
        at_goal = bool((self._pos == self.n - 1).all())
        reward = 1.0 if at_goal else -0.01
        return (self._pos.astype(np.float32), reward, at_goal,
                self._t >= self.max_steps, {})


class Pendulum(Env):
    """Classic torque-limited pendulum swing-up (standard dynamics:
    theta'' = 3g/(2l) sin(theta) + 3/(ml^2) u). Continuous action in
    [-2, 2]; obs (cos, sin, theta_dot); reward
    -(angle^2 + 0.1 theta_dot^2 + 0.001 u^2); 200-step episodes. The
    in-repo continuous-control benchmark for SAC (reference:
    Pendulum-v1 used across rllib/algorithms tuned examples)."""

    observation_space = Space.box((3,), -8.0, 8.0)
    action_space = Space.box((1,), -2.0, 2.0)
    max_steps = 200

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._th = 0.0
        self._thdot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th),
                         self._thdot], np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = float(self._rng.uniform(-np.pi, np.pi))
        self._thdot = float(self._rng.uniform(-1.0, 1.0))
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        g, m, length, dt = 10.0, 1.0, 1.0, 0.05
        th_norm = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm ** 2 + 0.1 * self._thdot ** 2 + 0.001 * u ** 2
        self._thdot += (3 * g / (2 * length) * np.sin(self._th)
                        + 3.0 / (m * length ** 2) * u) * dt
        self._thdot = float(np.clip(self._thdot, -8.0, 8.0))
        self._th += self._thdot * dt
        self._t += 1
        return self._obs(), -float(cost), False, \
            self._t >= self.max_steps, {}


class BanditEnv(Env):
    """K-armed stochastic bandit; 1-step episodes (reference: bandit envs
    in rllib/examples)."""

    def __init__(self, k: int = 10, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self.means = self._rng.normal(0.0, 1.0, size=k)
        self.observation_space = Space.box((1,), 0.0, 1.0)
        self.action_space = Space.discrete(k)

    def reset(self, *, seed: Optional[int] = None):
        return np.zeros(1, np.float32), {}

    def step(self, action):
        r = float(self._rng.normal(self.means[int(action)], 1.0))
        return np.zeros(1, np.float32), r, True, False, {}


class VectorEnv:
    """N independent env copies stepped in lockstep with auto-reset.

    Reference: rllib/env/vector_env.py. Auto-reset on episode end so the
    batch dimension never shrinks — matches what a batched policy step wants.
    """

    def __init__(self, env_fns: List[Any]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, *, seed: Optional[int] = None):
        obs = []
        for i, e in enumerate(self.envs):
            o, _ = e.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        return np.stack(obs), [{} for _ in self.envs]

    def step(self, actions):
        """On episode end the returned obs is the auto-reset obs; the true
        terminal observation is preserved in infos[i]['final_obs'] so
        callers can bootstrap truncations correctly."""
        obs, rews, terms, truncs = [], [], [], []
        infos = [{} for _ in range(self.num_envs)]
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            o, r, tm, tr, _ = e.step(a)
            if tm or tr:
                infos[i]["final_obs"] = o
                o, _ = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(tm)
            truncs.append(tr)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(terms), np.asarray(truncs), infos)


_REGISTRY = {
    "CartPole-v1": CartPole,
    "CartPole": CartPole,
    "GridWorld": GridWorld,
    "Bandit": BanditEnv,
    "Pendulum-v1": Pendulum,
    "Pendulum": Pendulum,
}


def register_env(name: str, ctor) -> None:
    """Reference: ray.tune.registry.register_env."""
    _REGISTRY[name] = ctor


def make_env(spec, **kwargs) -> Env:
    """Build an env from a name, class, or callable; falls back to a
    gymnasium adapter for unknown string names if gymnasium is present."""
    if callable(spec) and not isinstance(spec, str):
        return spec(**kwargs)
    if spec in _REGISTRY:
        return _REGISTRY[spec](**kwargs)
    try:                                    # optional gymnasium adapter
        import gymnasium
    except ImportError:
        raise ValueError(f"unknown env {spec!r}; known: {list(_REGISTRY)} "
                         "(gymnasium not importable for external names)")
    return _GymAdapter(gymnasium.make(spec, **kwargs))


class _GymAdapter(Env):
    def __init__(self, gym_env):
        self._env = gym_env
        osp, asp = gym_env.observation_space, gym_env.action_space
        if hasattr(asp, "n"):
            self.action_space = Space.discrete(int(asp.n))
        else:
            self.action_space = Space.box(tuple(asp.shape))
        self.observation_space = Space.box(tuple(osp.shape))

    def reset(self, *, seed=None):
        return self._env.reset(seed=seed)

    def step(self, action):
        return self._env.step(action)

    def close(self):
        self._env.close()
