"""Replay buffers (a copy of ray_tpu/rllib/replay.py, which imports no
JAX).

Reference counterpart: rllib/utils/replay_buffers/ (ReplayBuffer,
EpisodeReplayBuffer). Uniform-sampling ring buffer over columnar numpy
storage; an episode variant stores whole trajectories for algorithms
that need contiguous sequences.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .sample_batch import SampleBatch, concat_samples


class ReplayBuffer:
    """Uniform ring buffer over transition columns (DQN-style)."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if not self._cols:       # lazy alloc from first batch's schema
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        for start in range(0, n, self.capacity):
            chunk = {k: np.asarray(v)[start:start + self.capacity]
                     for k, v in batch.items()}
            m = len(next(iter(chunk.values())))
            idx = (self._next + np.arange(m)) % self.capacity
            for k, v in chunk.items():
                self._cols[k][idx] = v
            self._next = int((self._next + m) % self.capacity)
            self._size = min(self._size + m, self.capacity)

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})


class EpisodeReplayBuffer:
    """Stores whole episodes; samples by episode or as flat transitions."""

    def __init__(self, capacity_episodes: int = 1000, seed: int = 0):
        self.capacity = capacity_episodes
        self._episodes: List[SampleBatch] = []
        self._cumlen: Optional[np.ndarray] = None   # rebuilt when stale
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._episodes)

    def add_episode(self, episode: SampleBatch) -> None:
        self._episodes.append(episode)
        if len(self._episodes) > self.capacity:
            self._episodes.pop(0)
        self._cumlen = None

    def sample_episodes(self, n: int) -> List[SampleBatch]:
        idx = self._rng.integers(0, len(self._episodes), size=n)
        return [self._episodes[i] for i in idx]

    def sample(self, batch_size: int) -> SampleBatch:
        """Uniform over transitions via a cumulative-length index — no
        full flatten per call."""
        if self._cumlen is None:
            self._cumlen = np.cumsum([e.count for e in self._episodes])
        total = int(self._cumlen[-1])
        gidx = np.sort(self._rng.integers(0, total, size=batch_size))
        ep = np.searchsorted(self._cumlen, gidx, side="right")
        local = gidx - np.concatenate([[0], self._cumlen])[ep]
        keys = self._episodes[0].keys()
        out = {k: [] for k in keys}
        for e, l in zip(ep, local):
            row = self._episodes[e]
            for k in keys:
                out[k].append(np.asarray(row[k])[l])
        return SampleBatch({k: np.stack(v) for k, v in out.items()})
