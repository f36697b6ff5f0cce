"""SampleBatch: columnar rollout storage as a dict of numpy arrays
(a copy of ray_tpu/rllib/sample_batch.py, which imports no JAX).

Reference counterpart: rllib/policy/sample_batch.py (SampleBatch,
concat_samples). A thin dict wrapper whose values are host numpy; the
learners move each minibatch to their device.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

# Canonical column names (reference: SampleBatch.OBS etc.)
OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
NEXT_OBS = "next_obs"
VALUES = "values"
LOGPS = "logps"
ADVANTAGES = "advantages"
RETURNS = "returns"


class SampleBatch(dict):
    """dict[str, np.ndarray] with equal leading (time/batch) dimension."""

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.count)
        return SampleBatch({k: np.asarray(v)[perm] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: np.asarray(v)[start:end]
                            for k, v in self.items()})

    def minibatches(self, size: int, *, drop_last: bool = True
                    ) -> Iterator["SampleBatch"]:
        n = self.count
        end = n - (n % size) if drop_last else n
        for i in range(0, end, size):
            yield self.slice(i, min(i + size, n))

    def as_numpy(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.items()}

    def __repr__(self):
        cols = {k: tuple(np.shape(v)) for k, v in self.items()}
        return f"SampleBatch(count={self.count}, cols={cols})"


def concat_samples(batches: List[SampleBatch]) -> SampleBatch:
    """Reference: SampleBatch.concat_samples."""
    if not batches:
        return SampleBatch()
    keys = batches[0].keys()
    return SampleBatch({k: np.concatenate([np.asarray(b[k]) for b in batches])
                        for k in keys})


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                terminateds: np.ndarray, last_value: np.ndarray,
                *, gamma: float = 0.99, lam: float = 0.95):
    """Generalized Advantage Estimation over a [T, B] rollout.

    Reference: rllib/evaluation/postprocessing.py::compute_advantages.
    Runs on host numpy — rollouts arrive on host anyway; the learner
    update (the hot path) is what's jitted.
    """
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    lastgaelam = np.zeros_like(last_value)
    nextvalue = last_value
    nonterminal = 1.0 - terminateds.astype(np.float32)
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * nextvalue * nonterminal[t] - values[t]
        lastgaelam = delta + gamma * lam * nonterminal[t] * lastgaelam
        adv[t] = lastgaelam
        nextvalue = values[t]
    returns = adv + values
    return adv, returns
