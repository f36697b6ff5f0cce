"""Stoppers: declarative trial/experiment stop conditions (counterpart of
ray_tpu/tune/stoppers.py).

Reference counterpart: python/ray/tune/stopper/ (Stopper,
MaximumIterationStopper, TrialPlateauStopper, ExperimentPlateauStopper,
TimeoutStopper, CombinedStopper). A stopper's __call__(trial_id, result)
returns True to stop that trial; stop_all() ends the experiment.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np


class Stopper:
    def __call__(self, trial_id: str, result: Dict) -> bool:
        return False

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._iters: Dict[str, int] = collections.defaultdict(int)

    def __call__(self, trial_id: str, result: Dict) -> bool:
        self._iters[trial_id] += 1
        return self._iters[trial_id] >= self.max_iter


class TrialPlateauStopper(Stopper):
    """Stop a trial when its metric stops moving (std over a window)."""

    def __init__(self, metric: str, *, std: float = 0.01,
                 num_results: int = 4, grace_period: int = 4,
                 mode: Optional[str] = None):
        self.metric = metric
        self.std = std
        self.num_results = num_results
        self.grace_period = grace_period
        self._window: Dict[str, collections.deque] = {}
        self._count: Dict[str, int] = collections.defaultdict(int)

    def __call__(self, trial_id: str, result: Dict) -> bool:
        v = result.get(self.metric)
        if v is None:
            return False
        self._count[trial_id] += 1
        win = self._window.setdefault(
            trial_id, collections.deque(maxlen=self.num_results))
        win.append(float(v))
        if self._count[trial_id] < self.grace_period:
            return False
        return (len(win) == self.num_results
                and float(np.std(win)) <= self.std)


class ExperimentPlateauStopper(Stopper):
    """Stop everything when the best metric has plateaued."""

    def __init__(self, metric: str, *, mode: str = "max",
                 patience: int = 8, top: int = 10, std: float = 0.001):
        self.metric = metric
        self.mode = mode
        self.patience = patience
        self.top = top
        self.std = std
        self._best: List[float] = []
        self._stale_rounds = 0

    def __call__(self, trial_id: str, result: Dict) -> bool:
        v = result.get(self.metric)
        if v is None:
            return False
        self._best.append(float(v))
        self._best.sort(reverse=(self.mode == "max"))
        del self._best[self.top:]
        if len(self._best) == self.top and float(
                np.std(self._best)) <= self.std:
            self._stale_rounds += 1
        else:
            self._stale_rounds = 0
        return False

    def stop_all(self) -> bool:
        return self._stale_rounds >= self.patience


class TimeoutStopper(Stopper):
    """Budget starts on first use, not at construction, so a stopper built
    ahead of fit() gets the full window."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._deadline: Optional[float] = None

    def stop_all(self) -> bool:
        if self._deadline is None:
            self._deadline = time.monotonic() + self.timeout_s
            return False
        return time.monotonic() >= self._deadline


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self.stoppers = stoppers

    def __call__(self, trial_id: str, result: Dict) -> bool:
        return any(s(trial_id, result) for s in self.stoppers)

    def stop_all(self) -> bool:
        return any(s.stop_all() for s in self.stoppers)


class FunctionStopper(Stopper):
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, trial_id: str, result: Dict) -> bool:
        return bool(self.fn(trial_id, result))


def make_stopper(stop) -> Optional[Stopper]:
    """Coerce RunConfig.stop into a Stopper: dict means metric thresholds
    (reference: tune.run(stop={'training_iteration': 10}))."""
    if stop is None or isinstance(stop, Stopper):
        return stop
    if callable(stop):
        return FunctionStopper(stop)
    if isinstance(stop, dict):
        thresholds = dict(stop)

        def check(_tid, result):
            for k, bound in thresholds.items():
                v = result.get(k)
                if v is not None and float(v) >= bound:
                    return True
            return False

        return FunctionStopper(check)
    raise TypeError(f"unsupported stop spec: {stop!r}")
