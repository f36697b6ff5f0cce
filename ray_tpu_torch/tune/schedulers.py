"""Trial schedulers (counterpart of
ray_tpu/tune/schedulers.py).

Reference parity: python/ray/tune/schedulers/ — FIFOScheduler,
AsyncHyperBandScheduler (ASHA, async_hyperband.py), MedianStoppingRule
(median_stopping_rule.py), PopulationBasedTraining (pbt.py). Decisions are
made on every reported result: CONTINUE or STOP; PBT may also EXPLOIT
(copy a better trial's config+checkpoint with mutation).
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_result(self, trial_id: str, iteration: int,
                  metric_value: float) -> str:
        return CONTINUE

    def on_complete(self, trial_id: str) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving: at each rung (grace_period *
    reduction_factor^k iterations), a trial must be in the top
    1/reduction_factor of completed rung entries to continue."""

    def __init__(self, *, metric: str = "", mode: str = "max",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        self.mode = mode
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self.rungs: Dict[int, List[float]] = {}
        rung = grace_period
        while rung < max_t:
            self.rungs[rung] = []
            rung *= reduction_factor

    def on_result(self, trial_id, iteration, value) -> str:
        if iteration >= self.max_t:
            return STOP
        if iteration not in self.rungs:
            return CONTINUE
        v = value if self.mode == "max" else -value
        rung = self.rungs[iteration]
        rung.append(v)
        k = max(1, len(rung) // self.rf)
        top_k = sorted(rung, reverse=True)[:k]
        return CONTINUE if v >= top_k[-1] else STOP


class MedianStoppingRule(TrialScheduler):
    def __init__(self, *, metric: str = "", mode: str = "max",
                 grace_period: int = 3, min_samples: int = 3):
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples
        self.history: Dict[str, List[float]] = {}

    def on_result(self, trial_id, iteration, value) -> str:
        v = value if self.mode == "max" else -value
        self.history.setdefault(trial_id, []).append(v)
        if iteration < self.grace or len(self.history) < self.min_samples:
            return CONTINUE
        bests = [max(h) for tid, h in self.history.items()
                 if tid != trial_id and h]
        if len(bests) < self.min_samples - 1:
            return CONTINUE
        bests.sort()
        median = bests[len(bests) // 2]
        mine = max(self.history[trial_id])
        return CONTINUE if mine >= median else STOP


class HyperBandScheduler(TrialScheduler):
    """Multi-bracket asynchronous HyperBand (reference:
    python/ray/tune/schedulers/hyperband.py + async_hyperband.py with
    brackets > 1).

    Each trial is assigned round-robin to one of `brackets` successive-
    halving brackets whose grace periods are geometrically staggered
    (grace, grace*rf, grace*rf^2, ...): aggressive brackets kill weak
    trials early, conservative ones give slow starters a longer runway —
    the HyperBand exploration/exploitation hedge, unlike plain ASHA's
    single bracket."""

    def __init__(self, *, metric: str = "", mode: str = "max",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100, brackets: int = 3):
        self.mode = mode
        self.rf = reduction_factor
        self.max_t = max_t
        self.brackets: List[Dict[int, List[float]]] = []
        self.bracket_grace: List[int] = []
        for s in range(max(1, brackets)):
            grace = grace_period * (reduction_factor ** s)
            if grace >= max_t:
                break
            rungs: Dict[int, List[float]] = {}
            rung = grace
            while rung < max_t:
                rungs[rung] = []
                rung *= reduction_factor
            self.brackets.append(rungs)
            self.bracket_grace.append(grace)
        if not self.brackets:
            raise ValueError(
                f"grace_period ({grace_period}) must be < max_t ({max_t}) "
                "to form at least one HyperBand bracket")
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def bracket_of(self, trial_id: str) -> int:
        b = self._assignment.get(trial_id)
        if b is None:
            b = self._next_bracket
            self._assignment[trial_id] = b
            self._next_bracket = (b + 1) % len(self.brackets)
        return b

    def on_result(self, trial_id, iteration, value) -> str:
        if iteration >= self.max_t:
            return STOP
        rungs = self.brackets[self.bracket_of(trial_id)]
        if iteration not in rungs:
            return CONTINUE
        v = value if self.mode == "max" else -value
        rung = rungs[iteration]
        rung.append(v)
        k = max(1, len(rung) // self.rf)
        top_k = sorted(rung, reverse=True)[:k]
        return CONTINUE if v >= top_k[-1] else STOP


class PopulationBasedTraining(TrialScheduler):
    """PBT: at each perturbation interval, bottom-quantile trials exploit a
    top-quantile trial's config (with mutation). The tuner applies the
    returned new config on the trial's next step."""

    def __init__(self, *, metric: str = "", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile: float = 0.25, seed: int = 0):
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile
        self.rng = random.Random(seed)
        self.latest: Dict[str, float] = {}
        self.configs: Dict[str, Dict[str, Any]] = {}
        self.pending_config: Dict[str, Dict[str, Any]] = {}

    def register(self, trial_id: str, config: Dict[str, Any]):
        self.configs[trial_id] = dict(config)

    def on_result(self, trial_id, iteration, value) -> str:
        v = value if self.mode == "max" else -value
        self.latest[trial_id] = v
        if iteration % self.interval or len(self.latest) < 3:
            return CONTINUE
        ranked = sorted(self.latest.items(), key=lambda kv: kv[1])
        n = len(ranked)
        cut = max(1, int(n * self.quantile))
        bottom = [t for t, _ in ranked[:cut]]
        top = [t for t, _ in ranked[-cut:]]
        if trial_id in bottom and top:
            donor = self.rng.choice(top)
            new_cfg = dict(self.configs.get(donor, {}))
            for k, spec in self.mutations.items():
                if callable(spec):
                    new_cfg[k] = spec()
                elif isinstance(spec, list):
                    new_cfg[k] = self.rng.choice(spec)
                elif k in new_cfg:
                    new_cfg[k] = new_cfg[k] * self.rng.choice([0.8, 1.25])
            self.pending_config[trial_id] = new_cfg
            self.configs[trial_id] = new_cfg
        return CONTINUE

    def take_pending_config(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self.pending_config.pop(trial_id, None)
