"""Search algorithms: sequential config suggestion (counterpart of
ray_tpu/tune/search.py).

Reference counterpart: python/ray/tune/search/ — BasicVariantGenerator
(random/grid, already covered by space.generate_variants) plus the
wrapped Bayesian samplers (HyperOpt/Optuna). In-image scope: a
dependency-free TPE ("tree-structured Parzen estimator", the HyperOpt
algorithm): split observed trials into good/bad by quantile, model each
set with a kernel density, and suggest the candidate maximizing the
good/bad likelihood ratio.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .space import Choice, Domain, GridSearch, LogUniform, QUniform, RandInt, Uniform


def sample_space_value(dom, rng):
    """Draw one value from a space entry: GridSearch picks uniformly,
    Domains sample, literals pass through."""
    if isinstance(dom, GridSearch):
        return rng.choice(list(dom.values))
    if isinstance(dom, Domain):
        return dom.sample(rng)
    return dom


class Searcher:
    """Interface: suggest(trial_id) -> config | None; report back scores."""

    def set_search_properties(self, metric: str, mode: str,
                              space: Dict[str, Any]) -> None:
        self.metric, self.mode, self.space = metric, mode, space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None) -> None:
        pass


class TPESampler(Searcher):
    """TPE-lite over the tune search-space primitives.

    gamma: top fraction treated as "good". n_candidates: samples scored
    by l(x)/g(x) per suggestion. Falls back to pure random until
    n_startup observations exist.
    """

    def __init__(self, *, gamma: float = 0.25, n_candidates: int = 24,
                 n_startup: int = 8, seed: int = 0):
        import random
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        self._rng = random.Random(seed)   # space Domains sample from stdlib
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: List[Tuple[str, float]] = []

    def _random_config(self) -> Dict[str, Any]:
        return {k: sample_space_value(v, self._rng)
                for k, v in self.space.items()}

    @staticmethod
    def _is_numeric(dom) -> bool:
        return isinstance(dom, (Uniform, LogUniform, QUniform, RandInt))

    def _kde_logpdf(self, x: float, obs: np.ndarray, lo: float,
                    hi: float) -> float:
        if len(obs) == 0:
            return 0.0
        bw = max((hi - lo) / max(len(obs), 1) * 1.06, 1e-12)
        z = (x - obs) / bw
        return float(np.log(np.mean(np.exp(-0.5 * z * z) + 1e-12)))

    def _score_candidate(self, cand: Dict[str, Any],
                         good: List[Dict], bad: List[Dict]) -> float:
        score = 0.0
        for k, dom in self.space.items():
            v = cand[k]
            if self._is_numeric(dom):
                lo = getattr(dom, "low", 0.0)
                hi = getattr(dom, "high", 1.0)
                tx = np.log if isinstance(dom, LogUniform) else (lambda a: a)
                gx = np.asarray([tx(float(c[k])) for c in good])
                bx = np.asarray([tx(float(c[k])) for c in bad])
                x = tx(float(v))
                score += (self._kde_logpdf(x, gx, tx(lo), tx(hi))
                          - self._kde_logpdf(x, bx, tx(lo), tx(hi)))
            else:
                # categorical: smoothed count ratio
                gcount = sum(1 for c in good if c[k] == v) + 1.0
                bcount = sum(1 for c in bad if c[k] == v) + 1.0
                score += float(np.log(gcount / len(good or [1]))
                               - np.log(bcount / len(bad or [1])))
        return score

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        scored = [s for s in self._scores if s[1] is not None]
        if len(scored) < self.n_startup:
            cfg = self._random_config()
        else:
            # ascending sort by sign*score puts the BEST trials first
            # (max: key=-score; min: key=+score); split by gamma quantile
            sign = -1.0 if self.mode == "max" else 1.0
            ranked = sorted(scored, key=lambda t: sign * t[1])
            n_good = max(1, int(np.ceil(self.gamma * len(ranked))))
            good_ids = {tid for tid, _ in ranked[:n_good]}
            good = [self._configs[tid] for tid, _ in scored
                    if tid in good_ids]
            bad = [self._configs[tid] for tid, _ in scored
                   if tid not in good_ids]
            cands = [self._random_config()
                     for _ in range(self.n_candidates)]
            cfg = max(cands,
                      key=lambda c: self._score_candidate(c, good, bad))
        self._configs[trial_id] = cfg
        return dict(cfg)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None) -> None:
        if trial_id not in self._configs:
            return
        score = None
        if result is not None:
            v = result.get(self.metric)
            score = None if v is None else float(v)
        self._scores.append((trial_id, score))


class BasicVariantGenerator(Searcher):
    """Random sampling as a Searcher (reference: BasicVariant). Grid axes
    are sampled uniformly here — use Tuner without a search_alg for full
    grid expansion."""

    def __init__(self, *, seed: int = 0):
        import random
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        return {k: sample_space_value(v, self._rng)
                for k, v in self.space.items()}
