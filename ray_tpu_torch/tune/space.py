"""Search-space primitives (counterpart of
ray_tpu/tune/space.py).

Reference parity: python/ray/tune/search/sample.py (uniform, loguniform,
quniform, randint, choice, grid_search) + variant generation.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclasses.dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclasses.dataclass
class QUniform(Domain):
    low: float
    high: float
    q: float

    def sample(self, rng):
        return round(rng.uniform(self.low, self.high) / self.q) * self.q


@dataclasses.dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclasses.dataclass
class Choice(Domain):
    options: Sequence[Any]

    def sample(self, rng):
        return rng.choice(list(self.options))


@dataclasses.dataclass
class GridSearch:
    values: Sequence[Any]


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def choice(options) -> Choice:
    return Choice(options)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def generate_variants(space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Grid axes expand combinatorially; stochastic axes resample per
    variant; num_samples multiplies the grid (reference BasicVariant)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    grids: List[Dict[str, Any]] = [{}]
    for k in grid_keys:
        grids = [dict(g, **{k: val}) for g in grids
                 for val in space[k].values]
    variants = []
    for _ in range(num_samples):
        for g in grids:
            cfg = {}
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = g[k]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
