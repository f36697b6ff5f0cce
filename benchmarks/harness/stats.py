"""Percentiles, frozen with the benchmark.

A percentile is the nearest-rank one: the ceil(p/100 * n)-th smallest
sample, so it is always a value that was observed, and p90 of 100
requests has exactly 10 samples at or beyond it. A missing sample (a
request that failed or never answered) is +inf: it counts as having
missed every limit.
"""
from __future__ import annotations

import math
from typing import Iterable, List


def percentile(values: Iterable[float], p: float) -> float:
    xs: List[float] = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    if not 0 < p <= 100:
        raise ValueError(f"percentile {p} outside (0, 100]")
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[rank - 1]
