"""The general traffic generator. A mix is a data file under
`benchmarks/traffic/`; its `kind` names the runner (`harness/<kind>.py`)
and, for serving, its `arrivals` name the arrival law:

- `{"law": "poisson"}` (the default): exponential gaps;
- `{"law": "gamma", "cv": c}`: gamma gaps whose coefficient of variation
  is c, bursts for c > 1;
- `{"law": "closed", "clients": n, "requests": m}`: a closed loop, n
  clients each sending its next request when its last one has ended; m
  requests are drawn, and those not sent by the window's close are not
  counted. Such a request's due time is when it was sent.

A law beyond these, or a load that is not requests, is a runner of its
own: a new `harness/<kind>.py`.

Every seed gets the same work: the request sizes and the gaps between
arrivals come from the mix's own `shape_seed`, a fixed trace that every
run replays, and the run's seed draws the token ids. Permuting the
trace by the seed made the tails of time to first token move by a
fifth between seeds (which long prompts arrive together decides the
queue); replayed, seeds differ by content, not by how the work lines
up. So a serving cell measures one trace of its mix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass
class Request:
    index: int
    due_s: Optional[float]  # seconds after the window opens; None: closed
    prompt: np.ndarray      # (P,) int32
    max_new_tokens: int


def _lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _gaps(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    law = spec["law"]
    if law == "poisson":
        return rng.exponential(1.0, n)
    if law == "gamma":
        k = 1.0 / spec["cv"] ** 2
        return rng.gamma(k, 1.0 / k, n)
    raise ValueError(f"unknown arrival law {law!r}")


def arrivals(mix: Dict) -> Dict:
    return mix.get("arrivals", {"law": "poisson"})


def request_count(mix: Dict, seconds: float) -> int:
    law = arrivals(mix)
    if law["law"] == "closed":
        return int(law["requests"])
    return max(1, int(round(mix["rate_per_s"] * seconds)))


def requests(mix: Dict, seed: int, seconds: float,
             vocab: int) -> List[Request]:
    """The mix's requests over a window of `seconds`. Open loops send
    round(rate * seconds) requests, their gaps scaled so that they sum
    to the window (the last request is due at its close)."""
    law = arrivals(mix)
    n = request_count(mix, seconds)
    shape = np.random.default_rng(mix["shape_seed"])
    if law["law"] == "closed":
        due = [None] * n
    else:
        gaps = _gaps(law, n, shape)
        due = [float(d) for d in np.cumsum(gaps) * (seconds / gaps.sum())]
    prompts = _lengths(mix["prompt_len"], n, shape)
    outputs = _lengths(mix["output_len"], n, shape)
    run = np.random.default_rng(int(seed))
    return [Request(i, due[i],
                    run.integers(0, vocab, int(prompts[i]), dtype=np.int32),
                    int(outputs[i])) for i in range(n)]


def lm_batches(mix: Dict, seed: int, vocab: int) -> Iterator[Dict]:
    """Endless packed next-token batches: {"tokens": (batch, seq_len + 1)
    int32}, uniform ids, every row new."""
    run = np.random.default_rng(int(seed))
    shape = (mix["batch"], mix["seq_len"] + 1)
    while True:
        yield {"tokens": run.integers(0, vocab, shape, dtype=np.int32)}
