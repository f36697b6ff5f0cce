"""Environment knobs the port reads (the few of ray_tpu/util/knobs.py
it needs, under the same names)."""
from __future__ import annotations

import os

ENGINE_WATCHDOG_S = "RAY_TPU_ENGINE_WATCHDOG_S"
_ENGINE_WATCHDOG_DEFAULT = 30.0


def engine_watchdog_s() -> float:
    """The LLM engine's no-forward-progress window in seconds (<= 0
    disables the watchdog): RAY_TPU_ENGINE_WATCHDOG_S, default 30; a
    value that is not a number reads as the default."""
    raw = os.environ.get(ENGINE_WATCHDOG_S)
    if raw in (None, ""):
        return _ENGINE_WATCHDOG_DEFAULT
    try:
        return float(raw)
    except ValueError:
        return _ENGINE_WATCHDOG_DEFAULT


# the launcher's rank block (ray_tpu/util/knobs.py's train knobs, same
# names): a worker's rank, its world size and the rank-0 rendezvous
TRAIN_RANK = "RAY_TPU_TRAIN_RANK"
TRAIN_WORLD = "RAY_TPU_TRAIN_WORLD"
COORDINATOR = "RAY_TPU_COORDINATOR"


def _int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def train_rank() -> int:
    """RAY_TPU_TRAIN_RANK, default 0."""
    return _int(TRAIN_RANK, 0)


def train_world() -> int:
    """RAY_TPU_TRAIN_WORLD, default 1."""
    return _int(TRAIN_WORLD, 1)


def coordinator() -> "str | None":
    """RAY_TPU_COORDINATOR, the rendezvous address, default none."""
    return os.environ.get(COORDINATOR) or None


DATA_PREFETCH_DEPTH = "RAY_TPU_DATA_PREFETCH_DEPTH"


def data_prefetch_depth() -> int:
    """device_put_iterator's prefetch depth, the host batches staged on
    the device ahead of the consumer: RAY_TPU_DATA_PREFETCH_DEPTH,
    default 2."""
    return _int(DATA_PREFETCH_DEPTH, 2)
