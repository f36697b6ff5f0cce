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
