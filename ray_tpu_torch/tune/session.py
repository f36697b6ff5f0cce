"""Per-trial session: tune.report inside trainables (counterpart of
ray_tpu/tune/session.py).

Reference parity: ray.tune.report / session (python/ray/tune/trainable/
function_trainable.py). The synchronous reply carries the scheduler's
decision; STOP unwinds the trial via StopTrial.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class StopTrial(Exception):
    pass


_local = threading.local()


def _init_trial(trial_id: str, sync_report_fn) -> None:
    _local.trial_id = trial_id
    _local.report_fn = sync_report_fn
    _local.iteration = 0
    _local.override_config: Optional[Dict[str, Any]] = None


def _clear_trial() -> None:
    for k in ("trial_id", "report_fn", "iteration", "override_config"):
        if hasattr(_local, k):
            delattr(_local, k)


def report(metrics: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Report metrics; returns a new config if the scheduler (PBT) swapped
    this trial's hyperparameters, else None. Raises StopTrial on STOP."""
    if not hasattr(_local, "report_fn"):
        raise RuntimeError("tune.report() called outside a trial")
    _local.iteration += 1
    reply = _local.report_fn({"metrics": dict(metrics),
                              "iteration": _local.iteration}) or {}
    if reply.get("decision") == "STOP":
        raise StopTrial()
    return reply.get("new_config")


def get_trial_id() -> str:
    return getattr(_local, "trial_id", "")
