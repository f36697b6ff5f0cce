"""Per-worker training session (counterpart of ray_tpu/train/session.py).

Reference parity: python/ray/train/_internal/session.py +
python/ray/train/context.py — `train.report(...)`, `train.get_context()`
with rank/world info, checkpoint handoff.

Inside a train worker, `report` ships metrics (and optionally a checkpoint
path) to the trainer supervisor over the runtime's out-of-band report
channel; on the driver (local mode) it appends directly.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional

_session_lock = threading.Lock()
_session: Optional["TrainSession"] = None


@dataclasses.dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    trial_name: str = ""
    experiment_name: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank


class TrainSession:
    def __init__(self, context: TrainContext, report_fn):
        self.context = context
        self._report_fn = report_fn
        self.iteration = 0
        self._last_report_t: Optional[float] = None

    def _record_builtin_metrics(self, metrics: Dict[str, Any]) -> None:
        """Mirror the loop's cadence and well-known throughput keys onto
        the registry — these ship to the driver's exposition over the
        worker telemetry channel, giving bench.py a driver-captured
        source for step-time / tokens/s / MFU artifacts. Never raises."""
        import time  # noqa: PLC0415
        try:
            from ..util import metrics_catalog as mcat  # noqa: PLC0415
            now = time.perf_counter()
            if self._last_report_t is not None:
                mcat.get("ray_tpu_train_step_time_s").observe(
                    now - self._last_report_t)
            self._last_report_t = now
            mcat.get("ray_tpu_train_reports_total").inc()
            for key, gauge in (("tokens_per_s",
                                "ray_tpu_train_tokens_per_s"),
                               ("mfu", "ray_tpu_train_mfu")):
                v = metrics.get(key)
                if isinstance(v, (int, float)):
                    mcat.get(gauge).set(float(v))
        except Exception:
            pass

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Any] = None) -> None:
        self.iteration += 1
        self._record_builtin_metrics(metrics)
        payload = {"metrics": dict(metrics), "iteration": self.iteration,
                   "rank": self.context.world_rank}
        if checkpoint is not None:
            payload["checkpoint"] = getattr(checkpoint, "path", checkpoint)
        self._report_fn(payload)


def init_session(context: TrainContext, report_fn) -> TrainSession:
    global _session
    with _session_lock:
        _session = TrainSession(context, report_fn)
    return _session


def clear_session() -> None:
    global _session
    with _session_lock:
        _session = None


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No active train session — report()/get_context() must run "
            "inside a training function launched by a Trainer")
    return _session


def report(metrics: Dict[str, Any], checkpoint=None) -> None:
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return get_session().context
