"""Loggers & callbacks: per-trial metric persistence + lifecycle hooks
(counterpart of ray_tpu/tune/loggers.py).

Reference counterpart: python/ray/tune/logger/ (CSVLoggerCallback,
JsonLoggerCallback; TensorBoard is a documented gap — no tensorboardX
in-image) and tune/callback.py (Callback on_trial_result/complete/error).
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Lifecycle hooks; subclass and override what you need."""

    def on_trial_start(self, trial_id: str, config: Dict) -> None:
        pass

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str) -> None:
        pass

    def on_trial_error(self, trial_id: str, error: str) -> None:
        pass

    def on_experiment_end(self, trials: List[Any]) -> None:
        pass


class JsonLoggerCallback(Callback):
    """Appends one JSON line per result to <dir>/<trial_id>/result.json."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def _trial_dir(self, trial_id: str) -> str:
        d = os.path.join(self.log_dir, trial_id)
        os.makedirs(d, exist_ok=True)
        return d

    def on_trial_start(self, trial_id: str, config: Dict) -> None:
        with open(os.path.join(self._trial_dir(trial_id),
                               "params.json"), "w") as f:
            json.dump(config, f, default=str)

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        with open(os.path.join(self._trial_dir(trial_id),
                               "result.json"), "a") as f:
            f.write(json.dumps(result, default=str) + "\n")


class CSVLoggerCallback(Callback):
    """Writes <dir>/<trial_id>/progress.csv. The header is the union of
    all keys seen; when a new key appears the file is rewritten (rows are
    buffered in memory — tune results are small)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._fields: Dict[str, List[str]] = {}
        self._rows: Dict[str, List[Dict]] = {}

    def _path(self, trial_id: str) -> str:
        d = os.path.join(self.log_dir, trial_id)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "progress.csv")

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        path = self._path(trial_id)
        flat = {k: v for k, v in result.items()
                if not isinstance(v, (dict, list))}
        rows = self._rows.setdefault(trial_id, [])
        rows.append(flat)
        fields = self._fields.get(trial_id, [])
        new_keys = [k for k in sorted(flat) if k not in fields]
        if new_keys:
            fields = sorted(set(fields) | set(flat))
            self._fields[trial_id] = fields
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields,
                                   extrasaction="ignore", restval="")
                w.writeheader()
                w.writerows(rows)
        else:
            with open(path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields,
                                   extrasaction="ignore", restval="")
                w.writerow(flat)
