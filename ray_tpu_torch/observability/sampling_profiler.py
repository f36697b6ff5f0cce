"""Always-on sampling profiler: per-worker stack sampling with
task attribution, aggregated into folded stacks.

Reference counterpart: `ray stack` / py-spy attach in the reference
runtime — replaced by an IN-PROCESS stdlib sampler (`sys._current_frames`
walked by a daemon thread at `RAY_TPU_PROFILE_HZ`) so profiles carry
task/actor-method attribution for free: the per-task log markers
(`core/logging.mark_current_task`) also stamp a thread→task map here,
and every sample lands in a `(task_id, folded_stack)` bucket.

Aggregates stay bounded (`RAY_TPU_PROFILE_MAX_STACKS` distinct stacks,
overflow collapses into one "(overflow)" bucket) and ship to the driver
as deltas over the existing telemetry channel (`sys.profile` reports on
the worker heartbeat — never the control plane), where a
`ClusterProfileStore` merges them per worker for `ray_tpu profile` /
`/api/profile` export as collapsed-stack (flamegraph.pl / speedscope
paste) or speedscope JSON.

The sampler is off by default (hz=0) and can be started, stopped, or
snapshotted per worker at runtime through the `profile_ctl` control
verb without restarting anything.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..util import knobs

__all__ = ["SamplingProfiler", "ClusterProfileStore", "mark_thread",
           "fold_frame", "dump_stacks"]

# thread ident -> task_id currently attributed to that thread (same
# last-marker-wins contract as the log markers). Plain dict ops are
# atomic under the GIL; the sampler reads a point-in-time copy.
_marks: Dict[int, str] = {}


def mark_thread(task_id: Optional[str]) -> None:
    """Attribute the calling thread's future samples to `task_id`
    (None = idle). Hooked from core/logging.mark_current_task so the
    existing task-boundary markers drive profiler attribution too."""
    ident = threading.get_ident()
    if task_id:
        _marks[ident] = task_id
    else:
        _marks.pop(ident, None)


def _short_path(path: str) -> str:
    """Last two path components — enough to tell ray_tpu/core/worker.py
    from a user module without shipping absolute paths in every frame."""
    head, tail = os.path.split(path)
    base = os.path.basename(head)
    return f"{base}/{tail}" if base else tail


def fold_frame(frame, depth: int) -> str:
    """One sampled frame folded root-first into the collapsed-stack
    convention: `file:func;file:func;...` (leaf last)."""
    parts: List[str] = []
    while frame is not None and len(parts) < depth:
        code = frame.f_code
        parts.append(f"{_short_path(code.co_filename)}:{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


def dump_stacks(depth: Optional[int] = None) -> dict:
    """One-shot stack dump of every live thread in this process (the
    `ray_tpu stack` payload — the in-process answer to py-spy attach).
    Unlike the sampler this is on demand and exact: each thread's
    current stack, folded root-first, with its name and the task id
    currently attributed to it."""
    if depth is None:
        depth = knobs.get_int("RAY_TPU_PROFILE_DEPTH")
    names = {t.ident: t.name for t in threading.enumerate()}
    marks = dict(_marks)
    threads: List[Dict[str, Any]] = []
    for ident, frame in sys._current_frames().items():
        threads.append({"ident": ident,
                        "name": names.get(ident, f"thread-{ident}"),
                        "task_id": marks.get(ident, ""),
                        "stack": fold_frame(frame, depth)})
    threads.sort(key=lambda t: t["name"])
    return {"threads": threads, "ts": time.time()}


class SamplingProfiler:
    """The in-worker sampler: a daemon thread walks every live thread's
    stack at `hz` and aggregates (task_id, folded_stack) counts between
    `collect_delta()` calls. All entry points are thread-safe and never
    raise into callers — profiling must not fail user work."""

    def __init__(self, hz: float = 0.0,
                 max_stacks: Optional[int] = None,
                 depth: Optional[int] = None):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._max_stacks = (max_stacks if max_stacks is not None
                            else knobs.get_int("RAY_TPU_PROFILE_MAX_STACKS"))
        self._depth = (depth if depth is not None
                       else knobs.get_int("RAY_TPU_PROFILE_DEPTH"))
        self._hz = 0.0
        self._samples_total = 0
        self._dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._gen = 0           # bumps on every set_hz: retires old threads
        if hz > 0:
            self.set_hz(hz)

    @property
    def hz(self) -> float:
        return self._hz

    def set_hz(self, hz: float) -> None:
        """Start (hz>0), retune, or stop (hz<=0) the sampler thread."""
        hz = max(0.0, float(hz))
        with self._lock:
            self._hz = hz
            self._gen += 1
            gen = self._gen
        if hz <= 0:
            self._stop.set()
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(gen, self._stop), daemon=True,
            name="rtpu-profiler")
        self._thread.start()

    def stop(self) -> None:
        self.set_hz(0.0)

    def _loop(self, gen: int, stop: threading.Event) -> None:
        while not stop.is_set():
            with self._lock:
                if self._gen != gen:
                    return          # superseded by a newer set_hz
                hz = self._hz
            if hz <= 0:
                return
            if stop.wait(1.0 / hz):
                return
            try:
                self._sample_once()
            except Exception:
                pass                # a bad frame walk skips one tick

    def _sample_once(self) -> None:
        me = threading.get_ident()
        frames = sys._current_frames()
        marks = dict(_marks)
        folded: List[Tuple[str, str]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue            # never sample the sampler
            folded.append((marks.get(ident, ""),
                           fold_frame(frame, self._depth)))
        del frames
        with self._lock:
            for key in folded:
                if key not in self._counts \
                        and len(self._counts) >= self._max_stacks:
                    self._counts[("", "(overflow)")] = \
                        self._counts.get(("", "(overflow)"), 0) + 1
                    self._dropped += 1
                    continue
                self._counts[key] = self._counts.get(key, 0) + 1
            self._samples_total += len(folded)
        try:
            from ..util import metrics_catalog as mcat  # noqa: PLC0415
            mcat.get("ray_tpu_profile_samples_total").inc(len(folded))
        except Exception:
            pass

    # ---- export -----------------------------------------------------------
    def collect_delta(self) -> Optional[dict]:
        """Swap out and return the aggregate accumulated since the last
        call as a wire-pure payload (msgpack-safe: strings/ints/floats
        only), or None when nothing was sampled."""
        with self._lock:
            if not self._counts:
                return None
            counts, self._counts = self._counts, {}
            dropped, self._dropped = self._dropped, 0
            hz = self._hz
        return {"hz": hz,
                "samples": [[task, stack, n]
                            for (task, stack), n in counts.items()],
                "dropped": dropped}

    def snapshot(self) -> dict:
        """Non-destructive view of the pending (un-flushed) aggregate
        plus lifetime totals — the profile_ctl `snapshot` reply."""
        with self._lock:
            return {"hz": self._hz,
                    "samples": [[task, stack, n]
                                for (task, stack), n
                                in self._counts.items()],
                    "dropped": self._dropped,
                    "samples_total": self._samples_total}

    def status(self) -> dict:
        with self._lock:
            return {"hz": self._hz,
                    "samples_total": self._samples_total,
                    "pending_stacks": len(self._counts),
                    "dropped": self._dropped}


class ClusterProfileStore:
    """Driver-side merge of every worker's `sys.profile` deltas, keyed
    `(worker_id, task_id, folded_stack)`; exports collapsed-stack text
    and speedscope JSON (mirrors ClusterMetricsStore for metrics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str, str], int] = {}
        self.samples_total = 0
        self.dropped_total = 0
        self.hz: Dict[str, float] = {}      # worker_id -> last known hz

    def ingest(self, worker_id: str, payload: dict) -> None:
        if not isinstance(payload, dict):
            return
        samples = payload.get("samples") or []
        with self._lock:
            self.hz[worker_id] = float(payload.get("hz", 0.0) or 0.0)
            self.dropped_total += int(payload.get("dropped", 0) or 0)
            for entry in samples:
                try:
                    task, stack, n = entry
                except Exception:
                    continue
                key = (worker_id, str(task or ""), str(stack))
                self._counts[key] = self._counts.get(key, 0) + int(n)
                self.samples_total += int(n)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self.samples_total = 0
            self.dropped_total = 0

    def _filtered(self, worker: Optional[str],
                  task: Optional[str]) -> Dict[Tuple[str, str, str], int]:
        with self._lock:
            return {k: v for k, v in self._counts.items()
                    if (worker is None or k[0] == worker)
                    and (task is None or k[1] == task)}

    def collapsed(self, worker: Optional[str] = None,
                  task: Optional[str] = None,
                  tag_tasks: bool = True) -> str:
        """flamegraph.pl / speedscope-paste format: one `stack count`
        line per aggregate bucket; task attribution becomes a synthetic
        root frame `task:<id>` so per-task towers separate visually."""
        merged: Dict[str, int] = {}
        for (wid, tid, stack), n in self._filtered(worker, task).items():
            line = stack
            if tag_tasks and tid:
                line = f"task:{tid};{line}" if line else f"task:{tid}"
            merged[line] = merged.get(line, 0) + n
        return "\n".join(f"{stack} {n}"
                         for stack, n in sorted(merged.items(),
                                                key=lambda kv: -kv[1]))

    def speedscope(self, worker: Optional[str] = None,
                   task: Optional[str] = None,
                   name: str = "ray_tpu profile") -> dict:
        """One sampled-type speedscope profile (weights = sample
        counts); open at https://www.speedscope.app or in Perfetto."""
        frame_index: Dict[str, int] = {}
        frames: List[Dict[str, Any]] = []
        samples: List[List[int]] = []
        weights: List[int] = []

        def fidx(fname: str) -> int:
            i = frame_index.get(fname)
            if i is None:
                i = frame_index[fname] = len(frames)
                frames.append({"name": fname})
            return i

        for (wid, tid, stack), n in sorted(
                self._filtered(worker, task).items()):
            parts = []
            if tid:
                parts.append(f"task:{tid}")
            parts.extend(p for p in stack.split(";") if p)
            samples.append([fidx(p) for p in parts])
            weights.append(n)
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": name,
            "shared": {"frames": frames},
            "profiles": [{
                "type": "sampled", "name": name, "unit": "none",
                "startValue": 0, "endValue": total,
                "samples": samples, "weights": weights,
            }],
        }

    def summary(self) -> dict:
        with self._lock:
            workers = sorted({k[0] for k in self._counts})
            return {"samples_total": self.samples_total,
                    "dropped_total": self.dropped_total,
                    "stacks": len(self._counts),
                    "workers": workers,
                    "hz": dict(self.hz)}
