"""On-device profiling: torch.profiler traces + timing helpers
(counterpart of ray_tpu/observability/profiler.py).

The device side of a perf investigation: CUDA kernel-level traces
through `torch.profiler` (CUPTI), written as Chrome traces that open in
Perfetto or chrome://tracing, plus the memory and timing helpers a
benchmark reads.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import sys
import time
from typing import Any, Dict, Optional

# the one capture in flight: (profiler, log_dir)
_active: list = []


def start_trace(log_dir: str) -> str:
    """Begin capturing a CPU + CUDA trace into log_dir (one capture at a
    time; mirrors jax.profiler.start_trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _active:
        raise RuntimeError(f"a trace into {_active[0][1]} is running")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active.append((prof, log_dir))
    return log_dir


def stop_trace() -> Optional[str]:
    """End the capture and write it into its log_dir as
    trace-<pid>-<ns>.json; returns the log_dir (None when no capture
    was running)."""
    if not _active:
        return None
    prof, log_dir = _active.pop()
    prof.stop()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    return log_dir


@contextlib.contextmanager
def trace(log_dir: str):
    """with profiler.trace("/tmp/prof"): step(...)"""
    start_trace(log_dir)
    try:
        yield log_dir
    finally:
        stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a capture (torch.profiler.record_function)."""
    from torch.profiler import record_function
    with record_function(name):
        yield


def device_memory_profile(path: Optional[str] = None) -> bytes:
    """Snapshot the CUDA caching allocator's memory (pickled
    `torch.cuda.memory._snapshot()`, which `torch.cuda._memory_viz`
    and pytorch.org/memory_viz read)."""
    import torch
    data = pickle.dumps(torch.cuda.memory._snapshot())
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


def hbm_usage() -> Dict[str, int]:
    """Bytes allocated per local card (`torch.cuda.memory_allocated`),
    the cheap always-callable sibling of device_memory_profile. Only
    consults CUDA when this process initialised it already: initialising
    CUDA here would create a context on device 0 before a worker set its
    own device, and would break a later fork of this process. Returns {}
    on the CPU."""
    if "torch" not in sys.modules:
        return {}
    import torch
    if not torch.cuda.is_initialized():
        return {}
    return {str(i): int(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())}


def host_rss_bytes() -> int:
    """This process's resident set size (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE")


def timed_steps(step_fn, state, batch, *, warmup: int = 2,
                iters: int = 10, sync=None) -> Dict[str, Any]:
    """Wall-time a step the way a benchmark does: warmup, then time
    `iters` calls, fenced by `torch.cuda.synchronize()` where CUDA is
    initialised (eager CPU ops have finished when they return) and by a
    host read of `sync(metrics)` when given."""
    import torch

    def fence(metrics):
        if sync is not None:
            torch.as_tensor(sync(metrics)).cpu()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    m = None
    for _ in range(warmup):
        state, m = step_fn(state, batch)
    fence(m)
    t0 = time.time()
    for _ in range(iters):
        state, m = step_fn(state, batch)
    fence(m)
    dt = time.time() - t0
    return {"mean_step_s": dt / iters, "steps_per_s": iters / dt,
            "state": state}


__all__ = ["start_trace", "stop_trace", "trace", "annotate",
           "device_memory_profile", "hbm_usage", "host_rss_bytes",
           "timed_steps"]
