"""On-device profiling: torch.profiler traces + timing helpers
(counterpart of ray_tpu/observability/profiler.py).

The device side of a perf investigation: CUDA kernel-level traces
through `torch.profiler` (CUPTI), written as Chrome traces that open in
Perfetto or chrome://tracing, plus the memory and timing helpers a
benchmark reads.

The program's spans and counters live here too. `annotate(name)` is a
span: a `record_function` range while a capture runs on the calling
thread, and nothing beyond one check otherwise. A span lands in the
Chrome trace on the clock of the CUPTI kernels, so an idle gap of the
device can be named by the span open at that moment, whoever started
the capture. `count(name, n)` adds to a counter under the same gate, so
a count is kept only while a capture runs on the counting thread; the
program counts a launch after the call that issues its kernels
returns, so a launch is counted if and only if its kernels fall inside
the capture. `counters()` reads them. Inside `recording_counts()` the
counts a thread makes are collected instead, capture or not: a CUDA
graph's capture (models/decode_graph.py) records what its forward
counts, and each replay counts that again.

torch.profiler records host operations only on the thread that started
it. The engine's dispatches run on its own loop thread (`llm-engine`),
so `start_trace(log_dir, engine=engine)` and `trace(..., engine=)`
start and stop the capture there, through the engine's command queue:
the trace then holds the engine's spans and the host side of every
launch it makes. Without `engine=` the capture is the caller's thread's.
"""
from __future__ import annotations

import collections
import contextlib
import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, Optional

# the one capture in flight: (profiler, log_dir, engine or None)
_active: list = []
_NO_SPAN = contextlib.nullcontext()
_counts: Dict[str, int] = collections.Counter()
_counts_lock = threading.Lock()
# per thread: the Counter of an open recording_counts(), else unset
_recording = threading.local()


def capturing() -> bool:
    """Whether a torch.profiler capture runs on the calling thread:
    torch keeps the profiler's state per thread, and a process that
    never imported torch runs none."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def annotate(name: str):
    """The program's span: `with annotate("llm.decode"): ...` is a
    `record_function` range while a capture runs on this thread, and a
    shared no-op context otherwise."""
    if not capturing():
        return _NO_SPAN
    from torch.profiler import record_function
    return record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while a capture runs on this thread; inside
    `recording_counts()`, to that recording instead."""
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec[name] += n
    elif capturing():
        with _counts_lock:
            _counts[name] += n


@contextlib.contextmanager
def recording_counts():
    """`with recording_counts() as rec:` collects into the Counter `rec`
    the counts this thread makes inside the block, whether a capture
    runs or not, and keeps none of them in `counters()`."""
    prev = getattr(_recording, "counts", None)
    _recording.counts = rec = collections.Counter()
    try:
        yield rec
    finally:
        _recording.counts = prev


def counters(reset: bool = False) -> Dict[str, int]:
    """The counters kept so far (a copy); `reset` clears them."""
    with _counts_lock:
        out = dict(_counts)
        if reset:
            _counts.clear()
    return out


def _on_thread_of(engine, fn):
    """fn() on the engine's loop thread (its command queue) when an
    engine is given, else here."""
    if engine is None:
        return fn()
    box = []
    engine._run_on_loop(lambda: box.append(fn()))
    return box[0]


def start_trace(log_dir: str, engine=None) -> str:
    """Begin capturing a CPU + CUDA trace into log_dir (one capture at a
    time; mirrors jax.profiler.start_trace): on the calling thread, or
    with `engine` (an `LLMEngine`) on its loop thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _active:
        raise RuntimeError(f"a trace into {_active[0][1]} is running")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    _on_thread_of(engine, prof.start)
    _active.append((prof, log_dir, engine))
    return log_dir


def stop_trace() -> Optional[str]:
    """End the capture (on the thread that started it, after the device
    finished what was issued) and write it into its log_dir as
    trace-<pid>-<ns>.json; returns the log_dir (None when no capture
    was running)."""
    if not _active:
        return None
    prof, log_dir, engine = _active.pop()

    def stop():
        import torch
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()

    _on_thread_of(engine, stop)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    return log_dir


@contextlib.contextmanager
def trace(log_dir: str, engine=None):
    """with profiler.trace("/tmp/prof"): step(...); with `engine` the
    capture runs on its loop thread (start_trace)."""
    start_trace(log_dir, engine=engine)
    try:
        yield log_dir
    finally:
        stop_trace()


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


__all__ = ["start_trace", "stop_trace", "trace", "annotate", "count",
           "counters", "recording_counts", "capturing",
           "device_memory_profile", "hbm_usage",
           "host_rss_bytes", "timed_steps"]
