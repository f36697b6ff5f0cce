"""The traced slice of a window and its reduction.

`torch.profiler` records the host's operations only on the thread that
started it, so a slice is started and stopped on the thread that runs
the program (the engine's loop, through a forward pre-hook; the train
loop itself). The device's kernels, copies and fills come from CUPTI
for the whole process. The trace is exported as Chrome JSON into the
run's temporary directory, reduced, and deleted.

The reduction gives: the slice's length on the host clock
(`window_s`); the union of the device's operation intervals
(`busy_s`); time and launches by kernel name; for each
`record_function` range name, the device time of the operations that
were launched inside one of its instances on the launching thread (the
launch's correlation id ties a kernel to its host call); and the
slice's longest idle gaps, each named by the innermost host operation
that was running, at the gap's midpoint, on the thread that launched
the operation after it.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIX = "cuda_"     # CUDA API calls that launch or copy


class Slice:
    """A profiler capture from start() to stop(), on the calling
    thread."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> Dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.prof = None
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events, self.t1 - self.t0)


class ThreadSlice(Slice):
    """A slice toggled from another thread: `hook` runs as a forward
    pre-hook on the program's thread and starts or stops the capture
    there when asked."""

    def __init__(self):
        super().__init__()
        self.want = "idle"     # idle -> on -> off
        self.state = "idle"

    def hook(self, module, args):
        if self.state == "idle" and self.want == "on":
            self.start()
            self.state = "on"
        elif self.state == "on" and self.want == "off":
            self.stop()
            self.state = "off"


class Annotations:
    """record_function ranges around every module of the given classes,
    entered by a forward pre-hook and left by a forward hook."""

    def __init__(self, model, ranges: Dict[str, str]):
        from torch.autograd.profiler import record_function
        self.handles = []
        for name, cls in ranges.items():
            for m in model.modules():
                if type(m).__name__ != cls:
                    continue

                def pre(mod, args, _n=name):
                    mod._bench_range = record_function(_n)
                    mod._bench_range.__enter__()

                def post(mod, args, out):
                    mod._bench_range.__exit__(None, None, None)
                    mod._bench_range = None

                self.handles.append(m.register_forward_pre_hook(pre))
                self.handles.append(m.register_forward_hook(post))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def _union(intervals: List[tuple]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events: List[Dict], window_s: float) -> Dict:
    dev, launches = [], {}
    ranges: Dict[str, Dict[int, List[tuple]]] = defaultdict(
        lambda: defaultdict(list))
    host: Dict[int, List[tuple]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"],
                        e.get("args", {}).get("correlation")))
        elif cat.startswith(LAUNCH_PREFIX):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], ts)
        elif cat in ("user_annotation", "cpu_op"):
            host[e["tid"]].append((ts, ts + dur, e["name"]))
            if cat == "user_annotation":
                ranges[e["name"]][e["tid"]].append((ts, ts + dur))
    busy = _union([(s, e) for s, e, _, _ in dev])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, name, _ in dev:
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-6
    under: Dict[str, float] = {}
    for rname, by_tid in ranges.items():
        index = {tid: (sorted(iv), [a for a, _ in sorted(iv)])
                 for tid, iv in by_tid.items()}
        total = 0.0
        for s, e, _, corr in dev:
            where = launches.get(corr)
            if where is None or where[0] not in index:
                continue
            iv, starts = index[where[0]]
            i = bisect.bisect_right(starts, where[1]) - 1
            if i >= 0 and where[1] <= iv[i][1]:
                total += (e - s) * 1e-6
        under[rname] = total
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    starts_by_dev = {s: corr for s, _, _, corr in dev}
    host_np = {tid: (np.array([a for a, _, _ in ev]),
                     np.array([b for _, b, _ in ev]), [n for *_, n in ev])
               for tid, ev in host.items()}
    idle = []
    for length, e0, s1 in gaps[:10]:
        label = "host: no operation"
        where = launches.get(starts_by_dev.get(s1))
        if where is not None and where[0] in host_np:
            a, b, names = host_np[where[0]]
            mid = (e0 + s1) / 2
            inside = np.nonzero((a <= mid) & (b >= mid))[0]
            if inside.size:
                label = names[inside[np.argmax(a[inside])]]
        idle.append([label, length * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": {k: v for k, v in kernels.items()},
        "ranges": under,
        "breakdown": {"device_ops": [[k[:160], v[1]] for k, v in top],
                      "idle_gaps": idle},
    }


def kernel_time(summary: Dict, needle: str):
    """(launches, seconds) of the kernels whose name holds `needle`."""
    n, t = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if needle in name:
            n += count
            t += secs
    return n, t
