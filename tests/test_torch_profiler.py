"""The port's profiler (ray_tpu_torch.observability.profiler) on the
CPU: tests/test_observability.py's trace-and-timing test on a torch
step, the memory helpers' CPU answers, and the program's spans and
counters, kept only while a capture runs on the calling thread."""
import json
import os
import subprocess
import sys
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.observability import profiler


def _step(state, batch):
    s = state + batch.sum()
    return s, {"loss": s}


def test_profiler_trace_and_timing(tmp_path):
    with profiler.trace(str(tmp_path / "prof")):
        with profiler.annotate("demo-step"):
            _step(torch.zeros(()), torch.ones((8, 8)))
    produced = list((tmp_path / "prof").rglob("*"))
    assert produced, "no trace files written"
    with open(produced[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "demo-step" for e in events)
    r = profiler.timed_steps(_step, torch.zeros(()), torch.ones((4, 4)),
                             warmup=1, iters=3)
    assert r["steps_per_s"] > 0
    assert float(r["state"]) == 4 * 16.0


def test_memory_helpers_on_the_cpu():
    """hbm_usage is {} where CUDA was never initialised, and does not
    initialise it (checked in a fresh interpreter, which no earlier
    test has touched CUDA in); the host RSS is this process's."""
    code = ("import torch\n"
            "from ray_tpu_torch.observability import profiler\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert profiler.hbm_usage() == {}\n"
            "assert not torch.cuda.is_initialized()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    assert profiler.host_rss_bytes() > 1 << 20


def _ranges(prof, tmp_path):
    path = str(tmp_path / "capture.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


def test_spans_and_counters_only_under_a_capture_on_this_thread(tmp_path):
    """The gate is torch's per-thread profiler state
    (`torch.autograd._profiler_enabled`): off without a capture, on
    under one started on this thread, off on a thread the capture was
    not started on. annotate is a record_function range and count adds
    only while it is on."""
    profiler.counters(reset=True)
    assert not torch.autograd._profiler_enabled()
    assert not profiler.capturing()
    with profiler.annotate("off-span"):
        profiler.count("off", 3)
    assert profiler.counters() == {}

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    seen = {}

    def elsewhere():
        seen["gate"] = torch.autograd._profiler_enabled()
        seen["capturing"] = profiler.capturing()
        profiler.count("elsewhere")

    try:
        assert torch.autograd._profiler_enabled() and profiler.capturing()
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with profiler.annotate("on-span"):
            with profiler.annotate("inner-span"):
                torch.ones(4).sum()
            profiler.count("on", 2)
            profiler.count("on")
    finally:
        prof.stop()
    assert seen == {"gate": False, "capturing": False}
    assert profiler.counters() == {"on": 3}
    assert profiler.counters(reset=True) == {"on": 3}
    assert profiler.counters() == {}
    names = _ranges(prof, tmp_path)
    assert "on-span" in names and "inner-span" in names
    assert "off-span" not in names


def test_a_span_open_when_the_capture_stops_is_closed_safely(tmp_path):
    """A capture may stop inside an open span (a benchmark stops it from
    a forward hook): the span ends with the capture, and leaving it
    later raises nothing."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    span = profiler.annotate("straddle")
    span.__enter__()
    prof.stop()
    span.__exit__(None, None, None)
    assert "straddle" in _ranges(prof, tmp_path)
    with profiler.annotate("after"):
        pass
