"""The port's profiler (ray_tpu_torch.observability.profiler) on the
CPU: tests/test_observability.py's trace-and-timing test on a torch
step, and the memory helpers' CPU answers."""
import json
import os
import subprocess
import sys

import torch

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
