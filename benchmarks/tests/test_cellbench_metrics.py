"""The metric arithmetic: nearest-rank percentiles, the end-to-end
readers over a window's client records (a stall moves both tails, a
failed request counts as missing), and the trace reduction."""
import json
from pathlib import Path

import pytest

import cpu_cells  # noqa: F401
from harness import stats
from harness.cell import _reader
from harness.trace import kernel_time, reduce_events

BENCH = Path(__file__).resolve().parents[1]
CHAT = json.loads((BENCH / "traffic" / "chat.json").read_text())


def reader(name):
    return _reader(BENCH, name)


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([5.0], 90) == 5.0
    assert sum(x > stats.percentile(xs, 90) for x in xs) == 10
    assert stats.percentile(xs + [float("inf")] * 20, 90) == float("inf")
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def _serve_rec(stall_at=None, stall_s=0.0, fail=()):
    """100 requests due every 0.5 s, first token 0.2 s after the due
    time, then a token every 0.05 s for 20 tokens; a stall of stall_s at
    stall_at delays every event after it."""
    reqs = []
    for i in range(100):
        due = 0.5 * i
        times = [due + 0.2 + 0.05 * j for j in range(20)]
        if stall_at is not None:
            times = [t + stall_s if t >= stall_at else t for t in times]
        failed = i in fail
        reqs.append({"due": due, "sent": due, "failed": failed,
                     "times": [] if failed else times})
    return {"kind": "serve", "window_s": 60.0, "requests": reqs,
            "traffic": CHAT, "setup_s": 1.0}


def test_ttft_and_itl_tails_see_a_stall_and_failures():
    ttft, itl = reader("ttft_p90_ms"), reader("itl_p95_ms")
    base = _serve_rec()
    assert ttft(base) == pytest.approx(200.0)
    assert itl(base) == pytest.approx(50.0)
    # a 3 s stall at t=20 s: every request in flight then waits
    stalled = _serve_rec(stall_at=20.0, stall_s=3.0)
    assert ttft(stalled) > 200.0 + 1000.0
    assert itl(stalled) > 50.0
    # a failed request is missing: 11 of 100 failed push p90 past any
    # latency that was served
    failed = _serve_rec(fail=range(0, 100, 9))
    assert ttft(failed) >= (60.0 + CHAT["ttft_wait_s"] - 99 * 0.5) * 1000
    assert ttft(_serve_rec(fail=range(0, 100, 50))) == pytest.approx(200.0)


def test_itl_counts_only_gaps_inside_the_window():
    rec = _serve_rec()
    rec["window_s"] = 10.0
    gaps = [b - a for r in rec["requests"]
            for a, b in zip(r["times"], r["times"][1:]) if b <= 10.0]
    assert gaps and reader("itl_p95_ms")(rec) == pytest.approx(
        1000 * stats.percentile(gaps, 95))


def test_train_rate_and_mfu():
    cfg = json.loads((BENCH / "configs" / "mistral-7b-s16.json").read_text())
    mix = json.loads((BENCH / "traffic" / "pretrain-8k.json").read_text())
    rec = {"kind": "train", "steps": 40, "tokens": 40 * 8192,
           "window_s": 32.0, "config": cfg, "traffic": mix}
    assert reader("train_tokens_per_s")(rec) == pytest.approx(10240.0)
    flops = 6 * 3_623_878_656 * 8192 + 3 * 4 * 32 * 128 * 8192 * 8193 / 2 * 16
    assert reader("mfu.train")(rec) == pytest.approx(
        100 * flops * 40 / 32.0 / 989e12)


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_reduction():
    ev = [
        _event("user_annotation", "bench.moe", 0, 100, tid=7),
        _event("cpu_op", "aten::mm", 10, 5, tid=7),
        _event("cuda_runtime", "cudaLaunchKernel", 11, 1, tid=7, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 1, tid=7, corr=2),
        _event("cpu_op", "aten::item", 300, 400, tid=7),
        _event("cuda_runtime", "cudaLaunchKernel", 710, 1, tid=7, corr=3),
        _event("kernel", "flash_fwd_wgmma_kernel<128>", 20, 50, tid=0, corr=1),
        _event("kernel", "gemm", 60, 40, tid=0, corr=2),     # overlaps
        _event("gpu_memcpy", "Memcpy HtoD", 720, 30, tid=0, corr=3),
        _event("gpu_user_annotation", "bench.moe", 20, 80, tid=0),
    ]
    s = reduce_events(ev, window_s=0.001)
    assert s["busy_s"] == pytest.approx((100 - 20 + 30) * 1e-6)
    assert s["ranges"]["bench.moe"] == pytest.approx(50e-6)
    assert kernel_time(s, "flash_fwd") == (1, pytest.approx(50e-6))
    label, gap = s["breakdown"]["idle_gaps"][0]
    assert gap == pytest.approx(620e-6) and label == "aten::item"
    rec = {"kind": "serve", "trace": s}
    assert reader("idle_share.chat")(rec) == pytest.approx(
        100 * (1 - 110e-6 / 1e-3))
    assert reader("moe_share.chat")(rec) == pytest.approx(
        100 * 50 / 110)
    # a reader that finds nothing to read returns nothing
    assert reader("moe_share.chat")({"kind": "serve", "trace": None}) is None
    assert reader("k1_roofline.train")({"kind": "train", "trace": None}) \
        is None
