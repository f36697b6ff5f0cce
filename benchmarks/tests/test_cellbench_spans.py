"""The readings of the program's own spans and counters: each span's
host time and the device's idle time inside it on a hand-built event
list, the serving path's operation and byte counts against hand
counts, each new chat reader on a hand-built record (and nothing from a
program that keeps no counters or spans), and a traced run of the
debug chat cell on the CPU, where the counters are read."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

import cpu_cells  # noqa: F401
from harness import program, roofline, serve_roofline, spans
from harness.cell import _reader

BENCH = Path(__file__).resolve().parents[1]
MIXTRAL = json.loads((BENCH / "configs" / "mixtral-8x7b-s16.json")
                     .read_text())
NEW = ("moe_experts_share.chat", "moe_routing_share.chat",
       "moe_row_use.chat", "attention_share.chat", "k1_roofline.chat",
       "k3_roofline.chat", "mfu.chat")


def _event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {}}


def test_host_spans_and_idle_under():
    """Host operations from 0 to 120 us make the slice; device busy [10,
    30] and [60, 100]: idle [0, 10], [30, 60], [100, 120]. A decode span
    [0, 50] holds 10 + 20 us of it, a drain span [50, 110] 10 + 10, the
    step around both 60; two instances of one name are counted twice,
    their time once. A decode span still open at the capture's stop
    (from 110 to 400) is cut at the slice's end."""
    ev = [
        _event("user_annotation", "llm.step", 0, 120),
        _event("user_annotation", "llm.decode", 0, 50),
        _event("user_annotation", "llm.drain", 50, 60),
        _event("user_annotation", "llm.emit", 102, 5),
        _event("user_annotation", "llm.emit", 104, 4),
        _event("user_annotation", "llm.decode", 110, 290),
        _event("cpu_op", "aten::mm", 0, 12),
        _event("cpu_op", "aten::item", 100, 20),
        _event("kernel", "gemm", 10, 15, tid=0),
        _event("kernel", "gemm", 20, 10, tid=0),          # overlaps
        _event("gpu_memcpy", "Memcpy DtoH", 60, 40, tid=0),
    ]
    assert spans.extent(ev) == (0, 120)
    assert spans.idle(ev) == [[0, 10], [30, 60], [100, 120]]
    under = spans.idle_under(ev)
    assert under["llm.step"] == pytest.approx(60e-6)
    assert under["llm.decode"] == pytest.approx(30e-6 + 10e-6)
    assert under["llm.drain"] == pytest.approx(20e-6)
    assert under["llm.emit"] == pytest.approx(6e-6)
    assert "aten::mm" not in under
    host = spans.host_spans(ev)
    assert host["llm.emit"] == [2, pytest.approx(6e-6)]
    assert host["llm.decode"] == [2, pytest.approx(60e-6)]
    assert host["llm.step"] == [1, pytest.approx(120e-6)]
    assert spans.idle_under([]) == {} and spans.idle([]) == []


def test_serving_counts_at_the_chat_cell():
    d, hd, ff = 4096, 128, 14336
    per_layer = d * hd * (2 * 32 + 2 * 8) + d * 8 + 2 * 3 * d * ff
    active = 16 * per_layer + 32000 * d
    assert serve_roofline.moe_active_params(MIXTRAL) == active \
        == 6_439_829_504
    flops, nbytes = serve_roofline.k3_cost(1000, 32, 8, 128)
    assert flops == 4 * 1000 * 32 * 128 and nbytes == 2 * 2 * 1000 * 8 * 128
    # K3 is bound by its bytes at 4 query heads a kv head
    assert nbytes / roofline.PEAK_BYTES > flops / roofline.PEAK_BF16_FLOPS
    counts = {"llm.prefill_tokens": 1000, "llm.prefill_pairs": 500500,
              "llm.decode_tokens": 64, "llm.decode_keys": 64 * 1500}
    assert serve_roofline.serve_flops(MIXTRAL, counts) == pytest.approx(
        2 * active * 1064 + 4 * d * 16 * (500500 + 96000))


def _chat_rec(flash_s, decode_s):
    return {"kind": "serve", "config": MIXTRAL, "trace": {
        "window_s": 2.0, "busy_s": 1.0,
        "ranges": {"moe.experts": 0.6, "moe.route": 0.03,
                   "moe.dispatch": 0.02, "moe.combine": 0.04, "moe.aux": 0.01,
                   "attn": 0.1, "bench.moe": 0.7},
        "kernels": {"void flash_fwd_wgmma_kernel<128>": [32, flash_s],
                    "void paged_decode_kernel<bf16, 128>": [160, decode_s],
                    "void paged_merge_kernel<128>": [16, decode_s / 4]}}}


def test_new_chat_readers(monkeypatch):
    counts = {"k1.launch:2,1024,32,8,128,1": 16,
              "k1.launch:1,2048,32,8,128,1": 16,
              "llm.prefill_tokens": 2900, "llm.prefill_pairs": 2_500_000,
              "llm.decode_tokens": 640, "llm.decode_keys": 960_000,
              "moe.rows_computed": 16 * 8 * (2 * 1024 + 2048 + 10 * 65)}
    monkeypatch.setattr(program, "counters", lambda: dict(counts))
    k1 = 16 * roofline.bound_s(*roofline.k1_cost(2, 1024, 32, 8, 128)) \
        + 16 * roofline.bound_s(*roofline.k1_cost(1, 2048, 32, 8, 128))
    k3 = roofline.bound_s(*serve_roofline.k3_cost(960_000 * 16, 32, 8, 128))
    rec = _chat_rec(flash_s=4 * k1, decode_s=4 * k3)
    got = {n: _reader(BENCH, n)(rec) for n in NEW}
    assert got["moe_experts_share.chat"] == pytest.approx(60.0)
    assert got["moe_routing_share.chat"] == pytest.approx(10.0)
    assert got["attention_share.chat"] == pytest.approx(10.0)
    assert got["k1_roofline.chat"] == pytest.approx(25.0)
    assert got["k3_roofline.chat"] == pytest.approx(20.0)
    assert got["moe_row_use.chat"] == pytest.approx(
        100 * 2 * 16 * 3540 / counts["moe.rows_computed"])
    assert got["mfu.chat"] == pytest.approx(
        100 * serve_roofline.serve_flops(MIXTRAL, counts) / 2.0 / 989e12)
    assert all(0 < v < 100 for v in got.values())


def test_nothing_to_read_gives_nothing(monkeypatch):
    """A program without the spans and counters (the parent of the
    change that added them) reads nothing, and raises nothing."""
    rec = _chat_rec(flash_s=1.0, decode_s=1.0)
    rec["trace"]["ranges"] = {"bench.moe": 0.7}
    monkeypatch.setattr(program, "counters", lambda: None)
    assert {n: _reader(BENCH, n)(rec) for n in NEW} == dict.fromkeys(NEW)
    untraced = dict(rec, trace=None)
    assert {n: _reader(BENCH, n)(untraced) for n in NEW} == dict.fromkeys(NEW)


def test_counters_of_a_traced_debug_chat_run(tmp_path):
    """The debug chat cell traced on the CPU: the program counted its
    slice's work, so the counter readers read; the device shares have
    no device operations to read there."""
    root = cpu_cells.make_root(tmp_path)
    script = f"""
import json, sys
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(root / 'benchmarks')!r}]
import cpu_cells
from harness import program
out, rec = cpu_cells.run_cell(cpu_cells.Path({str(root)!r}), "chat-debug",
                              seconds=3.0, trace=True)
print(json.dumps([out, program.counters()]))
"""
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out, counts = json.loads(p.stdout.splitlines()[-1])
    assert counts["llm.decode_tokens"] > 0 and counts["moe.rows_computed"]
    metrics = out["metrics"]
    assert 0 < metrics["moe_row_use.chat"]["value"] <= 100
    assert metrics["mfu.chat"]["value"] > 0
