"""Adding a configuration, a traffic mix, a per-layer metric and a cell
takes new files and new entries only: in a temporary copy of the
benchmark, dummies of each are added as files, and the harness of that
copy finds and runs them on the CPU at debug widths, in a process that
then holds no JAX. The dummy mixes take other numbers, bursty arrivals,
a closed loop, and a runner of a file of its own."""
import json
import subprocess
import sys

import cpu_cells

METRIC = '''"""Prefills the engine ran in the window (a dummy metric)."""


def read(rec):
    return rec.get("counters", {}).get("prefills")
'''


RUNNER = '''"""A runner that reports what its mix asked for (a dummy)."""
from harness import serve


def run(cell, seed, seconds, trace, device, t_start):
    rec = serve.run(cell, seed, seconds, trace, device, t_start)
    rec["counters"]["prefills"] = -1
    return rec
'''

MIXES = {
    "burst-cell": {"arrivals": {"law": "gamma", "cv": 3.0}},
    "closed-cell": {"arrivals": {"law": "closed", "clients": 2,
                                 "requests": 400}},
    "runner-cell": {"kind": "echo"},
}


def test_new_files_add_a_cell(tmp_path):
    root = cpu_cells.make_root(tmp_path)
    bench_dir = root / "benchmarks"
    cfg = cpu_cells.debug_configs()["mixtral-debug"]
    cfg["num_hidden_layers"] = 3
    (bench_dir / "configs" / "mixtral-dummy.json").write_text(json.dumps(cfg))
    mix = dict(cpu_cells.DEBUG_TRAFFIC["chat-debug"], rate_per_s=3.0,
               output_len={"dist": "fixed", "value": 6})
    (bench_dir / "traffic" / "chat-dummy.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "prefills.dummy.py").write_text(METRIC)
    (bench_dir / "harness" / "echo.py").write_text(RUNNER)
    cells = ["dummy-cell", *MIXES]
    for name in cells:
        (bench_dir / "checks" / f"{name}.json").write_text(
            json.dumps(cpu_cells.DEBUG_CHECKS["chat-debug"]))
    for name, extra in MIXES.items():
        (bench_dir / "traffic" / f"{name}.json").write_text(
            json.dumps(dict(mix, **extra)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mixtral-dummy", "source": "debug",
                             "file": "benchmarks/configs/mixtral-dummy.json",
                             "reduced": [], "why": "dummy"})
    for name in cells:
        bench["workloads"].append({
            "name": name, "config": "mixtral-dummy", "chips": 1,
            "traffic": "chat-dummy" if name == "dummy-cell" else name,
            "why": "dummy"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mixtral-chat" in m["workloads"]:
            m["workloads"].extend(cells)
    bench["per_layer"].append({
        "name": "prefills.dummy", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "engine host loop",
        "moves": "ttft_p90_ms", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = f"""
import json, sys
sys.path[:0] = [{str(bench_dir / 'tests')!r}, {str(bench_dir)!r}]
import cpu_cells, run
out0, _ = cpu_cells.run_cell(cpu_cells.Path({str(root)!r}), "dummy-cell",
                             seconds=3.0, trace=False)
out1, _ = cpu_cells.run_cell(cpu_cells.Path({str(root)!r}), "dummy-cell",
                             seconds=3.0, trace=True)
more = {{}}
for name in {list(MIXES)!r}:
    out, rec = cpu_cells.run_cell(cpu_cells.Path({str(root)!r}), name,
                                  seconds=3.0, trace=False)
    more[name] = [out, [(r["due"], r["sent"], r["times"][-1])
                         for r in rec["requests"]],
                  rec["counters"]["prefills"]]
print(json.dumps([out0, out1, run.forbidden_modules(),
                  sys.modules["harness"].__file__, more]))
"""
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out0, out1, bad, harness_file, more = json.loads(
        p.stdout.splitlines()[-1])
    assert harness_file.startswith(str(bench_dir))
    assert set(out0["metrics"]) == {"ttft_p90_ms", "itl_p95_ms", "setup_s"}
    assert out0["attempted"] == 9 and out0["correct"]
    assert out1["metrics"]["prefills.dummy"]["value"] > 0
    assert bad == []
    for name, (out, sends, prefills) in more.items():
        assert out["correct"] and out["failed"] == 0, name
        assert set(out["metrics"]) == {"ttft_p90_ms", "itl_p95_ms",
                                       "setup_s"}, name
    assert more["burst-cell"][0]["attempted"] == 9
    # the closed loop sends while the window is open, a request due when
    # it is sent, never more than its clients at once
    closed = more["closed-cell"][1]
    assert 2 <= len(closed) < 400
    assert all(due == sent and due < 3.0 for due, sent, _ in closed)
    assert all(sum(s <= t < end for _, s, end in closed) <= 2
               for _, t, _ in closed)
    assert more["runner-cell"][2] == -1
