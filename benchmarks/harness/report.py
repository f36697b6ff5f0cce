"""The run's result: metrics read by the cell's readers, the device,
and the numbers the correctness check compared, each beside its limit.
The last line on standard output is the result's JSON; the lines before
it give the sample counts behind each percentile and how late the open
loop ran. The last lines on standard error repeat the compared numbers.
"""
from __future__ import annotations

import json
import math
import sys
from typing import Dict

from harness import stats


def result(cell, rec: Dict, trace: bool, device: Dict) -> Dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(rec)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    if rec["kind"] == "serve":
        attempted = len(rec["requests"])
        failed = sum(1 for r in rec["requests"] if r["failed"])
    else:
        attempted, failed = rec["steps"], 0
    dev = dict(device, memory_peak_bytes=int(rec["memory_peak_bytes"]))
    out = {"correct": bool(rec["correct"]), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    # a reading that could not be taken (no finished request) is null:
    # JSON has no infinity
    out["checked"] = {k: {n: (x if not isinstance(x, float) or
                              math.isfinite(x) else None)
                          for n, x in v.items()}
                      for k, v in rec["checked"].items()}
    return out


def notes(rec: Dict):
    """Lines that go before the result: sample counts and lateness."""
    if "setup_parts" in rec:
        yield "set-up parts (s): " + json.dumps(rec["setup_parts"])
    if rec["kind"] != "serve":
        yield (f"steps in window: {rec['steps']} over {rec['window_s']:.6f} s"
               f"; set-up {rec['setup_s']:.6f} s")
        return
    reqs = rec["requests"]
    late = [r["sent"] - r["due"] for r in reqs if r["sent"] is not None]
    if late:
        yield (f"open loop lateness: median {stats.percentile(late, 50):.6f}"
               f" s, p99 {stats.percentile(late, 99):.6f} s, max "
               f"{max(late):.6f} s over {len(late)} sends")
    w = rec["window_s"]
    gaps = [(b - a) * 1000 for r in reqs
            for a, b in zip(r["times"], r["times"][1:]) if b <= w]
    own = [(t[-1] - t[0]) * 1000 / (len(t) - 1) for t in
           ([x for x in r["times"] if x <= w] for r in reqs) if len(t) > 1]
    yield (f"samples: {len(reqs)} requests due for ttft, "
           f"{sum(r['failed'] for r in reqs)} of them missing; "
           f"{len(gaps)} token gaps in the window; {len(own)} requests "
           f"with a gap in it")
    if gaps and own:
        pick = {f"gap_p{p}": stats.percentile(gaps, p)
                for p in (50, 90, 95, 99, 99.9)}
        pick.update({f"request_mean_gap_p{p}": stats.percentile(own, p)
                     for p in (50, 90, 95)})
        yield "gap percentiles (ms): " + json.dumps(pick)
    yield f"engine counters over the window: {json.dumps(rec['counters'])}"


def emit(out: Dict, rec: Dict) -> None:
    for line in notes(rec):
        print(line)
    if "check_detail" in rec:
        print(f"correctness readings: {json.dumps(rec['check_detail'])}")
    for name, v in out["checked"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
