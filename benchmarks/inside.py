"""What the program's own spans, counters and request timings say about
a serving cell's traced run: the readings that the harness's reduction
(`harness/trace.py`) and serving runner (`harness/serve.py`) do not yet
hand to the metric readers. The benchmark's own runs do not run this.

    python benchmarks/inside.py --workload mixtral-chat --seed <n> \
        --seconds 51

One run of the cell with --trace 1, as `run.py` makes it (its result
line, every per-layer metric in it), and after it one more JSON line:
  * `idle_under`: the device's idle seconds inside each span's
    instances (`harness/spans.py`), and `idle_launch_share`, the part
    inside `llm.decode`, `llm.prefill` or `llm.chunk` as a % of the
    slice, against the rest of the engine's loop;
  * `host_spans`: each span's instances and host seconds, and
    `decode_dispatch_ms`, `llm.decode`'s host time over its instances;
  * `decode_steps_per_s`: inside the traced slice (`llm.decode`
    instances) against the counted part before it (`get_stats()`), on
    one run: what tracing costs when it is on;
  * `k1_launches`: the slice's `flash_fwd` kernels against the
    program's `k1.launch:*` counts;
  * `extent_s`: the time the slice's host operations, spans and device
    operations cover on the profiler's clock, beside `window_s`;
  * from the engine's `request_timings()`, over the requests submitted
    in the counted part of the window: p50 and p90 of the queue wait
    (admit - submit) and of the first token's lag behind its prefill
    dispatch (first_token - prefill_end), in ms.
It keeps the slice's events and the engine by wrapping, in its own
process, `harness.trace.reduce_events` and the family's `engine`.
`--dump PATH` writes the slice's events, cut to what the readings use
(gzipped JSON: cat, name, ts, dur, tid, correlation).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as entry  # noqa: E402

LAUNCH = ("llm.decode", "llm.prefill", "llm.chunk")
LOOP = ("llm.admit", "llm.publish", "llm.drain", "llm.fetch_wait",
        "llm.emit")


def _tails(xs):
    from harness import stats
    if not xs:
        return None
    return {"n": len(xs), "p50": stats.percentile(xs, 50),
            "p90": stats.percentile(xs, 90)}


def _extent(events, cats):
    xs = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
          for e in events if e.get("ph") == "X"
          and str(e.get("cat", "")).lower() in cats]
    return (max(b for _, b in xs) - min(a for a, _ in xs)) * 1e-6 \
        if xs else 0.0


def inside(rec, events, engine, t_start):
    from harness import program, spans
    from harness.trace import DEVICE_CATS, kernel_time
    t = rec["trace"]
    window = t["window_s"]
    host = spans.host_spans(events)
    under = spans.idle_under(events)
    idle_s = window - t["busy_s"]
    launch = sum(under.get(s, 0.0) for s in LAUNCH)
    step = under.get("llm.step", 0.0)
    split = {"launch_s": launch,
             **{s: under.get(s, 0.0) for s in LOOP},
             "llm.step_outside_children_s": step - launch - sum(
                 under.get(s, 0.0) for s in ("llm.admit", "llm.publish",
                                             "llm.drain")),
             "outside_llm.step_s": sum(
                 e - s for s, e in spans.idle(events)) * 1e-6 - step}
    decodes = host.get("llm.decode", [0, 0.0])
    layers = rec["config"]["num_hidden_layers"]
    counts = program.counters() or {}
    t0 = t_start + rec["setup_s"]
    # a program without request timings (before they were added) gives
    # none
    timings = getattr(engine, "request_timings", list)()
    timed = [x for x in timings
             if 0.0 <= x["submit"] - t0 < rec["counted_s"]]
    return {
        "idle_s": idle_s, "idle_launch_share": 100.0 * launch / window,
        "idle_split": split, "idle_under": under, "host_spans": host,
        "decode_dispatch_ms": (1000.0 * decodes[1] / decodes[0]
                               if decodes[0] else None),
        "window_s": window,
        "extent_s": {"host_ops": _extent(events, ("cpu_op",)),
                     "spans": _extent(events, ("user_annotation",)),
                     "device": _extent(events, DEVICE_CATS)},
        "decode_steps_per_s": {
            "slice": decodes[0] / window,
            "slice_k3": kernel_time(t, "paged_decode_kernel")[0]
            / layers / window,
            "counted": rec["counters"]["decode_steps"] / rec["counted_s"]},
        "k1_launches": {
            "flash_fwd_kernels": kernel_time(t, "flash_fwd")[0],
            "counted": sum(n for n, _ in program.k1_launches(counts))},
        "counters": counts,
        "queue_wait_ms": _tails([1000.0 * (x["admit"] - x["submit"])
                                 for x in timed]),
        "first_token_lag_ms": _tails(
            [1000.0 * (x["first_token"] - x["prefill_end"])
             for x in timed]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    entry._environment()
    import torch

    from harness import cell as cell_mod
    from harness import report
    from harness import trace as trace_mod
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    kept = {}
    reduce = trace_mod.reduce_events

    def keep_events(events, window_s):
        kept["events"] = events
        return reduce(events, window_s)

    trace_mod.reduce_events = keep_events
    cell = cell_mod.load(entry.ROOT, entry.BENCH, args.workload)
    fam = cell.family
    make = fam.engine

    def keep_engine(*a, **kw):
        kept["engine"] = make(*a, **kw)
        return kept["engine"]

    fam.engine = keep_engine
    rec = cell_mod.runner(cell).run(cell, args.seed, args.seconds, True,
                                    torch.device("cuda", 0), T_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips}
    report.emit(report.result(cell, rec, True, device), rec)
    if "events" not in kept:
        print("the traced slice did not complete", file=sys.stderr)
        return 6
    print("inside: " + json.dumps(inside(rec, kept["events"], kept["engine"],
                                         T_START)), flush=True)
    if args.dump:
        with gzip.open(args.dump, "wt") as f:
            json.dump([[e.get("cat"), str(e.get("name"))[:80], e.get("ts"),
                        e.get("dur"), e.get("tid"),
                        e.get("args", {}).get("correlation")]
                       for e in kept["events"] if e.get("ph") == "X"], f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
