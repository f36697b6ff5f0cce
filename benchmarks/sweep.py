"""The rate sweep that fixed the serving cell's arrival rate. The
benchmark's own runs do not run this.

    python benchmarks/sweep.py --workload mixtral-chat --seed 2400000071 \
        --rates 2,2.5,3,3.5 --seconds 51 --ttft-ms 2000 --itl-ms 150

One process: the cell's model and engine are built and warmed once,
then each rate gets an open-loop window of the cell's mix at that rate
(the first tokens of every due request awaited, the rest aborted, the
engine left to drain). Per rate it prints the share of requests that
met both limits (time to first token, and the request's own mean gap
between tokens), the tails, and whether a backlog grew: requests still
waiting at the close, and the last quarter's median time to first
token against the first quarter's. The knee is the highest rate where
at least 90% met both, with no growing backlog.
"""
import argparse
import json
import sys
import time

import run as entry


def one_rate(engine, cell, seed, rate, seconds, ttft_ms, itl_ms):
    from harness import serve, stats, traffic
    mix = dict(cell.traffic, rate_per_s=rate)
    reqs = traffic.requests(mix, seed, seconds, cell.config["vocab_size"])
    client = serve.Client(engine, reqs, mix, seconds)
    t0 = time.perf_counter()
    client.start(t0)
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    waiting = engine.get_stats()["waiting"]
    client.wait_first_tokens(t0 + seconds + mix["ttft_wait_s"])
    client.close()
    while engine.get_stats()["active"] or engine.get_stats()["waiting"]:
        time.sleep(0.05)
    ttft, ok, gaps = [], 0, []
    for r in client.due_records():
        if r.error is not None or not r.times:
            ttft.append(float("inf"))
            continue
        t = (r.times[0] - r.due) * 1000
        ttft.append(t)
        own = ((r.times[-1] - r.times[0]) * 1000 / (len(r.times) - 1)
               if len(r.times) > 1 else 0.0)
        gaps += [(b - a) * 1000 for a, b in zip(r.times, r.times[1:])
                 if b <= seconds]
        ok += t <= ttft_ms and own <= itl_ms
    q = max(1, len(ttft) // 4)
    return {"rate": rate, "requests": len(ttft), "met_share": ok / len(ttft),
            "ttft_p50_ms": stats.percentile(ttft, 50),
            "ttft_p90_ms": stats.percentile(ttft, 90),
            "itl_p50_ms": stats.percentile(gaps, 50) if gaps else None,
            "itl_p95_ms": stats.percentile(gaps, 95) if gaps else None,
            "waiting_at_close": waiting,
            "ttft_first_quarter_p50_ms": stats.percentile(ttft[:q], 50),
            "ttft_last_quarter_p50_ms": stats.percentile(ttft[-q:], 50)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--ttft-ms", type=float, default=2000.0)
    ap.add_argument("--itl-ms", type=float, default=150.0)
    args = ap.parse_args(argv)
    entry._environment()
    import torch

    from harness import cell as cell_mod
    from harness import serve
    cell = cell_mod.load(entry.ROOT, entry.BENCH, args.workload)
    device = torch.device("cuda", 0)
    model = cell.family.build(cell.config, device, args.seed)
    engine = cell.family.engine(model, cell.config, device, args.seed)
    serve.warm(engine, cell.config, cell.traffic)
    for rate in [float(r) for r in args.rates.split(",")]:
        print(json.dumps(one_rate(engine, cell, args.seed, rate,
                                  args.seconds, args.ttft_ms, args.itl_ms)),
              flush=True)
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
