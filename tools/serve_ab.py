#!/usr/bin/env python3
"""A/B of `chip_smoke.py`'s paged serve burst between checkouts on one
GPU.

Run from anywhere, on a machine with an H100 and nvcc:

    python3 tools/serve_ab.py [--bursts N] TREE [TREE ...]

Each TREE is the root of a checkout (e.g. `.` and a `git archive` of the
parent commit unpacked under the ignored `_archive/`); name trees more
than once to run them in turns (parent, change, change, parent). Each
runs in a process of its own, from its own root and with its own code:
it builds that checkout's kernels, makes Llama-3-8B at full depth (bf16,
random weights from seed 0), and on an `LLMServer` over the paged engine
(`kv_page_size=16`, chip_smoke's buckets) serves one warm-up burst and
then N bursts of chip_smoke's 8 requests of 32 tokens. It prints one
line a burst (TTFT p50 and TPOT p50 from the engine, decode tokens/s:
tokens after each first token over the burst's wall time), then the
median of each metric for each tree over all its bursts, with the
card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

# runs in the tree's root; uses only what every port checkout has
CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from ray_tpu_torch.models import Llama, LlamaConfig
from ray_tpu_torch.ops.kernels import build
from ray_tpu_torch.serve.llm import LLMServer
build.build_all()
cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
model = Llama(cfg, device="cuda", seed=0)
rng = np.random.RandomState(0)
bodies = [{"prompt": rng.randint(0, cfg.vocab_size, n).tolist(),
           "max_tokens": cs.SERVE_NEW} for n in cs.SERVE_PLENS]
bodies[2].update(temperature=0.8, top_p=0.9)
bodies[5]["stream"] = True
server = LLMServer(lambda: (model, None), engine_config=dict(
    max_slots=8, max_seq_len=2048, prefill_buckets=cs.SERVE_BUCKETS,
    max_prefill_batch=4, kv_page_size=16), device="cuda")
cs.burst(server, bodies)
for _ in range(int(sys.argv[1])):
    server.engine._timings.clear()
    server.engine._tpot_samples.clear()
    t0 = time.time()
    res = cs.burst(server, bodies)
    wall = time.time() - t0
    st = server.stats()
    n = sum(len(r) for r in res)
    print("RESULT " + json.dumps({
        "ttft_ms": st["ttft_breakdown_p50_ms"]["total_ms"],
        "tpot_ms": st["tpot_p50_ms"], "tok_s": (n - len(res)) / wall}),
        flush=True)
server.shutdown()
"""
METRICS = ("ttft_ms", "tpot_ms", "tok_s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bursts", type=int, default=5)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    results = {}
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", CHILD, str(args.bursts)],
                              cwd=root, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            sys.exit(f"serve_ab: {tree} failed:\n{proc.stderr[-4000:]}")
        runs = [json.loads(line[len("RESULT "):])
                for line in proc.stdout.splitlines()
                if line.startswith("RESULT ")]
        for r in runs:
            print(f"serve_ab: turn {i} {tree}: TTFT p50 {r['ttft_ms']} ms, "
                  f"TPOT p50 {r['tpot_ms']} ms, decode tokens/s "
                  f"{r['tok_s']:.1f} [{gpu}]", flush=True)
        results.setdefault(tree, []).extend(runs)
    for tree, runs in results.items():
        med = {m: statistics.median(r[m] for r in runs) for m in METRICS}
        print(f"serve_ab: {tree}: median of {len(runs)} bursts: TTFT p50 "
              f"{med['ttft_ms']} ms, TPOT p50 {med['tpot_ms']} ms, decode "
              f"tokens/s {med['tok_s']:.1f} [{gpu}]", flush=True)


if __name__ == "__main__":
    main()
