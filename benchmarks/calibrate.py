"""Readings that the limits of the comparison deciding `correct` are set
from. The benchmark's own runs do not run this.

    python benchmarks/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--what program,control,half,altered]

Serving cell, per seed: a window at the cell's own load in which every
due request is waited for to its end, then, over the same sample of
finished requests, the reference's readings of the program's served tokens
(`program`) and of the tokens the float8 control puts first
(`control`) or the reference with bf16 operands puts first (`bf16`, a
witness of what bf16 rounding alone costs): every reading
`serve.readings` gives. Each of `faults.SERVE` (`half`, `altered`) gets
a window of its own with the fault planted, and the program's readings.
Training cell, per seed: the program's readings of its checked first
steps against the float32 reference (`program`), the float8
reference's (`control`), and the program's under each of
`faults.TRAIN` (`half`). One JSON line per seed and reading; all in one
process.
"""
import argparse
import gc
import json
import sys
import time

import faults
import run as entry


def _free(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def serve_readings(cell, seed, seconds, what, device):
    from harness import serve
    out = {}
    levels = {"program": False, "control": True, "bf16": "bf16"}
    plain = [k for k in what if k in levels]
    if plain:
        _, served = serve.window(cell, seed, seconds, False, device,
                                 time.perf_counter(), finish=True)
        _free(device)
        out["requests"] = len(served)
        for kind in plain:
            out[kind] = serve.readings(cell, seed, served, device,
                                       control=levels[kind])
            _free(device)
    for kind in [k for k in what if k in faults.SERVE]:
        with faults.SERVE[kind]():
            _, served = serve.window(cell, seed, seconds, False, device,
                                     time.perf_counter(), finish=True)
        _free(device)
        out[kind] = serve.readings(cell, seed, served, device)
        _free(device)
    return out


def train_readings(cell, seed, what, device):
    import contextlib

    import torch

    from harness import traffic, train
    cfg, opt = cell.config, cell.config["train"]["optimizer"]
    out = {}
    batches = []
    for kind in [k for k in what if k == "program" or k in faults.TRAIN]:
        fault = faults.TRAIN.get(kind, contextlib.nullcontext)
        with fault():
            _, (losses, grads, change, kept) = train.window(
                cell, seed, 0.5, False, device, time.perf_counter())
        _free(device)
        batches = [torch.from_numpy(k[0]) for k in kept]
        out[kind] = (losses, grads, change)
    if not batches:
        gen = traffic.lm_batches(cell.traffic, seed, cfg["vocab_size"])
        batches = [torch.from_numpy(next(gen)["tokens"][0])
                   for _ in range(cell.traffic["checked_steps"])]
    reference = cell.reference.train(cfg, opt, seed, batches, device)
    _free(device)
    if "control" in what:
        c = cell.reference.train(cfg, opt, seed, batches, device,
                                 control=True)
        out["control"] = (c["losses"], c["first_grad"], c["change"])
        _free(device)
    return {k: train.compare(*r, reference) for k, r in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    entry._environment()
    import torch

    from harness import cell as cell_mod
    cell = cell_mod.load(entry.ROOT, entry.BENCH, args.workload)
    device = torch.device(args.device)
    what = args.what.split(",")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            r = serve_readings(cell, seed, args.seconds, what, device)
        else:
            r = train_readings(cell, seed, what, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
