"""Cells at debug widths for runs on the CPU: the two cells' shapes and
recipes with every size cut down, written with the data files into a
temporary copy of the benchmark, and a run of one cell in this process
on the CPU, past the harness's look for a chip."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def debug_configs():
    mixtral = json.loads((BENCH / "configs" / "mixtral-8x7b-s16.json")
                         .read_text())
    mixtral.update(hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2,
                   num_local_experts=4, num_hidden_layers=2, vocab_size=256,
                   max_position_embeddings=512)
    mixtral["serve"]["engine"].update(
        max_slots=4, max_seq_len=160, kv_page_size=4, kv_pool_tokens=1024,
        prefill_buckets=[16, 32, 64, 128], max_prefill_batch=2,
        max_new_tokens_default=32)
    mixtral["serve"]["capacity_factor"] = 2.0   # E / k: dropless
    # float32 at debug widths: an unbroken run reads ~0 and every fault
    # reads far above the debug limit
    mixtral["weights"] = {"dtype": "float32", "norm_dtype": "float32",
                          "compute_dtype": "float32"}
    mistral = json.loads((BENCH / "configs" / "mistral-7b-s16.json")
                         .read_text())
    mistral.update(hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2,
                   num_hidden_layers=2, vocab_size=256,
                   max_position_embeddings=512)
    return {"mixtral-debug": mixtral, "mistral-debug": mistral}


DEBUG_TRAFFIC = {
    "chat-debug": {
        "kind": "serve", "rate_per_s": 6.0, "shape_seed": 7,
        "prompt_len": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                       "min": 8, "max": 120},
        "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.6,
                       "min": 2, "max": 24},
        "ttft_wait_s": 60, "trace_seconds": 1, "check_requests": 4},
    "pretrain-debug": {"kind": "train", "batch": 1, "seq_len": 64,
                       "checked_steps": 3, "trace_seconds": 1},
}

DEBUG_CHECKS = {
    "chat-debug": {"limits": {"mean_logit_gap": 0.01}},
    "pretrain-debug": {"limits": {"grad_gap": 0.01, "step_gap": 0.05}},
}


def make_root(tmp: Path) -> Path:
    """A checkout-like directory: the benchmark copied, BENCHMARK.json
    with the debug cells added, their data files beside the others."""
    shutil.copytree(BENCH, tmp / "benchmarks",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in debug_configs().items():
        path = f"benchmarks/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "debug",
                                 "file": path, "reduced": [], "why": "debug"})
    for name, mix in DEBUG_TRAFFIC.items():
        (tmp / "benchmarks" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    cells = [("chat-debug", "mixtral-debug", "chat-debug"),
             ("pretrain-debug", "mistral-debug", "pretrain-debug")]
    for cell, cfg, mix in cells:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "debug"})
        (tmp / "benchmarks" / "checks" / f"{cell}.json").write_text(
            json.dumps(DEBUG_CHECKS[cell]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            like = "chat-debug" if any("chat" in w for w in m["workloads"]) \
                else "pretrain-debug"
            m["workloads"].append(like)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def run_cell(root: Path, workload: str, seed: int = 1234567,
             seconds: float = 4.0, trace: bool = False):
    """One run on the CPU: (result dict, run record)."""
    import torch

    from harness import cell as cell_mod
    from harness import report
    t_start = time.perf_counter()
    cell = cell_mod.load(root, root / "benchmarks", workload)
    rec = cell_mod.runner(cell).run(cell, seed, seconds, trace,
                                    torch.device("cpu"), t_start)
    out = report.result(cell, rec, trace, {"platform": "cpu", "kind": "cpu",
                                           "count": 1})
    return out, rec
