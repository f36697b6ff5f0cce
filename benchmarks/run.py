"""The benchmark of the PyTorch and CUDA port, one cell per run.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each run is a fresh process. It loads the cell from BENCHMARK.json and
the data files under benchmarks/, makes its inputs and weights from the
seed, warms up, measures for --seconds, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics from a traced slice of the window.

It needs as many CUDA devices as the cell asks for, and exits non-zero
with no result without them, when the port is not in the checkout, or
when JAX or the JAX package was loaded.
"""
import os
import sys
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "nv"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole, so ray_tpu_torch is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _environment() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(BENCH / "_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT)]


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from harness import cell as cell_mod
    from harness import report
    cell = cell_mod.load(ROOT, BENCH, args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 4
    print(f"card: {_power_limit()}", file=sys.stderr)
    runner = cell_mod.runner(cell)
    rec = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that may not run here: {bad}", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips}
    report.emit(report.result(cell, rec, bool(args.trace), device), rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
