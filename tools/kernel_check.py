#!/usr/bin/env python3
"""Build the port's CUDA kernels and hold each against its plain version
on the GPU: the build, register/spill check and kernels phase of
`chip_smoke.py` alone, without its serve and train phases. The quick
check after a kernel edit; `chip_smoke.py` stays the whole proof.

Run from the root of a checkout on a machine with a GPU and nvcc:

    python3 tools/kernel_check.py

Exits non-zero if a kernel does not build, spills registers, or
disagrees with its plain version; prints each kernel's times as
`chip_smoke.py` does.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_check: torch.cuda.is_available() is false")
    import chip_smoke
    from ray_tpu_torch.ops.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(f"gpu: {smi.stdout.strip()}", flush=True)
    t0 = time.time()
    build.build_all()
    print(f"build: {', '.join(build.sources())} in {time.time() - t0:.1f} s",
          flush=True)
    chip_smoke.check_spills(build)
    rows = chip_smoke.phase_kernels(torch)
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
