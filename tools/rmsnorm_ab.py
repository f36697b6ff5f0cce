#!/usr/bin/env python3
"""A/B of K4 (ray_tpu_torch/csrc/rmsnorm.cu) on one GPU: the kernel as
built, its design variants, the parent's K4 from another checkout, and
F.rms_norm, timed in turns in one process at `chip_smoke.py`'s two K4
timing shapes: x (4096, 4096) bf16 (K4_RECORD's rows) and (8, 4096) bf16
(a decode step's norm), both with an fp32 weight (F.rms_norm gets it in
bf16: it takes no fp32 weight with a bf16 x).

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/rmsnorm_ab.py [--parent PATH/rmsnorm.cu]

`--parent` names another version's rmsnorm.cu (e.g. from a `git
archive` of the parent commit unpacked under the ignored `_archive/`);
it is built with the headers beside it. The variants are this
checkout's source built with the -D values in VARIANTS (add one to A/B
an idea). Everything is built with the port's nvcc flags, one nvcc each,
all at once, into ray_tpu_torch/_build/ab/, and called through its C
entry point, so no Python wrapper runs between the CUDA events. Each
output is checked against the plain math first. Then, 30 times, every
entry runs once (in forward, then reverse order), each launch timed
alone after the L2 cache was overwritten, with the stream held by a
device spin; the first two rounds are dropped. Prints the median and
quartiles of each, and each build's registers and spills, with the
card's name and power limit.
"""
import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4096, 4096), (8, 4096)]
# name -> extra nvcc flags on this checkout's rmsnorm.cu
VARIANTS = {
    "k4": [],
    "bulk_store": ["-DRMSNORM_BULK_STORE=1"],
    "stages2": ["-DRMSNORM_STAGES=2"],
    "stages4": ["-DRMSNORM_STAGES=4"],
    "warps4": ["-DRMSNORM_WARPS=4"],
    "stage16k": ["-DRMSNORM_STAGE_BYTES=16384"],
}
ROUNDS, DROPPED = 30, 2


def build_all(build, parent):
    """{name: (ctypes function, ptxas summary)} for every variant and
    the parent's source."""
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(build.CSRC_DIR, "rmsnorm.cu")
    jobs = [(n, src, flags) for n, flags in VARIANTS.items()]
    if parent:
        jobs.append(("parent", os.path.abspath(parent), []))
    procs = []
    for name, path, flags in jobs:
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
               "-I", os.path.dirname(path), "-o", lib, path]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    fns = {}
    for name, lib, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            sys.exit(f"rmsnorm_ab: nvcc failed for {name}:\n{log[:4000]}")
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", log)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        fn = ctypes.CDLL(lib).rtt_rmsnorm
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = (fn, f"{len(regs)} kernels, at most {max(regs)} "
                         f"registers, spill bytes "
                         f"{sum(int(a) + int(b) for a, b in spills)}")
    return fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another version's rmsnorm.cu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("rmsnorm_ab: needs a GPU")
    from chip_smoke import HOLD_CYCLES, bound_ms, PEAK_FP32_FLOPS
    from ray_tpu_torch.ops.kernels import build

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    fns = build_all(build, args.parent)
    for name, (_, summary) in fns.items():
        print(f"build {name}: {summary}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for rows, d in SHAPES:
        x = torch.randn(rows, d, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = torch.randn(d, device="cuda", generator=gen)
        w_bf16 = w.to(torch.bfloat16)
        y = torch.empty_like(x)
        ref = (x.float() * torch.rsqrt(x.float().square().mean(
            -1, keepdim=True) + 1e-6) * w).to(torch.bfloat16)

        def run(name):
            if name == "F.rms_norm":
                F.rms_norm(x, (d,), w_bf16, 1e-6)
                return
            status = fns[name][0](x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  rows, d, 1e-6, 1, 0, stream)
            if status:
                raise RuntimeError(f"{name}: CUDA error {status}")

        for name in fns:
            y.zero_()
            run(name)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            print(f"x ({rows}, {d}) bf16: {name} max abs err against the "
                  f"plain math {err:.3g}", flush=True)
            if err > 0.1:
                sys.exit(f"rmsnorm_ab: {name} is wrong at ({rows}, {d})")
        names = list(fns) + ["F.rms_norm"]
        times = {n: [] for n in names}
        for it in range(ROUNDS):
            for name in (names if it % 2 == 0 else names[::-1]):
                flush.zero_()
                torch.cuda._sleep(HOLD_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(name)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
        n = rows * d
        bms, by = bound_ms(4.0 * n, n * 2 * 2 + d * 4, PEAK_FP32_FLOPS)
        print(f"x ({rows}, {d}) bf16, weight fp32: bound {bms:.4f} ms ({by})"
              f" [{gpu}]", flush=True)
        for name, t in times.items():
            t = sorted(t[DROPPED:])
            med = statistics.median(t)
            print(f"x ({rows}, {d}) {name}: median {med:.4f} ms, quartiles "
                  f"{t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f}, "
                  f"{100 * bms / med:.1f}% of the bound [{gpu}]", flush=True)
        del x, w, w_bf16, y, ref


if __name__ == "__main__":
    main()
