#!/usr/bin/env python3
"""A/B of K4 (ray_tpu_torch/csrc/rmsnorm.cu) on one GPU: the kernel as
built, whose rows of up to 512 16-byte vectors stay in registers (one
read of x), against the same source with that path switched off (every
row takes the two-pass loop, which reads x twice), and against
F.rms_norm, at (4096, 4096) bf16 with an fp32 weight (the library call
gets the weight in bf16).

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/rmsnorm_ab.py

Both variants are built with the port's nvcc flags into
ray_tpu_torch/_build/ab/ and called through their C entry points, so no
Python wrapper runs between the CUDA events. The three alternate, 30
launches each, the L2 cache overwritten and the stream held by a device
spin before each; the first two of each are dropped. Prints the median
and quartiles of each, with the card's name and power limit.
"""
import ctypes
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("rmsnorm_ab: needs a GPU")
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops.kernels import build

    src = open(os.path.join(build.CSRC_DIR, "rmsnorm.cu")).read()
    # switch off every register-held branch of the dispatch
    two_pass = re.sub(r"else if \(per_lane <= (\d+)\)",
                      r"else if (false && per_lane <= \1)", src)
    assert two_pass != src
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, text in (("registers", src), ("two_pass", two_pass)):
        path = os.path.join(out_dir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o",
             lib, path])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            sys.exit(f"rmsnorm_ab: nvcc failed for {name}")
        fn = ctypes.CDLL(lib).rtt_rmsnorm
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    rows = d = 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(d, device="cuda", generator=gen)
    w_bf16 = w.to(torch.bfloat16)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    ref = (x.float() * torch.rsqrt(x.float().square().mean(-1, keepdim=True)
                                   + 1e-6) * w).to(torch.bfloat16)

    def run(name):
        if name == "F.rms_norm":
            F.rms_norm(x, (d,), w_bf16, 1e-6)
            return
        status = fns[name](x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                           d, 1e-6, 1, 0, stream)
        if status:
            raise RuntimeError(f"{name}: CUDA error {status}")

    for name in fns:
        run(name)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        print(f"{name}: max abs err against the plain math {err:.3g}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    names = list(fns) + ["F.rms_norm"]
    times = {n: [] for n in names}
    for it in range(30):
        for name in (names if it % 2 == 0 else names[::-1]):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(name)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for name, t in times.items():
        t = sorted(t[2:])
        print(f"{name}: median {statistics.median(t):.4f} ms, quartiles "
              f"{t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} [{gpu}]")


if __name__ == "__main__":
    main()
