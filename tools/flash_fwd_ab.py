#!/usr/bin/env python3
"""A/B of K1's wgmma kernel (ray_tpu_torch/csrc/flash_fwd.cu) on one GPU:
the source as built against variants made from it by text substitution
(VARIANTS), and against SDPA, at B=1 and B=2, S=2048, Hq=32, Hkv=8,
D=128, bf16, causal (chip_smoke.py's timed shape and the train phase's).

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/flash_fwd_ab.py

Every variant is built with the port's nvcc flags into
ray_tpu_torch/_build/ab/ (ptxas's performance advisories, such as
C7514, wgmma serialised, are printed) and called through its C entry
point, so no Python wrapper runs between the CUDA events; each is first
held against flash_attention_plain. They alternate with SDPA, 30
launches each, the L2 cache overwritten and the stream held by a device
spin before each; the first two of each are dropped. Prints the median
and quartiles of each (and TFLOP/s), with the card's name and power
limit.
"""
import ctypes
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 2048), (2, 2048)]   # (batch, sequence)
HQ, HKV, D = 32, 8, 128
# no overlap of the softmax with the P.V product
SERIAL = ("rtt::wgmma_wait<1>();   // S_n is done, P.V may still run",
          "rtt::wgmma_wait<0>();")
VARIANTS = [("as built", []), ("serial", [SERIAL])]


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_ab: needs a GPU")
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops.kernels import build
    from ray_tpu_torch.ops.kernels import flash_attention as fa

    src = open(os.path.join(build.CSRC_DIR, "flash_fwd.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, subs in VARIANTS:
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"flash_fwd_ab: {name}: {old!r} not in the source")
            text = text.replace(old, new)
        stem = name.replace(" ", "_").replace(",", "")
        path = os.path.join(out_dir, f"flash_fwd_{stem}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libflash_fwd_{stem}.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    fns = {}
    for name, lib, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        advice = sorted({m.group(0) for m in re.finditer(
            r"\(C75\d\d\)[^'\n]*", log)})
        print(f"build {name}: ptxas advisories {advice or 'none'}",
              flush=True)
        if proc.returncode != 0:
            sys.exit(f"flash_fwd_ab: nvcc failed for {name}:\n{log[:3000]}")
        fn = ctypes.CDLL(lib).rtt_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for b, s in SHAPES:
        q = torch.randn(b, s, HQ, D, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, s, HKV, D, device="cuda", generator=gen).bfloat16()
        v = torch.randn(b, s, HKV, D, device="cuda", generator=gen).bfloat16()
        out = torch.empty_like(q)
        lse = torch.empty(b * HQ, s, device="cuda")
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def run(name):
            if name == "sdpa":
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
                return
            status = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), b, s, s, HQ,
                               HKV, D, 1, D ** -0.5, 1, stream)
            if status:
                raise RuntimeError(f"{name}: CUDA error {status}")

        for name in fns:
            run(name)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            ok = bool((diff <= 1e-2 + 1.6e-2 * ref.float().abs()).all()) \
                and (lse - ref_lse).abs().max().item() <= 1e-3
            print(f"B={b} S={s} {name}: max abs err {diff.max().item():.3g} "
                  f"(atol 1e-2 + rtol 1.6e-2, lse atol 1e-3: {ok})",
                  flush=True)
            if not ok:
                sys.exit(f"flash_fwd_ab: {name} disagrees with the plain "
                         f"version")
        names = list(fns) + ["sdpa"]
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
        flops = 4.0 * b * HQ * D * (s * (s + 1) / 2)
        for name, t in times.items():
            t = sorted(t[2:])
            med = statistics.median(t)
            print(f"B={b} S={s} {name}: median {med:.4f} ms "
                  f"({flops / (med * 1e-3) / 1e12:.1f} TFLOP/s), quartiles "
                  f"{t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} [{gpu}]",
                  flush=True)


if __name__ == "__main__":
    main()
