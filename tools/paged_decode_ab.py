#!/usr/bin/env python3
"""K3 (ray_tpu_torch/csrc/paged_decode.cu) against the size of its key
splits, on one GPU, at `chip_smoke.py`'s timed K3 shape (8 sequences of
Llama-3-8B heads, page 16, a 2048-key table, bf16, 6322 keys).

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/paged_decode_ab.py

For each split size (the wrapper's SPLIT_KEYS, set for the run) it
checks the result against the plain version and prints the median time
of a call as `chip_smoke.time_ms` takes it (L2 overwritten, stream held),
the splits, and the device time of the split kernel and of the merge
under torch.profiler, with the card's name and power limit.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (128, 256, 512, 1024, 2048)


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("paged_decode_ab: needs a GPU")
    import chip_smoke as cs
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    gpu = smi.stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, table, lens, qpos = cs.k3_inputs(
        torch, gen, 32, 8, 128, 16, 2048, torch.bfloat16, cs.K3_LENGTHS,
        dict([cs.K3_EARLY_QPOS]))

    def call():
        return pa.paged_decode_attention(q, k, v, table, lens, 16, qpos=qpos)
    ref = pa.paged_decode_attention_plain(q, k, v, table, lens, 16,
                                          qpos=qpos)
    default = pa.SPLIT_KEYS
    try:
        for split in SPLITS:
            pa.SPLIT_KEYS = split
            err = (call().float() - ref.float()).abs().max().item()
            if err > cs.K3_ATOL:
                sys.exit(f"paged_decode_ab: split {split}: max abs err {err}")
            ms = cs.time_ms(call, iters=30)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            dev = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    dev[e.name] = dev.get(e.name, 0.0) \
                        + e.time_range.elapsed_us() / 10
            kern = {("split" if "decode_kernel" in n else "merge"): us
                    for n, us in dev.items() if "paged_" in n}
            print(f"split_keys {split}: splits "
                  f"{pa.split_plan(table.shape[1], 16)[1]}, {ms:.4f} ms a "
                  f"call; device us a call: " + ", ".join(
                      f"{n} {us:.2f}" for n, us in sorted(kern.items()))
                  + f"; max abs err {err:.3g} [{gpu}]", flush=True)
    finally:
        pa.SPLIT_KEYS = default


if __name__ == "__main__":
    main()
