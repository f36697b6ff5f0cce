#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel from `ray_tpu_torch/csrc/`, then runs three
phases and fails (non-zero exit, no result line) if any of them fails:

1. kernels: each kernel against its plain PyTorch version at
   Llama-3-8B attention shapes (Hq 32, Hkv 8, D 128, bf16), with the
   tolerance printed; kernel, plain and library times on the card and
   the least time the card could take (the bound).
2. serve: `LLMServer` over the paged engine on Llama-3-8B widths at full
   depth (32 layers, bf16, random weights from a seed), 8 requests of 32
   new tokens (greedy, one temperature/top_p, one streamed). Every
   request must finish with in-vocab tokens, and the launch counters of
   both kernels, zeroed just before, must have grown.
3. parity: at the same widths with 4 layers in fp32 (TF32 off), the
   engine's greedy tokens for 3 prompts must equal a full-recompute
   greedy loop through the plain (no-cache, plain-attention) model.

The second-to-last line is a JSON object listing each kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of JAX or ray_tpu.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# tolerances of kernel vs plain version on the same inputs, bf16. Both
# round O to bf16 (one ulp is 2**-7 of the value at worst), and K1 also
# rounds P to bf16 before P.V as the Pallas kernel does, so K1's output
# may differ by up to two ulps: |err| <= atol + rtol * |plain|. K3 keeps
# P in fp32; the two sum in different orders in fp32.
K1_ATOL_OUT, K1_RTOL_OUT = 1e-2, 1.6e-2
K1_ATOL_LSE = 1e-3      # lse is fp32 in both
K3_ATOL = 2e-2

K1_SHAPES = [(1, 128), (4, 512), (1, 2048)]   # (batch, sequence), causal
K1_RECORD = (1, 2048)                         # shape written to the JSON
K3_LENGTHS = [1, 37, 250, 512, 900, 1333, 1700, 2000]
K3_EARLY_QPOS = (3, 100)                      # (row, qpos < lengths - 1)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, each launch timed alone by CUDA
    events after the 50 MB L2 cache was overwritten (the main path
    finds a layer's inputs cold)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch):
    import torch.nn.functional as F
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(0)
    hq, hkv, d, dt = 32, 8, 128, torch.bfloat16
    rows = []

    k1_err = 0.0
    k1_rec = None
    for b, s in K1_SHAPES:
        q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        within = bool((diff <= K1_ATOL_OUT
                       + K1_RTOL_OUT * ref.float().abs()).all())
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"kernels: K1 flash_fwd B={b} S={s} max_abs_err out={err:.3g} "
              f"(atol {K1_ATOL_OUT} + rtol {K1_RTOL_OUT}: {within}) "
              f"lse={lse_err:.3g} (atol {K1_ATOL_LSE})", flush=True)
        check(within and lse_err <= K1_ATOL_LSE,
              f"K1 disagrees with its plain version at B={b} S={s}")
        k1_err = max(k1_err, err)
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        flops = 4.0 * b * hq * d * (s * (s + 1) / 2)
        nbytes = 2.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d) \
            + 4.0 * b * hq * s
        bms, by = bound_ms(flops, nbytes)
        print(f"kernels: K1 B={b} S={s} kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library (sdpa) {lib:.4f} ms, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        if (b, s) == K1_RECORD:
            k1_rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          library_ms=lib, shape=f"B={b} S={s} Hq={hq} "
                          f"Hkv={hkv} D={d} bf16 causal")
        del q, k, v, out, lse, ref, ref_lse, qt, kt, vt
    rows.append(dict(name="flash_fwd (K1)", route="cuda",
                     source="ray_tpu_torch/csrc/flash_fwd.cu",
                     replaces="ray_tpu/ops/pallas/flash_attention.py:36",
                     max_abs_err=k1_err, **k1_rec))

    ps, n = 16, len(K3_LENGTHS)
    per_seq = -(-2048 // ps)
    n_pages = n * per_seq
    k_flat = torch.randn((n_pages + 1) * ps, hkv, d, device="cuda",
                         generator=gen).to(dt)
    v_flat = torch.randn((n_pages + 1) * ps, hkv, d, device="cuda",
                         generator=gen).to(dt)
    table = torch.randperm(n_pages, device="cuda", generator=gen) \
        .reshape(n, per_seq).to(torch.int32)
    lengths = torch.tensor(K3_LENGTHS, dtype=torch.int32, device="cuda")
    qpos = lengths - 1
    qpos[K3_EARLY_QPOS[0]] = K3_EARLY_QPOS[1]
    q = torch.randn(n, hq, d, device="cuda", generator=gen).to(dt)
    out = pa.paged_decode_attention(q, k_flat, v_flat, table, lengths, ps,
                                    qpos=qpos)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_plain(q, k_flat, v_flat, table, lengths,
                                          ps, qpos=qpos)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"kernels: K3 paged_decode S={n} page_size={ps} lengths="
          f"{K3_LENGTHS} qpos[{K3_EARLY_QPOS[0]}]={K3_EARLY_QPOS[1]} "
          f"max_abs_err={err:.3g} (atol {K3_ATOL})", flush=True)
    check(err <= K3_ATOL, "K3 disagrees with its plain version")
    ms = time_ms(lambda: pa.paged_decode_attention(
        q, k_flat, v_flat, table, lengths, ps, qpos=qpos))
    plain = time_ms(lambda: pa.paged_decode_attention_plain(
        q, k_flat, v_flat, table, lengths, ps, qpos=qpos))
    keys = sum(min(ln, qp + 1) for ln, qp in
               zip(K3_LENGTHS, qpos.tolist()))
    flops = 4.0 * hq * d * keys
    nbytes = (2.0 * keys * hkv * d * 2          # K and V rows read
              + 2.0 * 2 * n * hq * d             # q in, out
              + 4.0 * sum(-(-min(ln, qp + 1) // ps) for ln, qp in
                          zip(K3_LENGTHS, qpos.tolist()))
              + 4.0 * 2 * n)                     # lengths, qpos
    bms, by = bound_ms(flops, nbytes)
    print(f"kernels: K3 kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
          f"none, bound {bms:.4f} ms ({by})", flush=True)
    rows.append(dict(name="paged_decode (K3)", route="cuda",
                     source="ray_tpu_torch/csrc/paged_decode.cu",
                     replaces="ray_tpu/ops/pallas/paged_attention.py:47",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                     bound_by=by, library_ms=None,
                     shape=f"S={n} Hq={hq} Hkv={hkv} D={d} page_size={ps} "
                     f"bf16 keys={keys}"))
    print("kernels: launches in this phase " + json.dumps(
        {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
         "paged_decode (K3)": pa.paged_decode_attention.launches}),
        flush=True)
    return rows


def burst(server, bodies):
    """Send every body at once (one thread each); return the token lists
    in order. Fails if any request fails or does not finish."""
    results = [None] * len(bodies)
    errors = []

    def run(i):
        try:
            if bodies[i].get("stream"):
                results[i] = list(server(bodies[i]))
            else:
                results[i] = server(bodies[i])["tokens"]
        except Exception as e:  # noqa: BLE001  reported below, then fails
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not errors, f"requests failed: {errors}")
    check(all(not t.is_alive() for t in threads), "requests did not finish")
    return results


def profile_burst(torch, server, bodies, gpu_line):
    """The same burst again under torch.profiler: the share of the wall
    time the GPU spent in kernels, and the kernels that took most of it.
    The profiler's own host cost lengthens the wall time, so the busy
    share it shows is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        burst(server, bodies)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    check(busy_us > 0, "the profiler saw no kernel on the GPU")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"serve-profile: wall {wall_us / 1e3:.1f} ms, GPU busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%, a lower "
          f"bound) [{gpu_line}]", flush=True)
    for name, us in top:
        print(f"serve-profile: {us / 1e3:9.2f} ms {100 * us / busy_us:5.1f}% "
              f"of busy  {name[:90]}", flush=True)


def phase_serve(torch, gpu_line):
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMServer

    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    t0 = time.time()
    server = LLMServer(
        lambda: (Llama(cfg, device="cuda", seed=0), None),
        engine_config=dict(max_slots=8, max_seq_len=2048, kv_page_size=16,
                           prefill_buckets=(32, 64, 128, 256, 512, 1024,
                                            2048),
                           max_prefill_batch=4),
        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.engine.model.parameters())
    print(f"serve: Llama-3-8B widths, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f}B params bf16, built in "
          f"{time.time() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(0)
    plens = [20, 30, 100, 200, 400, 700, 1000, 1500]
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in plens]
    bodies = [{"prompt": p, "max_tokens": 32} for p in prompts]
    bodies[2].update(temperature=0.8, top_p=0.9)
    bodies[5]["stream"] = True

    fa.flash_attention_fwd.launches = 0
    pa.paged_decode_attention.launches = 0
    # one short sampled request first: the burst's TTFT then leaves out
    # first-use costs (cuBLAS handles, pinned memory, sampling kernels)
    warm = server({"prompt": prompts[0][:8], "max_tokens": 2,
                   "temperature": 0.8, "top_p": 0.9})["tokens"]
    check(len(warm) == 2, "warm-up request failed")
    server.engine._ttft_samples.clear()
    t_start = time.time()
    results = burst(server, bodies)
    t_end = time.time()
    k1 = fa.flash_attention_fwd.launches
    k3 = pa.paged_decode_attention.launches
    stats = server.stats()
    for i, toks in enumerate(results):
        check(toks is not None and len(toks) == 32,
              f"request {i} returned {None if toks is None else len(toks)} "
              f"tokens, want 32")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {i} has out-of-vocab tokens")
    check(k1 > 0 and k3 > 0,
          f"kernels not launched on the main path: K1 {k1}, K3 {k3}")
    ttft = stats["ttft_breakdown_p50_ms"]["total_ms"]
    n_tok = sum(len(t) for t in results)
    decode_tok_s = (n_tok - len(results)) / (t_end - t_start)
    print(f"serve: {len(results)} requests x 32 tokens, prompts {plens}, "
          f"wall {t_end - t_start:.3f} s, TTFT p50 {ttft} ms (engine, "
          f"burst of 8), decode tokens/s {decode_tok_s:.1f} (tokens after "
          f"each first token / wall), tpot p50 "
          f"{stats.get('tpot_p50_ms')} ms, decode steps "
          f"{stats['decode_steps']}, prefill groups first dispatch ms "
          f"{stats['prefill_first_dispatch_ms']} [{gpu_line}]", flush=True)
    print(f"serve: main-path launches K1 {k1}, K3 {k3} "
          f"(K1: one per layer per prefill group; K3: one per layer per "
          f"decode step)", flush=True)
    profile_burst(torch, server, bodies, gpu_line)
    server.shutdown()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd (K1)": k1, "paged_decode (K3)": k3}


def phase_parity(torch):
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=4, dtype=torch.float32,
                                param_dtype=torch.float32, remat=False)
    model = Llama(cfg, device="cuda", seed=1)
    engine = LLMEngine(model, None, LLMEngineConfig(
        max_slots=4, max_seq_len=2048, kv_page_size=16,
        prefill_buckets=(32, 64, 128, 256)), device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (17, 60, 200)]
    n_new = 16
    try:
        rids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        got = [list(engine.stream(r)) for r in rids]
    finally:
        engine.shutdown()
    want = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(n_new):
                logits, _ = model(torch.tensor([seq], device="cuda"))
                seq.append(int(torch.argmax(logits[0, -1])))
            want.append(seq[len(p):])
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"parity: prompt {i} ({len(prompts[i])} tokens) engine {g} "
              f"plain {w}", flush=True)
    check(got == want, "engine greedy tokens differ from the plain "
                       "full-recompute loop")
    print("parity: ok (fp32, TF32 off, 4 layers of Llama-3-8B widths)",
          flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch", "csrc")):
        fail("run from a checkout of the repository: ray_tpu_torch/ is "
             "missing beside this script")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    gpu_line = smi.stdout.strip().splitlines()[0]
    print(f"gpu: {gpu_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    build.build_all()
    print(f"build: {', '.join(build.sources())} in {time.time() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)

    rows = phase_kernels(torch)
    launches = phase_serve(torch, gpu_line)
    phase_parity(torch)

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows, "gpu": gpu_line}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
