#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel from `ray_tpu_torch/csrc/`, then runs six
phases and fails (non-zero exit, no result line) if any of them fails:

1. kernels: each kernel against its plain PyTorch version at
   Llama-3-8B attention shapes (Hq 32, Hkv 8, D 128, bf16; K2a/K2b also
   fp32 at D 64), with the tolerance printed; kernel, plain and library
   times on the card and the least time the card could take (the bound).
2. serve: `LLMServer` over the paged engine on Llama-3-8B widths at full
   depth (32 layers, bf16, random weights from a seed), 8 requests of 32
   new tokens (greedy, one temperature/top_p, one streamed). Every
   request must finish with in-vocab tokens, and the launch counters of
   K1 and K3, zeroed just before, must have grown.
3. parity: at the same widths with 4 layers in fp32 (TF32 off), the
   engine's greedy tokens for 3 prompts (K1 prefill, K3 decode) must
   equal a full-recompute greedy loop through the same model with no
   cache and its attention held to the einsum path (`einsum_attention`;
   no kernel launches there, checked).
4. train: `make_train_step` with adamw and warmup_cosine on Llama-3-8B
   widths cut to 8 layers (bf16 compute, fp32 master weights, remat),
   5 steps on one fixed batch of 2 x 2048 tokens: finite losses and
   grad norms, the last loss below the first, and K1/K2a/K2b launched
   exactly as the path implies (counters zeroed just before); then one
   more step under the profiler.
5. train-parity: 3 fp32 train steps (TF32 off) of the flagship widths
   on the GPU (K1/K2a/K2b) give the CPU's loss and grad_norm, and so
   does one GPU step under remat "dots" (selective checkpointing; K1
   runs twice per layer).
6. north-star: pretrain the flagship widths on a repeating corpus,
   checkpoint through CheckpointManager, restore, and serve the restored
   weights through LLMServer: the greedy continuation must match the
   corpus at least once in 6 tokens.

The second-to-last line is a JSON object listing each kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of JAX or ray_tpu.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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
# K2a/K2b vs their plain versions, bf16. Both round dS (and K2b P) to
# bf16 before the products that take them, as the Pallas kernels do, but
# the fp32 values being rounded come from sums in different orders, so a
# rounding may land one bf16 ulp apart; dQ sums that over up to S keys
# and dK/dV over S * Hq/Hkv query rows, and the outputs are rounded to
# bf16 again: |err| <= atol + rtol * |plain|, two output ulps plus an
# absolute floor for the near-zero entries of the sums.
K2_ATOL, K2_RTOL = 1e-2, 1.6e-2
K2_ATOL_FP32 = 1e-4     # fp32: exact products, sums in another order
# (batch, sequence, causal); Hq 32, Hkv 8, D 128, bf16. (2, 2048) is the
# train phase's shape and the one written to the JSON.
K2_SHAPES = [(1, 128, True), (4, 512, True), (1, 2048, True),
             (2, 2048, True), (1, 1024, False), (1, 1000, True)]
K2_RECORD = (2, 2048, True)
# fp32 at the train-parity phase's head shape (Hq 8, Hkv 4, D 64)
K2_FP32_SHAPES = [(2, 256, True), (1, 300, False)]
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
    rows += k2_rows(torch, gen)
    print("kernels: launches in this phase " + json.dumps(
        {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
         "paged_decode (K3)": pa.paged_decode_attention.launches,
         "flash_bwd_dq (K2a)": fa.flash_bwd_dq.launches,
         "flash_bwd_dkv (K2b)": fa.flash_bwd_dkv.launches}), flush=True)
    return rows


def k2_check(torch, gen, b, s, causal, hq, hkv, d, dt):
    """K2a/K2b once against their plain versions; returns the inputs and
    (dq, dk, dv) errors."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dt)
    do = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                            causal=causal)
    errs, ok = [], True
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        diff = (got.float() - ref.float()).abs()
        errs.append(diff.max().item())
        if dt == torch.float32:
            ok = ok and errs[-1] <= K2_ATOL_FP32
        else:
            ok = ok and bool((diff <= K2_ATOL + K2_RTOL
                              * ref.float().abs()).all())
    tol = (f"atol {K2_ATOL_FP32}" if dt == torch.float32 else
           f"atol {K2_ATOL} + rtol {K2_RTOL}")
    print(f"kernels: K2 flash_bwd B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
          f"{str(dt)[6:]} {'causal' if causal else 'non-causal'} "
          f"max_abs_err dq={errs[0]:.3g} dk={errs[1]:.3g} dv={errs[2]:.3g} "
          f"({tol}: {ok})", flush=True)
    check(ok, f"K2a/K2b disagree with their plain versions at B={b} S={s} "
              f"causal={causal} {dt}")
    return (q, k, v, do, lse, delta), errs


def k2_rows(torch, gen):
    import torch.nn.functional as F
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    for b, s, causal in K2_FP32_SHAPES:
        k2_check(torch, gen, b, s, causal, 8, 4, 64, torch.float32)
    hq, hkv, d = 32, 8, 128
    err_dq = err_dkv = 0.0
    rec = {}
    for b, s, causal in K2_SHAPES:
        (q, k, v, do, lse, delta), errs = k2_check(
            torch, gen, b, s, causal, hq, hkv, d, torch.bfloat16)
        err_dq = max(err_dq, errs[0])
        err_dkv = max(err_dkv, errs[1], errs[2])
        if (b, s, causal) != K2_RECORD:
            continue
        kw = dict(causal=causal)
        ms_dq = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                **kw))
        ms_dkv = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  **kw))
        plain_dq = time_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, **kw), iters=5)
        plain_dkv = time_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, **kw), iters=5)
        # library: SDPA's backward on the same inputs through autograd on
        # a retained graph. It computes dQ, dK and dV in one pass, and no
        # PyTorch call computes dQ or (dK, dV) alone, so both rows carry
        # this one time: compare it with K2a + K2b.
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.autograd.grad(
            out_t, (qt, kt, vt), dot, retain_graph=True))
        pairs = s * (s + 1) / 2 if causal else float(s * s)
        prod = 2.0 * b * hq * d * pairs         # one product's operations
        n_q = float(b * s * hq * d)             # elements of q, dO or dQ
        n_kv = float(b * s * hkv * d)           # elements of k, v, dK, dV
        stats = 4.0 * 2 * b * hq * s            # lse + delta, fp32
        # K2a reads q, k, v, dO, lse, delta and writes dQ; K2b reads the
        # same and writes dK, dV (bf16: 2 bytes an element)
        bq, byq = bound_ms(3 * prod, 2 * (3 * n_q + 2 * n_kv) + stats)
        bkv, bykv = bound_ms(4 * prod, 2 * (2 * n_q + 4 * n_kv) + stats)
        print(f"kernels: K2a dq B={b} S={s} kernel {ms_dq:.4f} ms, plain "
              f"{plain_dq:.4f} ms, bound {bq:.4f} ms ({byq})", flush=True)
        print(f"kernels: K2b dkv B={b} S={s} kernel {ms_dkv:.4f} ms, plain "
              f"{plain_dkv:.4f} ms, bound {bkv:.4f} ms ({bykv})", flush=True)
        print(f"kernels: K2a + K2b {ms_dq + ms_dkv:.4f} ms against the "
              f"library (sdpa backward: dq, dk and dv in one call) "
              f"{lib:.4f} ms", flush=True)
        shape = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 "
                 f"{'causal' if causal else 'non-causal'}")
        lib_note = ("SDPA's whole backward (dQ, dK, dV in one call), "
                    "to compare with K2a + K2b")
        rec = {"dq": dict(ms=ms_dq, plain_ms=plain_dq, bound_ms=bq,
                          bound_by=byq, library_ms=lib, library=lib_note,
                          shape=shape),
               "dkv": dict(ms=ms_dkv, plain_ms=plain_dkv, bound_ms=bkv,
                           bound_by=bykv, library_ms=lib, library=lib_note,
                           shape=shape)}
        del qt, kt, vt, out_t, dot
    src = "ray_tpu_torch/csrc/flash_bwd.cu"
    return [dict(name="flash_bwd_dq (K2a)", route="cuda", source=src,
                 replaces="ray_tpu/ops/pallas/flash_attention.py:175",
                 max_abs_err=err_dq, **rec["dq"]),
            dict(name="flash_bwd_dkv (K2b)", route="cuda", source=src,
                 replaces="ray_tpu/ops/pallas/flash_attention.py:207",
                 max_abs_err=err_dkv, **rec["dkv"])]


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


# kernel name fragments -> kind, first match wins
PROFILE_KINDS = (
    ("attention kernels (K1/K2/K3)", ("flash_fwd", "bwd_dq", "bwd_dkv",
                                      "paged_decode")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("fused optimizer", ("multi_tensor_apply",)),
    ("elementwise", ("elementwise", "CatArrayBatchedCopy", "index")),
    ("reduction", ("reduce_kernel", "softmax", "norm_kernel",
                   "cross_entropy", "nll_loss")),
)


def gpu_profile(torch, fn, label, gpu_line, top=8):
    """Run fn once under torch.profiler: the share of the wall time the
    GPU spent in kernels, and the kernels that took most of it. The
    profiler's own host cost lengthens the wall time, so the busy share
    it shows is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name, ranges = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # ranges (e.g. Optimizer.step) span kernels; they are not busy
        # time of their own
        into = ranges if e.is_user_annotation else by_name
        into[e.name] = into.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    check(busy_us > 0, "the profiler saw no kernel on the GPU")
    print(f"{label}: wall {wall_us / 1e3:.1f} ms, GPU busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%, a lower "
          f"bound) [{gpu_line}]", flush=True)
    kinds = {}
    for name, us in by_name.items():
        kind = next((k for k, keys in PROFILE_KINDS if any(
            key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
    print(f"{label}: by kind " + ", ".join(
        f"{k} {us / 1e3:.2f} ms ({100 * us / busy_us:.1f}%)"
        for k, us in sorted(kinds.items(), key=lambda kv: -kv[1])),
        flush=True)
    for name, us in ranges.items():
        print(f"{label}: range {name} {us / 1e3:.2f} ms on the GPU "
              f"timeline", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{label}: {us / 1e3:9.2f} ms {100 * us / busy_us:5.1f}% "
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
    gpu_profile(torch, lambda: burst(server, bodies), "serve-profile",
                gpu_line)
    server.shutdown()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd (K1)": k1, "paged_decode (K3)": k3}


def phase_parity(torch):
    from unittest import mock

    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.models import llama as llama_module
    from ray_tpu_torch.ops import einsum_attention
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import paged_attention as pa
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
    zero_counters(fa)
    pa.paged_decode_attention.launches = 0
    try:
        rids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        got = [list(engine.stream(r)) for r in rids]
    finally:
        engine.shutdown()
    k1 = fa.flash_attention_fwd.launches
    k3 = pa.paged_decode_attention.launches
    check(k1 > 0 and k3 > 0, f"the engine did not run K1/K3: {k1}, {k3}")
    # the reference shares no kernel with the engine: the cache-less
    # forward's attention is held to the einsum path
    want = []
    zero_counters(fa)
    with torch.no_grad(), mock.patch.object(
            llama_module, "multi_head_attention", einsum_attention):
        for p in prompts:
            seq = list(p)
            for _ in range(n_new):
                logits, _ = model(torch.tensor([seq], device="cuda"))
                seq.append(int(torch.argmax(logits[0, -1])))
            want.append(seq[len(p):])
    check(fa.flash_attention_fwd.launches == 0,
          "the plain reference launched K1")
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"parity: prompt {i} ({len(prompts[i])} tokens) engine {g} "
              f"plain {w}", flush=True)
    check(got == want, "engine greedy tokens differ from the plain "
                       "full-recompute loop")
    print(f"parity: ok (fp32, TF32 off, 4 layers of Llama-3-8B widths; "
          f"engine K1 {k1}, K3 {k3} launches; reference einsum attention, "
          f"0 kernel launches)", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


TRAIN_LAYERS = 8          # depth cut of the train phase (widths: full 8B)
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
PARITY_STEPS = 3
PARITY_RTOL = 1e-4        # fp32 GPU (K1/K2 fp32, cuBLAS fp32) vs CPU
# __graft_entry__._flagship_config() widths (copied: this script imports
# nothing of the JAX package)
FLAGSHIP = dict(vocab_size=2048, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=4, d_ff=1408, max_seq_len=512)


def zero_counters(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def read_counters(fa):
    return {"flash_fwd (K1)": fa.flash_attention_fwd.launches,
            "flash_bwd_dq (K2a)": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv (K2b)": fa.flash_bwd_dkv.launches}


def phase_train(torch, gpu_line):
    """The slice's path at full width: Llama-3-8B widths with the depth
    cut to TRAIN_LAYERS, bf16 compute, fp32 master weights, remat, adamw
    with warmup_cosine, TRAIN_STEPS steps on one fixed batch."""
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                     warmup_cosine)

    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Llama(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ + 1),
                                     device="cuda", generator=gen)}
    tx = make_optimizer("adamw", schedule=warmup_cosine(3e-4, 1,
                                                        TRAIN_STEPS))
    state, step = make_train_step(model, tx)(batch)
    torch.cuda.synchronize()
    print(f"train: Llama-3-8B widths, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f}B params fp32 master / bf16 compute, "
          f"remat={cfg.remat} ({cfg.remat_policy}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, built in {time.time() - t0:.1f} s",
          flush=True)
    zero_counters(fa)
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t1 = time.time()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"train: step {i} loss {losses[-1]:.6f} grad_norm "
              f"{norms[-1]:.6f} time {times[-1] * 1e3:.1f} ms", flush=True)
    launches = read_counters(fa)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    print(f"train: median step {med * 1e3:.1f} ms (steps 1-"
          f"{TRAIN_STEPS - 1}), {TRAIN_BATCH * TRAIN_SEQ / med:.1f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) [{gpu_line}]", flush=True)
    print(f"train: launches {json.dumps(launches)} (expected K1 "
          f"2 x {cfg.n_layers} x {TRAIN_STEPS}: forward + remat recompute;"
          f" K2a, K2b {cfg.n_layers} x {TRAIN_STEPS})", flush=True)
    check(all(map(math.isfinite, losses + norms)),
          "non-finite loss or grad_norm")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    n = cfg.n_layers * TRAIN_STEPS
    check(launches == {"flash_fwd (K1)": 2 * n, "flash_bwd_dq (K2a)": n,
                       "flash_bwd_dkv (K2b)": n},
          f"unexpected launch counts {launches}")
    # one more step, profiled (after the counters were read)
    gpu_profile(torch, lambda: step(state, batch), "train-profile",
                gpu_line, top=12)
    del state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_parity(torch):
    """fp32 train steps on the GPU (K1 + K2a/K2b, fp32 kernels) against
    the same model and batch on the CPU (einsum attention, no remat);
    then one GPU step under remat "dots" against the CPU's first."""
    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.train import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.float32,
                      param_dtype=torch.float32)
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 257))
    cpu_model = Llama(cfg, device="cpu", seed=2)
    weights = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    results = {}
    for dev in ("cuda", "cpu"):
        model = cpu_model if dev == "cpu" else Llama(cfg, device="cuda",
                                                     seed=2)
        model.load_state_dict(weights)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        state, step = make_train_step(model, make_optimizer(
            "sgd", learning_rate=0.1))(batch)
        zero_counters(fa)
        rows = []
        for _ in range(PARITY_STEPS):
            state, m = step(state, batch)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        results[dev] = (rows, read_counters(fa))
        del model, state, step
    (gpu, launches), (cpu, _) = results["cuda"], results["cpu"]
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        print(f"train-parity: step {i} loss gpu {g[0]:.7f} cpu {c[0]:.7f} "
              f"grad_norm gpu {g[1]:.7f} cpu {c[1]:.7f}", flush=True)
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b)
             for g, c in zip(gpu, cpu) for a, b in zip(g, c))
    print(f"train-parity: flagship widths fp32 (TF32 off), S=256, sgd; "
          f"rtol {PARITY_RTOL}: {ok}; GPU launches {json.dumps(launches)}",
          flush=True)
    check(ok, "GPU train steps differ from the CPU")
    check(all(n > 0 for n in launches.values()),
          f"the GPU steps did not run K1/K2a/K2b: {launches}")

    # remat "dots": selective checkpointing around the ctypes-launched
    # kernels; K1 runs in the forward and again in the recompute
    dots = Llama(dataclasses.replace(cfg, remat=True, remat_policy="dots"),
                 device="cuda", seed=2)
    dots.load_state_dict(weights)
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    state, step = make_train_step(dots, make_optimizer(
        "sgd", learning_rate=0.1))(batch)
    zero_counters(fa)
    _, m = step(state, batch)
    got = (float(m["loss"]), float(m["grad_norm"]))
    launches = read_counters(fa)
    n = cfg.n_layers
    ok = all(abs(a - b) <= PARITY_RTOL * abs(b) for a, b in zip(got, cpu[0]))
    print(f"train-parity: remat dots, one step: loss gpu {got[0]:.7f} cpu "
          f"{cpu[0][0]:.7f} grad_norm gpu {got[1]:.7f} cpu {cpu[0][1]:.7f} "
          f"(rtol {PARITY_RTOL}: {ok}); launches {json.dumps(launches)} "
          f"(expected K1 2 x {n}, K2a and K2b {n})", flush=True)
    check(ok, "the remat dots step differs from the CPU")
    check(launches == {"flash_fwd (K1)": 2 * n, "flash_bwd_dq (K2a)": n,
                       "flash_bwd_dkv (K2b)": n},
          f"unexpected launch counts under remat dots: {launches}")
    del dots, state, step
    gc.collect()
    torch.cuda.empty_cache()


def phase_north_star(torch):
    """Pretrain the flagship widths on a repeating corpus, checkpoint
    through CheckpointManager, restore, and serve the restored weights
    through LLMServer on the paged engine (tests/test_north_star.py
    stages 1-3)."""
    import shutil
    import tempfile

    import numpy as np
    from ray_tpu_torch.models import Llama, LlamaConfig
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.train import (CheckpointManager, make_optimizer,
                                     make_train_step, restore_pytree)

    cfg = LlamaConfig(**FLAGSHIP, dtype=torch.bfloat16,
                      param_dtype=torch.float32)
    corpus = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": torch.from_numpy(corpus).to("cuda")}
    model = Llama(cfg, device="cuda", seed=0)
    state, step = make_train_step(model, make_optimizer(
        "adamw", learning_rate=5e-3))(batch)
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    print(f"north-star: losses {[round(x, 4) for x in losses]}", flush=True)
    check(losses[-1] < losses[0] - 0.3, f"pretrain loss did not fall: "
                                        f"{losses}")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(root)
        mgr.save(model.state_dict(), state.step)
        ckpt = mgr.latest()
        check(ckpt is not None and ckpt.metadata()["step"] == 15,
              "no committed checkpoint")
        restored = restore_pytree(ckpt.as_directory(), map_location="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state, step, model
    server = LLMServer(
        lambda: (Llama(cfg, device="cuda", seed=99), restored),
        engine_config=dict(max_slots=2, max_seq_len=64, kv_page_size=16,
                           prefill_buckets=(16,)), device="cuda")
    try:
        toks = server({"prompt": corpus[0, :8].tolist(),
                       "max_tokens": 6})["tokens"]
    finally:
        server.shutdown()
    truth = corpus[0, 8:14].tolist()
    hits = sum(int(t == u) for t, u in zip(toks, truth))
    print(f"north-star: restored checkpoint served greedy {toks}, corpus "
          f"{truth}, {hits}/6 match", flush=True)
    check(len(toks) == 6 and hits >= 1,
          "the served checkpoint does not continue the corpus")
    del server, restored
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
    launches = {"serve": phase_serve(torch, gpu_line)}
    phase_parity(torch)
    launches["train"] = phase_train(torch, gpu_line)
    phase_train_parity(torch)
    phase_north_star(torch)

    # each kernel's launches on the main paths that run it (serve, train)
    for r in rows:
        by_path = {p: n[r["name"]] for p, n in launches.items()
                   if r["name"] in n}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows, "gpu": gpu_line}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
