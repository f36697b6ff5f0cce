"""The training runner: the port's train step (`make_train_step`, the
step `SpmdTrainer` runs) fed through `data.device_put_iterator`.

Set-up builds the model with the harness's weights and the optimizer of
the configuration's recipe, and drives that one train state through the
first `checked_steps` steps of the seed's batches by the window's own
call and feed. It records each step's loss, each leaf's norm of the
first gradient as the optimizer got it (AdamW's first moment after one
step is (1 - b1) g) and each leaf's norm of its change over those steps
(the start made again from the seed). The window then runs steps back
to back on the same state until `--seconds` have passed, each step
ending in a read of its loss; the rate is all tokens of all steps over
the time from the window's open to the end of its last step.

`correct` holds those readings against the plain reference's own steps
on the same batches, run after the program is freed.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from harness import traffic as traffic_mod
from harness.trace import Slice
from harness.weights import make_named


def _first_moments(state, b1: float) -> Dict[str, float]:
    """Each leaf's first-moment norm over (1 - b1); a leaf the optimizer
    holds no moment of reads 0."""
    opt = state.opt_state
    out = {}
    for name, p in state.params.items():
        m = opt.state.get(p, {}).get("exp_avg")
        out[name] = 0.0 if m is None else float(m.float().norm()) / (1 - b1)
    return out


@torch.no_grad()
def _changes(model, groups, seed: int, device) -> Dict[str, float]:
    params = dict(model.named_parameters())
    out = {}
    for name, *_ in groups:
        for k, t0 in make_named(groups, name, seed, device).items():
            out[k] = float((params[k].float() - t0.float()).norm())
    return out


def window(cell, seed: int, seconds: float, trace: bool, device,
           t_start: float):
    """Set-up, the checked first steps and the window. Returns the run
    record and the program's readings: (losses, first_grad, change,
    the checked steps' host batches)."""
    from ray_tpu_torch.data.device_loader import device_put_iterator
    from ray_tpu_torch.train.spmd import make_train_step
    cfg, mix = cell.config, cell.traffic
    fam, ref = cell.family, cell.reference
    opt_cfg = cfg["train"]["optimizer"]
    parts = {"to_build": time.perf_counter() - t_start}
    model = fam.build(cfg, device, seed)
    parts["build"] = time.perf_counter() - t_start - parts["to_build"]
    kept = []

    def host():
        for b in traffic_mod.lm_batches(mix, seed, cfg["vocab_size"]):
            if len(kept) < mix["checked_steps"]:
                kept.append(b["tokens"].copy())
            yield b

    feed = device_put_iterator(host(), device=device)
    batch = next(feed)
    state, step = make_train_step(model, fam.optimizer(cfg))(batch)
    losses, first_grad = [], {}
    for i in range(mix["checked_steps"]):
        if i:
            batch = next(feed)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            first_grad = _first_moments(state, opt_cfg["b1"])
    parts["checked_steps"] = time.perf_counter() - t_start \
        - parts["to_build"] - parts["build"]
    groups = ref.weight_groups(cfg)
    change = _changes(model, groups, seed, device)

    tokens_per_step = mix["batch"] * mix["seq_len"]
    span = min(mix["trace_seconds"], seconds)
    on_at = seconds - span     # the window's last trace_seconds
    tslice = Slice() if trace else None
    n = n_traced = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    parts["readings"] = setup_s - sum(parts.values())
    while True:
        now = time.perf_counter() - t0
        if trace and tslice.prof is None and now >= on_at:
            tslice.start()
        batch = next(feed)
        if trace and tslice.prof is not None:
            with torch.profiler.record_function("bench.step"):
                state, m = step(state, batch)
                float(m["loss"])
            n_traced += 1
        else:
            state, m = step(state, batch)
            float(m["loss"])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if trace and tslice.prof is not None:
        tslice.stop()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    feed.close()
    del state, step, model, batch, m, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = tslice.reduce() if trace and tslice.t1 is not None else None
    if summary is not None:
        summary["steps"] = n_traced
    rec = {
        "kind": "train", "setup_s": setup_s, "window_s": window_s,
        "steps": n, "tokens": n * tokens_per_step,
        "trace": summary, "config": cfg, "traffic": mix,
        "memory_peak_bytes": peak, "setup_parts": parts,
    }
    return rec, (losses, first_grad, change, kept)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    rec, (losses, first_grad, change, kept) = window(
        cell, seed, seconds, trace, device, t_start)
    reference = cell.reference.train(
        cell.config, cell.config["train"]["optimizer"], seed,
        [torch.from_numpy(k[0]) for k in kept], device)
    read = compare(losses, first_grad, change, reference)
    # the checks file names the numbers compared; the rest are reported
    rec["checked"] = {k: {"value": read[k], "limit": v}
                      for k, v in cell.checks["limits"].items()}
    rec["check_detail"] = read
    rec["correct"] = all(v["value"] <= v["limit"]
                         for v in rec["checked"].values())
    return rec


def compare(losses, first_grad, change, reference) -> Dict:
    """The readings of the program against the reference:
    loss_gap, the largest |program - reference| over the steps' losses;
    grad_gap, over leaves, the gap between the norms of the first
    gradient, over the larger of the leaf's reference norm and the
    median leaf's; step_gap, the same for the change over the steps,
    leaving out leaves whose reference gradient is under a thousandth of
    the median leaf's (they move by round-off alone)."""
    loss_gap = max(abs(a - b) for a, b in zip(losses, reference["losses"]))
    rg, rc = reference["first_grad"], reference["change"]
    med_g = statistics.median(rg.values())
    med_c = statistics.median(rc.values())
    grad_gap = max(abs(first_grad[k] - rg[k]) / max(rg[k], med_g)
                   for k in rg)
    moved = [k for k in rc if rg[k] >= 1e-3 * med_g]
    step_gap = max(abs(change[k] - rc[k]) / max(rc[k], med_c)
                   for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "step_gap": step_gap}
