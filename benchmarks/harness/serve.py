"""The serving runner: the port's `LLMEngine` under the mix's load.

Set-up builds the model with the harness's weights, the engine with the
configuration's settings, and warms every prefill bucket the mix can
reach, alone and in a full prefill group. The window then offers the
mix's load (`traffic.requests`, `Client`), streams each request's
tokens and times each on arrival. Requests are timed from when they
were due, so a late sender or a stalled engine counts. After the close
no request is sent; the runner waits for the first token of every
request that was due (up to the mix's `ttft_wait_s`), then aborts what
is unfinished.

`correct` compares what the window served: a sample, drawn from the
seed, of the finished requests with the longest among them, each prompt
with its served tokens run once through the plain reference in float32
(after the program is freed). At each served position the reference
reads the gap by which the served token's logit lies below its best;
the cell's checks file names which of the readings (`readings`) are
compared, each with its limit.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

import numpy as np

from harness import traffic as traffic_mod
from harness.trace import Annotations, ThreadSlice


class _Record:
    __slots__ = ("req", "due", "rid", "sent", "times", "tokens", "error",
                 "thread")

    def __init__(self, req):
        self.req = req
        self.due = req.due_s     # a closed loop's request: when it is sent
        self.rid = None
        self.sent = None
        self.times: List[float] = []
        self.tokens: List[int] = []
        self.error = None
        self.thread = None

    @property
    def finished(self) -> bool:
        return self.error is None and \
            len(self.tokens) == self.req.max_new_tokens


class Client:
    """The load the mix's arrival law offers. An open loop has one
    sender thread, which sends each request when it is due, and a reader
    thread a request; a closed loop has a thread a client, which sends
    its next request when its last has ended, until the window closes,
    and reads its tokens itself. Times are seconds after the window
    opened (`t0`, perf_counter)."""

    def __init__(self, engine, reqs, mix: Dict, seconds: float):
        self.engine = engine
        self.records = [_Record(r) for r in reqs]
        self.law = traffic_mod.arrivals(mix)
        self.seconds = seconds
        self.t0 = None
        self.senders: List[threading.Thread] = []

    def due_records(self) -> List[_Record]:
        """The requests due in the window: every one of an open loop,
        those a closed loop sent."""
        return [r for r in self.records if r.due is not None]

    def _read(self, rec: _Record) -> None:
        try:
            for tok in self.engine.stream(rec.rid):
                rec.times.append(time.perf_counter() - self.t0)
                rec.tokens.append(int(tok))
        except Exception as e:  # noqa: BLE001  a failed request is data
            rec.error = repr(e)

    def _submit(self, rec: _Record) -> bool:
        rec.sent = time.perf_counter() - self.t0
        if rec.due is None:
            rec.due = rec.sent
        try:
            rec.rid = self.engine.submit(
                rec.req.prompt, max_new_tokens=rec.req.max_new_tokens,
                temperature=0.0)
        except Exception as e:  # noqa: BLE001  refused: counts missing
            rec.error = repr(e)
            return False
        return True

    def _send_open(self) -> None:
        for rec in self.records:
            wait = self.t0 + rec.req.due_s - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if self._submit(rec):
                rec.thread = threading.Thread(target=self._read, args=(rec,),
                                              daemon=True)
                rec.thread.start()

    def _send_closed(self, queue, lock) -> None:
        while True:
            with lock:
                rec = next(queue, None)
            if rec is None or time.perf_counter() - self.t0 >= self.seconds:
                return
            if self._submit(rec):
                self._read(rec)

    def start(self, t0: float) -> None:
        self.t0 = t0
        if self.law["law"] == "closed":
            queue, lock = iter(self.records), threading.Lock()
            self.senders = [threading.Thread(target=self._send_closed,
                                             args=(queue, lock), daemon=True)
                            for _ in range(int(self.law["clients"]))]
        else:
            self.senders = [threading.Thread(target=self._send_open,
                                             daemon=True)]
        for s in self.senders:
            s.start()

    def wait_first_tokens(self, deadline: float) -> None:
        if self.law["law"] != "closed":
            self.senders[0].join()   # its last request is due at the close
        while time.perf_counter() < deadline:
            if all(r.error is not None or r.times
                   for r in self.due_records()):
                return
            time.sleep(0.01)

    def threads(self) -> List[threading.Thread]:
        return self.senders + [r.thread for r in self.records
                               if r.thread is not None]

    def close(self) -> None:
        for rec in self.records:
            if rec.rid is not None and not rec.finished:
                self.engine.abort(rec.rid)
        for t in self.threads():
            t.join(timeout=60)


def warm(engine, cfg: Dict, mix: Dict) -> None:
    """Every bucket a prompt of the mix can land in, prefilled alone and
    in each power-of-two group up to max_prefill_batch, with a decode
    step after: the shapes the window will run, and no others."""
    e = cfg["serve"]["engine"]
    lo, hi = mix["prompt_len"]["min"], mix["prompt_len"]["max"]
    prev = 0
    sizes, g = [], 1
    while g <= e["max_prefill_batch"]:
        sizes.append(g)
        g *= 2
    for b in sorted(e["prefill_buckets"]):
        if b >= lo and prev < hi:
            n = min(b, e["max_seq_len"] - 8)
            for g in sizes:
                rids = [engine.submit(np.ones((n,), np.int32),
                                      max_new_tokens=2) for _ in range(g)]
                for rid in rids:
                    for _ in engine.stream(rid):
                        pass
        prev = b


def window(cell, seed: int, seconds: float, trace: bool, device,
           t_start: float, finish: bool = False):
    """Set-up and the window. Returns the run record and the sample of
    finished requests to check, [(prompt, served tokens)]. With
    `finish` every request due is waited for to its end instead of
    being aborted after its first token."""
    import torch
    cfg, mix = cell.config, cell.traffic
    fam = cell.family
    parts = {"to_build": time.perf_counter() - t_start}
    model = fam.build(cfg, device, seed)
    parts["build"] = time.perf_counter() - t_start - parts["to_build"]
    notes = Annotations(model, fam.ANNOTATE) if trace else None
    tslice = ThreadSlice() if trace else None
    hook = model.register_forward_pre_hook(tslice.hook) if trace else None
    engine = fam.engine(model, cfg, device, seed)
    t_warm = time.perf_counter()
    warm(engine, cfg, mix)
    reqs = traffic_mod.requests(mix, seed, seconds, cfg["vocab_size"])
    client = Client(engine, reqs, mix, seconds)
    before = engine.get_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    parts["engine"] = t_warm - t_start - parts["to_build"] - parts["build"]
    parts["warm"] = t0 - t_warm
    client.start(t0)
    # a traced run traces the window's last trace_seconds; the engine
    # counters are read over the part before it, which tracing leaves
    # alone (stopping a capture holds the engine's thread for seconds)
    counted = seconds - (min(mix["trace_seconds"], seconds) if trace else 0)
    time.sleep(max(0.0, t0 + counted - time.perf_counter()))
    after = engine.get_stats()
    if trace:
        tslice.want = "on"
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    if trace:
        tslice.want = "off"
    client.wait_first_tokens(t0 + seconds + mix["ttft_wait_s"])
    if trace:
        while tslice.state == "on" and time.perf_counter() < \
                t0 + seconds + mix["ttft_wait_s"]:
            time.sleep(0.01)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if finish:
        for t in client.threads():
            t.join()
    client.close()
    engine.shutdown()
    if hook is not None:
        hook.remove()
        notes.remove()
    summary = tslice.reduce() if trace and tslice.state == "off" else None
    records = client.due_records()
    rec = {
        "kind": "serve", "setup_s": setup_s, "window_s": float(seconds),
        "requests": [{"due": r.due, "sent": r.sent,
                      "times": r.times, "failed": r.error is not None
                      or not r.times} for r in records],
        "counters": {k: after[k] - before[k]
                     for k in ("decode_steps", "prefills",
                               "tokens_generated")},
        "counted_s": counted,
        "trace": summary, "config": cfg, "traffic": mix,
        "memory_peak_bytes": peak, "setup_parts": parts,
    }
    served = _sample([r for r in records if r.finished], seed,
                     mix["check_requests"])
    return rec, served


def readings(cell, seed: int, served, device, control=False) -> Dict:
    """What the reference reads of the sample, after the program is
    freed: over every served position, the mean and the widest gap of
    the served token's logit below the reference's best, the largest of
    the requests' own mean gaps, and the worst rank of a served token
    among the reference's logits."""
    import torch
    if not served:
        return {"mean_logit_gap": float("inf"), "widest_gap": float("inf"),
                "worst_request_mean_gap": float("inf"),
                "worst_rank": float("inf"), "tokens": 0}
    per = cell.reference.position_readings(cell.config, seed, served,
                                           device, control=control)
    gaps = torch.cat([g for g, _ in per]).double()
    ranks = torch.cat([r for _, r in per])
    return {"mean_logit_gap": float(gaps.mean()),
            "worst_request_mean_gap": max(float(g.double().mean())
                                          for g, _ in per),
            "widest_gap": float(gaps.max()),
            "worst_rank": int(ranks.max()), "tokens": int(gaps.numel())}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    import torch
    rec, served = window(cell, seed, seconds, trace, device, t_start)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    read = readings(cell, seed, served, device)
    # the checks file names the numbers compared; the rest are reported
    limits = cell.checks["limits"]
    rec["checked"] = {k: {"value": read[k], "limit": v}
                      for k, v in limits.items()}
    rec["check_detail"] = dict(read, requests=len(served))
    rec["correct"] = bool(served) and all(
        c["value"] <= c["limit"] for c in rec["checked"].values())
    return rec


def _sample(finished, seed: int, k: int):
    """The finished request with the most served tokens, and k - 1 more
    drawn from the seed; [(prompt, served tokens)]."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.tokens), -r.req.index))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng(int(seed) + 1)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) \
        if rest else []
    chosen = [longest] + [rest[i] for i in sorted(pick)]
    return [(r.req.prompt, list(r.tokens)) for r in chosen]
