"""The port's LLM engine telemetry against the JAX engine's: for one
request shed at submit (its deadline already passed) and one request
served to the end, the same cluster events in the same order with the
same attributes (util/events.py), and the same registry metric values
(util/metrics.py: tokens, TTFT and TPOT observation counts, the gauges
at rest, and the shed counter). Both engines run the same fp32 weights
on the CPU, on the contiguous cache and the paged one. Then the port's
own telemetry: the loop's and the model's spans and counters under a
capture on the loop thread, and each request's timings."""
import json
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.exceptions import DeadlineExceededError as JDeadline
from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import LLMEngineConfig as JEngineConfig
from ray_tpu.util import events as j_events
from ray_tpu.util import metrics as j_metrics
from ray_tpu_torch.exceptions import DeadlineExceededError
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from ray_tpu_torch.observability import profiler
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
from ray_tpu_torch.util import events as t_events
from ray_tpu_torch.util import metrics as t_metrics

WIDTHS = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128)
BASE = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32))
PROMPT = np.arange(1, 9, dtype=np.int32)
ATTRS = ("reason", "stage", "slot", "prompt_len", "generated", "aborted")


@pytest.fixture(scope="module")
def weights():
    model = JLlama(JConfig(**WIDTHS, dtype=jnp.float32))
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params, llama_params_from_flax(
        jax.tree.map(np.asarray, params))


def _record(engine, events_mod, metrics_mod, deadline_error):
    """Shed one request at submit and serve one to the end; returns the
    engine's events (type and attributes) and its metric values."""
    events_mod.drain()
    shed = metrics_mod.get_metric("ray_tpu_serve_requests_shed_total")
    shed0 = shed.get({"reason": "deadline_expired"}) if shed else 0.0
    tags = dict(engine._mtags)
    try:
        with pytest.raises(deadline_error):
            engine.submit(PROMPT, max_new_tokens=5,
                          deadline_ts=time.time() - 1)
        rid = engine.submit(PROMPT, max_new_tokens=5)
        tokens = list(engine.stream(rid))
        # the loop sets the gauges once a step: wait for a step at rest
        active = metrics_mod.get_metric("ray_tpu_llm_engine_active_slots")
        deadline = time.time() + 30
        while active.get(tags) != 0.0 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        engine.shutdown()
    evs = [(e["type"], {k: e.get("attrs", {}).get(k) for k in ATTRS
                        if k in e.get("attrs", {})})
           for e in events_mod.drain()
           if e.get("attrs", {}).get("engine") == tags["engine"]]
    m = {n: metrics_mod.get_metric(f"ray_tpu_llm_engine_{n}")
         for n in ("tokens_generated", "ttft_s", "tpot_s", "active_slots",
                   "waiting_requests", "batch_occupancy")}
    values = {
        "tokens": m["tokens_generated"].get(tags),
        "ttft_count": m["ttft_s"]._count.get(
            tuple(sorted(tags.items())), 0),
        "tpot_count": m["tpot_s"]._count.get(
            tuple(sorted(tags.items())), 0),
        "active": m["active_slots"].get(tags),
        "waiting": m["waiting_requests"].get(tags),
        "occupancy": m["batch_occupancy"].get(tags),
        "shed": metrics_mod.get_metric(
            "ray_tpu_serve_requests_shed_total").get(
                {"reason": "deadline_expired"}) - shed0,
    }
    return tokens, evs, values


@pytest.mark.parametrize("kv_page_size", [0, 4])
def test_events_and_metrics_match_the_jax_engine(weights, kv_page_size):
    jmodel, params, state = weights
    cfg = dict(BASE, kv_page_size=kv_page_size)
    want = _record(JEngine(jmodel, params, JEngineConfig(**cfg)),
                   j_events, j_metrics, JDeadline)
    got = _record(LLMEngine(Llama(LlamaConfig(**WIDTHS, dtype=torch.float32),
                                  device="cpu"), state,
                            LLMEngineConfig(**cfg), device="cpu"),
                  t_events, t_metrics, DeadlineExceededError)
    assert got == want
    tokens, evs, values = got
    assert [t for t, _ in evs] == ["serve.request.shed",
                                   "llm_engine.request_admit",
                                   "llm_engine.request_finish"]
    assert evs[0][1] == {"reason": "deadline_expired", "stage": "submit"}
    assert values["tokens"] == len(tokens) == 5
    assert values["ttft_count"] == 1 and values["tpot_count"] == 1
    assert values["shed"] == 1.0
    assert values["active"] == values["occupancy"] == 0.0


# the engine's and the model's spans, each with the spans one of whose
# instances must hold each of its instances (same thread)
SPAN_PARENTS = {
    "llm.admit": ("llm.step",), "llm.prefill": ("llm.step",),
    "llm.chunk": ("llm.step",), "llm.decode": ("llm.step",),
    "llm.publish": ("llm.step",), "llm.drain": ("llm.step",),
    "llm.fetch_wait": ("llm.drain",), "llm.emit": ("llm.drain",),
    **{name: ("llm.prefill", "llm.chunk", "llm.decode")
       for name in ("attn", "moe.route", "moe.dispatch", "moe.experts",
                    "moe.combine", "moe.aux")},
}
# (prompt length, max_new_tokens); 21 > prefill_chunk takes two chunks
SPAN_REQUESTS = [(5, 3), (7, 4), (12, 2), (16, 5), (21, 3)]


def _spans(log_dir):
    """{name: [(tid, start, end)]} of the record_function ranges of the
    one trace written into log_dir."""
    (path,) = list(log_dir.glob("*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append(
                (e["tid"], ts, ts + float(e["dur"])))
    return out


def _inside(child, parents, slack=0.01):
    tid, s, e = child
    return any(t == tid and ps - slack <= s and e <= pe + slack
               for t, ps, pe in parents)


def test_loop_spans_counters_and_request_timings(tmp_path):
    """The debug Mixtral served on the CPU (paged cache, prefill groups,
    one chunked prompt, K1's route pinned) under a capture started on
    the engine's loop thread (`profiler.trace(engine=)`): every span
    appears, nested as listed; the counters count the prompts' tokens
    and causal pairs, the decode rows (the tokens served after the
    first: pipeline_depth 0 lags none) and the keys each decode step
    reads; K1 is counted once a layer a prefill call, by shape; the
    experts' rows cover the routed ones. Without a capture nothing is
    counted. Every request's stamps are ordered, and
    ttft_breakdown_p50_ms keeps its keys."""
    mcfg = MixtralConfig.debug(dtype=torch.float32,
                               param_dtype=torch.float32, attn_impl="pallas")
    engine = LLMEngine(
        Mixtral(mcfg, device="cpu", seed=0), None,
        LLMEngineConfig(max_slots=4, max_seq_len=64, prefill_buckets=(8, 16),
                        kv_page_size=4, prefill_chunk=16, max_prefill_batch=2,
                        pipeline_depth=0),
        device="cpu")
    rng = np.random.default_rng(0)
    try:
        profiler.counters(reset=True)
        engine.generate_sync(rng.integers(1, 256, 6), max_new_tokens=3)
        assert profiler.counters() == {}
        log_dir = tmp_path / "trace"
        with profiler.trace(str(log_dir), engine=engine):
            rids = [engine.submit(rng.integers(1, 256, n), max_new_tokens=m)
                    for n, m in SPAN_REQUESTS]
            served = [len(list(engine.stream(r))) for r in rids]
        counts = profiler.counters(reset=True)
        timings = engine.request_timings()
        stats = engine.get_stats()
    finally:
        engine.shutdown()
    assert served == [m for _, m in SPAN_REQUESTS]
    spans = _spans(log_dir)
    assert set(SPAN_PARENTS) | {"llm.step"} <= set(spans)
    for name, parents in SPAN_PARENTS.items():
        around = [iv for p in parents for iv in spans[p]]
        assert all(_inside(iv, around) for iv in spans[name]), name
    assert not any(_inside(p, spans["llm.admit"])
                   for p in spans["llm.prefill"])

    lens = [n for n, _ in SPAN_REQUESTS]
    assert counts["llm.prefill_tokens"] == sum(lens)
    assert counts["llm.prefill_pairs"] == sum(n * (n + 1) // 2 for n in lens)
    assert counts["llm.decode_tokens"] == sum(m - 1 for m in served)
    assert counts["llm.decode_keys"] == sum(
        (m - 1) * n + (m - 1) * m // 2 for (n, _), m in
        zip(SPAN_REQUESTS, served))
    k1 = {k: v for k, v in counts.items() if k.startswith("k1.launch:")}
    assert sum(k1.values()) == mcfg.n_layers * len(spans["llm.prefill"])
    for key in k1:
        b, s, hq, hkv, d, causal = map(int, key.split(":")[1].split(","))
        assert b in (1, 2) and s in (8, 16) and causal == 1
        assert (hq, hkv, d) == (mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim)
    routed = mcfg.experts_per_token * mcfg.n_layers * (
        counts["llm.prefill_tokens"] + counts["llm.decode_tokens"])
    assert routed <= counts["moe.rows_computed"]

    assert len(timings) == 1 + len(SPAN_REQUESTS)
    for t in timings:
        assert t["submit"] <= t["admit"] <= t["prefill_end"] \
            <= t["first_token"]
    assert [t["request_id"] for t in timings[1:]] == rids
    assert set(stats["ttft_breakdown_p50_ms"]) == {
        "queue_ms", "prefill_dispatch_ms", "emit_ms", "total_ms"}
    assert "prefill_first_dispatch_ms" not in stats
