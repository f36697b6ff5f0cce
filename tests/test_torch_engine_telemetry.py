"""The port's LLM engine telemetry against the JAX engine's: for one
request shed at submit (its deadline already passed) and one request
served to the end, the same cluster events in the same order with the
same attributes (util/events.py), and the same registry metric values
(util/metrics.py: tokens, TTFT and TPOT observation counts, the gauges
at rest, and the shed counter). Both engines run the same fp32 weights
on the CPU, on the contiguous cache and the paged one."""
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
