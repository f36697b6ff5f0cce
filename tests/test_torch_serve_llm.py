"""The port's LLM deployment functions on its serve control plane, on the
CPU: `build_llm_deployment` and `build_openai_deployment` with
`device="cpu"` on a tiny Llama (2 layers, d 32, tests/test_openai_api.py's
widths), its weights the JAX params carried over by the port's converter.
Greedy tokens through the handle (unary and streamed) and through the
HTTP proxy (unary and SSE) must equal the JAX `LLMEngine`'s on the same
params, run in this process, and each reply's text must be the
tokenizer's decode of them (the tokenizer is one-to-one, so the text
also gives the ids back). Also: their default replica options
reserve one GPU; replies, `stats()` and `autoscale_metrics()` hold no
tensors; a stop string over SSE aborts the engine request and frees its
slot.

The replicas run `ray_tpu_torch.serve._testing`'s factory and tokenizer
(pickled by reference: a replica imports neither JAX nor this module)."""
import functools
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import LLMEngineConfig as JEngineConfig
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama_params_from_flax
from ray_tpu_torch.serve import _testing
from ray_tpu_torch.serve.http_proxy import start_proxy
from ray_tpu_torch.serve.llm import build_llm_deployment
from ray_tpu_torch.serve.llm.openai_api import build_openai_deployment

WIDTHS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=128)
ENGINE = {"max_slots": 4, "max_seq_len": 128, "prefill_buckets": (16, 32),
          "max_new_tokens_default": 8}
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], list(range(10, 30))]
NEW = 6
ROUTES = {"llm": "/llm", "openai": "/v1/completions"}
TOK = _testing.CodepointTok()
T = 60          # seconds any one reply may take


@pytest.fixture(scope="module")
def jax_llm():
    model = JLlama(JConfig(**WIDTHS, dtype=jnp.float32, remat=False))
    return model, model.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def want(jax_llm):
    eng = JEngine(*jax_llm, JEngineConfig(**ENGINE))
    try:
        return [[int(t) for t in eng.generate_sync(p, max_new_tokens=NEW)]
                for p in PROMPTS]
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def apps(jax_llm):
    """Both functions' apps, one replica each on the CPU, behind the proxy:
    {"handles": {"llm": ..., "openai": ...}, "port": ...}."""
    state = {k: v.numpy() for k, v in llama_params_from_flax(
        jax.tree.map(np.asarray, jax_llm[1])).items()}
    factory = functools.partial(_testing.llama_factory, WIDTHS, state)
    rt.init(num_cpus=6)
    try:
        handles = {
            "llm": serve.run(build_llm_deployment(
                factory, engine_config=dict(ENGINE), tokenizer=TOK,
                name="LLM", route_prefix="/llm", device="cpu"),
                name="llm-app"),
            "openai": serve.run(build_openai_deployment(
                factory, engine_config=dict(ENGINE), tokenizer=TOK,
                model_name="tiny-llama", device="cpu"), name="openai-app")}
        _proxy, port = start_proxy(port=0)
        deadline = time.time() + T
        for route in ROUTES.values():
            while True:
                try:
                    _post(port, route, {"prompt": [1], "max_tokens": 1})
                    break
                except urllib.error.URLError:     # routes not there yet
                    assert time.time() < deadline, f"no route {route}"
                    time.sleep(0.1)
        yield {"handles": handles, "port": port}
    finally:
        serve.shutdown()
        rt.shutdown()


def _post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=T) as r:
        assert r.status == 200
        if not body.get("stream"):
            return json.loads(r.read())
        assert "text/event-stream" in r.headers["Content-Type"]
        return [line[len(b"data: "):].decode() for line in r.read().split(
            b"\n\n") if line.startswith(b"data: ")]


def _body(app, prompt, stream):
    body = {"prompt": prompt, "max_tokens": NEW, "stream": stream}
    if app == "openai":
        body["temperature"] = 0.0      # the OpenAI default samples
    return body


def _served(apps, app, path, prompt):
    """(token ids, text) of one greedy request through `path`."""
    handle, port = apps["handles"][app], apps["port"]
    if path == "handle-unary":
        out = handle.remote(_body(app, prompt, False)).result(timeout_s=T)
    elif path == "handle-stream":
        chunks = _testing.drain(handle.options(stream=True).remote(
            _body(app, prompt, True)), T)
    elif path == "http-unary":
        out = _post(port, ROUTES[app], _body(app, prompt, False))
    else:
        events = _post(port, ROUTES[app], _body(app, prompt, True))
        chunks = [json.loads(e) if app == "openai" and e != "[DONE]"
                  else e for e in events]
    if path.endswith("unary"):
        if app == "llm":
            return out["tokens"], out["text"]
        assert out["usage"]["completion_tokens"] == NEW
        assert out["choices"][0]["finish_reason"] == "length"
        text = out["choices"][0]["text"]
        return TOK.encode(text), text
    if app == "llm":            # one decoded token a chunk
        assert all(len(c) == 1 for c in chunks)
        text = "".join(chunks)
        return TOK.encode(text), text
    assert chunks[-1] == "[DONE]"
    assert chunks[-2]["choices"][0]["finish_reason"] == "length"
    text = "".join(c["choices"][0]["text"] for c in chunks[:-1])
    return TOK.encode(text), text


@pytest.mark.parametrize("path", ["handle-unary", "handle-stream",
                                  "http-unary", "http-sse"])
@pytest.mark.parametrize("app", ["llm", "openai"])
def test_greedy_tokens_equal_the_jax_engine(apps, want, app, path):
    for prompt, w in zip(PROMPTS, want):
        toks, text = _served(apps, app, path, prompt)
        assert toks == w
        assert text == TOK.decode(w)


@pytest.mark.parametrize("build", [build_llm_deployment,
                                   build_openai_deployment])
def test_deployments_reserve_one_gpu_on_cuda(build):
    def opts(**kw):
        return build(_testing.llama_factory, **kw).deployment.config \
            .ray_actor_options

    assert opts() == {"num_gpus": 1}
    assert opts(device="cuda:0") == {"num_gpus": 1}
    assert opts(device="cpu") == {}
    assert opts(ray_actor_options={"num_cpus": 2}) == {"num_cpus": 2}
    app = build(_testing.llama_factory, device="cpu")
    assert app._kwargs["device"] == "cpu"


def _tensors(x, where="reply"):
    """Paths of every torch.Tensor inside x."""
    if isinstance(x, torch.Tensor):
        return [where]
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in _tensors(v, f"{where}.{k}")]
    if isinstance(x, (list, tuple)):
        return [p for i, v in enumerate(x)
                for p in _tensors(v, f"{where}[{i}]")]
    return []


@pytest.mark.parametrize("app", ["llm", "openai"])
def test_replies_and_stats_hold_no_tensors(apps, app):
    handle = apps["handles"][app]
    body = _body(app, PROMPTS[0], False)
    if app == "openai":
        body["logprobs"] = 1
    replies = {"unary": handle.remote(body).result(timeout_s=T),
               "stream": _testing.drain(handle.options(stream=True).remote(
                   _body(app, PROMPTS[0], True)), T),
               "stats": handle.stats.remote().result(timeout_s=T),
               "autoscale_metrics": handle.autoscale_metrics.remote()
               .result(timeout_s=T)}
    assert _tensors(replies) == []
    if app == "openai":
        lps = replies["unary"]["choices"][0]["logprobs"]["token_logprobs"]
        assert len(lps) == NEW and all(type(v) is float for v in lps)
    assert replies["stats"]["tokens_generated"] > 0
    assert isinstance(replies["autoscale_metrics"]["queue_depth"], float)


def test_stop_string_over_sse_aborts_and_frees_the_slot(apps, want):
    """A stop string that lands mid-stream cuts the reply there, ends it
    with finish_reason "stop", and aborts the engine request: after the
    stream every slot is free again."""
    stop = TOK.decode(want[2][2:4])
    events = _post(apps["port"], ROUTES["openai"],
                   {"prompt": PROMPTS[2], "max_tokens": NEW,
                    "temperature": 0.0, "stream": True, "stop": [stop]})
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    full = TOK.decode(want[2])
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        full[:full.index(stop)]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    handle = apps["handles"]["openai"]
    deadline = time.time() + T
    while True:
        st = handle.stats.remote().result(timeout_s=T)
        if st["active"] == 0 and st["free_slots"] == ENGINE["max_slots"]:
            break
        assert time.time() < deadline, f"slots not freed: {st}"
        time.sleep(0.05)
