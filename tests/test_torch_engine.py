"""The port's paged continuous-batching engine against the JAX engine.

Greedy output must be token-identical to ray_tpu's LLMEngine on the same
parameters (fp32, debug config). On the CPU the JAX engine decodes
through its page-gather route and the port through K3's plain version,
and prefills through XLA attention vs K1's plain version, so this also
holds the kernels' semantics. Sampled output cannot match jax.random's
bits; it is checked for reproducibility under one torch.Generator seed.
"""
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import LLMEngineConfig as JEngineConfig
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig, LLMServer

BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
            kv_page_size=4, max_prefill_batch=4)


@pytest.fixture(scope="module")
def jax_llm():
    cfg = JConfig.debug(dtype=jnp.float32)
    model = JLlama(cfg)
    return model, model.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def state(jax_llm):
    return llama_params_from_flax(jax.tree.map(np.asarray, jax_llm[1]))


def _engine(state, **kw):
    model = Llama(LlamaConfig.debug(dtype=torch.float32), device="cpu")
    seed = kw.pop("seed", 0)
    return LLMEngine(model, state, LLMEngineConfig(**{**BASE, **kw}),
                     device="cpu", seed=seed)


def _prompts():
    # lengths 5..33 across the 16 / 32 / 64 buckets
    return [np.arange(1 + i, 6 + i * 7) % 256 for i in range(5)]


def _run_all(engine, prompts, **kw):
    rids = [engine.submit(p, **kw) for p in prompts]
    return [list(engine.stream(r)) for r in rids]


def test_greedy_tokens_identical_to_jax_engine(jax_llm, state):
    prompts = _prompts()
    jeng = JEngine(jax_llm[0], jax_llm[1], JEngineConfig(**BASE))
    try:
        want = _run_all(jeng, prompts, max_new_tokens=10)
    finally:
        jeng.shutdown()
    eng = _engine(state)
    try:
        got = _run_all(eng, prompts, max_new_tokens=10)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert got == want
    assert stats["prefills"] == 5
    assert stats["kv_pages"]["free"] == stats["kv_pages"]["total"]
    assert stats["active"] == 0 and stats["free_slots"] == 4


def test_small_pool_holds_head_request_and_finishes_all(state):
    """A pool of 12 four-token pages fits one or two requests at a time;
    every request still finishes (FIFO hold at admission) with the
    tokens it gets alone."""
    prompts = _prompts()
    big = _engine(state)
    try:
        want = [big.generate_sync(p, max_new_tokens=8) for p in prompts]
    finally:
        big.shutdown()
    small = _engine(state, kv_pool_tokens=48)
    try:
        got = _run_all(small, prompts, max_new_tokens=8)
        stats = small.get_stats()
    finally:
        small.shutdown()
    assert got == want
    assert stats["kv_pages"]["total"] == 12
    assert stats["kv_pages"]["peak_in_use"] <= 12
    assert stats["kv_pages"]["free"] == 12


def test_request_larger_than_pool_is_refused(state):
    eng = _engine(state, kv_pool_tokens=16)
    try:
        with pytest.raises(ValueError, match="could never be admitted"):
            eng.submit(np.arange(10), max_new_tokens=20)
    finally:
        eng.shutdown()


def test_stop_token_ids_end_the_stream(state):
    eng = _engine(state)
    try:
        full = eng.generate_sync(_prompts()[1], max_new_tokens=10)
        stop = full[3]
        got = eng.generate_sync(_prompts()[1], max_new_tokens=10,
                                stop_token_ids=[stop])
    finally:
        eng.shutdown()
    assert got == full[:full.index(stop) + 1]


def test_abort_ends_streams(state):
    eng = _engine(state, max_slots=1)
    try:
        rid = eng.submit(_prompts()[0], max_new_tokens=100)
        queued = eng.submit(_prompts()[1], max_new_tokens=5)
        # one slot, held by rid: `queued` waits, so aborting it ends its
        # stream at once
        eng.abort(queued)
        assert list(eng.stream(queued)) == []
        it = eng.stream(rid)
        first = [next(it) for _ in range(3)]
        eng.abort(rid)                      # decoding: budget collapses
        rest = list(it)
        assert 3 + len(rest) < 100 and len(first) == 3
        # the engine keeps serving after aborts
        assert len(eng.generate_sync(_prompts()[2], max_new_tokens=4)) == 4
    finally:
        eng.shutdown()


def test_unported_configurations_raise():
    with pytest.raises(NotImplementedError, match="paged"):
        LLMEngineConfig(kv_page_size=0)
    with pytest.raises(NotImplementedError, match="decode_block"):
        LLMEngineConfig(decode_block=4)
    with pytest.raises(NotImplementedError, match="max_prefixes"):
        LLMEngineConfig(max_prefixes=2)


def test_submit_validates(state):
    eng = _engine(state)
    try:
        with pytest.raises(ValueError, match="empty"):
            eng.submit([])
        with pytest.raises(ValueError, match="top_p"):
            eng.submit([1, 2], top_p=0.0)
        with pytest.raises(ValueError, match="bucket"):
            eng.submit(np.arange(65))
    finally:
        eng.shutdown()


def test_seeded_sampling_is_reproducible(state):
    prompt = _prompts()[3]

    def sample(seed):
        eng = _engine(state, seed=seed)
        try:
            return eng.generate_sync(prompt, max_new_tokens=12,
                                     temperature=1.0, top_p=0.9)
        finally:
            eng.shutdown()

    a, b, c = sample(7), sample(7), sample(8)
    assert a == b
    assert a != c
    assert all(0 <= t < 256 for t in a + c)


def test_sampling_rules():
    """Greedy rows take the argmax; top-k and top-p cut the candidates."""
    eng = _engine(None, top_k=2)
    try:
        logits = torch.tensor([[0.0, 5.0, 4.0, -1.0],
                               [3.0, 0.0, 2.9, 1.0],
                               [0.0, 0.0, 9.0, 0.0]])
        temps = torch.tensor([0.0, 1.0, 1.0])
        top_ps = torch.tensor([1.0, 1.0, 0.5])
        seen = set()
        for _ in range(50):
            out = eng._sample_tokens(logits, temps, top_ps, True, True)
            assert out[0] == 1 and out[2] == 2   # greedy; top-p keeps 1
            seen.add(int(out[1]))
        assert seen == {0, 2}                     # top-k = 2
    finally:
        eng.shutdown()


def test_server_unary_and_streamed(state):
    server = LLMServer(
        lambda: (Llama(LlamaConfig.debug(dtype=torch.float32),
                       device="cpu"), state),
        engine_config=BASE, device="cpu")
    try:
        prompt = _prompts()[2].tolist()
        unary = server({"prompt": prompt, "max_tokens": 6})
        streamed = list(server({"prompt": prompt, "max_tokens": 6,
                                "stream": True}))
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            server({"prompt": prompt, "max_tokens": 6})["tokens"]))
            for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert server.stats()["tokens_generated"] == 30
    finally:
        server.shutdown()
    assert len(unary["tokens"]) == 6
    assert streamed == unary["tokens"]
    assert results == [unary["tokens"]] * 3
    with pytest.raises(ValueError, match="tokenizer"):
        server({"prompt": "text"})


def test_cuda_device_raises_without_a_gpu(state):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    model = Llama(LlamaConfig.debug(dtype=torch.float32), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(model, state, LLMEngineConfig(**BASE))
