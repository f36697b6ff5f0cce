"""The port's continuous-batching engine against the JAX engine.

Greedy output must be token-identical to ray_tpu's LLMEngine on the same
parameters (fp32, debug config), on both caches (contiguous,
kv_page_size=0, and paged, kv_page_size=4), with bucketed and chunked
prefill, decode_block and prefix caching. On the CPU the JAX engine
decodes through its page-gather route and the port through K3's plain
version, and prefills through XLA attention vs K1's plain version, so
this also holds the kernels' semantics. Sampled output cannot match
jax.random's bits; it is checked for reproducibility under one
torch.Generator seed.
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


@pytest.mark.parametrize("name,value", [
    ("logprobs", True), ("precompile", True), ("ngram_speculation", 2),
    ("ngram_order", 3), ("ngram_lookback", 64), ("watchdog_s", 5.0)])
def test_every_reference_field_is_served(jax_llm, state, name, value):
    """Each field of the JAX engine's config that the port once refused
    is served: an engine with it set gives the JAX engine's tokens (and
    logprobs, within 1e-4) for the same field; the n-gram fields run
    with speculation on."""
    kw = {name: value}
    if name.startswith("ngram_") and name != "ngram_speculation":
        kw["ngram_speculation"] = 2
    prompt = np.tile(np.arange(5, 9), 4)
    jeng = JEngine(jax_llm[0], jax_llm[1], JEngineConfig(**BASE, **kw))
    try:
        want = list(jeng.stream_detailed(jeng.submit(prompt,
                                                     max_new_tokens=12)))
    finally:
        jeng.shutdown()
    eng = _engine(state, **kw)
    try:
        assert getattr(eng.cfg, name) == value
        got = list(eng.stream_detailed(eng.submit(prompt,
                                                  max_new_tokens=12)))
    finally:
        eng.shutdown()
    assert [t for t, _ in got] == [t for t, _ in want]
    if name == "logprobs":
        np.testing.assert_allclose([lp for _, lp in got],
                                   [lp for _, lp in want], rtol=0, atol=1e-4)
    else:
        assert [lp for _, lp in got] == [None] * 12


def test_default_cache_is_contiguous_as_in_jax():
    assert LLMEngineConfig().kv_page_size == 0 == \
        JEngineConfig().kv_page_size
    cfg = LLMEngineConfig(kv_page_size=0, prefill_chunk=8, decode_block=4,
                          max_prefixes=2)
    assert (cfg.prefill_chunk, cfg.decode_block, cfg.max_prefixes) == \
        (8, 4, 2)


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


# ---- contiguous cache, chunked prefill, decode_block, prefix caching ----

LONG = (np.arange(80) * 7 + 3) % 256            # past the largest bucket
CAP = (np.arange(118) * 5 + 1) % 256            # budget clamps to 10
PREFIX = (np.arange(21) * 11 + 2) % 256         # 5 pages of 4 and a part
SUFFIX = (np.arange(9) * 13 + 5) % 256
SUFFIX2 = (np.arange(20) * 3 + 7) % 256
CACHES = [0, 4]                                 # kv_page_size


@pytest.fixture(scope="module")
def jax_tokens(jax_llm):
    """Greedy tokens of the JAX engine: bucketed prefill on the
    contiguous cache, and chunked prefill (chunk 8), decode_block 2 and
    prefix caching on the paged cache."""
    model, params = jax_llm
    out = {}
    eng = JEngine(model, params, JEngineConfig(**{**BASE,
                                                  "kv_page_size": 0}))
    try:
        out["short"] = _run_all(eng, _prompts(), max_new_tokens=10)
    finally:
        eng.shutdown()
    eng = JEngine(model, params, JEngineConfig(
        **BASE, prefill_chunk=8, decode_block=2, max_prefixes=2))
    try:
        out["chunked"] = _run_all(eng, _prompts() + [LONG],
                                  max_new_tokens=10)
        out["cap"] = eng.generate_sync(CAP, max_new_tokens=20)
        pid = eng.register_prefix(PREFIX)
        rids = [eng.submit(SUFFIX, max_new_tokens=8, prefix_id=pid),
                eng.submit(_prompts()[0], max_new_tokens=8),
                eng.submit(SUFFIX2, max_new_tokens=8, prefix_id=pid)]
        out["prefix"] = [list(eng.stream(r)) for r in rids]
        out["prefix_saved"] = eng.get_stats()["prefix_tokens_saved"]
    finally:
        eng.shutdown()
    return out


@pytest.mark.parametrize("kv,batch", [(0, 1), (0, 4), (4, 1), (4, 4)])
def test_bucketed_prefill_matches_jax(jax_tokens, state, kv, batch):
    eng = _engine(state, kv_page_size=kv, max_prefill_batch=batch)
    try:
        got = _run_all(eng, _prompts(), max_new_tokens=10)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert got == jax_tokens["short"]
    assert stats["prefills"] == 5 and stats["free_slots"] == 4
    assert ("kv_pages" in stats) == (kv > 0)


@pytest.mark.parametrize("kv", CACHES)
def test_chunked_prefill_matches_jax(jax_tokens, state, kv):
    """Chunked prompts (all but the first) interleave with a bucketed one
    and with decode steps; one is past the largest bucket. A second run
    of the long prompt lands on a reused slot, whose stored length is
    stale."""
    eng = _engine(state, kv_page_size=kv, prefill_chunk=8)
    try:
        got = _run_all(eng, _prompts() + [LONG], max_new_tokens=10)
        again = eng.generate_sync(LONG, max_new_tokens=10)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert got == jax_tokens["chunked"]
    assert again == jax_tokens["chunked"][-1]
    assert stats["prefills"] == 7 and stats["prefilling"] == 0
    assert stats["free_slots"] == 4


@pytest.mark.parametrize("kv", CACHES)
@pytest.mark.parametrize("block", [2, 4])
def test_decode_block_matches_jax(jax_tokens, state, kv, block):
    """decode_block steps per dispatch, pipelined, up to the
    max_seq_len boundary (a 118-token prompt's budget clamps to 10)."""
    eng = _engine(state, kv_page_size=kv, prefill_chunk=8,
                  decode_block=block, pipeline_depth=2)
    try:
        got = _run_all(eng, _prompts() + [LONG], max_new_tokens=10)
        cap = eng.generate_sync(CAP, max_new_tokens=20)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert got == jax_tokens["chunked"]
    assert cap == jax_tokens["cap"] and len(cap) == 128 - CAP.size
    assert stats["decode_steps"] % block == 0


@pytest.mark.parametrize("kv", CACHES)
def test_prefix_matches_jax(jax_tokens, state, kv):
    """register_prefix + submit(prefix_id): the JAX engine's tokens and
    savings, and the same tokens as the full prompt without the prefix,
    with a plain request interleaved and a reused slot."""
    eng = _engine(state, kv_page_size=kv, max_prefixes=2)
    try:
        full = eng.generate_sync(np.concatenate([PREFIX, SUFFIX]),
                                 max_new_tokens=8)
        pid = eng.register_prefix(PREFIX)
        rids = [eng.submit(SUFFIX, max_new_tokens=8, prefix_id=pid),
                eng.submit(_prompts()[0], max_new_tokens=8),
                eng.submit(SUFFIX2, max_new_tokens=8, prefix_id=pid)]
        got = [list(eng.stream(r)) for r in rids]
        again = eng.generate_sync(SUFFIX, max_new_tokens=8, prefix_id=pid)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert got == jax_tokens["prefix"]
    assert got[0] == full == again
    assert jax_tokens["prefix_saved"] == 2 * PREFIX.size
    assert stats["prefix_tokens_saved"] == 3 * PREFIX.size
    if kv:
        # pinned pages stay; every exclusive page came back
        assert stats["kv_pages"]["pinned_prefix"] == 6
        assert stats["kv_pages"]["in_use"] == 6


def test_pinned_prefix_cannot_block_admission(state):
    """A request needing more exclusive pages than pinning leaves free
    errors its own stream instead of holding the queue head forever;
    requests behind it, and adopters, are served."""
    eng = _engine(state, kv_pool_tokens=64, max_prefixes=2)   # 16 pages
    try:
        pid = eng.register_prefix(np.arange(2, 44))           # pins 11
        assert eng.get_stats()["kv_pages"]["pinned_prefix"] == 11
        # ceil((20 + 40) / 4) = 15 exclusive pages; 5 can ever be free
        doomed = eng.submit(np.arange(2, 22), max_new_tokens=40)
        with pytest.raises(ValueError, match="pinned by prefixes"):
            list(eng.stream(doomed))
        assert len(eng.generate_sync(np.arange(2, 10),
                                     max_new_tokens=8)) == 8
        assert len(eng.generate_sync([7, 7], max_new_tokens=4,
                                     prefix_id=pid)) == 4
        eng._run_on_loop(lambda: eng._unregister_prefix_paged(pid))
        pages = eng.get_stats()["kv_pages"]
    finally:
        eng.shutdown()
    assert pages["free"] == pages["total"] and pages["pinned_prefix"] == 0


@pytest.mark.parametrize("kv", CACHES)
def test_prefix_validation(state, kv):
    eng = _engine(state, kv_page_size=kv, max_prefixes=1)
    plain = _engine(state, kv_page_size=kv)
    try:
        with pytest.raises(ValueError, match="unknown prefix_id"):
            eng.submit([1, 2], prefix_id=0)
        with pytest.raises(ValueError, match="empty"):
            eng.register_prefix([])
        with pytest.raises(ValueError, match="no room"):
            eng.register_prefix(np.arange(127))
        pid = eng.register_prefix([1, 2, 3])
        with pytest.raises(ValueError, match="exhausted"):
            eng.register_prefix([4, 5])
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit([], prefix_id=pid)
        with pytest.raises(ValueError, match="max_prefixes=0"):
            plain.register_prefix([1, 2])
    finally:
        eng.shutdown()
        plain.shutdown()


def test_abort_while_chunk_prefilling(state):
    eng = _engine(state, kv_page_size=0, prefill_chunk=8, max_slots=1)
    try:
        rid = eng.submit(LONG, max_new_tokens=40)
        eng.abort(rid)
        assert len(list(eng.stream(rid))) < 40
        # the slot came back: the engine keeps serving
        assert len(eng.generate_sync(_prompts()[0], max_new_tokens=4)) == 4
        assert eng.get_stats()["free_slots"] == 1
    finally:
        eng.shutdown()


def test_server_cached_prefixes(jax_tokens, state):
    """LLMServer(cached_prefixes=...) strips a registered prefix from a
    prompt that starts with it; the engine adopts its KV."""
    server = LLMServer(
        lambda: (Llama(LlamaConfig.debug(dtype=torch.float32),
                       device="cpu"), state),
        engine_config={**BASE, "kv_page_size": 0},
        cached_prefixes=[PREFIX.tolist()], device="cpu")
    try:
        toks = server({"prompt": np.concatenate([PREFIX, SUFFIX]).tolist(),
                       "max_tokens": 8})["tokens"]
        short = server({"prompt": PREFIX[:5].tolist(), "max_tokens": 2})
        saved = server.stats()["prefix_tokens_saved"]
    finally:
        server.shutdown()
    assert toks == jax_tokens["prefix"][0]
    assert len(short["tokens"]) == 2
    assert saved == PREFIX.size
