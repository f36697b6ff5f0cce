"""n-gram speculation in the port's engine against the JAX engine.

Both engines run the same fp32 weights (converted with
llama_params_from_flax); greedy speculative output must be token-
identical to the JAX engine's on the contiguous cache and the paged one
(page 4, so verify steps of 1 + K tokens cross page-window boundaries),
with one request in flight the number of verify steps and accepted
proposals must equal the JAX engine's, and the edges of the reference's
tests/test_spec_decode.py are covered: a stop token and a budget inside
an accepted run, slots near max_seq_len, and sampled requests beside
speculating ones.
"""
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
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
from ray_tpu_torch.serve.llm.engine import _next_pow2

WIDTHS = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=160)
EOS = 0
BASE = dict(max_slots=4, max_seq_len=160, prefill_buckets=(16, 32),
            eos_token_id=EOS, ngram_speculation=4)
CACHES = [0, 4]                 # kv_page_size
# the model's greedy continuation of this prompt turns repetitive, so
# proposals are accepted
SPEC = np.array([15, 40, 33, 66, 10, 58, 33, 32] * 2, np.int32)
PLAIN = np.arange(1, 13, dtype=np.int32)


@pytest.fixture(scope="module")
def jax_llm():
    model = JLlama(JConfig(**WIDTHS, dtype=jnp.float32))
    return model, model.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def state(jax_llm):
    return llama_params_from_flax(jax.tree.map(np.asarray, jax_llm[1]))


def _engine(state, **kw):
    model = Llama(LlamaConfig(**WIDTHS, dtype=torch.float32), device="cpu")
    return LLMEngine(model, state, LLMEngineConfig(**{**BASE, **kw}),
                     device="cpu")


def _serve(engine, jobs):
    """Submit every (prompt, kwargs) job, stream each in order, shut the
    engine down; returns (token lists, stats)."""
    try:
        rids = [engine.submit(p, **kw) for p, kw in jobs]
        out = [list(engine.stream(r)) for r in rids]
        return out, engine.get_stats()
    finally:
        engine.shutdown()


STOP_AT = 9                     # index of the stop token in the output


@pytest.fixture(scope="module")
def jax_runs(jax_llm):
    model, params = jax_llm

    def run(jobs, **kw):
        return _serve(JEngine(model, params,
                              JEngineConfig(**{**BASE, **kw})), jobs)

    out = {}
    for kv in CACHES:
        out["spec", kv] = run([(SPEC, dict(max_new_tokens=40))],
                              kv_page_size=kv)
    full = out["spec", 0][0][0]
    out["stop"] = run([(SPEC, dict(max_new_tokens=40,
                                   stop_token_ids=[full[STOP_AT]]))])
    out["near_end"] = run([(SPEC, dict(max_new_tokens=30))],
                          max_seq_len=40, kv_page_size=4)
    out["mixed"] = run([(SPEC, dict(max_new_tokens=24)),
                        (SPEC[::-1].copy(), dict(max_new_tokens=24)),
                        (PLAIN, dict(max_new_tokens=12, temperature=0.8))],
                       kv_page_size=4)
    out["plain"] = run([(SPEC, dict(max_new_tokens=40))],
                       ngram_speculation=0)
    return out


@pytest.mark.parametrize("kv", CACHES)
def test_spec_tokens_and_steps_match_jax(jax_runs, state, kv):
    """One speculating request: the JAX engine's tokens (which are plain
    greedy decode's), and its number of verify steps and accepted
    proposals; fewer decode dispatches than tokens."""
    want, jstats = jax_runs["spec", kv]
    got, stats = _serve(_engine(state, kv_page_size=kv),
                        [(SPEC, dict(max_new_tokens=40))])
    assert got == want
    assert got[0] == jax_runs["plain"][0][0]
    assert stats["spec_steps"] == jstats["spec_steps"] > 0
    assert stats["spec_accepted"] == jstats["spec_accepted"] > 0
    assert stats["decode_steps"] < 40
    assert stats["free_slots"] == 4 and stats["active"] == 0


@pytest.mark.parametrize("kv", CACHES)
def test_spec_stop_token_and_budget_inside_an_accepted_run(jax_runs, state,
                                                           kv):
    full = jax_runs["spec", 0][0][0]
    stop = full[STOP_AT]
    got, _ = _serve(_engine(state, kv_page_size=kv),
                    [(SPEC, dict(max_new_tokens=40, stop_token_ids=[stop])),
                     (SPEC, dict(max_new_tokens=13))])
    assert got[0] == jax_runs["stop"][0][0]
    assert got[0] == full[:full.index(stop) + 1]
    assert got[1] == full[:13]


def test_spec_near_max_seq_len_matches_jax(jax_runs, state):
    """A slot within K + 1 of max_seq_len vetoes the verify step; the
    request still runs to max_seq_len (budget clamped to 24)."""
    got, stats = _serve(_engine(state, max_seq_len=40, kv_page_size=4),
                        [(SPEC, dict(max_new_tokens=30))])
    assert got == jax_runs["near_end"][0]
    assert len(got[0]) == 40 - SPEC.size
    assert stats["kv_pages"]["free"] == stats["kv_pages"]["total"]


def test_spec_verify_crossing_a_page_window_boundary(jax_runs, state):
    """Page 4: the paged decode window is a power of two of pages
    covering the longest slot. A verify step writes 1 + K positions, so
    its window must cover them: sized for one new token it would be a
    page short whenever the longest slot ends within K tokens of a
    window boundary, and the clamped writes of `PagedKV.flat_rows`
    would overwrite live KV of the slot. Such steps occur here, and the
    tokens stay the JAX engine's. Every verify step leaves the KV rows
    below the slot's length as they were."""
    engine = _engine(state, kv_page_size=4)
    crossings = []
    verify = engine._verify

    def spy(proposals, mask, temps, top_ps, window_pages, *rest):
        need = max(engine._disp_len.values())
        one_token = _next_pow2(-(-(need + 1) // 4))
        if window_pages and one_token < window_pages:
            crossings.append((need, window_pages))
        (slot,) = engine._active
        pages = engine._page_table[slot].long()
        rows = (pages[:, None] * 4 + torch.arange(4)).reshape(-1)
        rows = rows[:int(engine._lengths[slot])]
        pools = [engine._pools[0][0], engine._pools[-1][1]]
        before = [p[rows].clone() for p in pools]
        out = verify(proposals, mask, temps, top_ps, window_pages, *rest)
        assert all(torch.equal(p[rows], b) for p, b in zip(pools, before))
        return out

    engine._verify = spy
    got, _ = _serve(engine, [(SPEC, dict(max_new_tokens=40))])
    assert got == jax_runs["spec", 4][0]
    assert crossings, "no verify step crossed a window boundary"


def test_spec_mixed_sampled_and_greedy_requests(jax_runs, state):
    """Two speculating greedy requests and a sampled one decode
    together: the greedy ones give the JAX engine's tokens, the sampled
    one (verify position 0 only) its budget of in-vocab tokens."""
    want = jax_runs["mixed"][0]
    got, stats = _serve(_engine(state, kv_page_size=4),
                        [(SPEC, dict(max_new_tokens=24)),
                         (SPEC[::-1].copy(), dict(max_new_tokens=24)),
                         (PLAIN, dict(max_new_tokens=12, temperature=0.8))])
    assert got[:2] == want[:2]
    assert len(got[2]) == 12 and all(0 <= t < 128 for t in got[2])
    assert stats["spec_steps"] > 0


def test_spec_eligibility_follows_the_reference():
    """Only greedy, unguided, unpenalised requests keep a history to
    propose from."""
    engine = _engine(None)
    engine.shutdown()
    greedy = engine.submit(PLAIN)
    sampled = engine.submit(PLAIN, temperature=0.5)
    biased = engine.submit(PLAIN, logit_bias={3: 1.0})
    reqs = engine._requests
    assert reqs[greedy].hist == PLAIN.tolist()
    assert reqs[sampled].hist is None and reqs[biased].hist is None
