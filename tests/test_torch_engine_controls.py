"""The port's request controls against the JAX engine: penalties and
logit_bias, guided decoding, logprobs, deadlines, the watchdog and
precompile.

Both engines run the same fp32 weights (converted with
llama_params_from_flax). Greedy output under presence / frequency
penalties, logit_bias and guided masks (token choices and a regex, alone
and with penalties) must be token-identical to the JAX engine's on the
contiguous cache and the paged one, logprobs within 1e-4 of its
logprobs, and an engine built with precompile=True must serve the same
tokens with every slot free and no prefix savings counted. The cases
follow the reference's tests/test_penalties.py, test_guided_engine.py
and the engine tests of test_serve_fault_tolerance.py, held to the JAX
engine rather than to calibrated constants.
"""
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import LLMEngineConfig as JEngineConfig
from ray_tpu.serve.llm import TokenFSM as JTokenFSM
from ray_tpu_torch.exceptions import DeadlineExceededError, EngineWedgedError
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu.serve import context as j_context
from ray_tpu_torch.serve import context as t_context
from ray_tpu_torch.serve.context import _set_request_deadline
from ray_tpu_torch.serve.llm import (LLMEngine, LLMEngineConfig, LLMServer,
                                     TokenFSM)
from ray_tpu_torch.serve.llm.engine import _Request

WIDTHS = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128)
EOS = 0
BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32),
            eos_token_id=EOS)
CACHES = [0, 4]                 # kv_page_size
PROMPT = np.arange(1, 9, dtype=np.int32)
LONG = (np.arange(40) % 96 + 1).astype(np.int32)   # chunked at 16
CHOICES = [[11, 12, 13], [21, 22], [31]]
DIGITS = [None] * 128           # token strings: ids 1..9 are the digits
for _d in range(1, 10):
    DIGITS[_d] = str(_d)


def _pen_jobs():
    """Penalised requests decoding together (logit_bias forcing and
    blocking, presence and frequency penalties)."""
    return [(PROMPT, dict(max_new_tokens=8, logit_bias={77: 4.0},
                          presence_penalty=2.0)),
            (PROMPT + 1, dict(max_new_tokens=8, frequency_penalty=1.5)),
            (PROMPT + 2, dict(max_new_tokens=8, presence_penalty=-1.0,
                              frequency_penalty=0.7,
                              logit_bias={5: 2.0, 6: -3.0})),
            (PROMPT, dict(max_new_tokens=6, logit_bias={77: 1e4})),
            (PROMPT, dict(max_new_tokens=6, logit_bias={35: -1e4})),
            (LONG, dict(max_new_tokens=6, logit_bias={9: 3.0},
                        frequency_penalty=2.0))]


def _guided_jobs(fsm_cls):
    def choices():
        return fsm_cls.from_choices(CHOICES, vocab_size=128, eos_id=EOS)
    return [(PROMPT, dict(max_new_tokens=8, guided_fsm=choices())),
            (PROMPT + 3, dict(max_new_tokens=8, guided_fsm=fsm_cls.from_regex(
                r"[1-9]{2,3}", DIGITS, eos_id=EOS))),
            (LONG, dict(max_new_tokens=8, guided_fsm=choices())),
            (PROMPT, dict(max_new_tokens=8, guided_fsm=choices(),
                          logit_bias={21: 1e4})),
            (PROMPT + 5, dict(max_new_tokens=8, guided_fsm=choices(),
                              presence_penalty=2.0,
                              logit_bias={31: 2.5})),
            (PROMPT + 1, dict(max_new_tokens=6))]


def _lp_jobs():
    return [(PROMPT, dict(max_new_tokens=6)),
            (LONG, dict(max_new_tokens=6)),
            (PROMPT + 2, dict(max_new_tokens=6, logit_bias={40: 5.0}))]


@pytest.fixture(scope="module")
def jax_llm():
    model = JLlama(JConfig(**WIDTHS, dtype=jnp.float32))
    return model, model.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def state(jax_llm):
    return llama_params_from_flax(jax.tree.map(np.asarray, jax_llm[1]))


def _model():
    return Llama(LlamaConfig(**WIDTHS, dtype=torch.float32), device="cpu")


def _engine(state, **kw):
    return LLMEngine(_model(), state, LLMEngineConfig(**{**BASE, **kw}),
                     device="cpu")


def _serve(engine, jobs, detailed=False):
    """Submit every (prompt, kwargs) job, stream each in order, shut the
    engine down; returns (outputs, stats)."""
    read = engine.stream_detailed if detailed else engine.stream
    try:
        rids = [engine.submit(p, **kw) for p, kw in jobs]
        out = [list(read(r)) for r in rids]
        return out, engine.get_stats()
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_runs(jax_llm):
    model, params = jax_llm

    def run(jobs, detailed=False, **kw):
        return _serve(JEngine(model, params, JEngineConfig(**{
            **BASE, "prefill_chunk": 16, **kw})), jobs, detailed)

    out = {}
    for kv in CACHES:
        out["pen", kv] = run(_pen_jobs(), kv_page_size=kv)[0]
        out["guided", kv] = run(_guided_jobs(JTokenFSM), kv_page_size=kv)[0]
        out["lp", kv] = run(_lp_jobs(), True, kv_page_size=kv,
                            logprobs=True)[0]
    out["lp_block"] = run(_lp_jobs(), True, decode_block=2,
                          logprobs=True)[0]
    out["lp_spec"] = run([(np.array([15, 40, 33, 66, 10, 58, 33, 32] * 2),
                           dict(max_new_tokens=20))], True, kv_page_size=4,
                         logprobs=True, ngram_speculation=4)
    out["reuse"] = run([(PROMPT, dict(max_new_tokens=4,
                                      logit_bias={77: 1e4},
                                      presence_penalty=1.0)),
                        (PROMPT, dict(max_new_tokens=6))], max_slots=1)[0]
    eng = JEngine(model, params, JEngineConfig(**BASE, kv_page_size=4,
                                               max_prefixes=2,
                                               prefill_chunk=16))
    try:
        pid = eng.register_prefix(LONG[:20])
        out["precompile"] = [eng.generate_sync(PROMPT, max_new_tokens=6),
                             eng.generate_sync(LONG, max_new_tokens=6),
                             eng.generate_sync(LONG[20:], max_new_tokens=6,
                                               prefix_id=pid)]
    finally:
        eng.shutdown()
    return out


# ---- penalties and logit_bias ---------------------------------------------

@pytest.mark.parametrize("kv", CACHES)
def test_penalties_match_jax(jax_runs, state, kv):
    """Presence, frequency, logit_bias (forcing +1e4, blocking -1e4) and
    their mixes, six requests at once (one chunked), on both caches."""
    got, stats = _serve(_engine(state, kv_page_size=kv, prefill_chunk=16),
                        _pen_jobs())
    assert got == jax_runs["pen", kv]
    assert got[3] == [77] * 6
    assert stats["free_slots"] == 4 and stats["active"] == 0


def test_penalties_do_not_leak_across_slot_reuse(jax_runs, state):
    """One slot: a penalised request, then a plain one on the same slot,
    which starts from fresh counts and bias."""
    got, _ = _serve(_engine(state, max_slots=1, prefill_chunk=16),
                    [(PROMPT, dict(max_new_tokens=4, logit_bias={77: 1e4},
                                   presence_penalty=1.0)),
                     (PROMPT, dict(max_new_tokens=6))])
    assert got == jax_runs["reuse"]
    assert got[0] == [77] * 4 and got[1] != [77] * 6


def test_penalty_state_updates_in_place_on_the_device():
    """_pen_bias counts the fed token of each active row in place and
    gives static - presence * (count > 0) - frequency * count."""
    counts = torch.zeros((3, 8), dtype=torch.int32)
    static = torch.zeros((3, 8))
    static[1, 2] = 0.5
    pres = torch.tensor([1.0, 2.0, 0.0])
    freq = torch.tensor([0.5, 0.0, 0.0])
    mask = torch.tensor([True, True, False])
    for tok in ([3, 2, 4], [3, 5, 4]):
        bias = LLMEngine._pen_bias((counts, static, pres, freq),
                                   torch.tensor(tok), mask)
    assert counts[0, 3] == 2 and counts[1, 2] == 1 and counts[1, 5] == 1
    assert counts[2].sum() == 0
    assert bias[0, 3] == -1.0 - 0.5 * 2
    assert bias[1, 2] == 0.5 - 2.0 and bias[1, 5] == -2.0
    assert bias[2].abs().sum() == 0


def test_penalty_validation(state):
    engine = _engine(state)
    try:
        with pytest.raises(ValueError, match="penalties"):
            engine.submit(PROMPT, presence_penalty=3.0)
        with pytest.raises(ValueError, match="penalties"):
            engine.submit(PROMPT, frequency_penalty=-2.5)
    finally:
        engine.shutdown()


# ---- guided decoding --------------------------------------------------------

@pytest.mark.parametrize("kv", CACHES)
def test_guided_matches_jax(jax_runs, state, kv):
    """Choices (bucketed and chunked prefill), a regex over digit
    tokens, choices steered by logit_bias and with a presence penalty,
    beside an unguided request, on both caches: the JAX engine's tokens,
    each guided output in its language."""
    got, _ = _serve(_engine(state, kv_page_size=kv, prefill_chunk=16),
                    _guided_jobs(TokenFSM))
    assert got == jax_runs["guided", kv]
    for out in (got[0], got[2], got[4]):
        assert [t for t in out if t != EOS] in CHOICES
    digits = [t for t in got[1] if t != EOS]
    assert 2 <= len(digits) <= 3 and all(1 <= t <= 9 for t in digits)
    assert [t for t in got[3] if t != EOS] == [21, 22]
    assert len(got[5]) == 6


def test_guided_submit_validation(state):
    engine = _engine(state)
    try:
        dead = TokenFSM.from_choices([], vocab_size=128, eos_id=EOS)
        with pytest.raises(ValueError, match="no token"):
            engine.submit(PROMPT, guided_fsm=dead)
        with pytest.raises(ValueError, match="vocab_size"):
            engine.submit(PROMPT, guided_fsm=TokenFSM.from_choices(
                [[1]], vocab_size=64, eos_id=EOS))
        with pytest.raises(ValueError, match="eos"):
            engine.submit(PROMPT, guided_fsm=TokenFSM.from_choices(
                [[1]], vocab_size=128, eos_id=99))
    finally:
        engine.shutdown()


def test_guided_allow_cache_keys_on_request_id(state):
    """The decode mask's host buffer rebuilds a slot's row when the
    request in the slot changes, even at the same fsm_state: the cache
    keys on request_id, never on id(request)."""
    engine = _engine(state)
    engine.shutdown()
    fsm_a = TokenFSM.from_choices([[11, 12]], vocab_size=128, eos_id=EOS)
    fsm_b = TokenFSM.from_choices([[21, 22]], vocab_size=128, eos_id=EOS)
    r1 = _Request(request_id="req-key-a", prompt=PROMPT, max_new_tokens=4,
                  temperature=0.0, fsm=fsm_a, fsm_state=fsm_a.start)
    engine._active[0] = r1
    m1 = engine._guided_decode_allow().numpy()
    assert m1[0, 11] and not m1[0, 21] and m1[1].all()
    assert [key[0] for key in engine._guided_prev.values()] == ["req-key-a"]
    r2 = _Request(request_id="req-key-b", prompt=PROMPT, max_new_tokens=4,
                  temperature=0.0, fsm=fsm_b, fsm_state=fsm_b.start)
    assert r2.fsm_state == r1.fsm_state
    engine._active[0] = r2
    m2 = engine._guided_decode_allow().numpy()
    assert m2[0, 21] and not m2[0, 11]
    engine._active.clear()
    assert engine._guided_decode_allow() is None


# ---- logprobs ---------------------------------------------------------------

@pytest.mark.parametrize("kv", CACHES)
def test_logprobs_match_jax(jax_runs, state, kv):
    """Each token's logprob under the raw model distribution (before a
    logit_bias), for bucketed and chunked prefill and decode steps."""
    got, _ = _serve(_engine(state, kv_page_size=kv, prefill_chunk=16,
                            logprobs=True), _lp_jobs(), detailed=True)
    _assert_logprobs(got, jax_runs["lp", kv])


def test_logprobs_of_decode_block_and_verify_steps_match_jax(jax_runs,
                                                             state):
    got, _ = _serve(_engine(state, prefill_chunk=16, decode_block=2,
                            logprobs=True), _lp_jobs(), detailed=True)
    _assert_logprobs(got, jax_runs["lp_block"])
    want, jstats = jax_runs["lp_spec"]
    got, stats = _serve(_engine(state, prefill_chunk=16, kv_page_size=4,
                                logprobs=True, ngram_speculation=4),
                        [(np.array([15, 40, 33, 66, 10, 58, 33, 32] * 2),
                          dict(max_new_tokens=20))], detailed=True)
    _assert_logprobs(got, want)
    assert stats["spec_accepted"] == jstats["spec_accepted"] > 0


def _assert_logprobs(got, want):
    assert [[t for t, _ in o] for o in got] == \
        [[t for t, _ in o] for o in want]
    lp = np.array([lp for o in got for _, lp in o])
    lp_want = np.array([lp for o in want for _, lp in o])
    assert np.all(lp <= 0.0)
    np.testing.assert_allclose(lp, lp_want, rtol=0, atol=1e-4)


def test_logprobs_off_yields_none(state):
    got, _ = _serve(_engine(state), [(PROMPT, dict(max_new_tokens=3))],
                    detailed=True)
    assert [lp for _, lp in got[0]] == [None] * 3


# ---- deadlines and the watchdog --------------------------------------------

def _busy_then_queued(submit, stream, deadline):
    """One slot held by a long request; a second request whose deadline
    passes while it waits is shed at admission."""
    busy = submit(PROMPT, max_new_tokens=48)
    doomed = submit(PROMPT + 1, max_new_tokens=4, deadline_ts=deadline)
    with pytest.raises(DeadlineExceededError):
        list(stream(doomed))
    assert len(list(stream(busy))) == 48


def test_deadline_refused_at_submit_and_shed_at_admission(state):
    engine = _engine(state, max_slots=1)
    try:
        with pytest.raises(DeadlineExceededError):
            engine.submit(PROMPT, deadline_ts=time.time() - 1)
        _busy_then_queued(engine.submit, engine.stream, time.time() + 0.02)
        stats = engine.get_stats()
        assert stats["free_slots"] == 1 and stats["prefills"] == 1
        assert engine._requests == {}
    finally:
        engine.shutdown()


def test_server_passes_the_request_deadline(state):
    """LLMServer reads the deadline of serve.context: an expired one is
    refused, and one that passes while the request is queued sheds
    it."""
    server = LLMServer(_model_factory(state), engine_config={
        **BASE, "max_slots": 1}, device="cpu")
    try:
        _set_request_deadline(time.time() - 1)
        with pytest.raises(DeadlineExceededError):
            server({"prompt": PROMPT.tolist(), "max_tokens": 2})
        _set_request_deadline(None)
        results = []
        busy = threading.Thread(target=lambda: results.append(server(
            {"prompt": PROMPT.tolist(), "max_tokens": 48})["tokens"]))
        busy.start()
        deadline = time.time() + 30
        while not server.engine._active and time.time() < deadline:
            time.sleep(0.005)
        _set_request_deadline(time.time() + 0.01)
        with pytest.raises(DeadlineExceededError):
            server({"prompt": (PROMPT + 1).tolist(), "max_tokens": 4})
        _set_request_deadline(None)
        busy.join(60)
        assert not busy.is_alive() and len(results[0]) == 48
    finally:
        _set_request_deadline(None)
        server.shutdown()


@pytest.mark.parametrize("offset", [None, 30.0, -5.0])
def test_remaining_budget_matches_jax(offset):
    """serve.context.remaining_budget: None without a deadline, else the
    seconds left (0 once passed), as the reference's."""
    deadline = None if offset is None else time.time() + offset
    try:
        _set_request_deadline(deadline)
        j_context._set_request_deadline(deadline)
        got, want = t_context.remaining_budget(), j_context.remaining_budget()
    finally:
        _set_request_deadline(None)
        j_context._set_request_deadline(None)
    if offset is None:
        assert got is None and want is None
    else:
        assert abs(got - want) < 1.0 and got <= max(offset, 0.0)
        assert (got == 0.0) == (offset < 0)


def _model_factory(state):
    return lambda: (_model(), state)


def test_watchdog_declares_a_stalled_engine_wedged(state):
    """A stall of the loop past watchdog_s x the dispatch grace with a
    request in flight: the engine is wedged, the stream raises
    EngineWedgedError, and so do later submits and check_health."""
    server = LLMServer(_model_factory(state), engine_config={
        **BASE, "watchdog_s": 0.5}, device="cpu")
    engine = server.engine
    try:
        assert len(engine.generate_sync(PROMPT, max_new_tokens=4)) == 4
        server.check_health()
        assert not engine.wedged
        engine._chaos_stall(7.0)    # > 10 x 0.5 s: the command's grace
        rid = engine.submit(PROMPT, max_new_tokens=8)
        with pytest.raises(EngineWedgedError):
            list(engine.stream(rid))
        assert engine.wedged
        with pytest.raises(EngineWedgedError):
            engine.submit(PROMPT)
        with pytest.raises(EngineWedgedError):
            server.check_health()
    finally:
        server.shutdown()


def test_idle_engine_is_never_wedged(state):
    engine = _engine(state, watchdog_s=0.5)
    try:
        assert engine.generate_sync(PROMPT, max_new_tokens=2)
        time.sleep(2.0)                        # 4 windows, idle
        assert not engine.wedged
        assert engine.generate_sync(PROMPT, max_new_tokens=2)
    finally:
        engine.shutdown()
    engine = _engine(state, watchdog_s=0)
    engine.shutdown()
    assert engine._watchdog_thread is None


def test_watchdog_window_reads_the_knob(state, monkeypatch):
    monkeypatch.setenv("RAY_TPU_ENGINE_WATCHDOG_S", "7.5")
    engine = _engine(state)
    engine.shutdown()
    assert engine._watchdog_s == 7.5
    monkeypatch.delenv("RAY_TPU_ENGINE_WATCHDOG_S")
    engine = _engine(state, watchdog_s=2.0)
    engine.shutdown()
    assert engine._watchdog_s == 2.0


# ---- precompile -------------------------------------------------------------

@pytest.mark.parametrize("kv", CACHES)
def test_precompile_leaves_the_engine_as_it_was(jax_runs, state, kv):
    """precompile=True warms every bucket, the chunked and the prefix
    paths in __init__: afterwards every slot (and page) is free,
    prefix_tokens_saved is 0, and requests get the JAX engine's
    tokens."""
    engine = _engine(state, kv_page_size=kv, max_prefixes=2,
                     prefill_chunk=16, precompile=True)
    try:
        stats = engine.get_stats()
        assert stats["prefix_tokens_saved"] == 0
        assert stats["prefills"] > 0 and stats["free_slots"] == 4
        assert stats["active"] == 0 and stats["prefilling"] == 0
        if kv:
            assert stats["kv_pages"]["free"] == stats["kv_pages"]["total"]
        assert engine._prefixes == {}
        pid = engine.register_prefix(LONG[:20])
        assert pid == 0
        got = [engine.generate_sync(PROMPT, max_new_tokens=6),
               engine.generate_sync(LONG, max_new_tokens=6),
               engine.generate_sync(LONG[20:], max_new_tokens=6,
                                    prefix_id=pid)]
        assert engine.get_stats()["prefix_tokens_saved"] == 20
    finally:
        engine.shutdown()
    assert got == jax_runs["precompile"]
