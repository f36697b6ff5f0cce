"""The port's guided-decoding FSM and OpenAI surface against the
reference's.

`ray_tpu_torch/serve/llm/guided.py` must give the masks, transitions and
acceptance of `ray_tpu/serve/llm/guided.py` on the reference's specs
(token choices, regexes, JSON schemas). `OpenAIServer`, called directly
on the same fp32 weights with the same tokenizer, must answer every
request body as the reference's `OpenAIServer` does, ids and timestamps
aside (logprobs within 1e-4): completions and chat, unary and streamed
(stop-string holdback), `n` choices, logprobs, guided choice, regex and
JSON, penalties and logit_bias, and error objects. Bodies are greedy
(temperature 0): sampled tokens cannot match jax.random's bits.
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.serve.llm import LLMServer as JLLMServer
from ray_tpu.serve.llm import guided as j_guided
from ray_tpu.serve.llm.openai_api import OpenAIServer as JOpenAIServer
from ray_tpu.serve.llm.openai_api import _token_strings as j_token_strings
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu_torch.serve.llm import LLMServer, guided
from ray_tpu_torch.serve.llm.openai_api import OpenAIServer, _token_strings

WIDTHS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=128)
ENGINE = {"max_slots": 4, "max_seq_len": 128, "prefill_buckets": (16, 32),
          "max_new_tokens_default": 8, "logprobs": True}


class DummyTok:
    """Token ids are character codes (mod vocab); decode maps id t to
    chr(32 + t % 90) (the reference test's tokenizer)."""

    def __init__(self, vocab=128):
        self.vocab = vocab

    def encode(self, text):
        return [ord(c) % self.vocab for c in text]

    def decode(self, ids):
        return "".join(chr(32 + (int(t) % 90)) for t in ids)


# ---- guided.py ----------------------------------------------------------------

def _reachable_states(fsm, limit=400):
    """Every state reachable from the start over allowed tokens (BFS),
    with its mask, transitions and acceptance."""
    seen, order, frontier = {fsm.start}, [], [fsm.start]
    while frontier and len(order) < limit:
        state = frontier.pop(0)
        allowed = fsm.allowed(state)
        nxt = {int(t): fsm.advance(state, int(t))
               for t in np.flatnonzero(allowed)}
        order.append((state, allowed.tobytes(), nxt,
                      fsm.is_accepting(state), fsm.is_complete(state)))
        for s in nxt.values():
            if s >= 0 and s not in seen:
                seen.add(s)
                frontier.append(s)
    return order


TOY = [None, "1", "2", "3", "4", "5", "6", "7", "8", "9", "0", "abc", "a",
       "b", "-", "."]
ASCII = [None] + [chr(31 + i) for i in range(1, 96)]
SCHEMAS = [
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "n": {"type": "integer"}},
     "required": ["ok", "n"]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1,
     "maxItems": 3},
    {"type": "object", "properties": {
        "name": {"type": "string", "maxLength": 4},
        "kind": {"enum": ["a", "b"]}, "v": {"const": 3},
        "x": {"type": "number"}}, "required": ["name"]},
]
FSM_CASES = [
    ("choices", dict(seqs=[[5, 6], [5, 7, 8], [9]], vocab_size=16)),
    ("choices", dict(seqs=[[1, 2], [1, 2, 3]], vocab_size=8)),
    ("regex", dict(pattern=r"[1-9]{2,3}", strings=TOY)),
    ("regex", dict(pattern=r"(abc|a)b*-?[0-9]+", strings=TOY)),
    ("regex", dict(pattern=r"a.?\.[^a-c]{1,2}", strings=TOY)),
    ("regex", dict(pattern=r"\d{2,4}|ab+", strings=TOY)),
] + [("schema", dict(schema=s, strings=ASCII)) for s in SCHEMAS]


def _build(mod, kind, case):
    if kind == "choices":
        return mod.TokenFSM.from_choices(case["seqs"], case["vocab_size"],
                                         eos_id=0)
    pattern = (mod.json_schema_to_regex(case["schema"]) if kind == "schema"
               else case["pattern"])
    return mod.compile_guided(mod.GuidedSpec(regex=pattern),
                              vocab_size=len(case["strings"]), eos_id=0,
                              token_strings=case["strings"])


@pytest.mark.parametrize("kind,case", FSM_CASES)
def test_guided_fsm_matches_the_reference(kind, case):
    ours = _reachable_states(_build(guided, kind, case))
    theirs = _reachable_states(_build(j_guided, kind, case))
    assert len(ours) > 1
    assert ours == theirs
    if kind == "schema":
        assert guided.json_schema_to_regex(case["schema"]) == \
            j_guided.json_schema_to_regex(case["schema"])


def test_guided_validation_matches_the_reference():
    for mod in (guided, j_guided):
        with pytest.raises(ValueError):
            mod.GuidedSpec()
        with pytest.raises(ValueError):
            mod.GuidedSpec(choices=["a"], regex="b")
        with pytest.raises(ValueError, match="token_strings"):
            mod.compile_guided(mod.GuidedSpec(regex="a"), vocab_size=4,
                               eos_id=0)
    spec = guided.GuidedSpec(choices=["ab", "ba"])
    fsm = guided.compile_guided(spec, vocab_size=8, eos_id=0,
                                tokenize=lambda s: [{"a": 1, "b": 2}[c]
                                                    for c in s])
    assert set(np.flatnonzero(fsm.allowed(fsm.start))) == {1, 2}


def test_token_strings_match_the_reference():
    class SPTok:
        pieces = ["<pad>", "▁", "▁hi", "lo", "▁wo"]

        def convert_ids_to_tokens(self, ids):
            return [self.pieces[i] for i in ids]

        def decode(self, ids):
            return "".join(self.pieces[i].replace("▁", "") for i in ids)

    class Broken(DummyTok):
        def convert_ids_to_tokens(self, ids):
            raise RuntimeError("no piece vocab")

    for tok, n in ((SPTok(), 5), (DummyTok(), 128), (Broken(), 6)):
        assert _token_strings(tok, n) == j_token_strings(tok, n)
    assert _token_strings(SPTok(), 5) == ["<pad>", " ", " hi", "lo", " wo"]


# ---- OpenAIServer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_llm():
    model = JLlama(JConfig(**WIDTHS, dtype=jnp.float32, remat=False))
    return model, model.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def state(jax_llm):
    return llama_params_from_flax(jax.tree.map(np.asarray, jax_llm[1]))


def _factory(state):
    return lambda: (Llama(LlamaConfig(**WIDTHS, dtype=torch.float32),
                          device="cpu"), state)


@pytest.fixture(scope="module")
def servers(jax_llm, state):
    ref = JOpenAIServer(lambda: jax_llm, engine_config=dict(ENGINE),
                        tokenizer=DummyTok(), model_name="tiny-llama")
    ours = OpenAIServer(_factory(state), engine_config=dict(ENGINE),
                        tokenizer=DummyTok(), model_name="tiny-llama",
                        device="cpu")
    yield ours, ref
    ours.shutdown()
    ref.engine.shutdown()


def _answer(server, body):
    out = server(copy.deepcopy(body))
    if isinstance(out, dict):
        return out
    return list(out)            # a stream: every chunk, then "[DONE]"


def _split_logprobs(obj, found):
    """obj without ids, timestamps and logprob values (collected in
    `found`)."""
    if isinstance(obj, list):
        return [_split_logprobs(x, found) for x in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        if k in ("id", "created"):
            continue
        if k == "token_logprobs" and v is not None:
            found.extend(v)
            v = len(v)
        out[k] = _split_logprobs(v, found)
    return out


def _same(ours, ref, body):
    got_lp, want_lp = [], []
    got = _split_logprobs(_answer(ours, body), got_lp)
    want = _split_logprobs(_answer(ref, body), want_lp)
    assert got == want, body
    np.testing.assert_allclose(got_lp, want_lp, rtol=0, atol=1e-4)
    return got


GREEDY = {"temperature": 0}
BODIES = {
    "completion": {"prompt": [1, 2, 3, 4], "max_tokens": 6, **GREEDY},
    "text prompt": {"prompt": "hello there", "max_tokens": 5, **GREEDY},
    "default budget": {"prompt": [3, 4, 5], **GREEDY},
    "chat": {"messages": [{"role": "user", "content": "hi"}],
             "max_tokens": 5, **GREEDY},
    "stream": {"prompt": [5, 6, 7], "max_tokens": 4, "stream": True,
               **GREEDY},
    "chat stream": {"messages": [{"role": "user", "content": "yo"}],
                    "max_tokens": 3, "stream": True, **GREEDY},
    "n choices": {"prompt": [1, 2, 3, 4], "max_tokens": 5, "n": 3,
                  **GREEDY},
    "logprobs": {"prompt": [2, 4, 6], "max_tokens": 5, "logprobs": 1,
                 **GREEDY},
    "penalties": {"prompt": [2, 4, 6], "max_tokens": 8,
                  "presence_penalty": 1.5, "frequency_penalty": 0.5,
                  "logit_bias": {"33": 3.0, "40": -100}, **GREEDY},
    "logit_bias forces": {"prompt": [1, 2], "max_tokens": 4,
                          "logit_bias": {"77": 100}, **GREEDY},
    "guided choice": {"prompt": [1, 2, 3, 4], "max_tokens": 8,
                      "guided_choice": ["AB", "XY"], **GREEDY},
    "guided regex": {"prompt": [1, 2, 3, 4], "max_tokens": 8,
                     "guided_regex": "[0-9]{2}", **GREEDY},
    "guided json": {"prompt": [1, 2, 3, 4], "max_tokens": 24,
                    "guided_json": {"type": "array",
                                    "items": {"type": "integer"},
                                    "minItems": 1, "maxItems": 3},
                    **GREEDY},
    "guided with penalty": {"prompt": [9, 9], "max_tokens": 8,
                            "guided_choice": ["AB", "XY", "AX"],
                            "presence_penalty": 2.0,
                            "logit_bias": {"88": 5.0}, **GREEDY},
    "bad top_p": {"prompt": [1, 2], "top_p": 0.0},
    "bad top_p stream": {"prompt": [1], "top_p": 0.0, "stream": True},
    "two guides": {"prompt": [1, 2], "guided_choice": ["A"],
                   "guided_regex": "x"},
    "n stream": {"prompt": [1, 2], "n": 2, "stream": True},
    "best_of": {"prompt": [1, 2], "n": 2, "best_of": 5},
    "n zero": {"prompt": [1, 2], "n": 0},
    "bad penalty": {"prompt": [1, 2], "presence_penalty": 3.0},
}
ERRORS = ("bad top_p", "bad top_p stream", "two guides", "n stream",
          "best_of", "n zero", "bad penalty")


@pytest.mark.parametrize("name", list(BODIES))
def test_openai_answers_match_the_reference(servers, name):
    got = _same(*servers, BODIES[name])
    first = got if isinstance(got, dict) else got[0]
    if name in ERRORS:
        assert first["error"]["type"] == "invalid_request_error"
    else:
        assert "error" not in first and first["choices"]


def test_openai_stop_strings_match_the_reference(servers):
    """A stop string cuts unary and streamed text alike; a partial
    match at the end of a stream is flushed when the budget ends."""
    ours, _ref = servers
    body = {"prompt": [9, 8, 7], "max_tokens": 8, **GREEDY}
    full = _answer(ours, body)["choices"][0]["text"]
    assert len(full) >= 5
    for stop in (full[2], full[2:4], [full[2:4], "zz"], full[-1] + "\x00"):
        unary = _same(*servers, {**body, "stop": stop})
        streamed = _same(*servers, {**body, "stop": stop, "stream": True})
        text = "".join(c["choices"][0].get("text") or ""
                       for c in streamed[:-1])
        assert text == unary["choices"][0]["text"]


def test_openai_sampled_answers_have_the_reference_shape(servers):
    """Sampled (the OpenAI default temperature 1.0) n choices: the same
    structure and token counts as the reference's."""
    body = {"prompt": [1, 2, 3, 4], "max_tokens": 5, "n": 3,
            "logit_bias": {"0": -100}}
    ours, ref = servers
    got, want = _answer(ours, body), _answer(ref, body)
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    assert got["usage"] == want["usage"]
    assert {k for c in got["choices"] for k in c} == \
        {k for c in want["choices"] for k in c}


def test_n_choices_submit_failure_aborts_siblings(servers):
    """If the k-th of n submits raises, the k - 1 already submitted are
    aborted before the error propagates."""
    server, _ = servers
    submitted, aborted = [], []
    real_submit, real_abort = server.engine.submit, server.engine.abort

    def flaky_submit(*args, **kwargs):
        if len(submitted) == 2:
            raise RuntimeError("pool exhausted")
        rid = real_submit(*args, **kwargs)
        submitted.append(rid)
        return rid

    def spy_abort(rid):
        aborted.append(rid)
        real_abort(rid)

    server.engine.submit, server.engine.abort = flaky_submit, spy_abort
    try:
        with pytest.raises(RuntimeError, match="pool exhausted"):
            server._completions({"prompt": [1, 2, 3], "n": 3,
                                 "max_tokens": 4})
    finally:
        del server.engine.submit, server.engine.abort
    assert len(submitted) == 2 and sorted(aborted) == sorted(submitted)
    for rid in submitted:       # the aborted siblings still end
        list(server.engine.stream(rid))


def test_llm_server_surface(jax_llm, state):
    """LLMServer.register_prefix is idempotent per key, answers a key
    still registering as pending, and serves prompts that start with the
    prefix with the reference server's tokens; generate is __call__;
    autoscale_metrics reads the engine's stats; check_health passes on
    a live engine."""
    config = {**ENGINE, "max_prefixes": 2, "kv_page_size": 4}
    ours = LLMServer(_factory(state), engine_config=config, device="cpu")
    ref = JLLMServer(lambda: jax_llm, engine_config=config)
    prefix = list(range(3, 24))
    body = {"prompt": prefix + [5, 6, 7], "max_tokens": 6}
    try:
        first = ours.register_prefix({"prefix": prefix, "key": "sys"})
        assert first == {"key": "sys", "prefix_id": 0, "prefix_tokens": 21}
        assert ours.register_prefix({"prefix": prefix, "key": "sys"}) == \
            first
        ours._prefix_inflight.add("late")
        assert ours.register_prefix({"prefix": [1, 2], "key": "late"}) == \
            {"key": "late", "prefix_id": -1, "pending": True}
        assert ref.register_prefix({"prefix": prefix, "key": "sys"}) == \
            first
        got = ours.generate(dict(body))
        assert got == ref.generate(dict(body))
        metrics = ours.autoscale_metrics()
        assert metrics["prefix_tokens_saved"] == 21.0
        assert metrics["queue_depth"] == 0.0 and metrics["kv_util"] > 0
        assert set(metrics) == set(ref.autoscale_metrics())
        ours.check_health()
        ours.engine.shutdown()
        with pytest.raises(RuntimeError, match="loop died"):
            ours.check_health()
    finally:
        ours.shutdown()
        ref.engine.shutdown()
