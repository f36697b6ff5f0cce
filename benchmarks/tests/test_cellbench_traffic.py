"""The traffic generators: deterministic from the seed, the same work
for every seed in another order, and the stated distributions."""
import json
from pathlib import Path

import numpy as np

import cpu_cells  # noqa: F401  (puts the benchmark on sys.path)
from harness import traffic

BENCH = Path(__file__).resolve().parents[1]
CHAT = json.loads((BENCH / "traffic" / "chat.json").read_text())
PRETRAIN = json.loads((BENCH / "traffic" / "pretrain-8k.json").read_text())
BIG_SEED = 2 ** 31 + 12345


def _key(reqs):
    return [(r.due_s, r.max_new_tokens, r.prompt.tobytes()) for r in reqs]


def test_open_loop_is_a_function_of_the_seed():
    a = traffic.requests(CHAT, BIG_SEED, 51, 32000)
    b = traffic.requests(CHAT, BIG_SEED, 51, 32000)
    c = traffic.requests(CHAT, BIG_SEED + 1, 51, 32000)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)
    # every seed replays the same sizes and arrivals; the ids differ
    assert [(r.due_s, r.prompt.size, r.max_new_tokens) for r in a] == \
        [(r.due_s, r.prompt.size, r.max_new_tokens) for r in c]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_open_loop_arrivals_fill_the_window():
    reqs = traffic.requests(CHAT, 7, 51, 32000)
    assert len(reqs) == round(CHAT["rate_per_s"] * 51)
    dues = [r.due_s for r in reqs]
    assert dues == sorted(dues) and dues[0] > 0
    assert abs(dues[-1] - 51) < 1e-9
    for r in reqs:
        assert r.prompt.dtype == np.int32
        assert 0 <= r.prompt.min() and r.prompt.max() < 32000


def test_length_distributions_are_the_stated_ones():
    mix = dict(CHAT, rate_per_s=200.0)
    reqs = traffic.requests(mix, 3, 100, 32000)
    prompts = np.array([r.prompt.size for r in reqs])
    outputs = np.array([r.max_new_tokens for r in reqs])
    for xs, spec in ((prompts, CHAT["prompt_len"]),
                     (outputs, CHAT["output_len"])):
        assert xs.min() >= spec["min"] and xs.max() <= spec["max"]
        assert abs(np.median(xs) / spec["median"] - 1) < 0.05
        inner = xs[(xs > spec["min"]) & (xs < spec["max"])]
        # the log-lengths' spread is the stated sigma (clipping aside)
        assert abs(np.std(np.log(inner)) / spec["sigma"] - 1) < 0.1
    gaps = np.diff([0.0] + [r.due_s for r in reqs])
    assert abs(gaps.mean() * mix["rate_per_s"] - 1) < 1e-6
    # exponential gaps: the coefficient of variation is about 1
    assert abs(gaps.std() / gaps.mean() - 1) < 0.1


def test_lm_batches():
    a = traffic.lm_batches(PRETRAIN, BIG_SEED, 32768)
    b = traffic.lm_batches(PRETRAIN, BIG_SEED, 32768)
    rows = [next(a)["tokens"] for _ in range(4)]
    assert all(np.array_equal(x, next(b)["tokens"]) for x in rows)
    assert rows[0].shape == (PRETRAIN["batch"], PRETRAIN["seq_len"] + 1)
    assert rows[0].dtype == np.int32
    assert all(0 <= r.min() and r.max() < 32768 for r in rows)
    assert not np.array_equal(rows[0], rows[1])


def test_gamma_arrivals_have_the_stated_burstiness():
    mix = dict(CHAT, rate_per_s=200.0, arrivals={"law": "gamma", "cv": 3.0})
    reqs = traffic.requests(mix, BIG_SEED, 100, 32000)
    gaps = np.diff([0.0] + [r.due_s for r in reqs])
    assert len(reqs) == 20000
    assert abs(gaps.mean() * mix["rate_per_s"] - 1) < 1e-6
    assert abs(gaps.std() / gaps.mean() / 3.0 - 1) < 0.1


def test_closed_loop_requests_have_no_due_time():
    mix = dict(CHAT, arrivals={"law": "closed", "clients": 64,
                               "requests": 500})
    a = traffic.requests(mix, BIG_SEED, 51, 32000)
    b = traffic.requests(mix, BIG_SEED + 1, 51, 32000)
    assert len(a) == 500 and all(r.due_s is None for r in a)
    assert [r.prompt.size for r in a] == [r.prompt.size for r in b]
