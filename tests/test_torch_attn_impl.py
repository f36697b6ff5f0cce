"""Pinned attention routes: `attn_impl` "xla" | "dpa" | "pallas" on
Llama, Mixtral and GPT-2, the `RAY_TPU_ATTN_IMPL` and
`RAY_TPU_PAGED_ATTN_IMPL` knobs, and the raises, each held to the
reference's same route on the same inputs (numpy, seeded).

On the CPU the reference's "pallas" runs its Pallas kernels in interpret
mode and the port's runs each kernel's plain version; "dpa" is
`jax.nn.dot_product_attention` against `F.scaled_dot_product_attention`.
Tolerance: 1e-5 absolute on fp32 logits and attention outputs.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu import models as jmodels
from ray_tpu.ops import attention as j_attn
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import LLMEngineConfig as JEngineConfig
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import convert
from ray_tpu_torch.ops import attention as t_attn
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig

ATOL = 1e-5
ROUTES = ("xla", "pallas", "dpa")


def _t(a):
    return torch.from_numpy(np.array(a))


_PARAMS = {}


def _family(name, impl):
    """(jax model, flax params, port model) of one debug family in fp32,
    both pinned to `impl`, sharing the reference's weights."""
    if name == "llama":
        jcfg = jmodels.LlamaConfig.debug(dtype=jnp.float32, attn_impl=impl)
        tcfg = tmodels.LlamaConfig.debug(dtype=torch.float32,
                                         attn_impl=impl)
        jm, tcls, conv = (jmodels.Llama(jcfg), tmodels.Llama,
                          convert.llama_params_from_flax)
    elif name == "mixtral":
        jcfg = dataclasses.replace(jmodels.MixtralConfig.debug(
            dtype=jnp.float32, attn_impl=impl), n_experts=2)
        tcfg = dataclasses.replace(tmodels.MixtralConfig.debug(
            dtype=torch.float32, attn_impl=impl), n_experts=2)
        jm, tcls, conv = (jmodels.Mixtral(jcfg), tmodels.Mixtral,
                          convert.mixtral_params_from_flax)
    else:
        jcfg = jmodels.GPT2Config.debug(dtype=jnp.float32, attn_impl=impl)
        tcfg = tmodels.GPT2Config.debug(dtype=torch.float32,
                                        attn_impl=impl)
        jm, tcls, conv = (jmodels.GPT2(jcfg), tmodels.GPT2,
                          convert.gpt2_params_from_flax)
    if name not in _PARAMS:         # the weights do not depend on impl
        _PARAMS[name] = jax.jit(jm.init)(
            jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    params = _PARAMS[name]
    tm = tcls(tcfg, device="cpu")
    tm.load_state_dict(conv(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("name", ["llama", "mixtral", "gpt2"])
def test_pinned_route_logits_match_the_reference_route(name, impl):
    jm, params, tm = _family(name, impl)
    tokens = np.random.RandomState(11).randint(0, 256, (2, 16)) \
        .astype(np.int32)
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(_t(tokens))
    if isinstance(want, tuple):
        want, got = want[0], got[0]
    assert tm.cfg.attn_impl == impl
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _qkv(sq, sk, hq=4, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, h, d)).astype(np.float32)
            for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]


@pytest.mark.parametrize("impl,sq,sk,causal", [
    ("xla", 4, 12, True), ("xla", 12, 12, False), ("pallas", 4, 12, True),
    ("pallas", 12, 12, False), ("dpa", 12, 12, False)])
def test_pinned_route_op_matches_the_reference_route(impl, sq, sk, causal):
    """multi_head_attention at GQA 4/2, where the models' causal
    self-attention (above) does not reach: "xla" with an offset mask,
    "pallas" with causal Sq != Sk running the kernel (plain version
    here) and comparing absolute indices as the reference's explicit
    "pallas" does, and each route without a mask."""
    q, k, v = _qkv(sq, sk)
    want = j_attn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        impl=impl)
    got = t_attn.multi_head_attention(_t(q), _t(k), _t(v), causal=causal,
                                      impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("value", ["auto", "xla", "dpa", "pallas"])
def test_attn_knob_reads_as_the_reference_reads_it(monkeypatch, value):
    """RAY_TPU_ATTN_IMPL overrides "auto" and leaves a pinned impl
    alone; "auto" left over takes "xla" on a CPU tensor in both."""
    monkeypatch.setenv("RAY_TPU_ATTN_IMPL", value)
    q, k, v = _qkv(8, 8)
    for impl in ("auto", "xla"):
        want = j_attn._resolve_impl(impl, jnp.asarray(q), jnp.asarray(k),
                                    True, None)
        got = t_attn.resolve_impl(impl, _t(q), _t(k), _t(v), True, None)
        assert got == want


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_engine_tokens_under_the_paged_knob_match_the_reference(
        monkeypatch):
    """tests/test_paged_attention_kernel.py's engine case: greedy tokens
    with RAY_TPU_PAGED_ATTN_IMPL "pallas" (the reference's kernel in
    interpret mode, the port's K3 plain version) and "gather" are one
    list (that reference test holds its "gather" to its "pallas"; here
    the port's two runs are held to the reference's "pallas" run). The
    port's knob is read on every call:
    "pallas" sends every decode step through `paged_decode_attention`,
    "gather" sends none, and the fresh prefills through
    `multi_head_attention` only under "pallas"."""
    jcfg = jmodels.LlamaConfig(vocab_size=128, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=64,
                               max_seq_len=64, remat=False,
                               dtype=jnp.float32)
    jm = jmodels.Llama(jcfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    state = convert.llama_params_from_flax(jax.tree.map(np.asarray, params))
    prompts = [np.arange(2, 8) % 128, np.arange(3, 20) % 128]
    # one prefill bucket (the reference test's are (8, 32)): each bucket
    # is one more interpret-mode compile of the reference's kernel
    eng_kw = dict(max_slots=2, max_seq_len=64, prefill_buckets=(32,),
                  kv_page_size=8, max_prefill_batch=1)

    def ref(impl):
        monkeypatch.setenv("RAY_TPU_PAGED_ATTN_IMPL", impl)
        eng = JEngine(jm, params, JEngineConfig(**eng_kw))
        try:
            return [eng.generate_sync(p, max_new_tokens=6)
                    for p in prompts]
        finally:
            eng.shutdown()

    def port(impl):
        monkeypatch.setenv("RAY_TPU_PAGED_ATTN_IMPL", impl)
        tcfg = tmodels.LlamaConfig(vocab_size=128, d_model=32, n_layers=2,
                                   n_heads=4, n_kv_heads=2, d_ff=64,
                                   max_seq_len=64, dtype=torch.float32)
        model = tmodels.Llama(tcfg, device="cpu")
        eng = LLMEngine(model, state, LLMEngineConfig(**eng_kw),
                        device="cpu")
        try:
            return [eng.generate_sync(p, max_new_tokens=6)
                    for p in prompts]
        finally:
            eng.shutdown()

    decode = _count_calls(monkeypatch, t_attn, "paged_decode_attention")
    prefill = _count_calls(monkeypatch, t_attn, "multi_head_attention")
    got_pallas = port("pallas")
    assert len(decode) > 0 and len(prefill) > 0
    decode.clear()
    prefill.clear()
    got_gather = port("gather")
    assert decode == [] and prefill == []
    want = ref("pallas")
    assert got_pallas == want and got_gather == want


def test_bad_values_raise():
    for cfg in (tmodels.LlamaConfig.debug, tmodels.MixtralConfig.debug,
                tmodels.GPT2Config.debug):
        with pytest.raises(ValueError, match="attn_impl"):
            cfg(attn_impl="flash")
    q, k, v = (_t(a) for a in _qkv(8, 8))
    with pytest.raises(ValueError, match="attn_impl"):
        t_attn.multi_head_attention(q, k, v, impl="einsum")


@pytest.mark.parametrize("knob,value", [
    ("RAY_TPU_ATTN_IMPL", "flash"), ("RAY_TPU_PAGED_ATTN_IMPL", "xla")])
def test_bad_knob_values_raise_when_read(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    q, k, v = (_t(a) for a in _qkv(8, 8))
    with pytest.raises(ValueError, match=knob):
        if knob == "RAY_TPU_ATTN_IMPL":
            t_attn.multi_head_attention(q, k, v)
        else:
            pool = torch.zeros(16, 2, 16)
            cache = t_attn.PagedKV(pool, pool.clone(),
                                   torch.zeros(2, 2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32), 8,
                                   fresh=True)
            t_attn.paged_cached_attention(
                q, k, v, cache, torch.arange(8).expand(2, 8))


def test_dpa_refuses_what_the_reference_refuses():
    q, k, v = _qkv(4, 8)
    with pytest.raises(ValueError, match="dpa"):
        j_attn.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), impl="dpa")
    with pytest.raises(ValueError, match="dpa"):
        t_attn.multi_head_attention(_t(q), _t(k), _t(v), impl="dpa")
    q, k, v = (_t(a) for a in _qkv(8, 8))
    seg = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="dpa"):
        t_attn.multi_head_attention(q, k, v, segment_ids=seg, impl="dpa")


def test_pallas_with_segment_ids_raises_where_the_reference_drops_them():
    """The reference's explicit "pallas" calls its kernel without the
    segment mask (its output equals the unmasked one); the port raises."""
    q, k, v = _qkv(8, 8)
    seg = np.repeat(np.array([[0] * 4 + [1] * 4]), 2, 0).astype(np.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    dropped = j_attn.multi_head_attention(jq, jk, jv, impl="pallas",
                                          segment_ids=jnp.asarray(seg))
    plain = j_attn.multi_head_attention(jq, jk, jv, impl="pallas")
    np.testing.assert_array_equal(np.asarray(dropped), np.asarray(plain))
    with pytest.raises(ValueError, match="segment_ids"):
        t_attn.multi_head_attention(_t(q), _t(k), _t(v), impl="pallas",
                                    segment_ids=_t(seg))
