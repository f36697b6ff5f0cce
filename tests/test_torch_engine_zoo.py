"""The port's engine serving the zoo's families against the JAX engine:
greedy tokens of GPT-2, int8 Llama and Mixtral (debug widths, fp32)
equal to ray_tpu's LLMEngine on the same parameters, on the contiguous
(kv_page_size=0) and the paged (kv_page_size=4) cache.

Mixtral's expert capacity comes from each model call's token count, so
its output depends on the batch a request shares and on the engine's
call shapes (bucket padding, idle decode slots). The batched runs use
capacity_factor = n_experts / experts_per_token, where capacity equals
the call's token count and no token is dropped; one run keeps the
published 1.25 and submits one request at a time, so the engine must
call the model with the JAX engine's shapes to give its tokens.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu import models as jmodels
from ray_tpu.ops.quant import quantize_llama_params
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import LLMEngineConfig as JEngineConfig
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import convert
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig

BASE = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32),
            max_prefill_batch=4)
N_NEW = 8


def _prompts(vocab):
    # lengths 5..25 across the 16 and 32 buckets
    return [np.arange(1 + i, 6 + i * 6) % vocab for i in range(5)]


def _jax_tokens(model, params, kw, prompts, one_at_a_time=False):
    eng = JEngine(model, params, JEngineConfig(**BASE, **kw))
    try:
        if one_at_a_time:
            return [eng.generate_sync(p, max_new_tokens=N_NEW)
                    for p in prompts]
        rids = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
        return [list(eng.stream(r)) for r in rids]
    finally:
        eng.shutdown()


def _port_tokens(model, state, kw, prompts, one_at_a_time=False):
    eng = LLMEngine(model, state, LLMEngineConfig(**BASE, **kw),
                    device="cpu")
    try:
        if one_at_a_time:
            return [eng.generate_sync(p, max_new_tokens=N_NEW)
                    for p in prompts]
        rids = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
        return [list(eng.stream(r)) for r in rids]
    finally:
        eng.shutdown()


def _init(model):
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def gpt2():
    jm = jmodels.GPT2(jmodels.GPT2Config.debug(dtype=jnp.float32))
    params = _init(jm)
    state = convert.gpt2_params_from_flax(jax.tree.map(np.asarray, params))
    return jm, params, state


@pytest.mark.parametrize("kv", [0, 4])
def test_gpt2_greedy_tokens_match_jax_engine(gpt2, kv):
    jm, params, state = gpt2
    prompts = _prompts(256)
    kw = dict(kv_page_size=kv, prefill_chunk=16)
    want = _jax_tokens(jm, params, kw, prompts)
    tm = tmodels.GPT2(tmodels.GPT2Config.debug(dtype=torch.float32),
                      device="cpu")
    assert _port_tokens(tm, state, kw, prompts) == want


@pytest.fixture(scope="module")
def int8_llama():
    jcfg = jmodels.LlamaConfig.debug(dtype=jnp.float32, quant="int8")
    fp = _init(jmodels.Llama(dataclasses.replace(jcfg, quant=None)))
    qparams = jax.tree.map(jnp.asarray, quantize_llama_params(fp))
    state = convert.llama_params_from_flax(jax.tree.map(np.asarray,
                                                        qparams))
    return jmodels.Llama(jcfg), qparams, state


@pytest.mark.parametrize("kv", [0, 4])
def test_int8_llama_greedy_tokens_match_jax_engine(int8_llama, kv):
    jm, qparams, state = int8_llama
    prompts = _prompts(256)
    kw = dict(kv_page_size=kv)
    want = _jax_tokens(jm, qparams, kw, prompts)
    tm = tmodels.Llama(tmodels.LlamaConfig.debug(dtype=torch.float32,
                                                 quant="int8"),
                       device="cpu")
    assert _port_tokens(tm, state, kw, prompts) == want


def _mixtral(cf):
    jm = jmodels.Mixtral(jmodels.MixtralConfig.debug(
        dtype=jnp.float32, capacity_factor=cf))
    params = _init(jm)
    state = convert.mixtral_params_from_flax(jax.tree.map(np.asarray,
                                                          params))
    tm = tmodels.Mixtral(tmodels.MixtralConfig.debug(
        dtype=torch.float32, capacity_factor=cf), device="cpu")
    return jm, params, tm, state


@pytest.mark.parametrize("kv", [0, 4])
def test_mixtral_no_drop_greedy_tokens_match_jax_engine(kv):
    """capacity_factor 2.0 = n_experts / experts_per_token (4 / 2):
    capacity is the call's token count, so batching cannot drop one."""
    jm, params, tm, state = _mixtral(2.0)
    prompts = _prompts(256)
    kw = dict(kv_page_size=kv)
    assert _port_tokens(tm, state, kw, prompts) == _jax_tokens(
        jm, params, kw, prompts)


@pytest.mark.parametrize("kv", [0, 4])
def test_mixtral_published_capacity_one_request_at_a_time(kv):
    """capacity_factor 1.25: tokens are dropped at prefill (bucket
    padding counts) and at every decode step (all slots, idle ones
    included, share the call), exactly where the JAX engine drops
    them."""
    jm, params, tm, state = _mixtral(1.25)
    prompts = _prompts(256)
    kw = dict(kv_page_size=kv)
    assert _port_tokens(tm, state, kw, prompts, True) == _jax_tokens(
        jm, params, kw, prompts, True)
