"""HF weight import into the port (ray_tpu_torch.train.adapters) against
config-built, random-init `transformers` models, the counterparts of
tests/test_hf_parity.py: the imported weights give the HF model's
logits, and served through the port's engine, HF's greedy continuation.

Tolerance: fp32 logits, atol 1e-4. Both sides are torch on the CPU with
the same weights; they differ in the order of a few sums (fused qkv,
the head), a few ulps of logits of order 1. The port's import carries
HF's norm epsilon (1e-5 for GPT-2's LayerNorm, 1e-6 for Llama's
RMSNorm); the reference's importer drops it and is held to 1e-2.
"""
import dataclasses

import numpy as np
import pytest

import torch

from ray_tpu_torch.models import GPT2, Llama
from ray_tpu_torch.serve.llm import LLMEngine, LLMEngineConfig
from ray_tpu_torch.train import adapters

transformers = pytest.importorskip("transformers")

ATOL = 1e-4


@pytest.fixture(scope="module")
def hf_gpt2():
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=64, n_embd=48,
                                  n_layer=2, n_head=4, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_llama():
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0,
        tie_word_embeddings=False, attention_dropout=0.0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _gpt2(source, **kw):
    state, cfg = adapters.import_hf_gpt2_weights(source, **kw)
    model = GPT2(dataclasses.replace(cfg, dtype=torch.float32),
                 device="cpu")
    model.load_state_dict(state)
    return model.eval()


def test_gpt2_logits_match_hf(hf_gpt2):
    tokens = torch.tensor([[3, 17, 42, 7, 9, 23, 1, 0]])
    with torch.no_grad():
        want = hf_gpt2(tokens).logits
        got = _gpt2(hf_gpt2)(tokens.int())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_gpt2_import_from_a_state_dict_needs_cfg(hf_gpt2):
    sd = hf_gpt2.state_dict()
    with pytest.raises(ValueError, match="pass cfg="):
        adapters.import_hf_gpt2_weights(sd)
    _, cfg = adapters.import_hf_gpt2_weights(hf_gpt2)
    # GPT2Model's keys (no "transformer." prefix) map the same way
    bare = {k[len("transformer."):]: v for k, v in sd.items()
            if k.startswith("transformer.")}
    a, _ = adapters.import_hf_gpt2_weights(sd, cfg=cfg)
    b, _ = adapters.import_hf_gpt2_weights(bare, cfg=cfg)
    assert set(a) == set(b) == set(GPT2(cfg, device="cpu").state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    # Conv1D [in, out] -> Dense [out, in]
    assert torch.equal(a["h_0.qkv.weight"],
                       sd["transformer.h.0.attn.c_attn.weight"].t())


def test_llama_logits_match_hf(hf_llama):
    tokens = torch.tensor([[5, 12, 33, 2, 64, 8]])
    state, cfg = adapters.import_hf_llama_weights(hf_llama)
    assert cfg.norm_eps == hf_llama.config.rms_norm_eps
    assert not cfg.tie_embeddings
    model = Llama(dataclasses.replace(cfg, dtype=torch.float32),
                  device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        want = hf_llama(tokens).logits
        got, _ = model(tokens.int())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert got[0, -1].argmax() == want[0, -1].argmax()


def test_llama_import_ties_the_head_without_lm_head(hf_llama):
    sd = {k: v for k, v in hf_llama.state_dict().items()
          if k != "lm_head.weight"}
    state, cfg = adapters.import_hf_llama_weights(
        sd, cfg=dataclasses.replace(
            adapters.import_hf_llama_weights(hf_llama)[1],
            tie_embeddings=True))
    assert "lm_head.weight" not in state
    assert set(state) == set(Llama(cfg, device="cpu").state_dict())


def test_imported_gpt2_greedy_matches_hf_generate(hf_gpt2):
    """Imported weights served through the port's engine on both caches
    give HF's greedy continuation token for token."""
    prompt = [3, 17, 42, 7]
    n_new = 6
    with torch.no_grad():
        out = hf_gpt2.generate(torch.tensor([prompt]), max_new_tokens=n_new,
                               do_sample=False, pad_token_id=0)
    expected = out[0, len(prompt):].tolist()
    for kv in (0, 4):
        eng = LLMEngine(_gpt2(hf_gpt2), None, LLMEngineConfig(
            max_slots=2, max_seq_len=64, prefill_buckets=(8, 16),
            kv_page_size=kv), device="cpu")
        try:
            got = eng.generate_sync(prompt, max_new_tokens=n_new)
        finally:
            eng.shutdown()
        assert got == expected, (kv, got, expected)


def test_torch_state_dict_to_numpy_is_fp32_host(hf_llama):
    out = adapters.torch_state_dict_to_numpy(
        {k: v.to(torch.bfloat16) for k, v in
         list(hf_llama.state_dict().items())[:3]})
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in out.values())
