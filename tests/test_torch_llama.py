"""Port parity: ray_tpu_torch's Llama against the JAX Llama on the same
parameters, carried over by ray_tpu_torch.models.convert.

Tolerance: fp32 logits, atol 1e-4. Logits here reach magnitude ~4 after
several matmuls of width up to 2048; oneDNN and XLA sum those in
different orders, which moves fp32 logits by up to ~1e-5 (measured
3e-6 on the debug config). 1e-4 keeps a 10x margin over that and stays
far below what a wrong weight layout, mask or rotation would move
(order 1).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__
from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.ops.attention import PagedKV as JPagedKV
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu_torch.ops.attention import PagedKV

ATOL = 1e-4


def _pair(jcfg, tcfg, seed=0):
    jm = JLlama(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _torch_cfg(jcfg, **kw):
    fields = dict(vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
                  n_layers=jcfg.n_layers, n_heads=jcfg.n_heads,
                  n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
                  max_seq_len=jcfg.max_seq_len, rope_theta=jcfg.rope_theta,
                  norm_eps=jcfg.norm_eps,
                  tie_embeddings=jcfg.tie_embeddings,
                  dtype=torch.float32, param_dtype=torch.float32)
    fields.update(kw)
    return LlamaConfig(**fields)


def _compare_logits(jm, params, tm, tokens):
    want, _ = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("tie", [False, True])
def test_debug_logits_match_jax(tie):
    jcfg = JConfig.debug(dtype=jnp.float32, tie_embeddings=tie)
    jm, params, tm = _pair(jcfg, LlamaConfig.debug(
        dtype=torch.float32, tie_embeddings=tie))
    tokens = np.random.RandomState(0).randint(0, 256, (2, 24)) \
        .astype(np.int32)
    _compare_logits(jm, params, tm, tokens)


def test_flagship_logits_match_jax():
    jcfg = __graft_entry__._flagship_config()
    jcfg = JConfig(**{**jcfg.__dict__, "dtype": jnp.float32})
    jm, params, tm = _pair(jcfg, _torch_cfg(jcfg))
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 48)) \
        .astype(np.int32)
    _compare_logits(jm, params, tm, tokens)


def test_paged_prefill_then_decode_matches_jax():
    """A fresh prefill over PagedKV pools, then cached one-token decode
    steps: per-step logits match the JAX model over its own PagedKV
    (its CPU routes: XLA prefill, gather decode; the port's: K1's and
    K3's plain versions)."""
    jcfg = JConfig.debug(dtype=jnp.float32)
    jm, params, tm = _pair(jcfg, LlamaConfig.debug(dtype=torch.float32), 3)
    b, ps, P, prompt = 2, 4, 8, 7
    hkv, hd = jcfg.n_kv_heads, jcfg.head_dim
    n_flat = (b * P + 1) * ps
    table = np.random.RandomState(2).permutation(b * P).reshape(b, P) \
        .astype(np.int32)
    tokens = np.random.RandomState(3).randint(0, 256, (b, prompt)) \
        .astype(np.int32)
    j_pools = [(jnp.zeros((n_flat, hkv, hd)), jnp.zeros((n_flat, hkv, hd)))
               for _ in range(jcfg.n_layers)]
    t_pools = [(torch.zeros(n_flat, hkv, hd), torch.zeros(n_flat, hkv, hd))
               for _ in range(jcfg.n_layers)]
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    zeros = np.zeros((b,), np.int32)
    pos = np.broadcast_to(np.arange(prompt), (b, prompt)).astype(np.int32)
    j_cache = [JPagedKV(k, v, jt, jnp.asarray(zeros), ps, fresh=True)
               for k, v in j_pools]
    t_cache = [PagedKV(k, v, tt, torch.from_numpy(zeros), ps, fresh=True)
               for k, v in t_pools]
    want, j_cache = jm.apply({"params": params}, jnp.asarray(tokens),
                             cache=j_cache, positions=jnp.asarray(pos))
    with torch.no_grad():
        got, t_cache = tm(torch.from_numpy(tokens), cache=t_cache,
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)
    for step in range(4):
        p = np.full((b, 1), prompt + step, np.int32)
        want, j_cache = jm.apply({"params": params}, jnp.asarray(nxt[:, None]),
                                 cache=j_cache, positions=jnp.asarray(p))
        with torch.no_grad():
            got, t_cache = tm(torch.from_numpy(nxt[:, None]), cache=t_cache,
                              positions=torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        assert t_cache[0].lengths.tolist() == \
            np.asarray(j_cache[0].lengths).tolist()
        nxt = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)


def test_contiguous_cache_decode_matches_jax():
    jcfg = JConfig.debug(dtype=jnp.float32)
    jm, params, tm = _pair(jcfg, LlamaConfig.debug(dtype=torch.float32), 4)
    tokens = np.random.RandomState(5).randint(0, 256, (2, 6)).astype(np.int32)
    j_cache = jm.empty_cache(2, 16, dtype=jnp.float32)
    t_cache = tm.empty_cache(2, 16)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    want, _ = jm.apply({"params": params}, jnp.asarray(tokens),
                       cache=j_cache, positions=jnp.asarray(pos))
    with torch.no_grad():
        got, t_cache = tm(torch.from_numpy(tokens), cache=t_cache,
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert [int(x) for x in t_cache[0][2]] == [6, 6]


def test_converter_maps_every_parameter():
    jcfg = JConfig.debug(dtype=jnp.float32)
    params = JLlama(jcfg).init_params(jax.random.PRNGKey(0))
    sd = llama_params_from_flax({"params": jax.tree.map(np.asarray, params)})
    tm = Llama(LlamaConfig.debug(dtype=torch.float32), device="cpu")
    assert set(sd) == set(tm.state_dict())
    q = np.asarray(params["layer_1"]["attention"]["q_proj"]["kernel"])
    assert torch.equal(sd["layer_1.attention.q_proj.weight"],
                       torch.from_numpy(q.T.copy()))
    head = np.asarray(params["lm_head"]["kernel"])
    assert sd["lm_head.weight"].shape == (jcfg.vocab_size, jcfg.d_model)
    assert torch.equal(sd["lm_head.weight"], torch.from_numpy(head.T.copy()))
    assert torch.equal(sd["layer_0.attn_norm"],
                       torch.from_numpy(np.array(
                           params["layer_0"]["attn_norm"])))


def test_presets_match_jax():
    for name in ("llama3_8b", "llama3_1b", "debug"):
        j = getattr(JConfig, name)()
        t = getattr(LlamaConfig, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps", "remat"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_seeded_init_is_reproducible_and_follows_flax_scales():
    cfg = LlamaConfig.debug(dtype=torch.float32)
    a = Llama(cfg, device="cpu", seed=3).state_dict()
    b = Llama(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    emb = a["token_embed.weight"]
    assert abs(emb.std().item() - 0.02) < 0.003
    w = a["layer_0.mlp.down_proj.weight"]            # fan_in = d_ff = 128
    assert abs(w.std().item() - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert torch.all(a["final_norm"] == 1)


def test_bf16_config_gives_fp32_logits():
    cfg = LlamaConfig.debug(param_dtype=torch.bfloat16)
    m = Llama(cfg, device="cpu")
    with torch.no_grad():
        logits, _ = m(torch.zeros(1, 4, dtype=torch.int32))
    assert logits.dtype == torch.float32


def test_unported_options_raise():
    """attn_impl is not ported; int8 is (it builds QuantDense
    projections, held against the JAX int8 Llama in
    tests/test_torch_zoo.py) and so is remat (its gradients are checked
    in tests/test_torch_train.py)."""
    m = Llama(LlamaConfig.debug(quant="int8", dtype=torch.float32),
              device="cpu")
    q = m.state_dict()["layer_0.attention.q_proj.kernel_q"]
    assert q.dtype == torch.int8 and q.shape == (64, 64)
    with pytest.raises(ValueError):
        LlamaConfig.debug(quant="int4")
    with pytest.raises(NotImplementedError):
        LlamaConfig.debug(attn_impl="pallas")
    with pytest.raises(ValueError):
        LlamaConfig.debug(remat=True, remat_policy="offload")


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama(LlamaConfig.debug(), device="cuda")
