"""Port parity for the model zoo: ray_tpu_torch's ops (layer_norm, GELU,
MoE dispatch), int8 quantization and every model family against the
JAX package on the same weights (carried over by
ray_tpu_torch.models.convert) and inputs made from a numpy seed.

Tolerances, fp32: atol 1e-5 for single ops (the frameworks sum in
different orders, a few ulps of values of order 1); atol 1e-4 for
model outputs (logits of order 1-10 after several matmuls, as
tests/test_torch_llama.py states); quantize_dense bit for bit. A wrong
layout, mask or routing moves these by order 1.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu import models as jmodels
from ray_tpu.ops import activations as j_act
from ray_tpu.ops import moe as j_moe
from ray_tpu.ops import norms as j_norms
from ray_tpu.ops import quant as j_quant
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import convert
from ray_tpu_torch.ops import activations as t_act
from ray_tpu_torch.ops import moe as t_moe
from ray_tpu_torch.ops import norms as t_norms
from ray_tpu_torch.ops import quant as t_quant

ATOL_OP = 1e-5
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(model, *args, seed=0):
    """Flax params of `model` for example inputs `args`, initialised
    under jit (flax's eager init dispatches op by op)."""
    return jax.jit(model.init)(jax.random.PRNGKey(seed), *args)["params"]


def _apply(model, params, *args, **kw):
    """model.apply under jit; keyword arguments are static."""
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, **kw))
    return fn(params, *args)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------- ops --

@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm(eps):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 3 + 1).astype(np.float32)
    w, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    _close(t_norms.layer_norm(_t(x), _t(w), _t(b), eps),
           j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), eps), ATOL_OP)


def test_layer_norm_keeps_input_dtype():
    x = torch.randn(4, 32).to(torch.bfloat16)
    assert t_norms.layer_norm(x, torch.ones(32),
                              torch.zeros(32)).dtype == torch.bfloat16


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(t_act.gelu(_t(x)), jax.nn.gelu(jnp.asarray(x)), ATOL_OP)
    exact = torch.nn.functional.gelu(_t(x))
    assert (t_act.gelu(_t(x)) - exact).abs().max() > 1e-4


def test_geglu():
    rng = np.random.RandomState(1)
    g, u = (rng.randn(4, 7, 32).astype(np.float32) for _ in range(2))
    _close(t_act.geglu(_t(g), _t(u)),
           j_act.geglu(jnp.asarray(g), jnp.asarray(u)), ATOL_OP)


@pytest.mark.parametrize("n,e,k,cf", [(24, 4, 2, 1.25), (9, 8, 2, 1.25),
                                      (100, 8, 1, 0.5), (7, 3, 3, 2.0)])
def test_expert_capacity(n, e, k, cf):
    assert t_moe.expert_capacity(n, e, k, cf) == j_moe.expert_capacity(
        n, e, k, cf)


def _moe_inputs(seed, g=24, d=8, e=4, d_out=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(g, d).astype(np.float32)
    logits = rng.randn(g, e).astype(np.float32)
    w = rng.randn(e, d, d_out).astype(np.float32)
    return x, logits, w


def _moe_pair(x, logits, w, **kw):
    j_out, j_aux = j_moe.moe_dispatch_combine(
        jnp.asarray(x), jnp.asarray(logits),
        lambda b: jnp.einsum("ecd,edo->eco", b, jnp.asarray(w)), **kw)
    t_out, t_aux = t_moe.moe_dispatch_combine(
        _t(x), _t(logits), lambda b: torch.bmm(b, _t(w)), **kw)
    return (j_out, j_aux), (t_out, t_aux)


@pytest.mark.parametrize("kw", [dict(), dict(capacity=1), dict(capacity=24),
                                dict(k=1, capacity_factor=1.0)],
                         ids=["cf1.25", "cap1", "no_drop", "top1"])
def test_moe_dispatch_combine_matches_jax(kw):
    """Output and the three aux values; at capacity factor 1.25 and
    capacity 1 some tokens are dropped (zero rows at their experts)."""
    x, logits, w = _moe_inputs(2)
    (j_out, j_aux), (t_out, t_aux) = _moe_pair(x, logits, w, **kw)
    _close(t_out, j_out, ATOL_OP)
    for got, want in zip(t_aux, j_aux):
        _close(got, want, ATOL_OP)
    if kw.get("capacity") == 1:
        # 24 tokens, 4 experts of 1 slot: most contributions dropped
        assert (t_out.abs().sum(-1) == 0).sum() >= 20


def test_moe_drops_tokens_past_capacity():
    """With capacity 2, an expert chosen first by 5 tokens keeps the
    first two in token order and drops the rest, as the reference."""
    x = np.eye(5, 4, dtype=np.float32)
    logits = np.tile(np.array([[5.0, 1.0, 0.0, -1.0]], np.float32), (5, 1))
    w = np.ones((4, 4, 2), np.float32)
    (j_out, _), (t_out, _) = _moe_pair(x, logits, w, k=1, capacity=2)
    _close(t_out, j_out, ATOL_OP)
    kept = (t_out.abs().sum(-1) > 0).tolist()
    assert kept == [True, True, False, False, False]


def test_top_k_routing_ties_go_to_the_lower_index():
    """Rows with tied logits route as jax.lax.top_k does."""
    logits = np.array([[1.0, 1.0, 1.0, 1.0],
                       [0.5, 2.0, 2.0, 0.5],
                       [3.0, 0.0, 3.0, 3.0],
                       [0.0, 1.0, 0.0, 1.0],
                       [-1.0, -1.0, 2.0, -1.0]], np.float32)
    for k in (1, 2, 3):
        jw, ji = j_moe.top_k_routing(jnp.asarray(logits), k)
        tw, ti = t_moe.top_k_routing(_t(logits), k)
        assert ti.tolist() == np.asarray(ji).tolist()
        _close(tw, jw, ATOL_OP)
    x = np.random.RandomState(3).randn(5, 8).astype(np.float32)
    w = np.random.RandomState(4).randn(4, 8, 3).astype(np.float32)
    (j_out, _), (t_out, _) = _moe_pair(x, logits, w, capacity=2)
    _close(t_out, j_out, ATOL_OP)


# -------------------------------------------------------------- quant --

def test_quantize_dense_is_bit_identical_to_numpy():
    rng = np.random.RandomState(5)
    kernel = rng.randn(96, 40).astype(np.float32)          # (in, out)
    # a column with max 127: scale 1.0, so x.5 values test half-even
    kernel[:6, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    kernel[6:, 0] = 0.25
    kernel[:, 1] = 0.0                                      # amax floor
    want = j_quant.quantize_dense(kernel)
    got = t_quant.quantize_dense(_t(kernel.T))              # (out, in)
    assert got["kernel_q"].dtype == torch.int8
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["kernel_q"].numpy(),
                                  want["kernel_q"].T)
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert got["kernel_q"][0, :6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.fixture(scope="module")
def int8_llama():
    jcfg = jmodels.LlamaConfig(vocab_size=128, d_model=64, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=128,
                               max_seq_len=64, dtype=jnp.float32)
    params = _init(jmodels.Llama(jcfg), jnp.zeros((1, 8), jnp.int32))
    qparams = j_quant.quantize_llama_params(params)
    tcfg = tmodels.LlamaConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=64, dtype=torch.float32)
    return jcfg, params, qparams, tcfg


def test_int8_llama_logits_match_jax(int8_llama):
    jcfg, _, qparams, tcfg = int8_llama
    jm = jmodels.Llama(dataclasses.replace(jcfg, quant="int8"))
    tm = tmodels.Llama(dataclasses.replace(tcfg, quant="int8"),
                       device="cpu")
    sd = convert.llama_params_from_flax(_np(qparams))
    assert set(sd) == set(tm.state_dict())
    assert sd["layer_0.mlp.down_proj.kernel_q"].dtype == torch.int8
    tm.load_state_dict(sd)
    tokens = np.random.RandomState(6).randint(0, 128, (2, 9)) \
        .astype(np.int32)
    want, _ = _apply(jm, qparams, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tm(_t(tokens))
    _close(got, want)


def test_quantize_llama_params_matches_jax(int8_llama):
    """The port's quantize_llama_params on the fp state_dict gives the
    reference's quantized tree, converted: same int8 values and scales,
    same byte count."""
    _, params, qparams, _ = int8_llama
    fp = convert.llama_params_from_flax(_np(params))
    got = t_quant.quantize_llama_params(fp)
    want = convert.llama_params_from_flax(_np(qparams))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      want[name].numpy(), err_msg=name)
    assert t_quant.quantized_bytes(got) == j_quant.quantized_bytes(qparams)
    assert t_quant.quantized_bytes(got) < 0.45 * t_quant.quantized_bytes(fp)


# ------------------------------------------------- forwards vs flax --

def _mixtral_pair(seed=0, **kw):
    jm = jmodels.Mixtral(jmodels.MixtralConfig.debug(dtype=jnp.float32,
                                                     **kw))
    params = _init(jm, jnp.zeros((1, 8), jnp.int32), seed=seed)
    tm = tmodels.Mixtral(tmodels.MixtralConfig.debug(dtype=torch.float32,
                                                     **kw), device="cpu")
    sd = convert.mixtral_params_from_flax(_np(params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return jm, params, tm


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_mixtral_logits_and_aux_loss_match_jax(cf):
    """At capacity factor 0.5 half the assignments are dropped."""
    jm, params, tm = _mixtral_pair(capacity_factor=cf)
    tokens = np.random.RandomState(7).randint(0, 256, (2, 16)) \
        .astype(np.int32)
    (want, _), mut = _apply(jm, params, jnp.asarray(tokens),
                            mutable=["aux_loss"])
    with torch.no_grad():
        got, cache = tm(_t(tokens))
    assert cache is None and got.dtype == torch.float32
    _close(got, want)
    _close(tm.aux_loss(), jmodels.Mixtral.aux_loss(mut), ATOL_OP)


def test_mixtral_contiguous_cache_decode_matches_jax():
    jm, params, tm = _mixtral_pair(1)
    tokens = np.random.RandomState(8).randint(0, 256, (2, 6)) \
        .astype(np.int32)
    j_cache = jm.empty_cache(2, 16, dtype=jnp.float32)
    t_cache = tm.empty_cache(2, 16)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    step = jax.jit(lambda p, t, c, q: jm.apply({"params": p}, t, cache=c,
                                               positions=q))
    want, j_cache = step(params, jnp.asarray(tokens), j_cache,
                         jnp.asarray(pos))
    with torch.no_grad():
        got, t_cache = tm(_t(tokens), cache=t_cache, positions=_t(pos))
    _close(got, want)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    p = np.full((2, 1), 6, np.int32)
    want, _ = step(params, jnp.asarray(nxt), j_cache, jnp.asarray(p))
    with torch.no_grad():
        got, _ = tm(_t(nxt), cache=t_cache, positions=_t(p))
    _close(got, want)


def test_mixtral_presets_match_jax():
    for name in ("mixtral_8x7b", "debug"):
        j = getattr(jmodels.MixtralConfig, name)()
        t = getattr(tmodels.MixtralConfig, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "n_experts", "experts_per_token",
                  "capacity_factor", "max_seq_len", "rope_theta",
                  "norm_eps", "router_aux_coef", "router_z_coef", "remat"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def _gpt2_pair(seed=1):
    jm = jmodels.GPT2(jmodels.GPT2Config.debug(dtype=jnp.float32))
    params = _init(jm, jnp.zeros((1, 8), jnp.int32), seed=seed)
    tm = tmodels.GPT2(tmodels.GPT2Config.debug(dtype=torch.float32),
                      device="cpu")
    sd = convert.gpt2_params_from_flax(_np(params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return jm, params, tm


def test_gpt2_logits_match_jax():
    jm, params, tm = _gpt2_pair()
    tokens = np.random.RandomState(9).randint(0, 256, (2, 20)) \
        .astype(np.int32)
    want = _apply(jm, params, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(_t(tokens))
    assert isinstance(got, torch.Tensor)       # plain logits, no cache
    _close(got, want)


def test_gpt2_cached_positions_clamp_like_jax():
    """With a cache: (logits, cache), and positions past max_seq_len - 1
    read the last learned position, as the reference clamps."""
    jm, params, tm = _gpt2_pair(2)
    tokens = np.random.RandomState(10).randint(0, 256, (1, 4)) \
        .astype(np.int32)
    pos = np.array([[0, 1, 70, 90]], np.int32)       # max_seq_len 64
    j_cache = [(jnp.zeros((1, 96, 4, 16)), jnp.zeros((1, 96, 4, 16)),
                jnp.zeros((1,), jnp.int32)) for _ in range(2)]
    t_cache = [(torch.zeros(1, 96, 4, 16), torch.zeros(1, 96, 4, 16),
                torch.zeros(1, dtype=torch.int32)) for _ in range(2)]
    want, _ = jax.jit(lambda p, t, c, q: jm.apply(
        {"params": p}, t, cache=c, positions=q))(
        params, jnp.asarray(tokens), j_cache, jnp.asarray(pos))
    with torch.no_grad():
        got, new_cache = tm(_t(tokens), cache=t_cache, positions=_t(pos))
    _close(got, want)
    assert int(new_cache[0][2][0]) == 91


def test_gpt2_presets_match_jax():
    for name in ("small", "medium", "large", "debug"):
        j = getattr(jmodels.GPT2Config, name)()
        t = getattr(tmodels.GPT2Config, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "max_seq_len", "norm_eps", "d_ff", "head_dim",
                  "n_kv_heads"):
            assert getattr(t, f) == getattr(j, f), (name, f)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_logits_match_jax(pool):
    jm = jmodels.ViT(jmodels.ViTConfig.debug(dtype=jnp.float32, pool=pool))
    params = _init(jm, jnp.zeros((1, 32, 32, 3)), seed=3)
    tm = tmodels.ViT(tmodels.ViTConfig.debug(dtype=torch.float32, pool=pool),
                     device="cpu")
    sd = convert.vit_params_from_flax(_np(params))
    assert set(sd) == set(tm.state_dict())
    k = np.asarray(params["trunk"]["patch_embed"]["kernel"])   # HWIO
    assert torch.equal(sd["trunk.patch_embed.weight"],
                       _t(k.transpose(3, 2, 0, 1)))
    tm.load_state_dict(sd)
    images = np.random.RandomState(11).randn(3, 32, 32, 3) \
        .astype(np.float32)
    want = _apply(jm, params, jnp.asarray(images))
    with torch.no_grad():
        got = tm(_t(images))
    assert got.shape == (3, 10) and got.dtype == torch.float32
    _close(got, want)


def test_clip_embeddings_and_loss_match_jax():
    jm = jmodels.CLIP(jmodels.CLIPConfig.debug(dtype=jnp.float32))
    params = _init(jm, jnp.zeros((1, 32, 32, 3)),
                   jnp.zeros((1, 16), jnp.int32), seed=4)
    tm = tmodels.CLIP(tmodels.CLIPConfig.debug(dtype=torch.float32),
                      device="cpu")
    sd = convert.clip_params_from_flax(_np(params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    rng = np.random.RandomState(12)
    images = rng.randn(4, 32, 32, 3).astype(np.float32)
    tokens = rng.randint(1, 255, (4, 16)).astype(np.int32)
    tokens[np.arange(4), [15, 9, 3, 12]] = 255           # EOT at each row
    tokens[1, 10:] = 0                                    # right padding
    want = _apply(jm, params, jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(_t(images), _t(tokens))
    for g, w in zip(got, want):
        _close(g, w, ATOL_OP)
    _close(tmodels.contrastive_loss(*got),
           jmodels.contrastive_loss(*want), ATOL_OP)


@pytest.mark.parametrize("act", ["tanh", "relu", "gelu"])
def test_mlp_matches_jax(act):
    jcfg = jmodels.MLPConfig(hidden=(32, 16), out_dim=3, activation=act)
    params = _init(jmodels.MLP(jcfg), jnp.zeros((1, 7)), seed=5)
    tm = tmodels.MLP(tmodels.MLPConfig(hidden=(32, 16), out_dim=3,
                                       activation=act), 7, device="cpu")
    sd = convert.mlp_params_from_flax(_np(params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    x = np.random.RandomState(13).randn(6, 7).astype(np.float32)
    want = _apply(jmodels.MLP(jcfg), params, jnp.asarray(x))
    with torch.no_grad():
        _close(tm(_t(x)), want, ATOL_OP)


def test_resnet_lite_matches_jax():
    jm = jmodels.ResNetLite()
    params = _init(jm, jnp.zeros((1, 32, 32, 3)), seed=6)
    tm = tmodels.ResNetLite(device="cpu")
    sd = convert.resnet_params_from_flax(_np(params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    images = np.random.RandomState(14).randn(2, 32, 32, 3) \
        .astype(np.float32)
    want = _apply(jm, params, jnp.asarray(images))
    with torch.no_grad():
        _close(tm(_t(images)), want)


@pytest.mark.parametrize("fn,tree", [
    (convert.gpt2_params_from_flax, {"h_0": {"mystery": np.zeros(3)}}),
    (convert.mixtral_params_from_flax, {"layer_0": {"moe": {
        "router_bias": np.zeros(4)}}}),
    (convert.vit_params_from_flax, {"trunk": {"register_token":
                                              np.zeros((1, 1, 4))}}),
    (convert.resnet_params_from_flax, {"stem": {"kernel": np.zeros(
        (3, 3, 3))}}),
    (convert.llama_params_from_flax, {"layer_0": {"attn_norm_bias":
                                                  np.zeros(4)}}),
])
def test_converters_raise_on_unknown_parameters(fn, tree):
    with pytest.raises(ValueError, match="unmapped flax parameter"):
        fn(tree)


def test_seeded_zoo_init_follows_flax_scales():
    m = tmodels.Mixtral(tmodels.MixtralConfig.debug(dtype=torch.float32),
                        device="cpu", seed=3)
    again = tmodels.Mixtral(tmodels.MixtralConfig.debug(
        dtype=torch.float32), device="cpu", seed=3)
    a, b = m.state_dict(), again.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    gate = a["layer_0.moe.experts_gate_kernel"]          # (E 4, d 64, ff)
    assert abs(gate.std().item() - (4 * 64) ** -0.5) < 0.1 * (4 * 64) ** -0.5
    assert abs(a["layer_0.moe.router_kernel"].std().item() - 0.02) < 0.004
    g = tmodels.GPT2(tmodels.GPT2Config.debug(), device="cpu").state_dict()
    assert abs(g["wpe.weight"].std().item() - 0.01) < 0.002
    assert torch.all(g["h_0.qkv.bias"] == 0)
    c = tmodels.CLIP(tmodels.CLIPConfig.debug(), device="cpu").state_dict()
    assert float(c["logit_scale"]) == pytest.approx(2.6592)
    assert torch.all(c["vision_trunk.cls_token"] == 0)
