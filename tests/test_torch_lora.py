"""The port's LoRA adapters (ray_tpu_torch/train/lora.py) against the
JAX package's on the same weights: the target set, the zero start, the
merge, three adapter-only train steps and an adapter checkpoint.

The reference's adapters are carried over by
`models.convert.lora_from_flax` (A (in, r) -> (r, in), B (r, out) ->
(out, r)). Tolerances: the fp32 merge to rtol 1e-6, with an absolute
floor of 1e-6 of the largest delta (XLA and oneDNN sum the rank-4
product in different orders for some shapes, an ulp of the delta, which
a base of the opposite sign cancels down to a small sum); a bf16 merge
within one bf16 ulp (the fp32 delta may round to the neighbouring bf16
value); the train steps' loss,
grad_norm and adapters to rtol 1e-4, as tests/test_torch_train.py holds
AdamW steps (oneDNN and XLA sum in different orders), the adapters with
an absolute floor of 1e-4 lr for the elements that pass near 0 (they
moved by ~5e-8 there).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu import models as jmodels
from ray_tpu.ops import quant as j_quant
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import init_lora as j_init_lora
from ray_tpu.train import lora_param_count as j_lora_param_count
from ray_tpu.train import make_lora_train_step as j_make_lora_train_step
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import merge_lora as j_merge_lora
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import convert
from ray_tpu_torch.train import (DEFAULT_TARGETS, init_lora,
                                 lora_param_count, make_lora_train_step,
                                 make_optimizer, merge_lora, restore_pytree,
                                 save_pytree)
from ray_tpu_torch.train.lora import unflatten_adapters

WIDTHS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=32)


def _np(tree):
    """numpy leaves; bf16 ones as fp32 (exact), which torch can take."""
    def leaf(x):
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, tree)


def _init(model, seed=0):
    return jax.jit(model.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _llama(dtype=jnp.float32, tdtype=torch.float32, remat=False, seed=0):
    jm = jmodels.Llama(jmodels.LlamaConfig(**WIDTHS, remat=False,
                                           dtype=jnp.float32))
    params = _init(jm, seed)
    if dtype != jnp.float32:
        params = jax.tree.map(lambda x: x.astype(dtype), params)
    tm = tmodels.Llama(tmodels.LlamaConfig(
        **WIDTHS, remat=remat, dtype=torch.float32, param_dtype=tdtype),
        device="cpu")
    sd = convert.llama_params_from_flax(_np(params))
    tm.load_state_dict({k: v.to(tm.state_dict()[k].dtype)
                        for k, v in sd.items()})
    return jm, params, tm


def _family(name):
    """(flax params, the port's model holding them) of one family."""
    if name == "llama":
        _, params, tm = _llama()
        return params, tm
    if name == "gpt2":
        params = _init(jmodels.GPT2(jmodels.GPT2Config.debug(
            dtype=jnp.float32)))
        tm = tmodels.GPT2(tmodels.GPT2Config.debug(dtype=torch.float32),
                          device="cpu")
        tm.load_state_dict(convert.gpt2_params_from_flax(_np(params)))
        return params, tm
    params = _init(jmodels.Mixtral(jmodels.MixtralConfig.debug(
        dtype=jnp.float32)))
    tm = tmodels.Mixtral(tmodels.MixtralConfig.debug(dtype=torch.float32),
                         device="cpu")
    tm.load_state_dict(convert.mixtral_params_from_flax(_np(params)))
    return params, tm


def _random_b(lora, seed):
    """The JAX adapters with B drawn from a seed (B = 0 at init)."""
    rng = np.random.RandomState(seed)

    def fill(node):
        if node is None:
            return None
        b = rng.standard_normal(node["B"].shape).astype(np.float32) * 0.1
        return {"A": node["A"], "B": jnp.asarray(b)}

    adapters = jax.tree.map(fill, lora["adapters"],
                            is_leaf=lambda x: x is None or (
                                isinstance(x, dict) and set(x) == {"A", "B"}))
    return {**lora, "adapters": adapters}


@pytest.mark.parametrize("family", ["llama", "gpt2", "mixtral"])
def test_targets_match_reference(family):
    """The same weights are adapted, with the same parameter count;
    embeddings, the LM head and Mixtral's stacked 3-D experts are not."""
    params, tm = _family(family)
    want = convert.lora_from_flax(_np(j_init_lora(
        params, jax.random.PRNGKey(1), rank=4)))
    got = init_lora(tm, 1, rank=4)
    assert set(got["adapters"]) == set(want["adapters"])
    assert lora_param_count(got) == j_lora_param_count(
        j_init_lora(params, jax.random.PRNGKey(1), rank=4))
    for name, pair in got["adapters"].items():
        w = tm.get_parameter(name)
        assert pair["A"].shape == want["adapters"][name]["A"].shape \
            == (4, w.shape[1])
        assert pair["B"].shape == (w.shape[0], 4)
        assert not any(t in name for t in ("embed", "lm_head", "experts"))


def test_init_distribution_and_zero_start():
    """A ~ N(0, 1) / rank in fp32 (also over a bf16 base), B = 0: the
    merged weights are the base's, bit for bit."""
    _, _, tm = _llama(jnp.bfloat16, torch.bfloat16)
    lora = init_lora(tm, 3, rank=8)
    a = torch.cat([p["A"].reshape(-1) for p in lora["adapters"].values()])
    assert all(p["A"].dtype == p["B"].dtype == torch.float32
               for p in lora["adapters"].values())
    assert abs(float(a.std()) - 1 / 8) < 0.01 and abs(float(a.mean())) < 0.01
    assert all(bool((p["B"] == 0).all()) for p in lora["adapters"].values())
    merged = merge_lora(tm, lora)
    for name, p in tm.named_parameters():
        assert merged[name].dtype == p.dtype
        assert torch.equal(merged[name], p), name
    assert lora_param_count(lora) < sum(p.numel() for p in tm.parameters())


def test_unmatched_targets_raise():
    _, _, tm = _llama()
    with pytest.raises(ValueError):
        init_lora(tm, 1, targets=("nope",))
    # int8 projections hold `kernel_q`: never a target, in either package
    jcfg = jmodels.LlamaConfig(**WIDTHS, dtype=jnp.float32)
    q = j_quant.quantize_llama_params(_init(jmodels.Llama(jcfg)))
    with pytest.raises(ValueError):
        j_init_lora(q, jax.random.PRNGKey(1))
    with pytest.raises(ValueError):
        init_lora(convert.llama_params_from_flax(_np(q)), 1)


def test_lora_from_flax_rejects_unmapped_leaves():
    with pytest.raises(ValueError):
        convert.lora_from_flax({"rank": 4, "alpha": 16.0, "adapters": {
            "q_proj": {"kernel": {"C": np.zeros((2, 2), np.float32)}}}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, params, tm = _llama(jdt, tdt)
    jl = _random_b(j_init_lora(params, jax.random.PRNGKey(2), rank=4), 5)
    want = convert.llama_params_from_flax(_np(j_merge_lora(params, jl)))
    got = merge_lora(tm, convert.lora_from_flax(_np(jl)))
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        g = got[name].detach()
        assert g.dtype == tm.get_parameter(name).dtype
        if dtype == "float32":
            scale = float((w - tm.get_parameter(name).detach()).abs().max())
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=name)
        else:
            gf, wf = g.float().numpy(), w.float().numpy()
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wf),
                                                      1e-30))) - 7)
            assert (np.abs(gf - wf) <= ulp).all(), name
        moved += int(not torch.equal(g, tm.get_parameter(name).detach()))
    assert moved == 2 * 7          # every projection of both layers


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_jax(remat):
    """3 steps of make_lora_train_step (adamw, lr 1e-2) against the JAX
    step on a one-device mesh from the same base and adapters: loss,
    grad_norm and the adapters; the base never moves. Under remat the
    recompute must see the merged weights, not the module's own."""
    jm, params, tm = _llama(remat=remat)
    jl = j_init_lora(params, jax.random.PRNGKey(1), rank=4,
                     targets=("q_proj", "v_proj", "down_proj"))
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, WIDTHS["vocab_size"], (4, 17)).astype(np.int32)
               for _ in range(3)]
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    j_state, j_step = j_make_lora_train_step(
        jm, j_make_optimizer("adamw", learning_rate=1e-2), mesh, params)(
        {"tokens": jnp.asarray(batches[0])}, jl)
    base = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    t_state, t_step = make_lora_train_step(
        tm, make_optimizer("adamw", learning_rate=1e-2))(
        None, convert.lora_from_flax(_np(jl)))
    for b in batches:
        j_state, jm_ = j_step(j_state, {"tokens": jnp.asarray(b)})
        t_state, tm_ = t_step(t_state, {"tokens": torch.from_numpy(b)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-4, err_msg=key)
    assert t_state.step == 3
    want = convert.lora_from_flax(_np({**jl, "adapters": j_state.params}))
    got = unflatten_adapters(t_state.params)
    for name, pair in want["adapters"].items():
        for k in "AB":
            np.testing.assert_allclose(got[name][k].detach().numpy(),
                                       pair[k].numpy(), rtol=1e-4,
                                       atol=1e-4 * 1e-2, err_msg=f"{name}/{k}")
    assert float(got["layer_0.attention.q_proj.weight"]["B"]
                 .detach().abs().max()) > 0
    for k, v in tm.state_dict().items():
        assert torch.equal(v, base[k]), k


def test_adapter_checkpoint_roundtrip(tmp_path):
    _, _, tm = _llama()
    lora = init_lora(tm, 3, rank=4, targets=("q_proj",))
    save_pytree(lora, str(tmp_path / "lora_ckpt"))
    back = restore_pytree(str(tmp_path / "lora_ckpt"), map_location="cpu")
    assert back["rank"] == 4 and back["alpha"] == 16.0
    assert set(back["adapters"]) == set(lora["adapters"])
    for name, pair in lora["adapters"].items():
        for k in "AB":
            assert torch.equal(back["adapters"][name][k], pair[k])


def test_default_targets_are_the_reference_s():
    from ray_tpu.train.lora import DEFAULT_TARGETS as J_TARGETS
    assert tuple(DEFAULT_TARGETS) == tuple(J_TARGETS)
    assert "lm_head" not in DEFAULT_TARGETS
