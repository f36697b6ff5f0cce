"""The zoo's train steps, registry and entry point against the JAX
package: two `make_train_step` steps of GPT-2 and Mixtral (debug widths,
fp32, sgd) from the same parameters and batches, `get_model` over every
registry name, and `entry()` on the CPU.

Tolerances: train-step loss and grad_norm rtol 1e-5 and parameters atol
1e-6, as tests/test_torch_train.py states for sgd.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__
from ray_tpu import models as jmodels
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.entry import entry, flagship_config
from ray_tpu_torch.models import convert
from ray_tpu_torch.train import make_optimizer, make_train_step


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------- train steps --

def _train_pair(name, jcfg, tcfg, convert_fn, steps=2):
    rng = np.random.RandomState(15)
    batches = [rng.randint(0, 256, (4, 17)).astype(np.int32)
               for _ in range(steps)]
    jm = getattr(jmodels, name)(jcfg)
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    j_state, j_step = j_make_train_step(
        jm, j_make_optimizer("sgd", learning_rate=0.1), mesh,
        donate_state=False)(jax.random.PRNGKey(0),
                            {"tokens": jnp.asarray(batches[0])})
    tm = getattr(tmodels, name)(tcfg, device="cpu")
    tm.load_state_dict(convert_fn(_np(j_state.params)))
    t_state, t_step = make_train_step(tm, make_optimizer(
        "sgd", learning_rate=0.1))({"tokens": _t(batches[0])})
    for tokens in batches:
        j_state, jm_ = j_step(j_state, {"tokens": jnp.asarray(tokens)})
        t_state, tm_ = t_step(t_state, {"tokens": _t(tokens)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-5, err_msg=key)
    want = convert_fn(_np(j_state.params))
    for n, p in t_state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("remat", [False, True])
def test_gpt2_train_steps_match_jax(remat):
    _train_pair("GPT2",
                jmodels.GPT2Config.debug(dtype=jnp.float32, remat=remat),
                tmodels.GPT2Config.debug(dtype=torch.float32, remat=remat),
                convert.gpt2_params_from_flax)


@pytest.mark.parametrize("remat", [False, True])
def test_mixtral_train_steps_match_jax(remat):
    """The router loss stays out of the train loss, as the reference's
    next_token_loss leaves it out; remat recomputes each block."""
    _train_pair("Mixtral",
                jmodels.MixtralConfig.debug(dtype=jnp.float32, remat=remat),
                tmodels.MixtralConfig.debug(dtype=torch.float32,
                                            remat=remat),
                convert.mixtral_params_from_flax)


# ---------------------------------------------- registry and entry() --

# the registry's names, with config overrides that keep the full-size
# presets small on the CPU
_SMALL = {
    "llama3-8b": dict(d_model=64, n_layers=1, d_ff=64, vocab_size=64),
    "llama3-1b": dict(d_model=64, n_layers=1, d_ff=64, vocab_size=64),
    "gpt2": dict(d_model=64, n_layers=1, n_heads=4, vocab_size=64),
    "gpt2-medium": dict(d_model=64, n_layers=1, n_heads=4, vocab_size=64),
    "gpt2-large": dict(d_model=64, n_layers=1, n_heads=4, vocab_size=64),
    "mixtral-8x7b": dict(d_model=64, n_layers=1, d_ff=64, vocab_size=64),
    "vit-base": dict(image_size=32, d_model=64, n_layers=1, n_heads=4,
                     d_ff=64),
}


def test_registry_has_the_reference_names():
    from ray_tpu.models import _REGISTRY as j_registry
    assert sorted(tmodels._REGISTRY) == sorted(j_registry)


@pytest.mark.parametrize("name", sorted(tmodels._REGISTRY))
def test_get_model_builds_every_registry_name(name):
    """Each name builds its family on the CPU; the preset widths it does
    not override are the reference's."""
    from ray_tpu.models import _REGISTRY as j_registry
    kw = _SMALL.get(name, {})
    m = tmodels.get_model(name, device="cpu", seed=1, **kw)
    j = j_registry[name]()          # a flax module holds no weights
    assert type(m).__name__ == type(j).__name__
    if hasattr(j, "cfg"):
        jc, tc = j.cfg, m.cfg
        for f in dataclasses.fields(jc):
            if f.name in ("dtype", "param_dtype", *kw):
                continue
            if not hasattr(tc, f.name):
                # the port routes attention by shape alone: GPT-2's config
                # has no attn_impl; Llama's and Mixtral's keep the field
                # and raise on any value but "auto"
                assert (name.startswith("gpt2") and f.name == "attn_impl"
                        and jc.attn_impl == "auto"), f.name
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        for f, v in kw.items():
            assert getattr(tc, f) == v
    assert all(torch.isfinite(p).all() for p in m.parameters())


def test_get_model_unknown_name_and_register():
    with pytest.raises(KeyError, match="unknown model"):
        tmodels.get_model("nope")
    tmodels.register_model("tiny-gpt2", lambda **kw: tmodels.GPT2(
        tmodels.GPT2Config.debug(n_layers=1), **kw))
    try:
        m = tmodels.get_model("tiny-gpt2", device="cpu")
        assert m.cfg.n_layers == 1
    finally:
        del tmodels._REGISTRY["tiny-gpt2"]


def test_entry_on_cpu_matches_the_reference_example():
    """entry() builds the flagship widths and the reference's example
    tokens; its forward, given the reference's parameters, gives the
    reference's logits. Both compute in bf16 (8-bit mantissa) and round
    at different points through 4 blocks: logits of order 1 differ by up
    to 0.053 (measured), so atol 0.1; a wrong weight moves them by order
    1."""
    j_forward, (j_params, j_tokens) = __graft_entry__.entry()
    forward, (params, tokens) = entry(device="cpu")
    assert tokens.dtype == torch.int32 and tokens.shape == (2, 128)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    jc, tc = __graft_entry__._flagship_config(), flagship_config()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq_len"):
        assert getattr(tc, f) == getattr(jc, f), f
    with torch.no_grad():
        own = forward(params, tokens)
        assert own.shape == (2, 128, 2048) and torch.isfinite(own).all()
        got = forward(convert.llama_params_from_flax(_np(j_params)), tokens)
    want = np.asarray(j_forward(j_params, j_tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=0.1, rtol=0)
