"""The port's GRPO (ray_tpu_torch/rllib/grpo.py) against the JAX
package's on the same weights and inputs: the advantages, the token
log-probs, the learner's update with the clip active and not, the
trainer's step over a fixed sampler (padding, masks, rewards) in full
and over LoRA adapters, and the engine sampler on the CPU.

Tolerances: the advantages exactly (the same numpy); the log-probs to
rtol 1e-5 (fp32 forwards that sum in different orders); the updates'
stats to rtol 1e-4 and the params to rtol 1e-4 with atol lr / 10, as
tests/test_torch_train.py holds AdamW steps: Adam divides each element's
gradient by its own running rms, so an element whose gradient is at
rounding level may step by a different fraction of lr in each
framework.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu import models as jmodels
from ray_tpu.rllib import grpo as jgrpo
from ray_tpu.train import init_lora as j_init_lora
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import grpo
from ray_tpu_torch.train.lora import unflatten_adapters

WIDTHS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=64)
EOS = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0):
    """The JAX Llama with params from `seed`, and the port's Llama
    holding the same params."""
    jm = jmodels.Llama(jmodels.LlamaConfig(**WIDTHS, remat=False,
                                           dtype=jnp.float32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = tmodels.Llama(tmodels.LlamaConfig(**WIDTHS, dtype=torch.float32),
                       device="cpu")
    tm.load_state_dict(convert.llama_params_from_flax(_np(params)))
    return jm, params, tm


def _japply(jm):
    return lambda p, t: jm.apply({"params": p}, t)[0]


def _close_params(got, want_tree, lr):
    want = convert.llama_params_from_flax(_np(want_tree))
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=lr / 10, err_msg=name)


def test_group_relative_advantages_exact():
    r = np.random.RandomState(0).rand(24).astype(np.float32)
    r[8:12] = 2.0                                    # a tied group
    got = grpo.group_relative_advantages(r, 4)
    np.testing.assert_array_equal(got, jgrpo.group_relative_advantages(r, 4))
    assert got.dtype == np.float32 and np.allclose(got[8:12], 0.0)


def test_token_logps_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.standard_normal((3, 9, 64)).astype(np.float32) * 3
    tokens = rng.randint(0, 64, (3, 9)).astype(np.int32)
    np.testing.assert_allclose(
        grpo._token_logps(torch.from_numpy(logits),
                          torch.from_numpy(tokens)).numpy(),
        np.asarray(jgrpo._token_logps(jnp.asarray(logits),
                                      jnp.asarray(tokens))), rtol=1e-5)
    jm, params, tm = _pair()
    cfg = grpo.GRPOConfig(temperature=0.7)
    jl = jgrpo.GRPOLearner(_japply(jm), params,
                           jgrpo.GRPOConfig(temperature=0.7))
    tl = grpo.GRPOLearner(grpo.module_apply(tm), dict(tm.named_parameters()),
                          cfg)
    toks = rng.randint(0, 64, (4, 13)).astype(np.int32)
    got = tl.token_logps(tl.params, toks)
    assert isinstance(got, np.ndarray) and got.shape == (4, 12)
    np.testing.assert_allclose(got, jl.token_logps(params, toks), rtol=1e-5)


def _batch(seed, rows=6, cols=14):
    """A padded GRPO batch with a ragged mask and log-probs that move the
    ratio away from 1 (so the surrogate's clip bites)."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((rows, cols - 1), np.float32)
    for r in range(rows):
        start = rng.randint(1, 5)
        mask[r, start:start + rng.randint(3, cols - 1 - start)] = 1.0
    return {"tokens": rng.randint(0, 64, (rows, cols)).astype(np.int32),
            "mask": mask,
            "advantages": rng.standard_normal(rows).astype(np.float32)}


@pytest.mark.parametrize("grad_clip", [1e-3, 1e6])
def test_learner_updates_match_jax(grad_clip):
    """2 updates from the same params on the same batch: with the global
    norm clip active (1e-3) and not (1e6)."""
    jm, params, tm = _pair()
    kw = dict(lr=1e-3, grad_clip=grad_clip, kl_coeff=0.1, clip_param=0.2)
    jl = jgrpo.GRPOLearner(_japply(jm), params, jgrpo.GRPOConfig(**kw))
    tl = grpo.GRPOLearner(grpo.module_apply(tm), dict(tm.named_parameters()),
                          grpo.GRPOConfig(**kw))
    batch = _batch(2)
    base = jl.token_logps(params, batch["tokens"])
    rng = np.random.RandomState(3)
    batch["old_logps"] = (base + 0.3 * rng.standard_normal(base.shape)
                          ).astype(np.float32)
    batch["ref_logps"] = (base + 0.2 * rng.standard_normal(base.shape)
                          ).astype(np.float32)
    for _ in range(2):
        want = jl.update({k: jnp.asarray(v) for k, v in batch.items()})
        got = tl.update(batch)
        assert set(got) == set(want) == {"pg_loss", "kl", "total_loss"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    _close_params(tl.params, jl.params, kw["lr"])


def _fixed_sampler(prompt_ids, group):
    """Deterministic completions of 6 tokens, EOS-terminated at a
    row-dependent place (one row never ends), padded with EOS."""
    plen = len(prompt_ids)
    rng = np.random.RandomState(plen)
    toks = np.zeros((group, plen + 6), np.int32)
    toks[:, :plen] = prompt_ids
    comp = rng.randint(6, 64, (group, 6))
    for g in range(group - 1):
        end = g % 6
        comp[g, end] = EOS
        comp[g, end + 1:] = EOS
    toks[:, plen:] = comp
    return toks


def _reward(prompt_ids, completion_ids):
    return float(sum(int(t) % 3 == 0 for t in completion_ids)) \
        + 0.1 * len(completion_ids)


PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13]]


def test_trainer_step_matches_jax_with_fixed_sampler():
    """2 steps over prompts of two lengths: rewards on the completions cut
    at EOS, masks, right padding across prompts, both log-prob passes and
    the update agree; kl > 0 after the first update."""
    jm, params, tm = _pair(4)
    kw = dict(group_size=4, max_new_tokens=6, lr=1e-3, kl_coeff=0.1)
    jt = jgrpo.GRPOTrainer(_japply(jm), params, _reward,
                           jgrpo.GRPOConfig(**kw), eos_id=EOS,
                           sampler=_fixed_sampler)
    tt = grpo.GRPOTrainer(model=tm, reward_fn=_reward,
                          cfg=grpo.GRPOConfig(**kw), eos_id=EOS,
                          sampler=_fixed_sampler, device="cpu")
    assert tt.sampler is _fixed_sampler
    for i in range(2):
        want = jt.step(PROMPTS)
        got = tt.step(PROMPTS)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert got["kl"] > 0 and want["kl"] > 0
    assert set(tt.timings) == {"sample_s", "logps_s", "update_s"}
    _close_params(tt.params, jt.params, kw["lr"])
    # the reference is a frozen clone: it still holds the start
    start = convert.llama_params_from_flax(_np(params))
    for name, ref in tt.ref_params.items():
        assert torch.equal(ref, start[name]), name
        assert ref.data_ptr() != tt.params[name].data_ptr()


def test_lora_trainer_matches_jax_with_fixed_sampler():
    """make_lora_grpo_trainer over the same base and adapters: 2 steps'
    stats and the adapters agree; the base never moves; the engine's
    copy of the module receives the merged weights after each step."""
    jm, params, tm = _pair(5)
    jlora = j_init_lora(params, jax.random.PRNGKey(1), rank=4,
                        targets=("q_proj", "v_proj"))
    kw = dict(group_size=4, max_new_tokens=6, lr=5e-3, kl_coeff=0.1)
    jt = jgrpo.make_lora_grpo_trainer(jm, params, jlora, _reward,
                                      cfg=jgrpo.GRPOConfig(**kw),
                                      eos_id=EOS, max_seq_len=64)
    jt.sampler.shutdown()
    jt.sampler = _fixed_sampler
    base = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    tt = grpo.make_lora_grpo_trainer(tm, None, convert.lora_from_flax(
        _np(jlora)), _reward, cfg=grpo.GRPOConfig(**kw), eos_id=EOS,
        max_seq_len=64, device="cpu")
    engine = tt.sampler.engine
    push = tt.sampler.set_params
    try:
        assert engine.model is not tm
        tt.sampler = _fixed_sampler
        for i in range(2):
            want = jt.step(PROMPTS)
            got = tt.step(PROMPTS)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=f"step {i} {k}")
        assert got["kl"] > 0
        push(tt.params)
        from ray_tpu_torch.train import merge_lora
        merged = merge_lora(tm, {"rank": 4, "alpha": 16.0, "adapters":
                                 unflatten_adapters(tt.params)})
        for name, w in engine.params.items():
            assert torch.equal(w, merged[name]), name
        assert not torch.equal(merged["layer_0.attention.q_proj.weight"],
                               base["layer_0.attention.q_proj.weight"])
    finally:
        engine.shutdown()
    for k, v in tm.state_dict().items():
        assert torch.equal(v, base[k]), k
    want = convert.lora_from_flax(_np({**jlora, "adapters": jt.params}))
    got = unflatten_adapters(tt.params)
    for name, pair in want["adapters"].items():
        for k in "AB":
            np.testing.assert_allclose(got[name][k].detach().numpy(),
                                       pair[k].numpy(), rtol=1e-4,
                                       atol=kw["lr"] / 10)


def test_engine_sampler_on_cpu():
    """Shape (G, plen + max_new), EOS padding after a short completion,
    the ValueError on an over-long budget, and set_params reaching the
    engine's weights; a trainer given `model=` samples through an engine
    that shares the learner's module."""
    _, _, tm = _pair(6)
    with torch.no_grad():
        tm.lm_head.weight.zero_()       # uniform next-token distribution
    cfg = grpo.GRPOConfig(group_size=16, max_new_tokens=16, temperature=1.0)
    s = grpo.EngineSampler(tm, None, cfg, eos_id=EOS, max_seq_len=32,
                           device="cpu")
    try:
        toks = s([1, 2, 3], 16)
        assert toks.shape == (16, 19) and toks.dtype == np.int32
        assert (toks[:, :3] == [1, 2, 3]).all()
        assert ((toks >= 0) & (toks < 64)).all()
        short = 0
        for row in toks[:, 3:]:
            hits = np.nonzero(row == EOS)[0]
            if len(hits) and hits[0] < 15:
                short += 1
                assert (row[hits[0]:] == EOS).all()
        assert short > 0
        with pytest.raises(ValueError):
            s(list(range(17)), 2)           # 17 + 16 > 32
        new = torch.full_like(tm.lm_head.weight, 0.5)
        s.set_params({"lm_head.weight": new})
        assert torch.equal(s.engine.params["lm_head.weight"], new)
        with pytest.raises(KeyError):
            s.set_params({"nope": new})
    finally:
        s.shutdown()
    _, _, tm = _pair(7)
    t = grpo.GRPOTrainer(model=tm, reward_fn=_reward,
                         cfg=grpo.GRPOConfig(group_size=2, max_new_tokens=4),
                         max_seq_len=32, device="cpu")
    try:
        assert isinstance(t.sampler, grpo.EngineSampler)
        assert t.sampler.engine.model is tm
        for name, p in t.sampler.engine.params.items():
            assert p is t.params[name]
        stats = t.step([[1, 2, 3]])
        assert np.isfinite(stats["total_loss"])
        # the update wrote the engine's weights in place: nothing to copy
        for name, p in t.sampler.engine.params.items():
            assert p is t.params[name]
    finally:
        t.shutdown()


def test_plain_sampling_loop_without_model_or_sampler():
    """With neither a model nor a sampler the trainer samples by full
    forwards from a generator seeded cfg.seed: same seed, same tokens."""
    _, _, tm = _pair(8)
    params = {k: v.detach().clone() for k, v in tm.named_parameters()}
    apply_fn = grpo.module_apply(tm)
    cfg = grpo.GRPOConfig(group_size=3, max_new_tokens=5, seed=11)
    a = grpo.GRPOTrainer(apply_fn, params, _reward, cfg, device="cpu")
    b = grpo.GRPOTrainer(apply_fn, {k: v.detach().clone()
                                    for k, v in params.items()},
                         _reward, cfg, device="cpu")
    ta, tb = a._sample_group([1, 2], 3), b._sample_group([1, 2], 3)
    assert ta.shape == (3, 7) and np.array_equal(ta, tb)
    stats = a.step([[1, 2], [3, 4, 5]])
    assert all(np.isfinite(v) for v in stats.values())
