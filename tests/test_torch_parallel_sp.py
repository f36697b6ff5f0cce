"""Sequence parallelism inside a model's train step on the port against
the JAX package, on the CPU.

One world of 4 gloo ranks (`train.backend.launch`) runs every mesh
case; the JAX step runs on the same MeshSpec over 4 of the 8 virtual
CPU devices, from the same params (the JAX init, converted) and the
same `inputs`/`targets` batches made from a seed (the JAX step cannot
take a tokens batch of S + 1 columns on sp: jit needs the dim to
divide). Loss and grad_norm agree to rtol 1e-4 each step, ntokens
exactly, and the params after 3 sgd steps to rtol 1e-4 (atol 1e-6), as
tests/test_torch_parallel.py holds its cases. Cases: Llama at sp 4 on
the split-prefix route (attn_impl "pallas": the kernels' plain versions
on the CPU) with a loss mask that is 0 across a chunk boundary and over
a whole row, Llama at fsdp 2 x sp 2, Mixtral at ep 2 x sp 2 at capacity
factor 1.0 (tokens drop: the loss at a no-drop capacity differs), GPT-2
at dp 2 x sp 2. Beside them: the split-prefix core alone against the
reference's full causal attention (outputs and gradients, fp32, 1e-5),
a LocalBatch from `device_put_iterator` under sp equal to the step's
own cut of a tokens batch (and the same loss), and "dpa" under sp
raising ValueError.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JGPT2Config
from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu.models import Mixtral as JMixtral
from ray_tpu.models import MixtralConfig as JMixtralConfig
from ray_tpu.ops import multi_head_attention as j_mha
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu.train import next_token_loss as j_next_token_loss
from ray_tpu_torch.models.convert import (gpt2_params_from_flax,
                                          llama_params_from_flax,
                                          mixtral_params_from_flax)
from ray_tpu_torch.ops import sequence_parallel_attention
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.train.backend import launch

RTOL, ATOL = 1e-4, 1e-6
LLAMA = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
             n_kv_heads=4, d_ff=128, max_seq_len=64)
MIXTRAL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=128, n_experts=4, experts_per_token=2,
               max_seq_len=64, capacity_factor=1.0)
GPT2 = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=64)
FAMILIES = {
    "llama": (JLlama, JLlamaConfig, llama_params_from_flax),
    "mixtral": (JMixtral, JMixtralConfig, mixtral_params_from_flax),
    "gpt2": (JGPT2, JGPT2Config, gpt2_params_from_flax),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(seed, vocab, mask=False):
    """3 batches of `inputs`/`targets` (8, 16); with `mask`, a loss
    mask that is 0 over columns 2-5 of rows 0-3 (across sp 4's chunk
    boundary at 4) and over all of row 5."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        t = rng.randint(0, vocab, (8, 17)).astype(np.int32)
        b = {"inputs": t[:, :-1], "targets": t[:, 1:]}
        if mask:
            m = (rng.rand(8, 16) > 0.2).astype(np.float32)
            m[:4, 2:6] = 0.0
            m[5] = 0.0
            b["loss_mask"] = m
        out.append(b)
    return out


def _jax_init(model, cfg, spec, batches):
    """The JAX step on MeshSpec(**spec) over 4 virtual devices from
    PRNGKey(0): (its initial params as the port's state_dict, state,
    step)."""
    cls, cfg_cls, convert = FAMILIES[model]
    jm = cls(cfg_cls(**cfg, dtype=jnp.float32))
    mesh = j_build_mesh(JMeshSpec(**spec), devices=jax.devices()[:4])
    state, step = j_make_train_step(
        jm, j_make_optimizer("sgd", learning_rate=0.1), mesh,
        donate_state=False)(jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batches[0].items()})
    params = {k: v.numpy() for k, v in convert(_np(state.params)).items()}
    return params, state, step


def _jax_steps(model, state, step, batches):
    rows = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                              "ntokens")})
    convert = FAMILIES[model][2]
    return {"metrics": rows, "params": {
        k: v.numpy() for k, v in convert(_np(state.params)).items()}}


CASES = {
    "llama_sp4_split_prefix": dict(model="llama", cfg=LLAMA,
                                   spec=dict(sp=4), seed=200, mask=True,
                                   port_cfg=dict(attn_impl="pallas")),
    "llama_fsdp2_sp2": dict(model="llama", cfg=LLAMA,
                            spec=dict(fsdp=2, sp=2), seed=201),
    "mixtral_ep2_sp2": dict(model="mixtral", cfg=MIXTRAL,
                            spec=dict(ep=2, sp=2), seed=202),
    "gpt2_dp2_sp2": dict(model="gpt2", cfg=GPT2, spec=dict(dp=2, sp=2),
                         seed=203),
}


def _mixtral_drops(state, batch):
    """The JAX Mixtral's loss at capacity factor 1.0 and at a no-drop
    capacity on the same params and batch."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return [float(jax.jit(lambda p, b, m=m: j_next_token_loss(
        m.apply, p, b)[0])(state.params, jb))
        for m in (JMixtral(JMixtralConfig(**MIXTRAL, dtype=jnp.float32)),
                  JMixtral(JMixtralConfig(**{**MIXTRAL,
                                             "capacity_factor": 2.0},
                                          dtype=jnp.float32)))]


@pytest.fixture(scope="module")
def runs():
    cases, jax_side = {}, {}
    for name, c in CASES.items():
        batches = _batches(c["seed"], c["cfg"]["vocab_size"],
                           c.get("mask", False))
        params, state, step = _jax_init(c["model"], c["cfg"], c["spec"],
                                        batches)
        cases[name] = dict(model=c["model"], cfg=c["cfg"], spec=c["spec"],
                           opt="sgd", lr=0.1, batches=batches,
                           params=params, port_cfg=c.get("port_cfg", {}))
        jax_side[name] = (state, step)
    rng = np.random.RandomState(204)
    loader = dict(cases["llama_fsdp2_sp2"], host={
        "tokens": rng.randint(0, 256, (8, 17)).astype(np.int64),
        "loss_mask": (rng.rand(8, 16) > 0.3).astype(np.float32)})
    jobs = [("train_cases", [cases[n] for n in CASES]),
            ("loader_sp_case", loader),
            ("dpa_sp_case", dict(cases["llama_fsdp2_sp2"],
                                 spec=dict(sp=4)))]
    port = {}

    def ranks():
        port["out"] = launch(_testing.run_jobs, 4, "cpu", jobs,
                             timeout_s=240)[0]

    th = threading.Thread(target=ranks)
    th.start()
    try:
        want = {n: _jax_steps(c["model"], *jax_side[n], c["batches"])
                for n, c in cases.items()}
        drops = _mixtral_drops(jax_side["mixtral_ep2_sp2"][0],
                               cases["mixtral_ep2_sp2"]["batches"][0])
    finally:
        th.join()
    assert "out" in port, "the 4-rank world did not return"
    trained, loader_out, dpa_out = port["out"]
    return {"want": want, "got": dict(zip(CASES, trained)),
            "drops": drops, "loader": loader_out, "dpa": dpa_out}


@pytest.mark.parametrize("name", list(CASES))
def test_sp_train_step_matches_jax(runs, name):
    want, got = runs["want"][name], runs["got"][name]
    for i, (w, g) in enumerate(zip(want["metrics"], got["metrics"])):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=f"step {i} {key}")
        assert g["ntokens"] == w["ntokens"], i
    assert got["metrics"][0]["loss"] != got["metrics"][-1]["loss"]
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_mixtral_sp_case_drops_tokens(runs):
    drop, nodrop = runs["drops"]
    assert abs(drop - nodrop) > 1e-4, "capacity 1.0 drops no token here"


def test_sp_loader_batch_is_the_steps_cut(runs):
    out = runs["loader"]
    assert out["same"], out
    assert out["keys"] == ["inputs", "loss_mask", "targets"]
    assert out["local_shape"] == [4, 8]          # rows over fsdp, S over sp
    assert out["losses"][0] == out["losses"][1]
    assert "do not split over sp=2" in out["odd_raises"]


def test_dpa_under_sp_raises(runs):
    assert runs["dpa"] is not None and "impl='dpa'" in runs["dpa"]


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_split_prefix_core_matches_full_causal_attention(hq, hkv):
    """Each chunk of 4 against the whole K/V on the split-prefix route
    (K1's and K2a/K2b's plain versions), concatenated, against the
    reference's causal attention of the whole sequence; the gradients
    of sum(out * w), the chunks' dK/dV summed."""
    rng = np.random.RandomState(hq * 10 + hkv)
    b, s, d, n = 2, 32, 16, 4
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32)
               for h in (hq, hkv, hkv))
    w = rng.randn(b, s, hq, d).astype(np.float32)

    def loss(q, k, v):
        out = j_mha(q, k, v, causal=True, impl="xla")
        return (out * w).sum(), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    c = s // n
    out = torch.cat([sequence_parallel_attention(
        tq[:, r * c:(r + 1) * c], tk, tv, r, impl="pallas")
        for r in range(n)], dim=1)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for g, t, name in zip(grads, (tq, tk, tv), "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=1e-5, err_msg=f"d{name}")
