"""Ring attention, the pipelines and Mixtral over ep on the port against
the JAX package, on the CPU.

One world of 4 gloo ranks (`train.backend.launch`) runs every case;
the JAX side runs on 4 of the 8 virtual CPU devices from the same
inputs. Ring attention at sp 4 (causal and not, GQA and not): outputs
to atol 1e-5 and the gradients of sum(out * w) in q, k and v to atol
1e-4, against JAX's `ring_attention` and `jax.grad` through it (the
reference's own test's tolerances, tests/test_parallel_ops.py).
`pipeline_apply` at pp 4: output against JAX's `pipeline_apply` and
`pipeline_reference` to atol 1e-5, gradients in x and the stacked
params to atol 1e-5. The pipelined train step at pp 2 x dp 2 and
Mixtral's train step at ep 2 x dp 2 with the published capacity factor
1.25 (at which these batches drop tokens: the no-drop loss differs):
3 sgd steps, losses to rtol 1e-4, params to rtol 1e-4 (atol 1e-6).
Mixtral's aux losses at ep 2 x dp 2: each layer's router loss (the
global batch's, the same on every rank) against the JAX Mixtral's sown
`aux_loss` collection on the global batch to rtol 1e-5, and the router
kernels' gradients from one mesh step of the loss plus the aux loss
against `jax.grad` of the same sum to rtol 1e-4 (atol 1e-7).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.models import Mixtral as JMixtral
from ray_tpu.models import MixtralConfig as JMixtralConfig
from ray_tpu.ops import ring_attention as j_ring_attention
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from ray_tpu.parallel.pipeline import pipeline_reference as j_pipeline_ref
from ray_tpu.parallel.pipeline_train import PipelinedLM as JPipelinedLM
from ray_tpu.parallel.pipeline_train import \
    make_pipeline_train_step as j_make_pipeline_train_step
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu.train import next_token_loss as j_next_token_loss
from ray_tpu_torch.models.convert import (mixtral_params_from_flax,
                                          pipelined_lm_params_from_flax)
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.train.backend import launch

RING = {
    "causal_gqa": dict(hq=4, hkv=2, causal=True),
    "noncausal_gqa": dict(hq=4, hkv=2, causal=False),
    "causal_mha": dict(hq=4, hkv=4, causal=True),
}
MIXTRAL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=128, n_experts=4, experts_per_token=2,
               max_seq_len=64, capacity_factor=1.25)
PIPE = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2,
            n_kv_heads=2, d_ff=64, max_seq_len=32)


def _devices(spec):
    return j_build_mesh(JMeshSpec(**spec), devices=jax.devices()[:4])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ring_case(i, hq, hkv, causal):
    rng = np.random.RandomState(10 + i)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(q=f(2, 32, hq, 16), k=f(2, 32, hkv, 16), v=f(2, 32, hkv, 16),
                w=f(2, 32, hq, 16), causal=causal)


def _ring_want(case):
    mesh = _devices(dict(sp=4))

    def loss(q, k, v):
        out = j_ring_attention(q, k, v, mesh=mesh, causal=case["causal"])
        return (out * case["w"]).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[x]) for x in "qkv"))
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


def _pipe_case():
    rng = np.random.RandomState(3)
    return dict(w=(rng.randn(4, 16, 16) * 0.1).astype(np.float32),
                b=(rng.randn(4, 16) * 0.1).astype(np.float32),
                x=rng.randn(16, 16).astype(np.float32),
                g=rng.randn(16, 16).astype(np.float32), n_micro=8)


def _pipe_want(case):
    mesh = _devices(dict(pp=4))

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(stacked, x):
        out = j_pipeline_apply(stage_fn, stacked, x, mesh=mesh,
                               n_microbatches=case["n_micro"])
        return (out * case["g"]).sum(), out

    stacked = {"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])}
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(case["x"]))
    ref = j_pipeline_ref(stage_fn, stacked, jnp.asarray(case["x"]))
    return {"out": np.asarray(out), "ref": np.asarray(ref),
            "dx": np.asarray(gx), "dw": np.asarray(gp["w"]),
            "db": np.asarray(gp["b"])}


def _tokens(seed, rows, cols, vocab):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, vocab, (rows, cols)).astype(np.int32)}
            for _ in range(3)]


def _pipe_train():
    cfg = JConfig(**PIPE, dtype=jnp.float32)
    mesh = _devices(dict(pp=2, dp=2))
    model = JPipelinedLM(cfg, mesh, n_microbatches=2)
    batches = _tokens(5, 8, 16, PIPE["vocab_size"])
    tx = j_make_optimizer("sgd", learning_rate=0.1)
    state, step = j_make_pipeline_train_step(model, tx)(
        jax.random.PRNGKey(0), {"tokens": jnp.asarray(batches[0]["tokens"])})
    params = pipelined_lm_params_from_flax(_np(state.params))
    case = dict(spec=dict(pp=2, dp=2), cfg=PIPE, n_micro=2, opt="sgd",
                lr=0.1, batches=batches, params={
                    "embed": params["embed"].numpy(),
                    "stages": {k: v.numpy()
                               for k, v in params["stages"].items()},
                    "final_norm": params["final_norm"].numpy()})
    return case, (state, step)


def _pipe_train_want(state, step, batches):
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b["tokens"])})
        losses.append(float(m["loss"]))
    p = pipelined_lm_params_from_flax(_np(state.params))
    flat = {"embed": p["embed"].numpy(), "final_norm": p["final_norm"].numpy()}
    flat.update({f"stages/{k}": v.numpy() for k, v in p["stages"].items()})
    return {"losses": losses, "params": flat}


def _mixtral():
    cfg = JMixtralConfig(**MIXTRAL, dtype=jnp.float32)
    mesh = _devices(dict(dp=2, ep=2))
    batches = _tokens(6, 8, 17, MIXTRAL["vocab_size"])
    tx = j_make_optimizer("sgd", learning_rate=0.1)
    first = {"tokens": jnp.asarray(batches[0]["tokens"])}
    state, step = j_make_train_step(JMixtral(cfg), tx, mesh,
                                    donate_state=False)(
        jax.random.PRNGKey(0), first)
    params = {k: v.numpy() for k, v in mixtral_params_from_flax(
        _np(state.params)).items()}
    # the published capacity drops tokens on these batches: the same
    # params at a no-drop capacity (the call's token count) give another
    # loss
    nodrop = JMixtral(JMixtralConfig(**{**MIXTRAL, "capacity_factor": 2.0},
                                     dtype=jnp.float32))
    losses = [float(jax.jit(lambda p, b, m=m: j_next_token_loss(
        m.apply, p, b)[0])(state.params, first))
        for m in (JMixtral(cfg), nodrop)]
    case = dict(model="mixtral", spec=dict(dp=2, ep=2), cfg=MIXTRAL,
                opt="sgd", lr=0.1, batches=batches, params=params)
    return case, (state, step), losses


def _aux_want(case):
    """Each layer's sown aux loss, and the router gradients of the next
    token loss plus the summed aux loss (and of the loss alone), on the
    global batch, one device."""
    model = JMixtral(JMixtralConfig(**MIXTRAL, dtype=jnp.float32))
    tokens = jnp.asarray(case["tokens"])
    params = case["jparams"]

    def loss(p, with_aux):
        (logits, _), mut = model.apply({"params": p}, tokens[:, :-1],
                                       mutable=["aux_loss"])
        ll = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(ll, tokens[:, 1:, None], -1).mean()
        return nll + with_aux * JMixtral.aux_loss(mut), mut

    (_, mut), grads = jax.value_and_grad(loss, has_aux=True)(params, 1.0)
    plain = jax.grad(lambda p: loss(p, 0.0)[0])(params)

    def routers(g):
        return {k: v.numpy() for k, v in mixtral_params_from_flax(
            _np(g)).items() if "router" in k}
    return {"aux": [float(mut["aux_loss"][f"layer_{i}"]["moe"]["router"][0])
                    for i in range(MIXTRAL["n_layers"])],
            "router_grads": routers(grads), "plain_grads": routers(plain)}


def _train_want(state, step, batches):
    rows = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b["tokens"])})
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                              "ntokens")})
    return {"metrics": rows, "params": {
        k: v.numpy() for k, v in mixtral_params_from_flax(
            _np(state.params)).items()}}


@pytest.fixture(scope="module")
def runs():
    ring = {n: _ring_case(i, **c) for i, (n, c) in enumerate(RING.items())}
    pipe = _pipe_case()
    ptrain, (pstate, pstep) = _pipe_train()
    mix, (mstate, mstep), mix_losses = _mixtral()
    aux = dict(model="mixtral", spec=dict(dp=2, ep=2), cfg=MIXTRAL, lr=0.1,
               params=mix["params"], tokens=mix["batches"][0]["tokens"])
    aux_jax = dict(aux, jparams=_np(mstate.params))
    jobs = [("ring_cases", list(ring.values())), ("pipeline_case", pipe),
            ("pipeline_train_case", ptrain), ("train_cases", [mix]),
            ("moe_aux_case", aux)]
    port = {}

    def ranks():
        port["out"] = launch(_testing.run_jobs, 4, "cpu", jobs,
                             timeout_s=240)[0]

    th = threading.Thread(target=ranks)
    th.start()
    want = {"ring": {n: _ring_want(c) for n, c in ring.items()},
            "pipe": _pipe_want(pipe),
            "ptrain": _pipe_train_want(pstate, pstep, ptrain["batches"]),
            "mix": _train_want(mstate, mstep, mix["batches"]),
            "mix_losses": mix_losses, "aux": _aux_want(aux_jax)}
    th.join()
    assert "out" in port, "the 4-rank world did not return"
    ring_out, pipe_out, ptrain_out, (mix_out,), aux_out = port["out"]
    got = {"ring": dict(zip(ring, ring_out)), "pipe": pipe_out,
           "ptrain": ptrain_out, "mix": mix_out, "aux": aux_out}
    return want, got


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(runs, name):
    want, got = runs[0]["ring"][name], runs[1]["ring"][name]
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[g], want[g], atol=1e-4, err_msg=g)
    assert np.abs(got["dk"]).max() > 0


def test_pipeline_apply_matches_jax(runs):
    want, got = runs[0]["pipe"], runs[1]["pipe"]
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5)
    np.testing.assert_allclose(got["out"], want["ref"], atol=1e-5)
    for g in ("dx", "dw", "db"):
        np.testing.assert_allclose(got[g], want[g], atol=1e-5, err_msg=g)
    assert (np.abs(got["dw"]).reshape(4, -1).max(axis=1) > 0).all()


def test_pipeline_train_step_matches_jax(runs):
    want, got = runs[0]["ptrain"], runs[1]["ptrain"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["losses"][0] != got["losses"][-1]
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_mixtral_over_ep_matches_jax(runs):
    want, got = runs[0]["mix"], runs[1]["mix"]
    drop, nodrop = runs[0]["mix_losses"]
    assert abs(drop - nodrop) > 1e-4, "capacity 1.25 drops no token here"
    for i, (w, g) in enumerate(zip(want["metrics"], got["metrics"])):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_mixtral_aux_losses_over_ep_are_global(runs):
    want, got = runs[0]["aux"], runs[1]["aux"]
    assert got["aux_same_on_every_rank"]
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
    assert set(got["router_grads"]) == set(want["router_grads"])
    for k, w in want["router_grads"].items():
        np.testing.assert_allclose(got["router_grads"][k], w, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        # the aux term moves the router's gradient by more than that
        assert np.abs(w - want["plain_grads"][k]).max() > 1e-3 * np.abs(
            w).max(), k
