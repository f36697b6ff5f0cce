"""GPT-2's fused qkv under tp, the experts under ep, tp and fsdp, and
the MoE dispatch sized to a rank, on the port against the JAX package,
on the CPU.

One world of 4 gloo ranks (`train.backend.launch`) runs every mesh
case; the JAX step runs on the same MeshSpec over 4 of the 8 virtual
CPU devices from the same params (the JAX init, converted) and batches
made from a seed. Loss and grad_norm agree to rtol 1e-4 each step,
ntokens exactly, and the params after 3 sgd steps to rtol 1e-4 (atol
1e-6), as tests/test_torch_parallel.py holds its cases. Cases: GPT-2 at
tp 4 and at fsdp 2 x tp 2; Mixtral at fsdp 2 x ep 2, ep 2 x tp 2 and
fsdp 2 x tp 2 at capacity factor 1.0 (tokens drop). On every Mixtral
mesh the experts are in FSDP2: each rank's shard is the one the
reference's table gives its jax array (the JAX state's shard shapes,
through the converter), on an (fsdp, ep[, tp]) mesh, gathered whole
over d when its layer's forward starts, and the ep exchange runs on
the ep group of that mesh. GPT-2's qkv at fsdp 2 x tp 2 against the
table: the weight's shard is the table's, the bias is whole over fsdp
as the table's P() has it (split over tp, the deliberate difference).
Mixtral's aux losses at ep 2 x tp 2 (each layer's router loss,
the global batch's on every rank, against the JAX Mixtral's sown
`aux_loss` to rtol 1e-5, and the router kernels' gradients from one
mesh step of the loss plus the aux loss to rtol 1e-4, atol 1e-7).
GPT-2 under tp keeps `h_{i}.qkv` whole in `state_dict()` and
`state_layout` ((3 d, d), rows [q; k; v]); a checkpoint saved at tp 4
restores onto fsdp 2 x tp 2 and onto one device bit for bit, and so do
a TrainState's params and adamw moments. On one device, the index
dispatch against the reference's `moe_dispatch_combine`: the same
tokens dropped, fp32 outputs within 1e-6.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JGPT2Config
from ray_tpu.models import Mixtral as JMixtral
from ray_tpu.models import MixtralConfig as JMixtralConfig
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu_torch.models.convert import (gpt2_params_from_flax,
                                          mixtral_params_from_flax)
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.train.backend import launch

RTOL, ATOL = 1e-4, 1e-6
MIXTRAL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=128, n_experts=4, experts_per_token=2,
               max_seq_len=64, capacity_factor=1.0)
GPT2 = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=64)
FAMILIES = {"mixtral": (JMixtral, JMixtralConfig, mixtral_params_from_flax),
            "gpt2": (JGPT2, JGPT2Config, gpt2_params_from_flax)}
CASES = {
    "gpt2_tp4": dict(model="gpt2", cfg=GPT2, spec=dict(tp=4), seed=300),
    "gpt2_fsdp2_tp2": dict(model="gpt2", cfg=GPT2, spec=dict(fsdp=2, tp=2),
                           seed=301),
    "mixtral_ep2_tp2": dict(model="mixtral", cfg=MIXTRAL,
                            spec=dict(ep=2, tp=2), seed=302),
    "mixtral_fsdp2_tp2": dict(model="mixtral", cfg=MIXTRAL,
                              spec=dict(fsdp=2, tp=2), seed=303),
    "mixtral_fsdp2_ep2": dict(model="mixtral", cfg=MIXTRAL,
                              spec=dict(fsdp=2, ep=2), seed=304),
}
MIXTRAL_CASES = ["mixtral_fsdp2_ep2", "mixtral_ep2_tp2", "mixtral_fsdp2_tp2"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, vocab):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, vocab, (8, 17)).astype(np.int32)}
            for _ in range(3)]


def _jax_init(c, batches):
    cls, cfg_cls, convert = FAMILIES[c["model"]]
    jm = cls(cfg_cls(**c["cfg"], dtype=jnp.float32))
    mesh = j_build_mesh(JMeshSpec(**c["spec"]), devices=jax.devices()[:4])
    state, step = j_make_train_step(
        jm, j_make_optimizer("sgd", learning_rate=0.1), mesh,
        donate_state=False)(jax.random.PRNGKey(0),
                            {"tokens": jnp.asarray(batches[0]["tokens"])})
    params = {k: v.numpy() for k, v in convert(_np(state.params)).items()}
    return params, state, step


def _reference_shards(model, state):
    """Each leaf's shard shape on one device under the reference's
    table, under the port's name and in its layout (a tree of zeros of
    those shapes through the family's converter)."""
    zeros = jax.tree.map(lambda a: np.zeros(
        a.sharding.shard_shape(a.shape), np.float32), state.params)
    return {k: list(v.shape) for k, v in FAMILIES[model][2](zeros).items()}


def _jax_steps(model, state, step, batches):
    rows = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b["tokens"])})
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                              "ntokens")})
    return {"metrics": rows, "params": {
        k: v.numpy() for k, v in FAMILIES[model][2](
            _np(state.params)).items()}}


def _aux_want(jparams, tokens):
    """Each layer's sown router loss of the JAX Mixtral on the global
    batch, and the router kernels' gradients of the mean next-token
    loss plus the summed aux loss (and of the loss alone)."""
    model = JMixtral(JMixtralConfig(**MIXTRAL, dtype=jnp.float32))
    tokens = jnp.asarray(tokens)

    def loss(p, with_aux):
        (logits, _), mut = model.apply({"params": p}, tokens[:, :-1],
                                       mutable=["aux_loss"])
        ll = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(ll, tokens[:, 1:, None], -1).mean()
        return nll + with_aux * JMixtral.aux_loss(mut), mut

    (_, mut), grads = jax.value_and_grad(loss, has_aux=True)(jparams, 1.0)
    plain = jax.grad(lambda p: loss(p, 0.0)[0])(jparams)

    def routers(g):
        return {k: v.numpy() for k, v in mixtral_params_from_flax(
            _np(g)).items() if "router" in k}
    return {"aux": [float(mut["aux_loss"][f"layer_{i}"]["moe"]["router"][0])
                    for i in range(MIXTRAL["n_layers"])],
            "router_grads": routers(grads), "plain_grads": routers(plain)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, jax_side, ref_shards = {}, {}, {}
    for name, c in CASES.items():
        batches = _tokens(c["seed"], c["cfg"]["vocab_size"])
        params, state, step = _jax_init(c, batches)
        cases[name] = dict(model=c["model"], cfg=c["cfg"], spec=c["spec"],
                           opt="sgd", lr=0.1, batches=batches, params=params)
        jax_side[name] = (state, step)
        ref_shards[name] = _reference_shards(c["model"], state)
    mix = cases["mixtral_ep2_tp2"]
    aux = dict(mix, tokens=mix["batches"][0]["tokens"])
    root = tmp_path_factory.mktemp("tp_ckpt")
    gpt2 = cases["gpt2_tp4"]
    jobs = [("train_cases", [cases[n] for n in CASES]),
            ("moe_aux_case", aux),
            ("checkpoint_case", dict(gpt2, path=str(root / "tp4"),
                                     save=dict(tp=4),
                                     restore=[dict(fsdp=2, tp=2)])),
            ("gpt2_tp_layout_case", dict(gpt2, path=str(root / "state")))]
    port = {}

    def ranks():
        port["out"] = launch(_testing.run_jobs, 4, "cpu", jobs,
                             timeout_s=240)[0]

    th = threading.Thread(target=ranks)
    th.start()
    try:
        want = {n: _jax_steps(c["model"], *jax_side[n], c["batches"])
                for n, c in cases.items()}
        want_aux = _aux_want(jax_side["mixtral_ep2_tp2"][0].params,
                             aux["tokens"])
    finally:
        th.join()
    assert "out" in port, "the 4-rank world did not return"
    trained, aux_out, ckpt, layout = port["out"]
    return {"want": want, "got": dict(zip(CASES, trained)),
            "aux": (want_aux, aux_out), "ckpt": ckpt, "layout": layout,
            "ref_shards": ref_shards}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_step_matches_jax(runs, name):
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


def test_mixtral_experts_shard_over_fsdp_and_tp(runs):
    """At ep 1 the tp-split experts go into FSDP2: a rank holds a
    quarter of each on fsdp 2 x tp 2, as it does of the projections."""
    got = runs["got"]["mixtral_fsdp2_tp2"]
    experts = [k for k in got["params"] if ".experts_" in k]
    assert experts
    for k in experts:
        assert got["local_numel"][k] * 4 == got["params"][k].size, k


def _experts(got):
    names = [k for k in got["params"] if ".experts_" in k]
    assert len(names) == 3 * MIXTRAL["n_layers"]
    return names


@pytest.mark.parametrize("name", MIXTRAL_CASES)
def test_mixtral_expert_shards_match_reference_table(runs, name):
    """The experts are in FSDP2 on every mesh: a DTensor on fsdp and on
    the model axes that split them (ep, and tp where it is > 1), fsdp on
    their d dim and ep on the expert dim, and each rank's shard has the
    shape the reference's table gives it (P("ep", "fsdp", "tp") for
    gate/up, P("ep", "tp", "fsdp") for down)."""
    got, ref = runs["got"][name], runs["ref_shards"][name]
    spec = CASES[name]["spec"]
    dims = ["fsdp"] + [a for a in ("ep", "tp") if spec.get(a, 1) > 1]
    e, d, ff = (MIXTRAL[k] for k in ("n_experts", "d_model", "d_ff"))
    for k in _experts(got):
        assert got["local_shape"][k] == ref[k], k
        assert got["mesh_dims"][k] == dims, k
        whole = [e, d, ff] if ".experts_down" not in k else [e, ff, d]
        fsdp_dim = 1 if ".experts_down" not in k else 2
        want = list(whole)
        want[0] //= spec.get("ep", 1)
        want[fsdp_dim] //= spec.get("fsdp", 1)
        want[3 - fsdp_dim] //= spec.get("tp", 1)
        assert got["local_shape"][k] == want, k
    ranks = 1
    for v in spec.values():
        ranks *= v
    held = sum(got["local_numel"][k] for k in _experts(got))
    assert held * ranks == sum(got["params"][k].size for k in _experts(got))


@pytest.mark.parametrize("name", MIXTRAL_CASES)
def test_mixtral_experts_gathered_before_the_expert_product(runs, name):
    """When each MoE layer's forward starts, FSDP2 has gathered its
    experts over fsdp: the grouped product reads each rank's experts
    (E / ep) whole over d, their ff dim split over tp."""
    got = runs["got"][name]
    spec = CASES[name]["spec"]
    e, d, ff = (MIXTRAL[k] for k in ("n_experts", "d_model", "d_ff"))
    e, ff = e // spec.get("ep", 1), ff // spec.get("tp", 1)
    assert sorted(got["at_forward"]) == sorted(_experts(got))
    for k, shape in got["at_forward"].items():
        assert shape == ([e, ff, d] if ".experts_down" in k else [e, d, ff])


@pytest.mark.parametrize("name", ["mixtral_fsdp2_ep2", "mixtral_ep2_tp2"])
def test_mixtral_ep_exchange_runs_on_the_experts_ep_group(runs, name):
    assert runs["got"][name]["ep_group_is_experts"] is True


def test_gpt2_qkv_bias_layout_against_the_reference_table(runs):
    """GPT-2 at fsdp 2 x tp 2: the reference's table replicates the qkv
    bias (`.*bias$`: P()). The port keeps it whole over fsdp, as the
    table does, outside FSDP2: its one dim is the one tp splits three
    ways (`_StridedShard(0, 3)`, which the block's local rows need), and
    FSDP2 would split that dim again. Over tp it holds a half, the
    deliberate difference. The qkv weight is in FSDP2 over its columns,
    and its shard is the table's (P("fsdp", "tp") on (d, 3 d))."""
    got, ref = runs["got"]["gpt2_fsdp2_tp2"], runs["ref_shards"]["gpt2_fsdp2_tp2"]
    d = GPT2["d_model"]
    for i in range(GPT2["n_layers"]):
        bias, weight = f"h_{i}.qkv.bias", f"h_{i}.qkv.weight"
        assert ref[bias] == [3 * d]
        assert got["mesh_dims"][bias] == ["tp"]
        assert got["placements"][bias] == "(_StridedShard(dim=0, sf=3),)"
        assert got["local_shape"][bias] == [3 * d // 2]
        assert got["mesh_dims"][weight] == ["fsdp", "tp"]
        assert got["local_shape"][weight] == ref[weight] == [3 * d // 2,
                                                             d // 2]


def test_mixtral_aux_losses_over_ep_tp_are_global(runs):
    want, got = runs["aux"]
    assert got["aux_same_on_every_rank"]
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
    assert set(got["router_grads"]) == set(want["router_grads"])
    for k, w in want["router_grads"].items():
        np.testing.assert_allclose(got["router_grads"][k], w, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        assert np.abs(w - want["plain_grads"][k]).max() > 1e-3 * np.abs(
            w).max(), k


def test_gpt2_qkv_keeps_its_layout_under_tp(runs):
    out = runs["layout"]
    assert out["whole_equal"]
    d = GPT2["d_model"]
    for name, shape in out["layout_shapes"].items():
        assert shape == ([3 * d, d] if name.endswith("weight") else [3 * d])
    assert all("_StridedShard(dim=0, sf=3)" in p
               for p in out["placements"].values())
    assert out["restored_equal"]


def test_gpt2_tp_checkpoint_restores_bit_for_bit(runs):
    out = runs["ckpt"]
    assert out["committed_on_return"]
    assert out["single_equal"]
    assert all(out["resharded_equal"].values()), out["resharded_equal"]
    assert all(out["own_storage"].values())
    assert out["mismatch_raises"]


@pytest.mark.parametrize("cf,rows", [(0.5, 1), (0.5, 4), (1.0, 8),
                                     (2.0, 2)])
def test_index_dispatch_matches_reference(cf, rows):
    """The same tokens dropped (the rows whose every slot drops, and
    the outputs beside a no-drop call), outputs within 1e-6."""
    rng = np.random.RandomState(int(cf * 10) + rows)
    g, e, d, k = 64, 4, 16, 2
    x = rng.randn(g, d).astype(np.float32)
    logits = rng.randn(g, e).astype(np.float32)
    w = rng.randn(e, d, d).astype(np.float32) / 4

    def jrun(cap_f):
        out, aux = jmoe.moe_dispatch_combine(
            jnp.asarray(x), jnp.asarray(logits),
            lambda b: jnp.einsum("ecd,edf->ecf", b, w), k=k,
            capacity_factor=cap_f)
        return np.asarray(out), aux

    want, jaux = jrun(cf)
    got, taux = tmoe.moe_dispatch_combine(
        torch.from_numpy(x), torch.from_numpy(logits),
        lambda b: torch.bmm(b, torch.from_numpy(w)), k=k,
        capacity_factor=cf, rows=rows)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux.load_balance_loss),
                               float(jaux.load_balance_loss), rtol=1e-6)
    dropped = lambda o: np.abs(o).sum(1) == 0  # noqa: E731
    np.testing.assert_array_equal(dropped(got), dropped(want))
    nodrop = jrun(float(e) / k)[0]
    moved = np.abs(want - nodrop).max(1) > 1e-6
    np.testing.assert_array_equal(np.abs(got - nodrop).max(1) > 1e-6, moved)
    if cf < 1.0:
        assert dropped(want).any() and moved.any()
