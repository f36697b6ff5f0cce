"""The port's sharded train step against the JAX package, on the CPU.

One world of 4 gloo ranks (`train.backend.launch`) runs every case
below with `make_train_step(model, tx, mesh)`; the JAX step runs on the
same MeshSpec over 4 of the 8 virtual CPU devices, from the same params
(the JAX init, converted) and batches. Loss and grad_norm agree to rtol
1e-4 each step, ntokens exactly, and the params after 3 steps to rtol
1e-4 (atol 1e-6 for elements near zero: the ranks and XLA sum in
different orders). Cases: dp 2 x fsdp 2, fsdp 2 x tp 2, dp 4, tp 4, tp
4 over 2 kv heads (k/v replicated, whole heads).
tests/test_torch_parallel_loss.py runs the loss and optimizer cases
through `run_cases` and `check_case` here.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu_torch.models import llama_params_from_flax
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.train.backend import launch

WIDTHS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
              n_kv_heads=4, d_ff=128, max_seq_len=64)
RTOL, ATOL = 1e-4, 1e-6


# ------------------------------------------------------- the train step --

def _batches(seed, rows=8, cols=17, vocab=256, masks=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(3):
        b = {"tokens": rng.randint(0, vocab, (rows, cols)).astype(np.int32)}
        if masks is not None:
            b["loss_mask"] = masks[i]
        out.append(b)
    return out


# the mesh specs; tests/test_torch_parallel_loss.py holds the loss and
# optimizer cases on meshes (a file each keeps each under a minute)
CASES = {
    "dp2_fsdp2": dict(spec=dict(dp=2, fsdp=2), seed=100),
    "fsdp2_tp2": dict(spec=dict(fsdp=2, tp=2), seed=101),
    "dp4": dict(spec=dict(dp=4), seed=102),
    "tp4": dict(spec=dict(tp=4), seed=103),
    "tp4_kv2": dict(spec=dict(tp=4), cfg=dict(WIDTHS, n_kv_heads=2),
                    seed=104),
}


def _case(c):
    cfg = c.get("cfg", WIDTHS)
    return dict(spec=c["spec"], cfg=cfg, opt=c.get("opt", "sgd"),
                lr=c.get("lr", 0.1), accum=c.get("accum", 1),
                batches=_batches(c["seed"], vocab=cfg["vocab_size"],
                                 masks=c.get("masks")))


def _init_params(cfg):
    """The JAX Llama's params from PRNGKey(0), drawn as make_train_step
    draws them (partitionable threefry: the same bits on any mesh)."""
    jm = JLlama(JConfig(**cfg, dtype=jnp.float32))
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        return jax.jit(lambda r: jm.init(r, jnp.zeros((1, 8), jnp.int32))[
            "params"])(jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _sd(params):
    return {k: v.numpy() for k, v in llama_params_from_flax(
        jax.tree.map(np.asarray, params)).items()}


def _jax_steps(case, params):
    """JAX's step on the case's MeshSpec over 4 virtual devices: its
    initial params must be `params`; then its per-step metrics and the
    params after (as the port's state_dict)."""
    jm = JLlama(JConfig(**case["cfg"], dtype=jnp.float32))
    mesh = j_build_mesh(JMeshSpec(**case["spec"]), devices=jax.devices()[:4])
    tx = j_make_optimizer(case["opt"], learning_rate=case["lr"])
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in case["batches"]]
    init = j_make_train_step(jm, tx, mesh, donate_state=False,
                             accum_steps=case["accum"])
    state, step = init(jax.random.PRNGKey(0), batches[0])
    start = _sd(state.params)
    assert all(np.array_equal(start[k], v) for k, v in params.items())
    rows = []
    for b in batches:
        state, m = step(state, b)
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                              "ntokens")})
    return {"metrics": rows, "params": _sd(state.params)}


def run_cases(specs):
    """The 4-rank world side of every case of `specs`, in a thread from
    the start, and the JAX side meanwhile: (want, got) by name."""
    names = list(specs)
    inits, cases = {}, {}
    for name in names:
        case = _case(specs[name])
        key = tuple(sorted(case["cfg"].items()))
        if key not in inits:
            inits[key] = _sd(_init_params(case["cfg"]))
        cases[name] = {**case, "params": inits[key]}
    port = {}

    def ranks():
        port["out"] = launch(_testing.train_cases, 4, "cpu",
                             [cases[n] for n in names], timeout_s=240)[0]

    th = threading.Thread(target=ranks)
    th.start()
    try:
        want = {n: _jax_steps(cases[n], cases[n]["params"]) for n in names}
    finally:
        th.join()
    assert "out" in port, "the 4-rank world did not return"
    return want, dict(zip(names, port["out"]))


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


def check_case(want, got):
    """Loss and grad_norm each step (rtol 1e-4), ntokens exactly, the
    params after (rtol 1e-4, atol 1e-6)."""
    for i, (w, g) in enumerate(zip(want["metrics"], got["metrics"])):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=f"step {i} {key}")
        assert g["ntokens"] == w["ntokens"], i
    # the steps moved the params: a step that did nothing would not
    # change the loss on the next batches
    assert got["metrics"][0]["loss"] != got["metrics"][-1]["loss"]
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_on_mesh_matches_jax(runs, name):
    check_case(runs[0][name], runs[1][name])
