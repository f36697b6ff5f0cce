"""LoRA over a sharded base, sharded checkpoints and the int8 forward over
tp, on the port against the JAX package, on the CPU.

One world of 4 gloo ranks (`train.backend.launch`) runs the three:
- LoRA: `make_lora_train_step(..., mesh=)` over the base sharded on fsdp
  2 x tp 2 (adapters on q_proj, v_proj and down_proj: column- and
  row-parallel weights), 3 sgd steps against the JAX LoRA step on the
  same spec from the same base and adapters: loss and grad_norm to rtol
  1e-4, the adapters to rtol 1e-4 (atol 1e-6), and the base never
  moves. (sgd: adam divides each element's gradient by its own rms, so
  an element whose gradient is at rounding level, where the ranks' and
  XLA's sums differ, moves by a fraction of lr either way; adamw over
  adapters is held to JAX in tests/test_torch_lora.py.)
- int8 over tp: the int8 Llama sharded on dp 2 x tp 2 (kernel_q a
  DTensor over tp), the gathered logits against the JAX int8 forward to
  atol 1e-4.
- checkpoints: a Llama sharded on fsdp 2 x tp 2 is saved (gathered to
  rank 0, committed before any rank returns), restored shard by shard
  onto dp 4, onto fsdp 2 x tp 2 (FSDP2's _StridedShard over tp's
  Shard) and onto one device; every tensor equal bit for bit. Each
  mesh restore moves through `Tensor.to` the bytes of its rank's shards
  and nothing more, and keeps each shard in a storage of its own bytes;
  a saved tensor of another shape than its layout raises.
- shard_pytree of the Llama's flat dict of weights on fsdp 2 x tp 2:
  each tensor's placements those of the rule table's spec (Shard(d) on
  each mesh dim the spec puts on dim d), its whole tensor the input.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.ops.quant import quantize_llama_params as j_quantize
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel.sharding import shard_pytree as j_shard_pytree
from ray_tpu.train import init_lora as j_init_lora
from ray_tpu.train import make_lora_train_step as j_make_lora_train_step
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import AXIS_ORDER, MeshSpec
from ray_tpu_torch.parallel.sharding import dim_of, partition_spec_for
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.train.backend import launch

WIDTHS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
              n_kv_heads=4, d_ff=128, max_seq_len=64)
LR = 0.1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(params):
    return {k: v.numpy()
            for k, v in convert.llama_params_from_flax(_np(params)).items()}


def _init(seed):
    jm = JLlama(JConfig(**WIDTHS, dtype=jnp.float32))
    return jm, jm.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 8), jnp.int32))["params"]


def _lora():
    jm, params = _init(0)
    mesh = j_build_mesh(JMeshSpec(fsdp=2, tp=2), devices=jax.devices()[:4])
    jl = j_init_lora(params, jax.random.PRNGKey(1), rank=4,
                     targets=("q_proj", "v_proj", "down_proj"))
    rng = np.random.RandomState(7)
    batches = [{"tokens": rng.randint(0, WIDTHS["vocab_size"],
                                      (8, 17)).astype(np.int32)}
               for _ in range(3)]
    state, step = j_make_lora_train_step(
        jm, j_make_optimizer("sgd", learning_rate=LR), mesh,
        j_shard_pytree(params, mesh))(
        {"tokens": jnp.asarray(batches[0]["tokens"])}, jl)
    port = convert.lora_from_flax(_np(jl))
    case = dict(spec=dict(fsdp=2, tp=2), cfg=WIDTHS, params=_sd(params),
                rank=port["rank"], alpha=port["alpha"], lr=LR,
                batches=batches, adapters={
                    n: {k: v.numpy() for k, v in pair.items()}
                    for n, pair in port["adapters"].items()})
    return case, jl, state, step


def _lora_want(jl, state, step, batches):
    rows = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b["tokens"])})
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    want = convert.lora_from_flax(_np({**jl, "adapters": state.params}))
    return {"metrics": rows, "adapters": {
        n: {k: v.numpy() for k, v in pair.items()}
        for n, pair in want["adapters"].items()}}


def _int8():
    jm, params = _init(2)
    qparams = j_quantize(params)
    tokens = np.random.RandomState(8).randint(
        0, WIDTHS["vocab_size"], (4, 12)).astype(np.int32)
    qm = JLlama(dataclasses.replace(jm.cfg, quant="int8"))
    want = np.asarray(jax.jit(lambda p, t: qm.apply({"params": p}, t)[0])(
        qparams, jnp.asarray(tokens)))
    case = dict(spec=dict(dp=2, tp=2), cfg=WIDTHS, params=_sd(qparams),
                tokens=tokens)
    return case, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    lora_case, jl, lstate, lstep = _lora()
    int8_case, int8_want = _int8()
    ckpt_case = dict(cfg=WIDTHS, params=_sd(_init(3)[1]),
                     save=dict(fsdp=2, tp=2),
                     restore=[dict(dp=4), dict(fsdp=2, tp=2)],
                     path=str(tmp_path_factory.mktemp("ckpt") / "sharded"))
    pytree_case = dict(spec=dict(fsdp=2, tp=2), params=ckpt_case["params"])
    jobs = [("lora_case", lora_case), ("int8_forward", int8_case),
            ("checkpoint_case", ckpt_case),
            ("shard_pytree_case", pytree_case)]
    port = {}

    def ranks():
        port["out"] = launch(_testing.run_jobs, 4, "cpu", jobs,
                             timeout_s=240)[0]

    th = threading.Thread(target=ranks)
    th.start()
    want = {"lora": _lora_want(jl, lstate, lstep, lora_case["batches"]),
            "int8": int8_want}
    th.join()
    assert "out" in port, "the 4-rank world did not return"
    lora, int8, ckpt, pytree = port["out"]
    return want, {"lora": lora, "int8": int8, "ckpt": ckpt,
                  "pytree": (pytree_case, pytree)}


def test_lora_over_sharded_base_matches_jax(runs):
    want, got = runs[0]["lora"], runs[1]["lora"]
    for i, (w, g) in enumerate(zip(want["metrics"], got["metrics"])):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    assert set(got["adapters"]) == set(want["adapters"])
    for name, pair in want["adapters"].items():
        for k in "AB":
            np.testing.assert_allclose(got["adapters"][name][k], pair[k],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}/{k}")
    assert np.abs(got["adapters"]["layer_0.mlp.down_proj.weight"]["B"]
                  ).max() > 0
    assert got["base_moved"] == []


def test_int8_forward_over_tp_matches_jax(runs):
    want, got = runs[0]["int8"], runs[1]["int8"]
    assert "Shard(dim=0)" in got["q_placements"]
    np.testing.assert_allclose(got["logits"], want, atol=1e-4)


def test_sharded_checkpoint_restores_bit_for_bit(runs):
    got = runs[1]["ckpt"]
    assert got["committed_on_return"]
    assert got["n_tensors"] == 2 * 9 + 3    # 9 a block, embed, norm, head
    assert got["resharded_equal"] == {
        "[('dp', 4)]": True, "[('fsdp', 2), ('tp', 2)]": True}
    assert got["single_equal"]
    # restored onto dp 4: replicated over dp, FSDP2's shard of each
    # parameter over a data mesh of one; onto fsdp 2 x tp 2: fsdp's
    # strided shard of the rows tp already split
    assert any("Replicate" in p for p in got["placements"]["[('dp', 4)]"])
    assert any("StridedShard" in p
               for p in got["placements"]["[('fsdp', 2), ('tp', 2)]"])
    # each rank moved its shards and nothing more, and keeps each in a
    # storage of its own (no view of the whole tensor); fsdp 2 x tp 2
    # holds a quarter of the sharded tensors
    for name, m in got["moved"].items():
        assert m["moved"] == m["held"], name
        assert m["largest_moved"] == m["largest_held"], name
    assert got["own_storage"] == {
        "[('dp', 4)]": True, "[('fsdp', 2), ('tp', 2)]": True}
    assert got["moved"]["[('fsdp', 2), ('tp', 2)]"]["held"] < \
        got["moved"]["[('dp', 4)]"]["held"]
    assert got["mismatch_raises"]


def test_shard_pytree_follows_the_table(runs):
    case, got = runs[1]["pytree"]
    mesh = MeshSpec(**case["spec"])
    assert got["whole_equal"]
    assert got["replicated"] == ["Replicate()"] * len(AXIS_ORDER)
    sharded = 0
    for name, v in case["params"].items():
        spec = partition_spec_for(name, v.shape, mesh)
        want = [f"Shard(dim={dim_of(spec, a)})"
                if dim_of(spec, a) is not None else "Replicate()"
                for a in AXIS_ORDER]
        assert got["placements"][name] == want, name
        sharded += want != ["Replicate()"] * len(AXIS_ORDER)
    assert sharded >= 2 * 7 + 2     # 7 projections a block, embed, head
