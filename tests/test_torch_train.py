"""The port's training path on the CPU against the JAX package: the
loss, the train step from the same parameters, gradient accumulation,
the optimizers against optax, the schedule, and activation
checkpointing.

Tolerances (fp32): under SGD the loss and grad_norm match to rtol 1e-5
and the parameters to atol 1e-6: oneDNN and XLA sum in different
orders, which moves values of order 1 by a few ulps per step. AdamW
divides each element's gradient by its own running rms, so an element
whose gradient is at rounding level (|g| ~ 1e-9, where the two
frameworks' sums may differ in sign) can move by up to lr in one
framework and not the other. Its parameters after 3 steps differed by
2.9e-4 at lr 1e-2 (0.03 lr) and are compared with atol lr / 10; the
later steps start from those parameters, so their loss and grad_norm
(9e-6 apart in relative terms) are compared to rtol 1e-4. The
optimizers alone, fed the same gradients, match optax to rtol 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_optimizer as j_make_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu.train import next_token_loss as j_next_token_loss
from ray_tpu.train import warmup_cosine as j_warmup_cosine
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu_torch.parallel import BF16, FP32
from ray_tpu_torch.train import (make_optimizer, make_train_step,
                                 next_token_loss, warmup_cosine)

WIDTHS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=64)


def _models(seed=0, batch=None):
    """The JAX Llama with params from `seed`, and the port's Llama
    holding the same params."""
    jm = JLlama(JConfig(**WIDTHS, dtype=jnp.float32))
    tokens = jnp.zeros((1, 8), jnp.int32) if batch is None else batch
    params = jm.init(jax.random.PRNGKey(seed), tokens[:1, :8])["params"]
    tm = _torch_model(params)
    return jm, params, tm


def _torch_model(params):
    tm = Llama(LlamaConfig(**WIDTHS, dtype=torch.float32,
                           param_dtype=torch.float32), device="cpu")
    tm.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, params)))
    return tm


def _batch(seed, rows=4, cols=17, mask=None):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, WIDTHS["vocab_size"], (rows, cols)) \
        .astype(np.int32)
    b = {"tokens": tokens}
    if mask is not None:
        b["loss_mask"] = mask
    return b


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_next_token_loss_matches_jax(masked):
    jm, params, tm = _models()
    mask = None
    if masked:
        mask = (np.random.RandomState(3).rand(4, 16) > 0.4) \
            .astype(np.float32)
    batch = _batch(1, mask=mask)
    _, want = j_next_token_loss(jm.apply, params, _j(batch))
    with torch.no_grad():
        _, got = next_token_loss(tm, _t(batch))
    for key in ("loss", "ntokens", "ppl"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5)
    assert float(got["ntokens"]) == (4 * 16 if mask is None else mask.sum())


@pytest.mark.parametrize("opt,lr", [("sgd", 0.1), ("adamw", 1e-2)])
def test_train_steps_match_jax(opt, lr):
    """3 steps of the port's make_train_step against the JAX step on a
    one-device CPU mesh, from the same params and batches: per-step loss
    and grad_norm, and the params after the last step."""
    batches = [_batch(10 + i) for i in range(3)]
    jm = JLlama(JConfig(**WIDTHS, dtype=jnp.float32))
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    j_init = j_make_train_step(jm, j_make_optimizer(opt, learning_rate=lr),
                               mesh, donate_state=False)
    j_state, j_step = j_init(jax.random.PRNGKey(0), _j(batches[0]))
    tm = _torch_model(j_state.params)
    t_init = make_train_step(tm, make_optimizer(opt, learning_rate=lr))
    t_state, t_step = t_init(_t(batches[0]))
    for batch in batches:
        j_state, jmet = j_step(j_state, _j(batch))
        t_state, tmet = t_step(t_state, _t(batch))
        for key in ("loss", "grad_norm", "ntokens", "ppl"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-5 if opt == "sgd" else 1e-4,
                                       err_msg=key)
    assert t_state.step == 3 == int(j_state.step)
    want = llama_params_from_flax(jax.tree.map(np.asarray, j_state.params))
    atol = 1e-6 if opt == "sgd" else lr / 10
    for name, p in t_state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def test_grad_accumulation_matches_full_batch_nonuniform_mask():
    """With a non-uniform loss_mask, micro-batch gradients weighted by
    token count give the full-batch step (mirrors the JAX test of the
    same name in tests/test_train.py)."""
    mask = np.zeros((4, 16), np.float32)
    mask[0, :15] = 1.0   # micro-batch 1 (rows 0-1): 18 tokens
    mask[1, :3] = 1.0
    mask[2, :2] = 1.0    # micro-batch 2 (rows 2-3): 3 tokens
    mask[3, :1] = 1.0
    batch = _t(_batch(1, mask=mask))
    _, params, _ = _models()
    outs = {}
    for accum in (1, 2):
        tm = _torch_model(params)
        init = make_train_step(tm, make_optimizer("adamw",
                                                  learning_rate=1e-2),
                               accum_steps=accum)
        state, step = init(batch)
        state, m = step(state, batch)
        outs[accum] = (float(m["loss"]), float(m["ntokens"]),
                       float(m["grad_norm"]),
                       state.params["layer_0.attention.q_proj.weight"]
                       .detach().clone())
    (l1, n1, g1, p1), (l2, n2, g2, p2) = outs[1], outs[2]
    assert n1 == n2 == mask.sum()
    assert abs(l1 - l2) < 1e-5 and abs(g1 - g2) < 1e-5 * g1
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=2e-4,
                               atol=2e-5)


def _opt_params(rng):
    """A small parameter dict under the port's names: one matrix with
    both dims >= 128 (adafactor factors it), small matrices, a norm and
    an embedding (no decay under the adamw mask)."""
    shapes = {"layer_0.mlp.up_proj.weight": (128, 160),
              "layer_0.attention.q_proj.weight": (16, 8),
              "layer_0.attn_norm": (16,),
              "token_embed.weight": (32, 16),
              "lm_head.weight": (130, 4)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "lion",
                                  "adafactor"])
def test_optimizer_matches_optax(name, clip):
    """Each optimizer of make_optimizer, with the warmup_cosine schedule,
    against its optax chain for 5 steps on the same gradients."""
    rng = np.random.RandomState(4)
    params = _opt_params(rng)
    # global norms ~450 and ~0.15: a clip at 1.0 acts on some steps only
    grads = [{k: (scale * rng.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()}
             for scale in (3.0, 1e-3, 3.0, 1e-3, 3.0)]
    kw = dict(grad_clip=clip, weight_decay=0.1)
    tx = j_make_optimizer(name, schedule=j_warmup_cosine(0.05, 2, 5), **kw)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = make_optimizer(name, schedule=warmup_cosine(0.05, 2, 5),
                         **kw)(list(t_params.items()))
    for g in grads:
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in
                                      g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(j_params[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # the step count is saved with the state and restored
    count = opt.state_dict()["count"]
    assert count == 5
    opt.count = 0
    opt.load_state_dict(opt.state_dict() | {"count": count})
    assert opt.count == 5


def test_warmup_cosine_matches_optax():
    for peak, warm, total, frac in ((3e-4, 10, 100, 0.1), (1.0, 0, 1, 0.5),
                                    (0.05, 2, 5, 0.1)):
        want = j_warmup_cosine(peak, warm, total, frac)
        got = warmup_cosine(peak, warm, total, frac)
        for count in range(total + 5):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6, atol=1e-12)
    assert warmup_cosine(1.0, 4, 10)(0) == 0.0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adagrad")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """remat (torch.utils.checkpoint per block; "dots" saves the
    projections' products) gives the gradients of the plain forward."""
    _, params, _ = _models()
    tokens = torch.from_numpy(_batch(5)["tokens"])
    grads = {}
    for remat in (False, True):
        tm = Llama(LlamaConfig(**WIDTHS, dtype=torch.float32,
                               param_dtype=torch.float32, remat=remat,
                               remat_policy=policy), device="cpu")
        tm.load_state_dict(llama_params_from_flax(
            jax.tree.map(np.asarray, params)))
        loss, _ = next_token_loss(tm, {"tokens": tokens})
        loss.backward()
        grads[remat] = {n: p.grad for n, p in tm.named_parameters()}
    for name, g in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), g.numpy(),
                                   atol=1e-7, rtol=0, err_msg=name)


def test_precision_policy_casts_floating_leaves():
    tree = {"w": torch.ones(2), "ids": torch.arange(3),
            "nested": [torch.zeros(1, dtype=torch.float64)]}
    out = BF16.cast_for_compute(tree)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64
    assert out["nested"][0].dtype == torch.bfloat16
    assert FP32.cast_for_compute(tree)["w"].dtype == torch.float32
    assert (BF16.param_dtype, BF16.output_dtype) == (torch.float32,
                                                     torch.float32)
