"""The port's kernel modules on the CPU: each kernel's plain PyTorch
version against the Pallas TPU kernel it replaces, run in interpret mode
as tests/test_paged_attention_kernel.py and tests/test_flash_attention.py
run it (the backward through jax.vjp of the Pallas custom_vjp); the
device routing of the wrappers; and the import hygiene of the whole
package.

The CUDA kernels themselves run only on a GPU; chip_smoke.py holds them
against these plain versions there.

Tolerance: fp32, atol 2e-5 — the Pallas kernels accumulate the softmax
online block by block while the plain versions normalise once, so sums
differ in order by a few ulps of values of order 1.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops.pallas.paged_attention import paged_decode_attention \
    as j_paged_decode
from ray_tpu_torch.ops.kernels import build
from ray_tpu_torch.ops.kernels import flash_attention as t_flash
from ray_tpu_torch.ops.kernels import paged_attention as t_paged

# the package re-exports a function of the module's name; take the module
j_flash = importlib.import_module("ray_tpu.ops.pallas.flash_attention")

ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal,hq,hkv,s", [
    (True, 4, 4, 32),
    (False, 4, 4, 32),
    (True, 8, 2, 40),       # GQA; S not a multiple of the 16-row block
    (False, 6, 3, 23),      # GQA; ragged
])
def test_flash_plain_matches_pallas(causal, hq, hkv, s):
    rng = np.random.RandomState(0)
    b, d = 2, 16
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    want = j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=16, block_k=16, interpret=True)
    # the Pallas kernel's lse comes from its forward, on GQA-expanded,
    # head-flattened (B*H, S, D) operands
    rep = hq // hkv

    def flat(x):
        x = jnp.repeat(jnp.asarray(x), hq // x.shape[2], axis=2)
        return x.transpose(0, 2, 1, 3).reshape(b * hq, s, d)
    _, want_lse = j_flash._flash_fwd(flat(q), flat(k), flat(v), d ** -0.5,
                                     causal, 16, 16, True)
    out, lse = t_flash.flash_attention_plain(_t(q), _t(k), _t(v),
                                             causal=causal)
    assert rep >= 1 and out.shape == (b, s, hq, d)
    assert lse.shape == (b * hq, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal,hq,hkv,s", [
    (True, 4, 4, 32),
    (False, 4, 4, 32),
    (True, 8, 2, 40),       # GQA; S not a multiple of the 16-row block
    (False, 8, 2, 23),      # GQA; ragged
])
def test_flash_bwd_plain_matches_pallas(causal, hq, hkv, s):
    """flash_attention_bwd_plain (K2a/K2b's plain version) against the
    Pallas backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) on the
    same fp32 inputs; dK/dV per kv head, as the reference's repeat of K/V
    sums them back under autodiff."""
    rng = np.random.RandomState(1)
    b, d = 2, 16
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    do = rng.randn(b, s, hq, d).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: j_flash.flash_attention(
        q, k, v, causal=causal, block_q=16, block_k=16, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = t_flash.flash_attention_plain(tq, tk, tv, causal=causal)
    got = t_flash.flash_attention_bwd_plain(tq, tk, tv, out, lse, _t(do),
                                            causal=causal)
    for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_grads_match_plain_autograd(causal):
    """On CPU tensors the autograd Function (forward: K1's plain
    version, backward: flash_attention_bwd -> K2a/K2b's plain version)
    gives autograd's gradients of flash_attention_plain."""
    gen = torch.Generator().manual_seed(2)
    b, s, hq, hkv, d = 2, 19, 6, 2, 16
    q = torch.randn(b, s, hq, d, generator=gen, requires_grad=True)
    k = torch.randn(b, s, hkv, d, generator=gen, requires_grad=True)
    v = torch.randn(b, s, hkv, d, generator=gen, requires_grad=True)
    g = torch.randn(b, s, hq, d, generator=gen)
    n = (t_flash.flash_bwd_dq.launches, t_flash.flash_bwd_dkv.launches)
    got = torch.autograd.grad(
        (t_flash.flash_attention(q, k, v, causal=causal) * g).sum(),
        (q, k, v))
    ref, _ = t_flash.flash_attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad((ref * g).sum(), (q, k, v))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=ATOL, rtol=0)
    assert (t_flash.flash_bwd_dq.launches,
            t_flash.flash_bwd_dkv.launches) == n


@pytest.mark.parametrize("case", ["lse_shape", "delta_dtype", "do_dtype",
                                  "contiguous", "cpu"])
def test_flash_bwd_input_checks(case):
    """What K2a/K2b refuse before a pointer reaches them; valid inputs on
    the CPU are refused last, for not being on a CUDA device."""
    q, k = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    v, do = k.clone(), q.clone()
    lse, delta = torch.zeros(4, 8), torch.zeros(4, 8)
    match = "flash_attention_bwd: " + case.split("_")[0]
    if case == "lse_shape":
        lse = torch.zeros(4, 1, 8)
    elif case == "delta_dtype":
        delta = delta.double()
    elif case == "do_dtype":
        do = do.bfloat16()
    elif case == "contiguous":
        do = torch.randn(1, 4, 8, 16).transpose(1, 2)
        match = "do is not contiguous"
    else:
        match = "CUDA tensors"
    with pytest.raises(ValueError, match=match):
        t_flash._check_bwd_inputs(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match=match):
        t_flash.flash_bwd_dq(q, k, v, do, lse, delta)


def test_flash_bwd_wrapper_routes_by_device():
    """flash_attention_bwd takes the plain version for CPU tensors, with
    no launch counted, and refuses any device other than CPU and CUDA."""
    q, k = torch.randn(1, 9, 4, 16), torch.randn(1, 9, 2, 16)
    out, lse = t_flash.flash_attention_plain(q, k, k)
    do = torch.randn_like(q)
    n = (t_flash.flash_bwd_dq.launches, t_flash.flash_bwd_dkv.launches)
    got = t_flash.flash_attention_bwd(q, k, k, out, lse, do)
    want = t_flash.flash_attention_bwd_plain(q, k, k, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (t_flash.flash_bwd_dq.launches,
            t_flash.flash_bwd_dkv.launches) == n
    m = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_flash.flash_attention_bwd(m, m, m, m, m, m)


def _build_pool(rng, S, P, ps, hkv, d, lengths):
    n_pages = S * P
    k_flat = np.zeros(((n_pages + 1) * ps, hkv, d), np.float32)
    v_flat = np.zeros(((n_pages + 1) * ps, hkv, d), np.float32)
    table = rng.permutation(n_pages).reshape(S, P).astype(np.int32)
    for s in range(S):
        for pos in range(lengths[s]):
            fr = table[s, pos // ps] * ps + pos % ps
            k_flat[fr] = rng.randn(hkv, d)
            v_flat[fr] = rng.randn(hkv, d)
    return k_flat, v_flat, table


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_decode_plain_matches_pallas(hq, hkv):
    S, P, ps, d = 3, 4, 8, 16
    rng = np.random.RandomState(0)
    lengths = np.asarray([5, 1, 29], np.int32)
    k_flat, v_flat, table = _build_pool(rng, S, P, ps, hkv, d, lengths)
    q = rng.randn(S, hq, d).astype(np.float32)
    want = jax.jit(lambda *a: j_paged_decode(
        *a, page_size=ps, interpret=True))(
        jnp.asarray(q), jnp.asarray(k_flat), jnp.asarray(v_flat),
        jnp.asarray(table), jnp.asarray(lengths))
    got = t_paged.paged_decode_attention_plain(
        _t(q), _t(k_flat), _t(v_flat), _t(table), _t(lengths), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_paged_decode_plain_replay_at_earlier_position():
    """A query at position < lengths-1 (speculative verification) sees
    keys up to its own position only, as the Pallas kernel does."""
    S, P, ps, hq, hkv, d = 2, 3, 8, 4, 2, 16
    rng = np.random.RandomState(1)
    lengths = np.asarray([20, 11], np.int32)
    k_flat, v_flat, table = _build_pool(rng, S, P, ps, hkv, d, lengths)
    q = rng.randn(S, hq, d).astype(np.float32)
    qpos = np.asarray([7, 3], np.int32)
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(k_flat),
                          jnp.asarray(v_flat), jnp.asarray(table),
                          jnp.asarray(lengths), page_size=ps,
                          qpos=jnp.asarray(qpos), interpret=True)
    got = t_paged.paged_decode_attention_plain(
        _t(q), _t(k_flat), _t(v_flat), _t(table), _t(lengths), ps,
        qpos=_t(qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_paged_decode_plain_empty_row_is_zero():
    k_flat = torch.randn(16, 2, 16)
    out = t_paged.paged_decode_attention_plain(
        torch.randn(1, 4, 16), k_flat, k_flat.clone(),
        torch.zeros(1, 2, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), 8)
    assert torch.all(out == 0)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """On a CPU tensor the wrappers return the plain version's result and
    launch nothing (their launch counters stay put)."""
    q, k = torch.randn(1, 9, 4, 16), torch.randn(1, 9, 2, 16)
    n1 = t_flash.flash_attention_fwd.launches
    out, lse = t_flash.flash_attention_fwd(q, k, k, causal=True)
    ref, ref_lse = t_flash.flash_attention_plain(q, k, k, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert torch.equal(t_flash.flash_attention(q, k, k), ref)
    assert t_flash.flash_attention_fwd.launches == n1

    n3 = t_paged.paged_decode_attention.launches
    pool = torch.randn(32, 2, 16)
    table = torch.tensor([[1, 0], [3, 2]], dtype=torch.int32)
    lens = torch.tensor([5, 12], dtype=torch.int32)
    qd = torch.randn(2, 4, 16)
    got = t_paged.paged_decode_attention(qd, pool, pool, table, lens, 8)
    assert torch.equal(got, t_paged.paged_decode_attention_plain(
        qd, pool, pool, table, lens, 8))
    assert t_paged.paged_decode_attention.launches == n3


def test_wrappers_reject_other_devices():
    q = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_flash.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        t_paged.paged_decode_attention(
            q[:, 0], q[0], q[0], torch.empty(1, 1, dtype=torch.int32,
                                             device="meta"),
            torch.empty(1, dtype=torch.int32, device="meta"), 4)


@pytest.mark.parametrize("case", ["dtype", "head_dim", "gqa", "contiguous"])
def test_flash_input_checks(case):
    q, k = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    v = k.clone()
    if case == "dtype":
        q = q.half()
        err = TypeError
    elif case == "head_dim":
        q, k, v = q[..., :8], k[..., :8].contiguous(), v[..., :8].contiguous()
        q = q.contiguous()
        err = ValueError
    elif case == "gqa":
        q = torch.randn(1, 8, 3, 16)
        err = ValueError
    else:
        k = torch.randn(1, 2, 8, 16).transpose(1, 2)
        err = ValueError
    with pytest.raises(err):
        t_flash._check_inputs(q, k, v)


@pytest.mark.parametrize("case", ["rep", "page_size", "index_dtype",
                                  "shape"])
def test_paged_input_checks(case):
    q = torch.randn(2, 4, 16)
    pool = torch.randn(32, 2, 16)
    table = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    qpos = torch.zeros(2, dtype=torch.int32)
    ps = 8
    err = ValueError
    if case == "rep":
        q = torch.randn(2, 2 * (t_paged.MAX_REP + 1), 16)
    elif case == "page_size":
        ps = 5
    elif case == "index_dtype":
        lens = lens.long()
        err = TypeError
    else:
        table = torch.zeros(3, 4, dtype=torch.int32)
    with pytest.raises(err):
        t_paged._check_inputs(q, pool, pool, table, lens, qpos, ps)


def test_build_lists_sources_and_defers_compiling():
    assert build.sources() == ["flash_bwd", "flash_fwd", "paged_decode"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.sources():
        assert os.path.isfile(os.path.join(build.CSRC_DIR, name + ".cu"))


def _run_python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_kernel_modules_import_without_nvcc_or_triton():
    """With no nvcc on PATH and no triton, the kernel modules import and
    their CPU paths run; nothing is compiled at import."""
    env = {"PATH": os.path.dirname(sys.executable),
           "PYTHONPATH": REPO, "HOME": os.environ.get("HOME", "/tmp")}
    code = (
        "import sys, shutil, torch\n"
        "assert shutil.which('nvcc') is None\n"
        "import ray_tpu_torch.ops.kernels.build as b\n"
        "import ray_tpu_torch.ops.kernels.flash_attention as f\n"
        "import ray_tpu_torch.ops.kernels.paged_attention as p\n"
        "assert 'triton' not in sys.modules\n"
        "assert not b._libs\n"
        "q = torch.randn(1, 5, 2, 16)\n"
        "f.flash_attention(q, q, q)\n"
        "print('ok')\n")
    res = _run_python(code, env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_FOREIGN = ("jax", "ray_tpu", "optax", "flax", "orbax")


def _leaks(module_list):
    return sorted(m for m in module_list
                  if m in _FOREIGN or m.startswith(tuple(
                      f + "." for f in _FOREIGN)))


def test_port_imports_no_jax_and_no_ray_tpu():
    """Importing every module of ray_tpu_torch, and chip_smoke.py, leaves
    jax, ray_tpu / ray_tpu.*, optax, flax and orbax out of sys.modules
    (ray_tpu_torch itself shares the prefix, hence the exact match)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
        "print(' '.join(sorted(sys.modules)))\n")
    res = _run_python(code)
    assert res.returncode == 0, res.stderr
    n_modules, mods = res.stdout.strip().splitlines()
    assert int(n_modules) >= 15
    assert _leaks(mods.split()) == []
    for name in ("ray_tpu_torch.serve.llm.engine", "ray_tpu_torch.train.spmd",
                 "ray_tpu_torch.train.optim", "ray_tpu_torch.train.checkpoint",
                 "ray_tpu_torch.parallel.precision"):
        assert name in mods.split()


def test_chip_smoke_refuses_without_a_gpu():
    """chip_smoke.py exits non-zero and prints no result where
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
