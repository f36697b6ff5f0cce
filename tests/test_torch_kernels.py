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
import shutil
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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_d64_ragged(causal):
    """The head dim of the wgmma forward (D 64) at a length that ends
    inside a tile (S 130), GQA: flash_attention_plain's out and lse
    against the Pallas forward."""
    rng = np.random.RandomState(3)
    b, s, hq, hkv, d = 1, 130, 8, 4, 64
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    want = j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=16, block_k=16, interpret=True)

    def flat(x):
        x = jnp.repeat(jnp.asarray(x), hq // x.shape[2], axis=2)
        return x.transpose(0, 2, 1, 3).reshape(b * hq, s, d)
    _, want_lse = j_flash._flash_fwd(flat(q), flat(k), flat(v), d ** -0.5,
                                     causal, 16, 16, True)
    out, lse = t_flash.flash_attention_plain(_t(q), _t(k), _t(v),
                                             causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL,
                               rtol=0)


def test_flash_plain_matches_pallas_vit_shape():
    """ViT-base's attention (the zoo's non-causal K1 route): 197 tokens
    (196 patches and the class token), Hq = Hkv = 12, D 64, against the
    Pallas forward."""
    rng = np.random.RandomState(4)
    b, s, h, d = 1, 197, 12, 64
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    want = j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   block_q=16, block_k=16, interpret=True)
    out, _ = t_flash.flash_attention_plain(_t(q), _t(k), _t(v),
                                           causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _bwd_case(causal, hq, hkv, s, d=16, b=2):
    return pytest.param(causal, hq, hkv, s, d, b,
                        id="-".join(map(str, (causal, hq, hkv, s)))
                        + ("" if d == 16 else f"-d{d}-b{b}"))


@pytest.mark.parametrize("causal,hq,hkv,s,d,b", [
    _bwd_case(True, 4, 4, 32),
    _bwd_case(False, 4, 4, 32),
    _bwd_case(True, 8, 2, 40),      # GQA; S not a multiple of the 16-row block
    _bwd_case(False, 8, 2, 23),     # GQA; ragged
    # the head dim of the wgmma kernels: the north-star shape (S 32, less
    # than one 64-row tile), a ragged S past two tiles, and Hq = Hkv
    _bwd_case(True, 8, 4, 32, d=64, b=2),
    _bwd_case(True, 8, 4, 130, d=64, b=1),
    _bwd_case(False, 8, 4, 130, d=64, b=1),
    _bwd_case(True, 4, 4, 130, d=64, b=1),
])
def test_flash_bwd_plain_matches_pallas(causal, hq, hkv, s, d, b):
    """flash_attention_bwd_plain (K2a/K2b's plain version) against the
    Pallas backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) on the
    same fp32 inputs; dK/dV per kv head, as the reference's repeat of K/V
    sums them back under autodiff."""
    rng = np.random.RandomState(1)
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


@pytest.mark.parametrize("hq,hkv", [(4, 4), (16, 2)])
def test_paged_decode_plain_edges_match_pallas(hq, hkv):
    """Lengths on page boundaries (one page, two pages, the table's
    whole width) and a 0-length row beside full ones, at rep 1 and rep 8:
    the plain version (K3's yardstick on the card) against the Pallas
    kernel."""
    S, P, ps, d = 4, 4, 8, 16
    rng = np.random.RandomState(2)
    lengths = np.asarray([8, 0, P * ps, 16], np.int32)
    k_flat, v_flat, table = _build_pool(rng, S, P, ps, hkv, d, lengths)
    q = rng.randn(S, hq, d).astype(np.float32)
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(k_flat),
                          jnp.asarray(v_flat), jnp.asarray(table),
                          jnp.asarray(lengths), page_size=ps, interpret=True)
    got = t_paged.paged_decode_attention_plain(
        _t(q), _t(k_flat), _t(v_flat), _t(table), _t(lengths), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("n_pages,page_size", [
    (128, 16), (256, 8), (16, 16), (4, 16), (1, 16), (0, 16), (3, 300),
    (100, 7), (1000, 1)])
def test_paged_split_plan_covers_the_table_in_whole_pages(n_pages,
                                                          page_size):
    split_keys, n_split = t_paged.split_plan(n_pages, page_size)
    width = n_pages * page_size
    assert split_keys % page_size == 0 and split_keys >= page_size
    assert split_keys <= max(t_paged.SPLIT_KEYS, page_size)
    assert n_split >= 1 and n_split * split_keys >= width
    assert (n_split - 1) * split_keys < max(width, 1)


def test_paged_workspace_reads_no_tensor_value():
    """The host side of a K3 call plans its splits and allocates its
    partials from shapes alone: no op that reads a value back to the
    host (`.item()`, `.tolist()`, a copy to the CPU) runs, so a decode
    step pipelined on CUDA events never waits here."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    q = torch.randn(8, 32, 128)
    table = torch.zeros(8, 128, dtype=torch.int32)
    with Record() as rec:
        split_keys, n_split, o_part, ml_part = t_paged._workspace(
            q, table, 16)
    assert (split_keys, n_split) == (256, 8)
    assert o_part.shape == (8, 32, 8, 128) and ml_part.shape == (2, 8, 32, 8)
    assert o_part.dtype == ml_part.dtype == torch.float32
    assert rec.ops and all(op.startswith("aten.empty") for op in rec.ops)
    # one split: the kernel writes O itself, no partials
    assert t_paged._workspace(q, table[:, :16], 16)[1:] == (1, None, None)


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
    assert build.sources() == ["flash_bwd", "flash_fwd", "paged_decode",
                               "rmsnorm"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.sources():
        assert os.path.isfile(os.path.join(build.CSRC_DIR, name + ".cu"))


def test_build_log_belongs_to_its_library():
    """Each library's ptxas log is named by the same source hash, so a
    reused library is never paired with another build's log."""
    logs = [build.log_path(n) for n in build.sources()]
    assert len(set(logs)) == len(logs)
    for name, log in zip(build.sources(), logs):
        lib = build._target(name)
        assert log == lib[:-len(".so")] + ".log"
        assert os.path.dirname(log) == build.BUILD_DIR


def _run_python(code, env=None):
    # -X faulthandler: a process that dies of a signal leaves its stack
    # in stderr, which each guard prints when the return code is not 0
    return subprocess.run([sys.executable, "-X", "faulthandler", "-c", code],
                          cwd=REPO, env=env,
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
        "import ray_tpu_torch.ops.kernels.rmsnorm as r\n"
        "assert 'triton' not in sys.modules\n"
        "assert not b._libs\n"
        "q = torch.randn(1, 5, 2, 16)\n"
        "f.flash_attention(q, q, q)\n"
        "r.fused_rms_norm(q, torch.ones(16))\n"
        "assert not b._libs\n"
        "print('ok')\n")
    res = _run_python(code, env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_FOREIGN = ("jax", "ray_tpu", "optax", "flax", "orbax", "transformers")


def _leaks(module_list):
    return sorted(m for m in module_list
                  if m in _FOREIGN or m.startswith(tuple(
                      f + "." for f in _FOREIGN)))


def test_port_imports_no_jax_and_no_ray_tpu():
    """Importing every module of ray_tpu_torch, and chip_smoke.py, leaves
    jax, ray_tpu / ray_tpu.*, optax, flax, orbax and transformers out of
    sys.modules (ray_tpu_torch itself shares the prefix, hence the exact
    match); so does running, in a gloo world of 2 spawned ranks, an sp
    train step and PPO over a mesh learner group."""
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
    for name in ("ray_tpu_torch.serve.llm.engine",
                 "ray_tpu_torch.serve.llm.guided",
                 "ray_tpu_torch.serve.llm.openai_api",
                 "ray_tpu_torch.serve.context", "ray_tpu_torch.exceptions",
                 "ray_tpu_torch.util.knobs",
                 "ray_tpu_torch.ops.kernels.rmsnorm", "ray_tpu_torch.train.spmd",
                 "ray_tpu_torch.train.optim", "ray_tpu_torch.train.checkpoint",
                 "ray_tpu_torch.parallel.precision",
                 "ray_tpu_torch.models.mixtral", "ray_tpu_torch.models.gpt2",
                 "ray_tpu_torch.models.vit", "ray_tpu_torch.models.clip",
                 "ray_tpu_torch.models.mlp", "ray_tpu_torch.ops.moe",
                 "ray_tpu_torch.ops.quant", "ray_tpu_torch.ops.linear",
                 "ray_tpu_torch.train.adapters", "ray_tpu_torch.entry",
                 "ray_tpu_torch.parallel.mesh",
                 "ray_tpu_torch.parallel.sharding",
                 "ray_tpu_torch.parallel.collectives",
                 "ray_tpu_torch.parallel.pipeline",
                 "ray_tpu_torch.parallel.pipeline_train",
                 "ray_tpu_torch.parallel._testing",
                 "ray_tpu_torch.ops.ring_attention",
                 "ray_tpu_torch.train.backend",
                 "ray_tpu_torch.train.spmd_trainer",
                 "ray_tpu_torch.train.config", "ray_tpu_torch.train.result",
                 "ray_tpu_torch.train.elastic", "ray_tpu_torch.train.utils",
                 "ray_tpu_torch.data.device_loader",
                 "ray_tpu_torch.observability.profiler",
                 # the runtime (its copy of ray_tpu/core, api, dag, the
                 # util and observability modules it needs) and the
                 # trainers over rank actors
                 "ray_tpu_torch.api", "ray_tpu_torch.dag",
                 "ray_tpu_torch._native.build",
                 "ray_tpu_torch._native.store_binding",
                 *(f"ray_tpu_torch.core.{m}" for m in (
                     "actor", "autoscaler", "dag_channel", "dag_runtime",
                     "device_store", "gcs", "ids", "jobs", "logging",
                     "node", "object_ref", "object_store",
                     "object_transfer", "persistence", "protocol",
                     "resources", "runtime", "runtime_env", "scheduling",
                     "serialization", "spilling", "task", "worker")),
                 *(f"ray_tpu_torch.util.{m}" for m in (
                     "netutil", "tracing", "events", "events_catalog",
                     "metrics", "metrics_catalog", "waits",
                     "placement_group", "collective", "state")),
                 "ray_tpu_torch.observability.sampling_profiler",
                 "ray_tpu_torch.observability.waitgraph",
                 "ray_tpu_torch.observability.timeline",
                 "ray_tpu_torch.observability.forensics",
                 "ray_tpu_torch.train.session",
                 "ray_tpu_torch.train.trainer",
                 "ray_tpu_torch.train.multihost",
                 "ray_tpu_torch.train._testing",
                 # the serve control plane
                 *(f"ray_tpu_torch.serve.{m}" for m in (
                     "config", "deployment", "batching", "multiplex",
                     "router", "handle", "replica", "autoscaler",
                     "controller", "api", "asgi", "_proxy_util",
                     "http_proxy", "chaos", "_testing")),
                 # the data layer and Tune
                 *(f"ray_tpu_torch.data.{m}" for m in (
                     "block", "plan", "executor", "exchange", "dataset",
                     "preprocessors", "service")),
                 *(f"ray_tpu_torch.tune.{m}" for m in (
                     "space", "search", "schedulers", "stoppers",
                     "session", "trainable", "loggers", "tuner")),
                 # the front doors: the CLI, the dashboard, jobs, the thin
                 # client, the local cluster, util and experimental
                 "ray_tpu_torch.__main__", "ray_tpu_torch.cli",
                 "ray_tpu_torch.client", "ray_tpu_torch.client.server",
                 "ray_tpu_torch.cluster_utils",
                 "ray_tpu_torch.job_submission",
                 "ray_tpu_torch.observability.dashboard",
                 "ray_tpu_torch.observability.memory_monitor",
                 *(f"ray_tpu_torch.util.{m}" for m in (
                     "actor_pool", "queue", "multiprocessing",
                     "joblib_backend", "check_serialize",
                     "scheduling_strategies")),
                 "ray_tpu_torch.experimental",
                 "ray_tpu_torch.experimental.internal_kv",
                 "ray_tpu_torch.experimental.tqdm_ray",
                 "ray_tpu_torch.rllib._testing",
                 # workflows, C++ tasks and the gRPC ingress
                 "ray_tpu_torch.workflow", "ray_tpu_torch.cross_language",
                 "ray_tpu_torch.serve.grpc_proxy"):
        assert name in mods.split()
    from ray_tpu_torch.parallel import _testing
    from ray_tpu_torch.train.backend import launch
    assert launch(_testing.sp_and_ppo_modules, 2, "cpu",
                  timeout_s=120) == [[], []]


def test_cpp_task_and_grpc_proxy_workers_import_no_jax_and_no_ray_tpu(
        tmp_path):
    """A worker that calls into a C++ library (through the module's own
    `_load(...).invoke`, the body of every cpp_function task) and the
    gRPC proxy's actor (its class, with a report of its process) list
    their modules: no jax, no ray_tpu / ray_tpu.*; the C++ worker, which
    holds no GPU, sees no card."""
    pytest.importorskip("grpc")
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    lib = tmp_path / "libmathlib.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "ray_tpu_torch", "_native"),
         os.path.join(REPO, "examples", "cpp_tasks", "mathlib.cc"),
         "-o", str(lib)], check=True, capture_output=True, timeout=120)
    code = (
        "import os, sys\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import cross_language as xl\n"
        "from ray_tpu_torch.serve import _proxy_util\n"
        "from ray_tpu_torch.serve.grpc_proxy import GrpcProxy\n"
        "lib = sys.argv[1]\n"
        "class ProbedProxy(GrpcProxy):\n"
        "    def modules(self):\n"
        "        import sys\n"
        "        return sorted(sys.modules)\n"
        "@rt.remote\n"
        "def cpp_call(lib):\n"
        "    import os, sys\n"
        "    from ray_tpu_torch import cross_language as xl\n"
        "    out = xl._load(lib).invoke('add', xl._encode_call((2, 3), {}))\n"
        "    return (out, os.environ.get('CUDA_VISIBLE_DEVICES'),\n"
        "            sorted(sys.modules))\n"
        "rt.init(num_cpus=3)\n"
        "assert rt.get(xl.cpp_function(lib, 'add').remote(4, 5)) == 9\n"
        "out, visible, cpp_mods = rt.get(cpp_call.remote(lib), timeout=120)\n"
        "proxy, port = _proxy_util.get_or_create_proxy(\n"
        "    'probe_grpc', ProbedProxy, '127.0.0.1', 0)\n"
        "proxy_mods = rt.get(proxy.modules.remote(), timeout=120)\n"
        "rt.shutdown()\n"
        "print(out, repr(visible), port > 0)\n"
        "print(' '.join(cpp_mods))\n"
        "print(' '.join(proxy_mods))\n")
    res = subprocess.run([sys.executable, "-X", "faulthandler", "-c", code,
                          str(lib)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=dict(os.environ, RAY_TPU_GPUS="1"))
    assert res.returncode == 0, res.stderr
    head, cpp_mods, proxy_mods = res.stdout.strip().splitlines()[-3:]
    assert head == "5 '' True"
    assert "ray_tpu_torch.cross_language" in cpp_mods.split()
    assert _leaks(cpp_mods.split()) == []
    assert {"grpc", "ray_tpu_torch.serve.grpc_proxy"} <= set(
        proxy_mods.split())
    assert _leaks(proxy_mods.split()) == []


def test_spawned_worker_imports_no_jax_and_no_ray_tpu():
    """A worker process the port's runtime spawns runs a task and reports
    its own modules: no jax, no ray_tpu / ray_tpu.*. So does a remote env
    runner actor (the port's _RemoteRunner, here with a report of its
    process), which samples on the CPU and sees no card."""
    code = (
        "import pickle, sys\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import rllib as tr\n"
        "from ray_tpu_torch.rllib._testing import ProbedRunner\n"
        "rt.init(num_cpus=2)\n"
        "@rt.remote\n"
        "def mods():\n"
        "    import sys\n"
        "    return sorted(sys.modules)\n"
        "got = rt.get(mods.remote(), timeout=120)\n"
        "cfg = (tr.PPOConfig().environment(tr.GridWorld)\n"
        "       .env_runners(num_envs_per_env_runner=2,\n"
        "                    rollout_fragment_length=4))\n"
        "cfg.device = 'cpu'\n"
        "params = tr.EnvRunner(tr.GridWorld, device='cpu').module.init(0)\n"
        "runner = rt.remote(ProbedRunner).remote(pickle.dumps(cfg), 1)\n"
        "batch, _ = rt.get(runner.sample.remote(params), timeout=120)\n"
        "info = rt.get(runner.probe.remote(), timeout=60)\n"
        "rt.shutdown()\n"
        "print('ray_tpu_torch.core.serialization' in got)\n"
        "print(' '.join(got))\n"
        "print(len(batch['obs']), repr(info['visible']), info['device'])\n"
        "print(' '.join(info['modules']))\n")
    res = _run_python(code)
    assert res.returncode == 0, res.stderr
    in_worker, mods, head, runner_mods = res.stdout.strip().splitlines()[-4:]
    assert in_worker == "True"
    assert _leaks(mods.split()) == []
    assert head == "8 '' cpu"
    assert "ray_tpu_torch.rllib.env_runner" in runner_mods.split()
    assert _leaks(runner_mods.split()) == []


def test_trial_worker_imports_no_jax_and_no_ray_tpu():
    """A Tune trial actor's worker, reserving a (declared) GPU, reports
    its own modules after reading a Dataset: the Tune and data modules
    are there, and no jax, no ray_tpu / ray_tpu.*."""
    code = (
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import data, tune\n"
        "def trial(config):\n"
        "    import sys\n"
        "    n = data.range(8).random_shuffle(seed=0).count()\n"
        "    tune.report({'n': n, 'mods': ' '.join(sorted(sys.modules))})\n"
        "rt.init(num_cpus=2)\n"
        "grid = tune.Tuner(tune.with_resources(trial, {'CPU': 1, 'GPU': 1}),\n"
        "                  tune_config=tune.TuneConfig(metric='n')).fit()\n"
        "m = grid.trials[0].last_metrics\n"
        "rt.shutdown()\n"
        "print(m['n'])\n"
        "print(m['mods'])\n")
    res = _run_python(code, dict(os.environ, RAY_TPU_GPUS="1"))
    assert res.returncode == 0, res.stderr
    n, mods = res.stdout.strip().splitlines()[-2:]
    assert n == "8"
    mods = mods.split()
    for name in ("ray_tpu_torch.tune.session", "ray_tpu_torch.data.dataset",
                 "ray_tpu_torch.data.exchange"):
        assert name in mods
    assert _leaks(mods) == []


def test_replica_worker_imports_no_jax_and_no_ray_tpu():
    """A serve replica worker hosting `build_llm_deployment`'s server (a
    tiny Llama on the CPU) reports its own modules: the engine and the
    serve plane are there, and no jax, no ray_tpu / ray_tpu.*."""
    code = (
        "import functools\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import serve\n"
        "from ray_tpu_torch.serve import _testing\n"
        "from ray_tpu_torch.serve.llm import LLMServer, "
        "build_llm_deployment\n"
        "class Server(LLMServer):\n"
        "    def modules(self, _body=None):\n"
        "        import sys\n"
        "        return sorted(sys.modules)\n"
        "w = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2,\n"
        "         n_kv_heads=1, d_ff=32, max_seq_len=64)\n"
        "rt.init(num_cpus=3)\n"
        "h = serve.run(build_llm_deployment(\n"
        "    functools.partial(_testing.llama_factory, w),\n"
        "    engine_config={'max_slots': 1, 'max_seq_len': 64,\n"
        "                   'prefill_buckets': (16,)},\n"
        "    server_cls=Server, device='cpu'))\n"
        "got = h.modules.remote().result(timeout_s=120)\n"
        "serve.shutdown()\n"
        "rt.shutdown()\n"
        "print(' '.join(got))\n")
    res = _run_python(code)
    assert res.returncode == 0, res.stderr
    mods = res.stdout.strip().splitlines()[-1].split()
    for name in ("ray_tpu_torch.serve.replica",
                 "ray_tpu_torch.serve.llm.engine", "torch"):
        assert name in mods
    assert _leaks(mods) == []


def _imported(importtime_log):
    """Module names a `python -X importtime` process imported."""
    return sorted({ln.rsplit("|", 1)[-1].strip()
                   for ln in importtime_log.splitlines()
                   if ln.startswith("import time:") and "|" in ln}
                  - {"imported package"})


def test_client_host_and_client_import_no_jax_and_no_ray_tpu():
    """A client host (`python -m ray_tpu_torch.client.server`, run with
    -X importtime) serves a client that runs a task: neither the host's
    imports nor the client's modules hold jax or ray_tpu / ray_tpu.*."""
    code = (
        "import subprocess, sys\n"
        "host = subprocess.Popen([sys.executable, '-X', 'importtime', '-m',\n"
        "    'ray_tpu_torch.client.server', '--listen', '127.0.0.1:0',\n"
        "    '--num-cpus', '1', '--num-gpus', '0'],\n"
        "    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)\n"
        "import ray_tpu_torch as rt\n"
        "rt.init(address=host.stdout.readline().strip())\n"
        "@rt.remote\n"
        "def one():\n"
        "    return 1\n"
        "got = rt.get(one.remote(), timeout=120)\n"
        "rt.shutdown()\n"
        "host.terminate()\n"
        "_, log = host.communicate(timeout=30)\n"
        "print(got)\n"
        "print(' '.join(sorted(sys.modules)))\n"
        "print(log.replace('\\n', '@@'))\n")
    res = _run_python(code)
    assert res.returncode == 0, res.stderr
    got, mods, log = res.stdout.strip().splitlines()[-3:]
    assert got == "1"
    assert "ray_tpu_torch.client" in mods.split()
    assert _leaks(mods.split()) == []
    host_mods = _imported(log.replace("@@", "\n"))
    assert {"ray_tpu_torch.client", "ray_tpu_torch.core.runtime"} <= set(
        host_mods)
    assert _leaks(host_mods) == []


def test_job_driver_imports_no_jax_and_no_ray_tpu(tmp_path):
    """A job submitted through the port's job submission is a driver of
    its own: it inits a runtime, runs a task and reports its modules."""
    job = tmp_path / "job.py"
    job.write_text(
        "import sys\n"
        "import ray_tpu_torch as rt\n"
        "rt.init(num_cpus=1)\n"
        "@rt.remote\n"
        "def one():\n"
        "    return 1\n"
        "assert rt.get(one.remote(), timeout=120) == 1\n"
        "rt.shutdown()\n"
        "print('MODULES ' + ' '.join(sorted(sys.modules)))\n")
    code = (
        "import sys\n"
        "from ray_tpu_torch.job_submission import JobSubmissionClient\n"
        "client = JobSubmissionClient()\n"
        f"sid = client.submit_job(entrypoint=sys.executable + ' {job}')\n"
        "print(client.wait_until_finished(sid, timeout=120))\n"
        "print([ln for ln in client.get_job_logs(sid).splitlines()\n"
        "       if ln.startswith('MODULES ')][-1])\n")
    res = _run_python(code)
    assert res.returncode == 0, res.stderr
    status, mods = res.stdout.strip().splitlines()[-2:]
    assert status == "SUCCEEDED"
    mods = mods.split()[1:]
    assert "ray_tpu_torch.core.runtime" in mods
    assert _leaks(mods) == []


def test_chip_smoke_refuses_without_a_gpu():
    """chip_smoke.py exits non-zero and prints no result where
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
