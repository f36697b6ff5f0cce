"""K4's module on the CPU: the port's `fused_rms_norm` (which takes its
plain version for a CPU tensor) against the JAX package's Pallas
`fused_rms_norm`, run in interpret mode as tests/test_flash_attention.py
runs it, on the same numpy inputs; the backward against `jax.grad`; and
the device routing of the wrapper.

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it
against `rms_norm_plain` there.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops.pallas import fused_rms_norm as j_fused_rms_norm
from ray_tpu_torch.ops.kernels import rmsnorm as t_rmsnorm


def test_forward_matches_pallas_fp32():
    # ragged rows: 132 is not a multiple of the Pallas block of 16 rows
    rng = np.random.RandomState(0)
    x = rng.randn(4, 33, 256).astype(np.float32)
    w = rng.randn(256).astype(np.float32)
    want = j_fused_rms_norm(jnp.asarray(x), jnp.asarray(w), block_rows=16,
                            interpret=True)
    got = t_rmsnorm.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (4, 33, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 64), (3, 7, 1000)])
def test_grads_match_pallas_vjp(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)

    def loss(xx, ww):
        return jnp.sum(j_fused_rms_norm(xx, ww, interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (t_rmsnorm.fused_rms_norm(xt, wt) ** 2).sum().backward()
    for got, ref in ((xt.grad, want[0]), (wt.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


def test_bf16_keeps_bf16():
    x = torch.ones(4, 128, dtype=torch.bfloat16) * 3
    w = torch.ones(128, dtype=torch.bfloat16)
    out = t_rmsnorm.fused_rms_norm(x, w)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), 1.0, atol=2e-2)
    want = j_fused_rms_norm(jnp.ones((4, 128), jnp.bfloat16) * 3,
                            jnp.ones((128,), jnp.bfloat16), interpret=True)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def test_weight_grad_keeps_the_weight_type():
    x = torch.randn(6, 32, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(32, dtype=torch.float32, requires_grad=True)
    t_rmsnorm.fused_rms_norm(x, w).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    before = t_rmsnorm.rmsnorm_fwd.launches
    x = torch.randn(5, 48)
    w = torch.randn(48)
    torch.testing.assert_close(t_rmsnorm.fused_rms_norm(x, w),
                               t_rmsnorm.rms_norm_plain(x, w), rtol=0,
                               atol=0)
    assert t_rmsnorm.rmsnorm_fwd.launches == before


def test_cuda_tensor_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        x = torch.randn(4, 16, device="cuda")
        t_rmsnorm.fused_rms_norm(x, torch.ones(16, device="cuda"))


def test_bad_inputs_raise_before_any_build():
    # the checks run before the kernel library is loaded
    x = torch.randn(4, 16)
    with pytest.raises(ValueError, match="weight"):
        t_rmsnorm._check_inputs(x, torch.ones(8))
    with pytest.raises(TypeError, match="float32"):
        t_rmsnorm._check_inputs(x.double(), torch.ones(16))
    with pytest.raises(ValueError, match="contiguous"):
        t_rmsnorm._check_inputs(torch.randn(16, 4).t(), torch.ones(16))
