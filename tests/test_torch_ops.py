"""Port parity: ray_tpu_torch.ops against ray_tpu.ops on the same inputs.

Inputs are made from a numpy seed and handed to both packages. Every
comparison is fp32 with atol 1e-5: the two frameworks sum in different
orders (oneDNN vs XLA), which moves fp32 results by a few ulps of
values of order 1, far inside 1e-5; a wrong mask or head mapping moves
them by order 1.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tpu.ops import activations as j_act
from ray_tpu.ops import attention as j_att
from ray_tpu.ops import norms as j_norms
from ray_tpu.ops import rotary as j_rot
from ray_tpu_torch.ops import activations as t_act
from ray_tpu_torch.ops import attention as t_att
from ray_tpu_torch.ops import norms as t_norms
from ray_tpu_torch.ops import rotary as t_rot

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm(eps):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    _close(t_norms.rms_norm(_t(x), _t(w), eps),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps))


@pytest.mark.parametrize("dtype", [(jnp.bool_, torch.bool),
                                   (jnp.float32, torch.float32)])
def test_causal_attention_mask(dtype):
    want = np.asarray(j_att.causal_attention_mask(7, dtype=dtype[0]))
    got = t_att.causal_attention_mask(7, dtype=dtype[1])
    assert got.dtype == dtype[1]
    np.testing.assert_array_equal(got.numpy(), want)
    from ray_tpu_torch import ops
    assert ops.causal_attention_mask is t_att.causal_attention_mask


def test_rms_norm_keeps_input_dtype():
    x = torch.randn(4, 32).to(torch.bfloat16)
    assert t_norms.rms_norm(x, torch.ones(32)).dtype == torch.bfloat16


def test_swiglu():
    rng = np.random.RandomState(1)
    g, u = (rng.randn(4, 7, 32).astype(np.float32) for _ in range(2))
    _close(t_act.swiglu(_t(g), _t(u)),
           j_act.swiglu(jnp.asarray(g), jnp.asarray(u)))


def test_rope_frequencies():
    tc, ts = t_rot.rope_frequencies(16, 64, 500000.0)
    jc, js = j_rot.rope_frequencies(16, 64, 500000.0)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("ndim", [4, 3])
def test_apply_rotary_contiguous(ndim):
    rng = np.random.RandomState(2)
    shape = (2, 9, 4, 16) if ndim == 4 else (9, 4, 16)
    x = rng.randn(*shape).astype(np.float32)
    tc, ts = t_rot.rope_frequencies(16, 32)
    jc, js = j_rot.rope_frequencies(16, 32)
    _close(t_rot.apply_rotary(_t(x), tc, ts),
           j_rot.apply_rotary(jnp.asarray(x), jc, js))


def test_apply_rotary_positions():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 2, 16).astype(np.float32)
    pos = rng.randint(0, 32, (3, 5)).astype(np.int32)
    tc, ts = t_rot.rope_frequencies(16, 32)
    jc, js = j_rot.rope_frequencies(16, 32)
    _close(t_rot.apply_rotary(_t(x), tc, ts, _t(pos)),
           j_rot.apply_rotary(jnp.asarray(x), jc, js, jnp.asarray(pos)))


def test_apply_rotary_splits_halves():
    """The rotation pairs dim i with dim i + D/2 (no interleave)."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    cos = torch.tensor([[0.0, 1.0]])
    sin = torch.tensor([[1.0, 0.0]])
    out = t_rot.apply_rotary(x, cos, sin)
    assert out[0, 0, 0].tolist() == [0.0, 0.0, 1.0, 0.0]


@pytest.mark.parametrize("causal,hq,hkv,sq,sk", [
    (True, 4, 4, 8, 8),
    (False, 4, 4, 8, 8),
    (True, 8, 2, 8, 8),       # GQA
    (False, 6, 3, 5, 11),     # GQA, cross lengths
    (True, 4, 2, 3, 10),      # causal offset: Sk != Sq
])
def test_multi_head_attention(causal, hq, hkv, sq, sk):
    rng = np.random.RandomState(4)
    q = rng.randn(2, sq, hq, 16).astype(np.float32)
    k = rng.randn(2, sk, hkv, 16).astype(np.float32)
    v = rng.randn(2, sk, hkv, 16).astype(np.float32)
    want = j_att.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      impl="xla")
    _close(t_att.multi_head_attention(_t(q), _t(k), _t(v), causal=causal),
           want)


@pytest.mark.parametrize("causal", [True, False])
def test_multi_head_attention_segment_ids(causal):
    rng = np.random.RandomState(5)
    q = rng.randn(2, 10, 4, 8).astype(np.float32)
    k = rng.randn(2, 10, 2, 8).astype(np.float32)
    v = rng.randn(2, 10, 2, 8).astype(np.float32)
    seg = np.array([[0] * 4 + [1] * 6, [0] * 7 + [1] * 3], np.int32)
    want = j_att.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jnp.asarray(seg), impl="xla", scale=0.3)
    got = t_att.multi_head_attention(_t(q), _t(k), _t(v), causal=causal,
                                     segment_ids=_t(seg), scale=0.3)
    _close(got, want)


def test_cached_attention_contiguous():
    rng = np.random.RandomState(6)
    b, L, hq, hkv, d, s = 2, 12, 4, 2, 8, 3
    ck = rng.randn(b, L, hkv, d).astype(np.float32)
    cv = rng.randn(b, L, hkv, d).astype(np.float32)
    lengths = np.array([4, 7], np.int32)
    pos = (lengths[:, None] + np.arange(s)[None, :]).astype(np.int32)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    want, (wk, wv, wl) = j_att.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lengths)),
        jnp.asarray(pos))
    got, (gk, gv, gl) = t_att.cached_attention(
        _t(q), _t(k), _t(v), (_t(ck), _t(cv), _t(lengths)), _t(pos))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    assert gl.tolist() == np.asarray(wl).tolist()


def _paged_inputs(seed, b=3, P=4, ps=4, hkv=2, d=8):
    rng = np.random.RandomState(seed)
    n_pages = b * P
    k_flat = rng.randn((n_pages + 1) * ps, hkv, d).astype(np.float32)
    v_flat = rng.randn((n_pages + 1) * ps, hkv, d).astype(np.float32)
    table = rng.permutation(n_pages).reshape(b, P).astype(np.int32)
    return rng, k_flat, v_flat, table


def test_paged_flat_rows():
    _, k_flat, v_flat, table = _paged_inputs(7)
    lengths = np.array([3, 0, 9], np.int32)
    pos = np.array([[0, 5, 15], [1, 2, 3], [4, 8, 12]], np.int32)
    jc = j_att.PagedKV(jnp.asarray(k_flat), jnp.asarray(v_flat),
                       jnp.asarray(table), jnp.asarray(lengths), 4)
    tc = t_att.PagedKV(_t(k_flat), _t(v_flat), _t(table), _t(lengths), 4)
    assert tc.flat_rows(_t(pos)).tolist() == \
        np.asarray(jc.flat_rows(jnp.asarray(pos))).tolist()


@pytest.mark.parametrize("route", ["gather", "decode", "fresh"])
def test_paged_cached_attention_routes(route):
    """Each route of the port's paged_cached_attention against the JAX
    op (which takes its gather / XLA routes on the CPU): out, pools and
    lengths."""
    rng, k_flat, v_flat, table = _paged_inputs(8)
    b, hq, hkv, d, ps = 3, 4, 2, 8, 4
    if route == "gather":
        lengths = np.array([2, 5, 0], np.int32)
        s = 3
    elif route == "decode":
        lengths = np.array([2, 9, 15], np.int32)
        s = 1
    else:
        lengths = np.zeros((b,), np.int32)
        s = 6
    pos = (lengths[:, None] + np.arange(s)[None, :]).astype(np.int32)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    fresh = route == "fresh"
    jc = j_att.PagedKV(jnp.asarray(k_flat), jnp.asarray(v_flat),
                       jnp.asarray(table), jnp.asarray(lengths), ps,
                       fresh=fresh)
    want, jn = j_att.paged_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
        jnp.asarray(pos))
    tc = t_att.PagedKV(_t(k_flat), _t(v_flat), _t(table), _t(lengths), ps,
                       fresh=fresh)
    got, tn = t_att.paged_cached_attention(_t(q), _t(k), _t(v), tc, _t(pos))
    _close(got, want)
    _close(tn.k_flat, jn.k_flat)
    _close(tn.v_flat, jn.v_flat)
    assert tn.lengths.tolist() == np.asarray(jn.lengths).tolist()
    assert tn.k_flat is tc.k_flat      # written in place


# (head dim, Hq, Hkv, q dtype, k and v dtype, K1 takes it, K3 takes it):
# the shape-and-type halves of the paged routes. fp16, head dims 96 and
# 256, GQA groups past K3's MAX_REP (17, and MQA at 32 heads) and pools
# of another type take no kernel; Llama-3-8B (D 128, rep 4, bf16), the
# flagship (D 64, rep 2, fp32) and D 16 at rep 16 take both.
_ROUTE_CASES = [
    (128, 32, 8, torch.float16, torch.float16, False, False),
    (96, 32, 8, torch.bfloat16, torch.bfloat16, False, False),
    (256, 8, 4, torch.bfloat16, torch.bfloat16, False, False),
    (64, 17, 1, torch.bfloat16, torch.bfloat16, True, False),
    (128, 32, 1, torch.bfloat16, torch.bfloat16, True, False),
    (128, 32, 8, torch.bfloat16, torch.float32, False, False),
    (64, 8, 4, torch.float32, torch.bfloat16, False, False),
    (128, 32, 8, torch.bfloat16, torch.bfloat16, True, True),
    (64, 8, 4, torch.float32, torch.float32, True, True),
    (16, 16, 1, torch.bfloat16, torch.bfloat16, True, True),
]


@pytest.mark.parametrize("d,hq,hkv,q_dt,kv_dt,flash,decode", _ROUTE_CASES)
def test_paged_route_conditions(d, hq, hkv, q_dt, kv_dt, flash, decode):
    assert t_att.flash_takes(d, q_dt, kv_dt, kv_dt) is flash
    assert t_att.paged_decode_takes(d, hq, hkv, q_dt, kv_dt, kv_dt) is decode


def test_paged_route_conditions_read_the_kernels_limits():
    """The conditions follow the kernel modules' own HEAD_DIMS and
    MAX_REP: every head dim the kernels list is taken, the largest
    group K3 takes is taken and one more is not."""
    from ray_tpu_torch.ops.kernels import flash_attention as k_flash
    from ray_tpu_torch.ops.kernels import paged_attention as k_paged
    bf16 = torch.bfloat16
    for d in k_flash.HEAD_DIMS:
        assert t_att.flash_takes(d, bf16, bf16, bf16)
    for d in k_paged.HEAD_DIMS:
        assert t_att.paged_decode_takes(d, 2, 2, bf16, bf16, bf16)
    rep = k_paged.MAX_REP
    assert t_att.paged_decode_takes(64, rep, 1, bf16, bf16, bf16)
    assert not t_att.paged_decode_takes(64, rep + 1, 1, bf16, bf16, bf16)
    # the pools' types are checked one by one
    assert not t_att.paged_decode_takes(64, 4, 2, bf16, bf16,
                                        torch.float32)


@pytest.mark.parametrize("route", ["decode", "fresh"])
def test_paged_cached_attention_routes_d96_mqa(route):
    """Head dim 96 and 32 query heads on one kv head, shapes no kernel
    takes, against the JAX op: fresh prefill through
    multi_head_attention, one-token decode through the page gather."""
    b, hq, hkv, d, ps = 2, 32, 1, 96, 4
    rng, k_flat, v_flat, table = _paged_inputs(9, b=b, P=3, ps=ps, hkv=hkv,
                                               d=d)
    if route == "decode":
        lengths = np.array([5, 11], np.int32)
        s = 1
    else:
        lengths = np.zeros((b,), np.int32)
        s = 7
    pos = (lengths[:, None] + np.arange(s)[None, :]).astype(np.int32)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    fresh = route == "fresh"
    jc = j_att.PagedKV(jnp.asarray(k_flat), jnp.asarray(v_flat),
                       jnp.asarray(table), jnp.asarray(lengths), ps,
                       fresh=fresh)
    want, jn = j_att.paged_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
        jnp.asarray(pos))
    tc = t_att.PagedKV(_t(k_flat), _t(v_flat), _t(table), _t(lengths), ps,
                       fresh=fresh)
    got, tn = t_att.paged_cached_attention(_t(q), _t(k), _t(v), tc, _t(pos))
    _close(got, want)
    _close(tn.k_flat, jn.k_flat)
    _close(tn.v_flat, jn.v_flat)
    assert tn.lengths.tolist() == np.asarray(jn.lengths).tolist()


def test_paged_fresh_prefill_goes_through_multi_head_attention(monkeypatch):
    """A fresh prefill hands the new tokens to multi_head_attention
    (causal, k and v in q's type), which picks K1 or the einsum path."""
    calls = []
    real = t_att.multi_head_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, k.dtype, v.dtype, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(t_att, "multi_head_attention", spy)
    rng, k_flat, v_flat, table = _paged_inputs(10)
    b, s, hq, hkv, d, ps = 3, 5, 4, 2, 8, 4
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    q = _t(rng.randn(b, s, hq, d).astype(np.float32))
    kv = _t(rng.randn(b, s, hkv, d).astype(np.float32)).double()
    tc = t_att.PagedKV(_t(k_flat), _t(v_flat), _t(table),
                       torch.zeros(b, dtype=torch.int32), ps, fresh=True)
    t_att.paged_cached_attention(q, kv, kv, tc, _t(pos), scale=0.3)
    assert calls == [((b, s, hq, d), torch.float32, torch.float32,
                      dict(causal=True, impl="auto", scale=0.3))]
