"""The frozen operation and byte counters against hand counts at the
cells' shapes."""
import json
from pathlib import Path

import pytest

import cpu_cells  # noqa: F401
from harness import roofline
from harness.cell import _reader

BENCH = Path(__file__).resolve().parents[1]
MISTRAL = json.loads((BENCH / "configs" / "mistral-7b-s16.json").read_text())


def test_peaks():
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.PEAK_FP32_FLOPS == 67e12
    assert roofline.PEAK_BYTES == 3.35e12
    assert roofline.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_kernel_counts_at_the_train_cell():
    b, s, hq, hkv, d = 1, 8192, 32, 8, 128
    pairs = 8192 * 8193 // 2                   # causal, diagonal included
    f, by = roofline.k1_cost(b, s, hq, hkv, d)
    assert f == 4 * 32 * 128 * pairs == 17_181_966_336 * 32
    assert by == 2 * (2 * 8192 * 32 * 128 + 2 * 8192 * 8 * 128) \
        + 4 * 32 * 8192
    fa, ba = roofline.k2a_cost(b, s, hq, hkv, d)
    fb, bb = roofline.k2b_cost(b, s, hq, hkv, d)
    assert fa == 3 * 2 * 32 * 128 * pairs and fb == 4 * 2 * 32 * 128 * pairs
    nq, nkv, st = 8192 * 32 * 128, 8192 * 8 * 128, 4 * 2 * 32 * 8192
    assert ba == 2 * (3 * nq + 2 * nkv) + st
    assert bb == 2 * (2 * nq + 4 * nkv) + st
    # all three are bound by operations at this shape
    assert f / roofline.PEAK_BF16_FLOPS > by / roofline.PEAK_BYTES


def test_model_flops_of_the_train_cell():
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    n = 16 * per_layer + 32768 * 4096
    assert roofline.dense_matmul_params(MISTRAL) == n == 3_623_878_656
    attn = 3 * 4 * 32 * 128 * (8192 * 8193 / 2) * 16
    assert roofline.train_step_flops(MISTRAL, 1, 8192) == pytest.approx(
        6 * n * 8192 + attn)


def test_roofline_readers():
    mix = json.loads((BENCH / "traffic" / "pretrain-8k.json").read_text())
    shape = (1, 8192, 32, 8, 128)
    k1 = roofline.bound_s(*roofline.k1_cost(*shape))
    ka = roofline.bound_s(*roofline.k2a_cost(*shape))
    kb = roofline.bound_s(*roofline.k2b_cost(*shape))
    trace = {"kernels": {"void flash_fwd_wgmma_kernel<128>": [32, 32 * k1 * 2],
                         "void bwd_dq_wgmma_kernel<128>": [16, 16 * ka * 3],
                         "void bwd_dkv_wgmma_kernel<128>": [16, 16 * kb * 3]},
             "ranges": {}, "busy_s": 1.0, "window_s": 1.0}
    rec = {"kind": "train", "trace": trace, "config": MISTRAL, "traffic": mix}
    assert _reader(BENCH, "k1_roofline.train")(rec) == pytest.approx(50.0)
    assert _reader(BENCH, "k2_roofline.train")(rec) == pytest.approx(100 / 3)
