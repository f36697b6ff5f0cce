"""The port's sharded train step's loss and optimizer against the JAX
package, on the CPU, through tests/test_torch_parallel.py's `run_cases`
(a world of 4 gloo ranks beside the JAX step on the same MeshSpec) and
`check_case` (loss and grad_norm rtol 1e-4 each step, ntokens exactly,
params rtol 1e-4 atol 1e-6 after 3 steps). Cases: loss masks whose
token counts differ across the ranks, one rank's none at all in a step
(the loss is the global masked mean: a per-rank mean averaged over
ranks is another number); accum_steps 2 on a mesh; adafactor on
sharded parameters whose second moments it factors.
"""
import numpy as np
import pytest

from test_torch_parallel import WIDTHS, check_case, run_cases

# adafactor factors a parameter's second moments when two dims are
# >= 128: these widths give it (128, 128) and (256, 128) projections
WIDE = dict(WIDTHS, d_model=128, d_ff=256)


def _unequal_masks():
    """Per-rank token counts far apart: rows 0-1 (rank 0 of dp 2 x fsdp
    2) nearly full, rows 6-7 a token or two, and none at all in the
    last step (a rank with no token counts 0 toward the global mean)."""
    masks = []
    for i in range(3):
        m = np.zeros((8, 16), np.float32)
        m[0, :16] = m[1, :15 - i] = 1.0
        m[2, :7] = m[3, :4] = m[4, :10] = m[5, :2] = 1.0
        if i < 2:
            m[6, :1] = 1.0
            m[7, :2 + i] = 1.0
        masks.append(m)
    return masks


CASES = {
    "unequal_masks": dict(spec=dict(dp=2, fsdp=2), masks=_unequal_masks(),
                          seed=105),
    "accum2": dict(spec=dict(dp=2, fsdp=2), accum=2, seed=106),
    "adafactor": dict(spec=dict(fsdp=2, tp=2), cfg=WIDE, opt="adafactor",
                      lr=1e-2, seed=107),
}


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_optimizer_on_mesh_match_jax(runs, name):
    check_case(runs[0][name], runs[1][name])


def test_unequal_masks_differ_across_ranks():
    """The unequal-mask case does what it says: the 4 data ranks' token
    counts differ, and a rank has none in the last step."""
    masks = _unequal_masks()
    counts = [m.reshape(4, 2, 16).sum(axis=(1, 2)) for m in masks]
    assert len(set(counts[0].tolist())) == 4
    assert counts[2][3] == 0
