"""A run past the harness's look for a chip, at debug widths on the CPU,
with the timed path broken underneath: `correct` comes out false for
each fault the cell can have, and true on the unbroken path. (One chip:
no exchange between chips to leave out.)"""
import pytest

import cpu_cells
import faults


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cpu_cells.make_root(tmp_path_factory.mktemp("cells"))


def _run(root, workload):
    out, _ = cpu_cells.run_cell(root, workload, seed=2 ** 31 + 99,
                                seconds=3.0)
    return out


def test_unbroken_runs_are_correct(root):
    for w in ("chat-debug", "pretrain-debug"):
        assert _run(root, w)["correct"], w


def test_serving_token_altered_where_produced(root):
    with faults.serve_token_altered():
        assert not _run(root, "chat-debug")["correct"]


def test_serving_half_the_batch_left_out(root):
    with faults.serve_half_slots():
        assert not _run(root, "chat-debug")["correct"]


def test_training_step_returns_state_unchanged(root):
    with faults.train_state_unchanged():
        out = _run(root, "pretrain-debug")
    assert not out["correct"]
    assert out["checked"]["step_gap"]["value"] == pytest.approx(1.0)
    assert out["checked"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_training_half_the_batch_left_out(root):
    with faults.train_half_batch():
        assert not _run(root, "pretrain-debug")["correct"]
