"""The control of the comparison that decides `correct`: the plain
reference in the precision below the configuration's (float8 e4m3
operands for bf16 compute) put in the program's place has to come out
not correct, where the program comes out correct. At debug widths on
the CPU here; at the cells' own sizes on the chip (`-m chip`)."""
from pathlib import Path

import pytest
import torch

import calibrate
import cpu_cells
from harness import cell as cell_mod

BENCH = Path(__file__).resolve().parents[1]
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _serve(cell, seeds, seconds, device):
    limits = cell.checks["limits"]
    for seed in seeds:
        r = calibrate.serve_readings(cell, seed, seconds,
                                     ["program", "control"], device)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert any(r["control"][k] > v for k, v in limits.items()), r


def _train(cell, seeds, device):
    limits = cell.checks["limits"]
    for seed in seeds:
        r = calibrate.train_readings(cell, seed, ["program", "control"],
                                     device)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert any(r["control"][k] > v for k, v in limits.items()), r


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cpu_cells.make_root(tmp_path_factory.mktemp("cells"))


def test_control_fails_at_debug_widths(root):
    cpu = torch.device("cpu")
    _serve(cell_mod.load(root, root / "benchmarks", "chat-debug"), SEEDS,
           3.0, cpu)
    _train(cell_mod.load(root, root / "benchmarks", "pretrain-debug"), SEEDS,
           cpu)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.chip
def test_control_fails_at_the_chat_cells_size(card):
    import run
    run._environment()
    _serve(cell_mod.load(run.ROOT, BENCH, "mixtral-chat"), SEEDS, 20.0, card)


@pytest.mark.chip
def test_control_fails_at_the_pretrain_cells_size(card):
    import run
    run._environment()
    _train(cell_mod.load(run.ROOT, BENCH, "mistral-pretrain"), SEEDS, card)
