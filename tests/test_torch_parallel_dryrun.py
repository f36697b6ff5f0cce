"""The port's multi-device dry run and its launcher, on the CPU.

`entry.dryrun_multichip(4, device="cpu")` runs every stage of the
reference's `__graft_entry__.dryrun_multichip` on 4 gloo ranks: the
train step over dp x fsdp x tp, LoRA over the sharded base, ring
attention over sp, Mixtral over ep, the int8 forward over tp and the
pipelined train step over pp x dp. Spawned ranks load neither JAX nor
the JAX package. The launcher takes a world down when a rank fails or the
deadline passes, and raises.
"""
import time

import pytest

from ray_tpu_torch.entry import dryrun_multichip, factor
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.train.backend import launch

STAGES = ("dryrun_multichip ok: mesh={'pp': 1, 'dp': 2, 'fsdp': 1, 'ep': 1, "
          "'sp': 1, 'tp': 2}",
          "dryrun lora ok: adapter step over", "dryrun sp ok: ring attention "
          "over sp=4", "dryrun ep ok: MoE over {'pp': 1, 'dp': 2, 'fsdp': 1, "
          "'ep': 2", "dryrun int8 ok: quantized serving forward over",
          "dryrun pp ok: 4-stage pipelined train step (pp=4 x dp=1)")


def test_dryrun_multichip_cpu_runs_every_stage(capsys):
    lines = dryrun_multichip(4, device="cpu", timeout_s=240)
    assert len(lines) == len(STAGES)
    for line, stage in zip(lines, STAGES):
        assert line.startswith(stage), (line, stage)
    assert capsys.readouterr().out.splitlines()[-len(STAGES):] == lines


def test_factor_matches_reference():
    """The reference's factoring of n devices into dp x fsdp x tp."""
    assert [factor(n) for n in (1, 2, 4, 8, 16, 6)] == [
        (1, 1, 1), (1, 1, 2), (2, 1, 2), (2, 2, 2), (2, 2, 4), (2, 1, 3)]


def test_ranks_load_no_jax():
    """A spawned rank unpickles its function from the port and imports
    neither jax, ray_tpu, optax, flax nor orbax (the test process has
    them all); each sees its rank in the launcher's env block."""
    out = launch(_testing.foreign_modules, 2, "cpu", timeout_s=120)
    assert out == [[], []]
    assert launch(_testing.rank_env, 2, "cpu", timeout_s=120) == ["0", "1"]


def test_failing_rank_takes_its_world_down():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*fails on "
                                           "purpose"):
        launch(_testing.fail_on, 3, "cpu", 1, timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_deadline_kills_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline of 4 s passed"):
        launch(_testing.sleep_for, 2, "cpu", 600.0, timeout_s=4)
    assert time.monotonic() - t0 < 30


def test_cuda_world_larger_than_the_cards_raises():
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        launch(_testing.sleep_for, 2, "cuda", 0.0)
