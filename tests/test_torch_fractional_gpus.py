"""Fractional GPUs on the port's runtime, with RAY_TPU_GPUS=1 declaring
one card on a machine without one. As in Ray, a request below one card
(0.5, 0.25) holds that share of a card and its process is bound to that
card's index (`get_gpu_ids() == [0]`, CUDA_VISIBLE_DEVICES "0"); holders
share the card until their shares reach 1, and the index returns to the
free pool with the last share. The reference accepts a fractional
num_tpus but grants it no chip id, which on CUDA would leave the process
unable to use the card: binding the share to the card's index is a
deliberate difference. A request above one card must be whole cards
(tests/test_torch_gpu_ids.py)."""
import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)


@pytest.fixture(scope="module")
def cluster():
    keys = ("RAY_TPU_GPUS", "CUDA_VISIBLE_DEVICES")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["RAY_TPU_GPUS"] = "1"
    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    try:
        yield rt.init(num_cpus=6)
    finally:
        rt.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@rt.remote(num_gpus=0.5)
class Half:
    def ids(self):
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")


def _gpus_free():
    return rt.available_resources().get("GPU", 0.0)


def _wait_free(n, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if abs(_gpus_free() - n) < 1e-9:
            return
        time.sleep(0.05)
    raise AssertionError(f"GPU free stayed {_gpus_free()}, not {n}")


def test_two_halves_share_card_zero_and_a_third_waits(cluster):
    assert rt.cluster_resources()["GPU"] == 1
    a, b = Half.remote(), Half.remote()
    assert rt.get([a.ids.remote(), b.ids.remote()], timeout=60) == \
        [([0], "0"), ([0], "0")]
    assert _gpus_free() == 0.0
    c = Half.remote()
    ref = c.ids.remote()
    ready, _ = rt.wait([ref], timeout=1.5)
    assert ready == []                       # the card's shares are spent
    rt.kill(a)
    assert rt.get(ref, timeout=60) == ([0], "0")
    assert _gpus_free() == 0.0
    rt.kill(b)
    _wait_free(0.5)
    rt.kill(c)
    _wait_free(1.0)


def test_shares_pack_and_a_whole_card_waits_for_them(cluster):
    """Shares of different sizes pack onto the card; a whole-card task
    waits until the last share is returned."""
    quarter = Half.options(num_gpus=0.25).remote()
    half = Half.remote()
    assert rt.get([quarter.ids.remote(), half.ids.remote()],
                  timeout=60) == [([0], "0"), ([0], "0")]
    _wait_free(0.25)

    @rt.remote(num_gpus=1)
    def whole():
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    ref = whole.remote()
    ready, _ = rt.wait([ref], timeout=1.5)
    assert ready == []
    rt.kill(quarter)
    rt.kill(half)
    assert rt.get(ref, timeout=60) == ([0], "0")
    _wait_free(1.0)


def test_more_than_a_card_must_be_whole_cards(cluster):
    with pytest.raises(ValueError, match="whole number of cards"):
        Half.options(num_gpus=1.5).remote()
    with pytest.raises(ValueError, match="whole number of cards"):
        placement_group([{"CPU": 1, "GPU": 1.5}])
    assert _gpus_free() == 1.0


def test_half_card_placement_group_bundle(cluster):
    """A 0.5 bundle reserves half the card for the group; a task in the
    bundle sees card 0, and a 0.5 actor outside the group takes the
    other half."""
    pg = placement_group([{"CPU": 1, "GPU": 0.5}])
    assert pg.wait(30)
    _wait_free(0.5)

    @rt.remote
    def in_bundle():
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    got = rt.get(in_bundle.options(placement_group=pg,
                                   bundle_index=0).remote(), timeout=60)
    assert got == ([0], "0")
    outside = Half.remote()
    assert rt.get(outside.ids.remote(), timeout=60) == ([0], "0")
    assert _gpus_free() == 0.0
    remove_placement_group(pg)
    _wait_free(0.5)
    rt.kill(outside)
    _wait_free(1.0)


def test_half_card_tune_trials_run_together(cluster, tmp_path):
    """tune.with_resources({"GPU": 0.5}): two trials at once on card 0.
    Each marks its start in a file and waits (up to 30 s) for the
    other's: trials run one after the other would each see only their
    own."""
    def trial(config):
        os.makedirs(config["dir"], exist_ok=True)
        open(os.path.join(config["dir"], str(config["x"])), "w").close()
        deadline = time.time() + 30
        while len(os.listdir(config["dir"])) < 2 \
                and time.time() < deadline:
            time.sleep(0.05)
        tune.report({"x": config["x"], "gpus": rt.get_gpu_ids(),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "saw_both": len(os.listdir(config["dir"])) == 2})

    grid = tune.Tuner(tune.with_resources(trial, {"CPU": 1, "GPU": 0.5}),
                      param_space={"x": tune.grid_search([1, 2]),
                                   "dir": str(tmp_path / "started")},
                      tune_config=tune.TuneConfig(metric="x", mode="max"),
                      ).fit()
    metrics = [t.last_metrics for t in grid.trials]
    assert [t.status for t in grid.trials] == ["TERMINATED"] * 2
    assert all(m["gpus"] == [0] and m["visible"] == "0" for m in metrics)
    assert all(m["saw_both"] for m in metrics)      # the two overlapped
    _wait_free(1.0)
