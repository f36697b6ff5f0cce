"""GPU scheduling in the port's runtime, on a machine without a GPU:
RAY_TPU_GPUS=2 declares two cards (the counterpart of the reference's
RAY_TPU_CHIPS, modelled on tests/test_core_extras.py's chip-id tests),
and the driver's CUDA_VISIBLE_DEVICES names them "5,7". A task or actor
with num_gpus is granted card ids (`get_gpu_ids`, indices into the
node's cards) and runs with CUDA_VISIBLE_DEVICES set to the cards they
name before its code runs; a CPU task sees none. CUDA reads that variable once per process, so a pooled
worker that ran with some ids is never handed others. A request of more
than one card must be a whole number of them; shares of one card are in
tests/test_torch_fractional_gpus.py."""
import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.train.multihost import MultiHostSpmd, _SpmdHost
from ray_tpu_torch.train.spmd_trainer import (ElasticSpmdTrainer,
                                              SpmdTrainerConfig)
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)


# the driver's own CUDA_VISIBLE_DEVICES: granted ids index it
NODE_CARDS = ["5", "7"]


@pytest.fixture(scope="module")
def cluster():
    keys = ("RAY_TPU_GPUS", "CUDA_VISIBLE_DEVICES")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["RAY_TPU_GPUS"] = "2"
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(NODE_CARDS)
    try:
        yield rt.init(num_cpus=4)
    finally:
        rt.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _card(ids):
    return ",".join(NODE_CARDS[i] for i in ids)


@rt.remote(num_gpus=1)
class Holder:
    def ids(self):
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def cpu_task():
    return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote(num_gpus=1)
def gpu_task():
    return (os.getpid(), rt.get_gpu_ids(),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def _wait_free(n: float, timeout: float = 20.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if rt.available_resources().get("GPU", 0.0) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"{n} GPUs never became free")


def test_resources_and_actor_ids(cluster):
    assert rt.cluster_resources()["GPU"] == 2
    a, b = Holder.remote(), Holder.remote()
    got = sorted(rt.get([a.ids.remote(), b.ids.remote()], timeout=60))
    assert got == [([0], "5"), ([1], "7")]
    assert rt.get(cpu_task.remote(), timeout=60) == ([], "")
    # a third card request waits until one of the two is released
    c = Holder.remote()
    ref = c.ids.remote()
    ready, _ = rt.wait([ref], timeout=1.5)
    assert ready == []
    rt.kill(a)
    ids, visible = rt.get(ref, timeout=60)
    assert len(ids) == 1 and visible == _card(ids)
    rt.kill(b)
    rt.kill(c)
    _wait_free(2)


def test_placement_group_bundles_report_their_ids(cluster):
    pg = placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}],
                         strategy="PACK")
    assert pg.wait(30)

    @rt.remote
    def bundle_ids():
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    got = rt.get([bundle_ids.options(placement_group=pg,
                                     bundle_index=i).remote()
                  for i in range(2)], timeout=60)
    assert sorted(g[0] for g in got) == [[0], [1]]
    assert all(v == _card(ids) for ids, v in got)
    # the group holds both cards: nothing is left outside it
    assert rt.available_resources().get("GPU", 0.0) == 0
    remove_placement_group(pg)
    _wait_free(2)


def test_pooled_worker_never_handed_other_ids(cluster):
    """A worker whose process ran with card 0 is retired, not handed
    card 1, when only card 1 is free; each worker process sees one
    CUDA_VISIBLE_DEVICES for its whole life."""
    seen = {}

    def run():
        pid, ids, visible = rt.get(gpu_task.remote(), timeout=60)
        assert visible == _card(ids)
        seen.setdefault(pid, set()).add(visible)
        return pid, visible

    pid0, v0 = run()
    # hold the card pid0 ran with, and leave only the other one free
    holders = [Holder.remote(), Holder.remote()]
    held = [rt.get(h.ids.remote(), timeout=60)[1] for h in holders]
    assert sorted(held) == NODE_CARDS
    rt.kill(holders[held.index(v0) ^ 1])
    _wait_free(1)
    pid1, v1 = run()
    assert v1 != v0 and pid1 != pid0
    rt.kill(holders[held.index(v0)])
    _wait_free(2)
    for _ in range(3):
        run()
    assert all(len(v) == 1 for v in seen.values()), seen


def test_fractional_gpu_requests_are_refused(cluster):
    """A request above one card that is not a whole number of cards (1.5
    names neither a share of one card nor whole cards, as in Ray) raises
    before anything is scheduled, whichever way it is asked for; whole
    counts run."""
    with pytest.raises(ValueError, match="whole number of cards"):
        Holder.options(num_gpus=1.5).remote()
    with pytest.raises(ValueError, match="whole number of cards"):
        gpu_task.options(num_gpus=1.5).remote()
    with pytest.raises(ValueError, match="whole number of cards"):
        cpu_task.options(resources={"GPU": 2.25}).remote()
    with pytest.raises(ValueError, match="whole number of cards"):
        placement_group([{"CPU": 1, "GPU": 1.5}])
    assert rt.available_resources().get("GPU", 0.0) == 2
    _, ids, visible = rt.get(gpu_task.options(num_gpus=1.0).remote(),
                             timeout=60)
    assert len(ids) == 1 and visible == _card(ids)


class _CardHost(_SpmdHost):
    """A rank that reports its cards instead of joining a NCCL world
    (this machine has no card to join one on)."""

    def join(self, coordinator):
        return dict(self.ping(), global_devices=self.world)


def _rank_cards(rank, world):
    return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")


def test_gang_ranks_get_a_card_by_default(cluster):
    """MultiHostSpmd and ElasticSpmdTrainer reserve one CPU and one GPU a
    rank unless asked otherwise, so each rank runs on its own card."""
    gang = MultiHostSpmd(2, _host_cls=_CardHost)
    try:
        got = gang.run(_rank_cards)
    finally:
        gang.shutdown()
    assert sorted(got) == [([0], "5"), ([1], "7")]
    tr = ElasticSpmdTrainer(SpmdTrainerConfig(model="llama-tiny"), iter,
                            num_hosts=2)
    assert tr.resources_per_host == {"CPU": 1, "GPU": 1}
    _wait_free(2)
