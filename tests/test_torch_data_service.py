"""The port's shared data service (ray_tpu_torch.data.service) against
the reference's: the non-slow cases of tests/test_data_service.py run as
one program under each package, each in a subprocess of its own (never
two runtimes in one process). Every outcome the cases check is
deterministic (sorted block ids, counts, statuses), so the port's must
equal the reference's, and each must also be what the reference's test
asserts. The port's run also reads the service through
`iter_device_batches(device="cpu")` (the reference's iter_jax_batches),
and leaves no data worker after `shutdown_service` and no worker process
after `shutdown`.
"""
import json
import os
import subprocess
import sys

import pytest

from ray_tpu_torch.data import range_, service

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r'''
import json, os, sys, threading, time
import numpy as np
import psutil
from importlib import import_module
pkg = sys.argv[1]
rt = import_module(pkg)
rd = import_module(pkg + ".data")
service = rd.service
state = import_module(pkg + ".util.state")
handle = rt.init(num_cpus=8)
out = {}


def tokens_ds(n_rows=160, block_rows=10):
    return rd.range_(n_rows, block_rows=block_rows).map_batches(
        lambda b: {"x": b["id"] * 2})


def consume(job, rank, cid, res, limit=None):
    it = service.iterator(job, rank=rank, consumer_id=cid)
    rows = 0
    for i, b in enumerate(it):
        rows += len(next(iter(b.values())))
        if limit is not None and i + 1 >= limit:
            break
    it.close()
    res[cid] = {"rows": rows, "bids": sorted(it.consumed_bids),
                "stats": dict(it.stats)}


def threads(targets):
    ts = [threading.Thread(target=consume, args=a) for a in targets]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    return [t.is_alive() for t in ts]


def error_of(fn):
    try:
        fn()
    except ValueError as e:
        return type(e).__name__ + ": " + str(e).split(";")[0][:60]
    return None


def draw(job, cid, gen, nonce, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        g = service._call("next_shard", job, cid, gen, [], nonce)
        if g.get("status") == "grant":
            return g
        time.sleep(0.1)
    raise AssertionError("no grant")


# registration
ds = tokens_ds()
k1 = ds.to_service("reg_a", dataset_name="reg_shared")
k2 = ds.to_service("reg_b", mode="rr", world_size=1,
                   dataset_name="reg_shared")
k3 = ds.to_service("reg_a", dataset_name="reg_shared")
st = service._call("stats")
out["register"] = [k1, k2, k3, "reg_shared" in st["datasets"]]
out["bad_mode"] = error_of(
    lambda: tokens_ds().to_service("bad_mode", mode="zigzag"))
tokens_ds().to_service("plan_a", dataset_name="ds_conflict")
out["conflict"] = error_of(lambda: rd.range_(64, block_rows=8).map_batches(
    lambda b: {"y": b["id"] + 1}).to_service(
        "plan_b", dataset_name="ds_conflict"))

# the two modes and the census
tokens_ds().to_service("fcfs2", mode="fcfs", epochs=1, n_slices=4,
                       dataset_name="ds_fcfs2")
res = {}
hung = threads([("fcfs2", None, f"c{i}", res) for i in range(2)])
bids = res["c0"]["bids"] + res["c1"]["bids"]
out["fcfs"] = [hung, sorted(bids), len(set(bids)) == len(bids),
               res["c0"]["rows"] + res["c1"]["rows"]]
tokens_ds().to_service("rr2", mode="round_robin", world_size=2, epochs=1,
                       n_slices=4, dataset_name="ds_rr2")
res = {}
hung = threads([("rr2", r, f"g{r}", res) for r in range(2)])
out["round_robin"] = [hung, res["g0"]["bids"], res["g1"]["bids"]]

# epochs, shared production, a late joiner
tokens_ds().to_service("ep2", mode="fcfs", epochs=2, n_slices=4,
                       dataset_name="ds_ep2")
res = {}
consume("ep2", None, "e_c0", res)
b = res["e_c0"]["bids"]
eps = [int(x[1]) for x in b]
out["epochs"] = [len(b), sorted(eps) == eps]
ds = tokens_ds()
ds.to_service("share_a", mode="fcfs", epochs=1, dataset_name="ds_share",
              n_slices=4)
ds.to_service("share_b", mode="round_robin", world_size=1, epochs=1,
              dataset_name="ds_share", n_slices=4)
res = {}
hung = threads([("share_a", None, "sa", res), ("share_b", 0, "sb", res)])
st = service._call("stats")
out["shared"] = [hung, res["sa"]["bids"], res["sb"]["bids"],
                 sorted(st["prod"]["ds_share"]["0"]["jobs"])]
ds.to_service("late_a", mode="fcfs", epochs=1, n_slices=4,
              dataset_name="ds_late")
res = {}
consume("late_a", None, "la0", res)
st = service._call("stats")
first = [res["la0"]["bids"], st["jobs"]["late_a"]["acked"],
         st["queue_depth"]["ds_late"]]
ds.to_service("late_b", mode="fcfs", epochs=1, n_slices=4,
              dataset_name="ds_late")
hung = threads([("late_b", None, "lb0", res)])
out["late"] = [first, hung, res["lb0"]["bids"], res["lb0"]["rows"]]

# grants: an idempotent nonce, fenced refetches
tokens_ds().to_service("idem", mode="fcfs", epochs=1, n_slices=4,
                       dataset_name="ds_idem")
gen = service._call("attach_consumer", "idem", "id_c0", None)["generation"]
g = draw("idem", "id_c0", gen, "n1")
again = service._call("next_shard", "idem", "id_c0", gen, [], "n1")
granted = service._call("stats")["jobs"]["idem"]["granted"]
nxt = service._call("next_shard", "idem", "id_c0", gen, [], "n2")
out["nonce"] = [again["status"], again["bid"] == g["bid"], granted,
                nxt["status"], nxt["bid"] != g["bid"]]
tokens_ds().to_service("rf", mode="fcfs", epochs=1, n_slices=4,
                       dataset_name="ds_rf")
gen = service._call("attach_consumer", "rf", "rf_c0", None)["generation"]
g = draw("rf", "rf_c0", gen, "r1")
ok = service._call("refetch", "rf", "rf_c0", gen, g["bid"])
gen2 = service._call("attach_consumer", "rf", "rf_c1", None)["generation"]
out["refetch"] = [
    ok["status"], ok["ref"] == g["ref"],
    service._call("refetch", "rf", "rf_c0", gen + 1, g["bid"])["status"],
    service._call("refetch", "rf", "rf_c1", gen2, g["bid"])["status"],
    service._call("refetch", "rf", "rf_c0", gen, "e0-s0-b999")["status"]]
tokens_ds().to_service("relay0", mode="fcfs", epochs=1, n_slices=2,
                       dataset_name="ds_relay0")
res = {}
consume("relay0", None, "r_c0", res)
out["relay"] = [res["r_c0"]["stats"]["blocks"],
                res["r_c0"]["stats"]["relay_bytes"]]

# fast_forward
tokens_ds().to_service("ffwd", mode="round_robin", world_size=1, epochs=1,
                       n_slices=4, dataset_name="ds_ffwd")
it = service.iterator("ffwd", rank=0, consumer_id="ff_c0")
skipped = it.fast_forward(5)
rest = list(it)
out["fast_forward"] = [skipped, len(rest), sorted(it.consumed_bids)]
tokens_ds().to_service("ffwd2", mode="fcfs", epochs=1, n_slices=4,
                       dataset_name="ds_ffwd2")
it = service.iterator("ffwd2", consumer_id="ff2_c0")
next(it)
it.flush_acks()
noop = it.fast_forward(1)
out["fast_forward_noop"] = [noop, 1 + sum(1 for _ in it)]

# telemetry
tokens_ds().to_service("tele", mode="fcfs", epochs=1, n_slices=2,
                       dataset_name="ds_tele")
res = {}
consume("tele", None, "t_c0", res)
want = ["data.service.register", "data.service.shard.grant",
        "data.service.epoch", "data.service.worker.scale"]
deadline = time.time() + 10
got = set()
while time.time() < deadline and len(got) < 4:
    handle.drain_local_events()
    rows, _ = handle.cluster_events.query(types=want, limit=500)
    got = {r["type"] for r in rows}
    time.sleep(0.1)
out["events"] = sorted(got)

# a consumer's batches on the device (the port's name for it)
if pkg == "ray_tpu_torch":
    tokens_ds().to_service("dev", mode="round_robin", world_size=1,
                           epochs=1, n_slices=4, dataset_name="ds_dev")
    it = service.iterator("dev", rank=0, consumer_id="dev_c0")
    xs = []
    for b in it.iter_device_batches(device="cpu", prefetch=2):
        xs.extend(b["x"].tolist())
        dtype = str(b["x"].dtype)
    out["device"] = [sorted(xs) == list(range(0, 320, 2)), dtype]

def data_workers():
    rows = state.list_actors(filters=[("state", "=", "ALIVE")], limit=1000)
    return sorted(r["class_name"] for r in rows
                  if r["class_name"] in ("_DataWorkerImpl",
                                         "DataServiceDispatcher"))

before = data_workers()
service.shutdown_service()
deadline = time.time() + 20
left = data_workers()
while time.time() < deadline and left:
    time.sleep(0.2)
    left = data_workers()
out["shutdown"] = [len(before) > 1, left]
rt.shutdown()
me = psutil.Process()
deadline = time.time() + 30
while time.time() < deadline:
    kids = [p for p in me.children(recursive=True)
            if "core.worker" in " ".join(p.cmdline())]
    if not kids:
        break
    time.sleep(0.2)
print("RESULT " + json.dumps({"out": out, "workers_left": len(kids)}))
'''


def _run(program, *modules):
    """Run `program` once under each package, the processes side by
    side; their RESULT objects, in order."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", program, m], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for m in modules]
    out = []
    try:
        for module, proc in zip(modules, procs):
            stdout, stderr = proc.communicate(timeout=300)
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("RESULT ")]
            assert proc.returncode == 0 and lines, (
                f"{module} run failed (rc {proc.returncode}):\n"
                f"{stdout[-3000:]}\n{stderr[-3000:]}")
            out.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for proc in procs:   # a failed or timed-out run
            if proc.poll() is None:
                proc.kill()
    return out


@pytest.fixture(scope="module")
def runs():
    return _run(PROGRAM, "ray_tpu", "ray_tpu_torch")


def _bids(epochs=1, n_blocks=16, n_slices=4):
    return sorted(f"e{e}-s{i % n_slices}-b{i // n_slices}"
                  for e in range(epochs) for i in range(n_blocks))


BY_IDX = [f"e0-s{i % 4}-b{i // 4}" for i in range(16)]

# what tests/test_data_service.py asserts of each case
EXPECTED = {
    "register": ["reg_shared", "reg_shared", "reg_shared", True],
    "bad_mode": "ValueError: mode must be fcfs|round_robin, got 'zigzag'",
    "conflict": "ValueError: dataset 'ds_conflict' is already registered "
                "with a different",
    "fcfs": [[False, False], _bids(), True, 160],
    "round_robin": [[False, False],
                    sorted(BY_IDX[i] for i in range(16) if i % 2 == 0),
                    sorted(BY_IDX[i] for i in range(16) if i % 2 == 1)],
    "epochs": [32, True],
    "shared": [[False, False], _bids(), _bids(), ["share_a", "share_b"]],
    "late": [[_bids(), 16, 0], [False], _bids(), 160],
    "nonce": ["grant", True, 1, "grant", True],
    "refetch": ["grant", True, "stale", "stale", "stale"],
    "relay": [16, 0],
    "fast_forward": [5, 11, sorted(BY_IDX[5:])],
    "fast_forward_noop": [0, 16],
    "events": sorted(["data.service.register", "data.service.shard.grant",
                      "data.service.epoch", "data.service.worker.scale"]),
}


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_service_case_matches_the_reference(runs, case):
    ref, port = runs
    assert port["out"][case] == ref["out"][case]
    assert port["out"][case] == EXPECTED[case]


def test_plan_rejects_cross_slice_stages():
    with pytest.raises(ValueError, match="shuffle"):
        service.plan_bytes_of(range_(64).random_shuffle())


def test_consumer_batches_on_the_device_and_nothing_left(runs):
    _, port = runs
    # every row once, int64 narrowed to int32 on the way
    assert port["out"]["device"] == [True, "torch.int32"]
    # the dispatcher and its data workers were up, and are gone
    assert port["out"]["shutdown"] == [True, []]
    assert port["workers_left"] == 0


# graceful_shutdown kills every data worker the dispatcher spawned: one
# it marked dead after a missed ping (it may only have been wedged, and
# is still up), and its ticks spawn none after it. The reference kills
# only the workers still marked alive, so a wedged worker outlives its
# service (a deliberate difference; the port's program only).
DEAD_WORKER_PROGRAM = r'''
import json, time
import ray_tpu_torch as rt
from ray_tpu_torch.data import service
from ray_tpu_torch.util import state
rt.init(num_cpus=4)


def alive():
    rows = state.list_actors(filters=[("state", "=", "ALIVE")], limit=1000)
    return sorted(r["actor_id"] for r in rows
                  if r["class_name"] == "_DataWorkerImpl")


def wait(pred, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.1)
    return pred()


# the dispatcher as a plain object: its tick thread keeps two workers
d = service.DataServiceDispatcher(min_workers=2, max_workers=2)
up = wait(lambda: len(d._workers) == 2 and len(alive()) == 2)
name = sorted(d._workers)[0]
victim = d._workers[name]["handle"]._actor_id
d._on_worker_dead(name)          # what a missed ping leads to
marked = d._workers[name]["state"] == "dead" and victim in alive()
d.graceful_shutdown()
d._scale_workers()               # a tick that runs after the shutdown
wait(lambda: not alive())
left = alive()
rt.shutdown()
print("RESULT " + json.dumps({"up": up, "marked": marked, "left": left}))
'''


def test_shutdown_kills_dead_marked_and_late_workers():
    (port,) = _run(DEAD_WORKER_PROGRAM, "ray_tpu_torch")
    assert port == {"up": True, "marked": True, "left": []}


# The seek skips the index-order prefix (the reference's contract in
# tests/test_data_service.py::test_fast_forward_skips_absolute_prefix)
# also while production lags: the dispatcher as a plain object with no
# data workers, its blocks offered by hand, slice 0 held back after its
# first block while slices 1-3 run ahead.
BY_IDX = [f"e0-s{i % 4}-b{i // 4}" for i in range(16)]


@pytest.mark.parametrize("mode", ["round_robin", "fcfs"])
def test_seek_skips_the_index_order_prefix_while_a_slice_lags(mode):
    d = service.DataServiceDispatcher(min_workers=0, max_workers=0)
    try:
        def offer(slice_idx, seq):
            d.offer_block("ds_lag", 0, slice_idx, seq,
                          f"ref-{slice_idx}-{seq}", 8, "w0")

        def acked():
            return sorted(d._jobs["lag"]["acked"])

        assert d.register_dataset("ds_lag", b"plan", 4)["ok"]
        d.register_job("lag", "ds_lag", mode, 1, 1)
        d._dispatch_slices()            # opens epoch 0, four slices
        gen = d.attach_consumer(
            "lag", "c0", 0 if mode == "round_robin" else None)["generation"]
        offer(0, 0)
        for s in (1, 2, 3):
            for seq in range(4):
                offer(s, seq)
        # idx 4 is slice 0's second block: the reply comes back short,
        # and idx 5 (produced) is not acked in its place
        out = d.fast_forward("lag", "c0", gen, 5)
        assert (out["skipped"], out["consumed"]) == (4, 4)
        assert acked() == sorted(BY_IDX[:4])
        offer(0, 1)
        out = d.fast_forward("lag", "c0", gen, 5)
        assert (out["skipped"], out["consumed"]) == (1, 5)
        assert acked() == sorted(BY_IDX[:5])
        # slice 0 ends after two blocks: idx 8 and 12 never exist, and
        # the seek steps over them once its slice is done
        for s in range(4):
            d.slice_done("ds_lag", 0, s, "w0")
        have = [b for b in BY_IDX if b not in ("e0-s0-b2", "e0-s0-b3")]
        out = d.fast_forward("lag", "c0", gen, 10)
        assert (out["consumed"], out["done"]) == (10, False)
        assert acked() == sorted(have[:10])
        grant = d.next_shard("lag", "c0", gen, [], None)
        assert grant["bid"] == have[10]
        # the rest of the epoch: every block is now handed out (one
        # granted, twelve acked), so the seek crosses the last barrier
        out = d.fast_forward("lag", "c0", gen, 14)
        assert (out["consumed"], out["done"]) == (13, True)
        assert d.next_shard("lag", "c0", gen, [grant["bid"]],
                            None)["status"] == "end"
        assert acked() == sorted(have)
    finally:
        d.graceful_shutdown()


def test_next_shard_grants_the_lowest_block_produced_so_far():
    """`next_shard` keeps production order, as the reference's does: with
    slice 0 not yet producing, the grant is slice 1's first block (idx 1)
    and idx 0 comes when it is produced. Holding grants to index order
    would stall a consumer behind a lagging slice, and could deadlock it
    against the produce-ahead budget the slices share."""
    d = service.DataServiceDispatcher(min_workers=0, max_workers=0)
    try:
        assert d.register_dataset("ds_order", b"plan", 4)["ok"]
        d.register_job("order", "ds_order", "round_robin", 1, 1)
        d._dispatch_slices()
        gen = d.attach_consumer("order", "c0", 0)["generation"]
        for s in (1, 2, 3):
            d.offer_block("ds_order", 0, s, 0, f"ref-{s}", 8, "w0")
        first = d.next_shard("order", "c0", gen, [], None)
        assert (first["bid"], first["idx"]) == ("e0-s1-b0", 1)
        d.offer_block("ds_order", 0, 0, 0, "ref-0", 8, "w0")
        second = d.next_shard("order", "c0", gen, [first["bid"]], None)
        assert (second["bid"], second["idx"]) == ("e0-s0-b0", 0)
    finally:
        d.graceful_shutdown()
