"""The port's thin client (`init(address="ray://...")`, client/) against
the reference's: one user program runs once under `ray_tpu` and once
under `ray_tpu_torch`, each in a subprocess of its own, and the JSON of
each of tests/test_client.py's ten cases must be equal. The program
starts a host (`python -m <pkg>.client.server`, 4 CPUs; the port's with
`--num-gpus 0`) and connects to it as a client.

The port's run then starts a second host that fakes one card
(RAY_TPU_GPUS=1, no --num-gpus) for its own cases: the cluster's GPU,
a num_gpus=1 task's ids, a named num_gpus=1 actor reached through the
client, `get_gpu_ids()` raising in the client, and tensors crossing the
wire through the port's object serialization (core/serialization.py)
without initialising CUDA in the client. Both hosts leave no worker.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r'''
import json, os, subprocess, sys, time
from importlib import import_module
import numpy as np
import psutil
pkg = sys.argv[1]
rt = import_module(pkg)
runtime_mod = import_module(pkg + ".core.runtime")
pgmod = import_module(pkg + ".util.placement_group")
data = import_module(pkg + ".data")
out = {}


def host(extra, env=None):
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg + ".client.server", "--listen",
         "127.0.0.1:0", "--num-cpus", "4", *extra], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    address = proc.stdout.readline().strip()
    assert address.startswith("ray://"), address
    return proc, address


def stop_host(proc):
    """SIGTERM the host; the number of its worker processes still alive
    after 20 s (they watch the host's socket and exit)."""
    kids = psutil.Process(proc.pid).children(recursive=True)
    proc.terminate()
    proc.wait(timeout=20)
    deadline = time.time() + 20
    while time.time() < deadline:
        alive = [k for k in kids if k.is_running()
                 and k.status() != psutil.STATUS_ZOMBIE]
        if not alive:
            break
        time.sleep(0.2)
    return len(alive)


def case(fn):
    try:
        out[fn.__name__] = fn()
    except Exception as e:
        out[fn.__name__] = ["raised", type(e).__name__, str(e)[:200]]
    return fn


proc, address = host(["--num-gpus", "0"] if pkg == "ray_tpu_torch" else [])
rt.init(address=address)


@case
def tasks_and_objects():
    @rt.remote
    def add(a, b):
        return a + b

    big = np.arange(10000, dtype=np.float32)
    ref = rt.put(big)

    @rt.remote
    def total(x):
        return float(x.sum())

    return [rt.get(add.remote(2, 3)), bool(np.array_equal(rt.get(ref), big)),
            rt.get(total.remote(ref)) == float(big.sum()),
            rt.get([add.remote(i, i) for i in range(20)])]


@case
def wait_and_cancel():
    @rt.remote
    def slow(sec):
        time.sleep(sec)
        return sec

    fast = slow.remote(0.05)
    slower = slow.remote(5.0)
    ready, pending = rt.wait([fast, slower], num_returns=1, timeout=3.0)
    got = [ready == [fast], pending == [slower]]
    rt.cancel(slower, force=True)
    try:
        rt.get(slower, timeout=10)
        got.append("no raise")
    except Exception:
        got.append("raised")
    return got


@case
def error_propagation():
    @rt.remote
    def boom():
        raise ValueError("remote kaboom")

    got = []
    try:
        rt.get(boom.remote())
    except Exception as e:
        got.append("remote kaboom" in str(e))
    try:
        rt.get(rt.ObjectRef("obj-nonexistent"), timeout=0.5)
        got.append("no raise")
    except Exception:
        got.append("raised")
    return got


@case
def actors():
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def get(self):
            return self.n

    c = Counter.remote(10)
    got = [rt.get(c.inc.remote()), rt.get(c.inc.remote(5)),
           rt.get(c.get.remote())]
    rt.kill(c)
    return got


@case
def named_actors():
    @rt.remote
    class KV:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v

        def get(self, k):
            return self.d.get(k)

    KV.options(name="client-kv").remote()
    h = rt.get_actor("client-kv")
    rt.get(h.set.remote("x", 42))
    got = rt.get(h.get.remote("x"))
    rt.kill(h)
    return got


@case
def namespaced_get_actor():
    rt.shutdown()
    rt.init(address=address, namespace="ns2")
    try:
        @rt.remote
        class Flag:
            def get(self):
                return "ns2-flag"

        Flag.options(name="flag").remote()
        h = rt.get_actor("flag")
        got = rt.get(h.get.remote())
        rt.kill(h)
    finally:
        rt.shutdown()
        rt2 = rt.init(address=address)
    return [got, rt2.ping()]


@case
def streaming_generator():
    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    return [rt.get(r) for r in gen.remote(5)]


@case
def resources_and_pg():
    res = rt.cluster_resources()
    avail = rt.available_resources()
    pg = pgmod.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    rt.get(pg.ready(), timeout=15)

    @rt.remote
    def where():
        return os.getpid()

    pid = rt.get(where.options(placement_group=pg, bundle_index=0).remote())
    pgmod.remove_placement_group(pg)
    return [res.get("CPU"), res.get("GPU", 0), avail.get("CPU", 0) <= 4.0,
            isinstance(pid, int)]


@case
def data_pipeline():
    ds = data.range(1000).map_batches(lambda b: {"id": b["id"] * 2})
    shuffled = data.range(100).random_shuffle(seed=1)
    return [ds.sum("id") == 2 * sum(range(1000)),
            sorted(r["id"] for r in shuffled.take_all()) == list(range(100))]


@case
def shutdown_reconnect():
    rt.shutdown()
    got = [runtime_mod.runtime_initialized()]
    rt2 = rt.init(address=address)

    @rt.remote
    def ping():
        return "alive"

    return got + [rt.get(ping.remote()), rt2.ping()]


rt.shutdown()
out["host_workers_left"] = stop_host(proc)

if pkg == "ray_tpu_torch":
    import torch
    serialization = import_module(pkg + ".core.serialization")
    unpacks = []
    unpack = serialization.unpack

    def counting_unpack(payload):
        unpacks.append(1)
        return unpack(payload)

    serialization.unpack = counting_unpack
    proc, address = host([], dict(os.environ, RAY_TPU_GPUS="1"))
    rt.init(address=address)
    port = {}

    @rt.remote(num_gpus=1)
    def on_card(x):
        return [rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                x * 2]

    class FromCard:
        """Pickles as a tensor the serializer took from a card (its
        from_cuda flag set): no card is needed to send one."""

        def __init__(self, values):
            self.values = values

        def __reduce__(self):
            import pickle
            ser = import_module(pkg + ".core.serialization")
            raw = np.asarray(self.values, np.float32)
            return (ser._rebuild_tensor,
                    (pickle.PickleBuffer(raw.view(np.uint8)), "float32",
                     raw.shape, False, True))

    @rt.remote
    def from_card():
        return FromCard([1.0, 2.0, 3.0])

    @rt.remote(num_gpus=1)
    class Probe:
        def ids(self):
            return rt.get_gpu_ids()

    try:
        ids, visible, doubled = rt.get(on_card.remote(torch.arange(4.0)))
        port["gpu_task"] = [rt.cluster_resources().get("GPU"), ids, visible,
                            doubled.tolist()]
        ref = rt.put(torch.ones(3))
        t = rt.get(from_card.remote())
        port["tensors"] = [rt.get(ref).tolist(), type(t).__name__,
                           str(t.device), t.tolist(), bool(unpacks),
                           torch.cuda.is_initialized()]
        Probe.options(name="gpu-probe").remote()
        port["named_gpu_actor"] = rt.get(
            rt.get_actor("gpu-probe").ids.remote())
        rt.kill(rt.get_actor("gpu-probe"))
        try:
            rt.get_gpu_ids()
            port["client_gpu_ids"] = "no raise"
        except RuntimeError as e:
            port["client_gpu_ids"] = "holds no granted cards" in str(e)
    finally:
        rt.shutdown()
        port["host_workers_left"] = stop_host(proc)
    out["port"] = port

print("RESULT " + json.dumps(out, default=lambda o: o.item()))
'''


def _spawn(pkg):
    # the client process sees no card: tensors that came from one are
    # rebuilt on its CPU
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", PROGRAM, pkg], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, pkg):
    try:
        stdout, stderr = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"{pkg} run failed (rc {proc.returncode}):\n{stdout[-3000:]}\n"
        f"{stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    procs = {pkg: _spawn(pkg) for pkg in ("ray_tpu", "ray_tpu_torch")}
    try:
        return {pkg: _result(p, pkg) for pkg, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


WANT = {
    "tasks_and_objects": [5, True, True, [2 * i for i in range(20)]],
    "wait_and_cancel": [True, True, "raised"],
    "error_propagation": [True, "raised"],
    "actors": [11, 16, 16],
    "named_actors": 42,
    "namespaced_get_actor": ["ns2-flag", "pong"],
    "streaming_generator": [0, 1, 4, 9, 16],
    "resources_and_pg": [4.0, 0, True, True],
    "data_pipeline": [True, True],
    "shutdown_reconnect": [False, "alive", "pong"],
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_same_case_same_result(runs, name):
    assert runs["ray_tpu_torch"][name] == runs["ray_tpu"][name]
    assert runs["ray_tpu_torch"][name] == WANT[name]


def test_terminated_host_leaves_no_worker(runs):
    assert runs["ray_tpu"]["host_workers_left"] == 0
    assert runs["ray_tpu_torch"]["host_workers_left"] == 0
    assert runs["ray_tpu_torch"]["port"]["host_workers_left"] == 0


def test_client_on_a_gpu_host(runs):
    """A host with one (faked) card: the client sees the GPU resource, a
    num_gpus=1 task and a named num_gpus=1 actor get card 0, and the
    client's own get_gpu_ids() raises."""
    port = runs["ray_tpu_torch"]["port"]
    assert port["gpu_task"] == [1.0, [0], "0", [0.0, 2.0, 4.0, 6.0]]
    assert port["named_gpu_actor"] == [0]
    assert port["client_gpu_ids"] is True


def test_client_tensors_follow_the_workers_rule(runs):
    """Values reach the client through the port's `unpack`: a tensor put
    by the client comes back, and one that came from a card is rebuilt
    on the client's CPU (CUDA_VISIBLE_DEVICES=""), with CUDA never
    initialised in the client."""
    assert runs["ray_tpu_torch"]["port"]["tensors"] == [
        [1.0, 1.0, 1.0], "Tensor", "cpu", [1.0, 2.0, 3.0], True, False]


class _FromCard:
    """Pickles as a tensor taken from a card (from_cuda set)."""

    def __reduce__(self):
        import pickle

        import numpy as np
        from ray_tpu_torch.core import serialization
        raw = np.arange(3, dtype=np.float32)
        return (serialization._rebuild_tensor,
                (pickle.PickleBuffer(raw.view(np.uint8)), "float32",
                 raw.shape, False, True))


def test_host_relays_a_card_tensor_without_cuda():
    """The client host's get and put only relay values: a tensor from a
    card stays on the host's CPU, marked, and is packed again as one from
    a card, so the next reader rebuilds it by its own rule; a reader with
    no card gets an unmarked CPU tensor."""
    from ray_tpu_torch.core import serialization
    payload = serialization.pack(_FromCard())
    with serialization.relaying():
        relayed = serialization.unpack(payload)
        again = serialization.pack(relayed)
        marked = serialization.unpack(again)
    assert relayed.device.type == "cpu"
    assert getattr(relayed, "_rtpt_from_cuda", False) is True
    assert getattr(marked, "_rtpt_from_cuda", False) is True
    plain = serialization.unpack(again)
    assert plain.device.type == "cpu" and plain.tolist() == [0.0, 1.0, 2.0]
    assert not hasattr(plain, "_rtpt_from_cuda")
