"""Device-resident objects in the port's runtime (counterpart of
tests/test_device_objects.py, case by case, with CPU torch.Tensors in
place of jax.Arrays).

A task/actor return holding a torch.Tensor stays resident in the
producing worker (ray_tpu_torch/core/device_store.py); same-worker edges
read the live value, and only a consumer elsewhere materializes it
through the shm store. Also held here: the counters equal the reference
runtime's for the same chains (each runtime in a subprocess of its own),
a tensor that came from a card is read by a worker without a GPU, an
in-place write to a received tensor acts as one to the reference's numpy
array, and CPU tensors take the pickle-5 out-of-band path with zero
copies.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.core import serialization


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt():
    handle = ray_tpu.init(num_cpus=4)
    yield handle
    ray_tpu.shutdown()


@ray_tpu.remote
class TensorActor:
    """Chain stages on ONE actor — the compiled-DAG actor-reuse shape."""

    def make(self, n):
        import torch
        return torch.arange(n, dtype=torch.float32)

    def double(self, x):
        return x * 2

    def total(self, x):
        return float(x.sum())

    def counters(self):
        from ray_tpu_torch.core import device_store
        return dict(device_store.COUNTERS)

    def reset_counters(self):
        from ray_tpu_torch.core import device_store
        device_store.COUNTERS.update(
            {"kept_device": 0, "device_hits": 0, "materialized": 0})


def test_actor_chain_no_host_roundtrip(rt):
    """Intermediate edges of an actor-method chain are served from the
    in-process device table: device_hits == #edges, materialized == 0
    until the driver reads the final value."""
    a = TensorActor.remote()
    a.reset_counters.remote()
    r1 = a.make.remote(1024)
    r2 = a.double.remote(r1)      # edge 1: same-worker, no D2H
    r3 = a.double.remote(r2)      # edge 2: same-worker, no D2H
    r4 = a.total.remote(r3)       # edge 3 (+ float return: not kept)
    assert ray_tpu.get(r4) == float(np.arange(1024).sum() * 4)
    c = ray_tpu.get(a.counters.remote())
    assert c["kept_device"] == 3       # r1, r2, r3 stayed on device
    assert c["device_hits"] == 3       # each edge read the live value
    assert c["materialized"] == 0      # nothing ever crossed to host
    ray_tpu.kill(a)


def test_driver_get_materializes_on_demand(rt):
    a = TensorActor.remote()
    a.reset_counters.remote()
    r1 = a.make.remote(64)
    got = ray_tpu.get(r1)              # driver needs bytes -> D2H now
    assert np.asarray(got).tolist() == list(range(64))
    c = ray_tpu.get(a.counters.remote())
    assert c["materialized"] == 1
    # after materialization the host copy is the source of truth (the
    # device entry was dropped to reclaim HBM); consumers still work
    assert ray_tpu.get(a.total.remote(r1)) == float(sum(range(64)))
    ray_tpu.kill(a)


def test_wait_reports_ready_without_materializing(rt):
    """ray_tpu.wait needs READINESS, not bytes: a finished device-
    resident object is ready, and waiting must not trigger the D2H the
    feature exists to avoid (nor destroy device locality)."""
    import time
    a = TensorActor.remote()
    a.reset_counters.remote()
    r1 = a.make.remote(256)
    deadline = time.time() + 10
    while time.time() < deadline:
        ready, pending = ray_tpu.wait([r1], timeout=0.2)
        if ready:
            break
    assert ready == [r1]
    c = ray_tpu.get(a.counters.remote())
    assert c["materialized"] == 0      # wait() alone caused no D2H
    # the value is still device-resident for same-worker consumers
    assert ray_tpu.get(a.total.remote(r1)) == float(sum(range(256)))
    c = ray_tpu.get(a.counters.remote())
    assert c["device_hits"] >= 1
    ray_tpu.kill(a)


def test_cross_actor_edge_materializes_and_is_correct(rt):
    a = TensorActor.remote()
    b = TensorActor.remote()
    r1 = a.make.remote(128)
    out = ray_tpu.get(b.total.remote(r1))   # b lives elsewhere
    assert out == float(sum(range(128)))
    ray_tpu.kill(a)
    ray_tpu.kill(b)


def test_compiled_dag_chain_device_edges(rt, monkeypatch):
    """The compiled-DAG chain, on the dynamic
    level-batched path (RAY_TPU_COMPILED_DAGS=0): intermediate edges
    stay device-resident (transfer counters prove no D2H), results
    unchanged vs eager execution. (The pipelined engine beats device
    edges outright: same-actor stages hand values over in-process —
    see test_compiled_dag_pipelined_actor_chain.)"""
    monkeypatch.setenv("RAY_TPU_COMPILED_DAGS", "0")
    from ray_tpu_torch.dag import InputNode
    actor = TensorActor.bind()
    with InputNode() as inp:
        n1 = actor.make.bind(inp)
        n2 = actor.double.bind(n1)
        n3 = actor.total.bind(n2)
    dag = n3.experimental_compile()
    out = ray_tpu.get(dag.execute(256))
    assert out == float(np.arange(256).sum() * 2)
    handle = actor._handle      # materialized at first execute
    c = ray_tpu.get(handle.counters.remote())
    assert c["device_hits"] == 2       # make->double, double->total
    assert c["materialized"] == 0      # final value is a float (host)
    # second execute reuses the compiled plan and stays device-resident
    out2 = ray_tpu.get(dag.execute(8))
    assert out2 == float(np.arange(8).sum() * 2)
    ray_tpu.kill(handle)


def test_compiled_dag_pipelined_actor_chain(rt):
    """Pipelined engine, same chain: same-actor stages hand values
    over IN-PROCESS (no serialization, no device-store bookkeeping at
    all) and results match the eager path."""
    from ray_tpu_torch.dag import InputNode
    actor = TensorActor.bind()
    with InputNode() as inp:
        dag = actor.total.bind(actor.double.bind(actor.make.bind(inp)))
    comp = dag.experimental_compile()
    assert comp.stats["mode"] == "pipelined"
    assert ray_tpu.get(comp.execute(256)) == float(
        np.arange(256).sum() * 2)
    assert ray_tpu.get(comp.execute(8)) == float(np.arange(8).sum() * 2)
    handle = actor._handle
    c = ray_tpu.get(handle.counters.remote())
    assert c["materialized"] == 0
    comp.close()
    ray_tpu.kill(handle)


def test_task_chain_locality_prefers_holder_worker(rt):
    """Plain (stateless) task chains: the scheduler places the consumer
    on the worker holding its device-resident dep when it's idle, so
    the edge is a local table hit."""

    @ray_tpu.remote
    def produce(n):
        import torch
        return torch.ones((n,), dtype=torch.float32)

    @ray_tpu.remote
    def consume(x):
        from ray_tpu_torch.core import device_store
        return float(x.sum()), device_store.COUNTERS["device_hits"]

    total, hits = ray_tpu.get(consume.remote(produce.remote(512)))
    assert total == 512.0
    assert hits >= 1, "consumer did not read the dep from the device table"


def test_unserializable_device_value_errors_not_loops(rt):
    """A device-kept value that won't pickle (e.g. a lock next to the
    arrays) must surface an error on get — not trigger an infinite
    lineage-reconstruction loop while the caller hangs."""
    from ray_tpu_torch.exceptions import ObjectLostError

    @ray_tpu.remote
    def bad():
        import threading
        import torch
        return {"x": torch.ones((4,)), "lock": threading.Lock()}

    ref = bad.remote()
    with pytest.raises(ObjectLostError, match="failed to materialize"):
        ray_tpu.get(ref, timeout=30)


@ray_tpu.remote
class TableProbe:
    def resident(self, oid):
        from ray_tpu_torch.core import device_store
        return device_store.contains(oid)

    def make(self, n):
        import torch
        return torch.arange(n, dtype=torch.float32)


def test_free_drops_device_entry(rt):
    """free() on a device-resident ref tells the holder to drop the
    live value — device memory is reclaimed, not leaked."""
    import time
    a = TableProbe.remote()
    r1 = a.make.remote(32)
    assert ray_tpu.get(a.resident.remote(r1.id)) is True
    ray_tpu.free([r1])
    deadline = time.time() + 5
    while time.time() < deadline:
        if ray_tpu.get(a.resident.remote(r1.id)) is False:
            break
        time.sleep(0.05)
    assert ray_tpu.get(a.resident.remote(r1.id)) is False
    ray_tpu.kill(a)


# ---- beyond the reference's cases -----------------------------------------

CHAINS = r'''
import json, sys
import numpy as np
MOD = sys.argv[1]
rt = __import__(MOD)
from importlib import import_module
ds = import_module(MOD + ".core.device_store")
rt.init(num_cpus=2)

def make_value(n):
    if MOD == "ray_tpu":
        import jax.numpy as jnp
        return jnp.arange(n, dtype=jnp.float32)
    import torch
    return torch.arange(n, dtype=torch.float32)

@rt.remote
class A:
    def make(self, n):
        return make_value(n)
    def double(self, x):
        return x * 2
    def total(self, x):
        return float(x.sum())
    def counters(self):
        return dict(ds.COUNTERS)

out = []
a = A.remote()
r1 = a.make.remote(1024)
r3 = a.double.remote(a.double.remote(r1))
out.append(rt.get(a.total.remote(r3)))
out.append(rt.get(a.counters.remote()))
got = rt.get(a.double.remote(a.make.remote(16)))      # driver reads it
out.append(np.asarray(got).tolist())
out.append(rt.get(a.counters.remote()))
out.append(rt.get(a.total.remote(r1)))                # r1 still resident
out.append(rt.get(a.counters.remote()))
rt.shutdown()
print("RESULT " + json.dumps(out))
'''


def _chains(module: str, program: str = CHAINS):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", program, module], env=env,
                          capture_output=True, text=True, timeout=180,
                          cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT "):])


def test_counters_equal_the_reference_runtimes():
    ref, port = _chains("ray_tpu"), _chains("ray_tpu_torch")
    assert port == ref
    assert port[1] == {"kept_device": 3, "device_hits": 3,
                       "materialized": 0}
    assert port[3]["materialized"] == 1


MUTATE = r'''
import json, sys, warnings
import numpy as np
MOD = sys.argv[1]
rt = __import__(MOD)
rt.init(num_cpus=2)

def make_value(n):
    if MOD == "ray_tpu":
        return np.arange(n, dtype=np.float32)
    import torch
    return torch.arange(n, dtype=torch.float32)

@rt.remote
def first(x):
    return float(x[0])

out = {"warnings": []}
for name, n in (("big", 1 << 20), ("small", 16)):   # shm, inline bytes
    ref = rt.put(make_value(n))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = rt.get(ref)
        try:
            got[0] = 7.0
            mutated = True
        except ValueError:
            mutated = "ValueError"
        again = float(rt.get(ref)[0])
    out["warnings"] += [str(w.message) for w in caught]
    out[name] = {"mutated": mutated, "again": again,
                 "task": rt.get(first.remote(ref))}
rt.shutdown()
print("RESULT " + json.dumps(out))
'''


def test_mutating_a_received_tensor_acts_as_the_references_array():
    """A CPU tensor read from shared memory aliases the object, as the
    reference's numpy array does: an in-place write shows in the next
    read and in a task's (README: a consumer that mutates clones first).
    A small object held inline as bytes is copied on read, so its stored
    value never changes; the reference's array there is read-only. No
    warning is raised in either runtime."""
    ref, port = _chains("ray_tpu", MUTATE), _chains("ray_tpu_torch", MUTATE)
    assert port["big"] == ref["big"] == {"mutated": True, "again": 7.0,
                                         "task": 7.0}
    assert ref["small"] == {"mutated": "ValueError", "again": 0.0,
                            "task": 0.0}
    assert port["small"] == {"mutated": True, "again": 0.0, "task": 0.0}
    assert port["warnings"] == ref["warnings"] == []


class _CudaTensorPayload:
    """Pickles exactly as a CUDA tensor does through the port's
    serializer (its bytes, copied to the host, rebuilt with
    from_cuda=True), so a machine without a card can make one."""

    def __init__(self, t):
        self.t = t

    def __reduce__(self):
        raw = self.t.reshape(-1).view(torch.uint8).numpy()
        return (serialization._rebuild_tensor,
                (pickle.PickleBuffer(raw), str(self.t.dtype)[6:],
                 tuple(self.t.shape), False, True))


def test_tensor_from_a_card_is_read_by_a_worker_without_gpu(rt):
    """torch's own pickling of a CUDA tensor raises in a process without
    a GPU ("Attempting to deserialize object on a CUDA device"); the
    port rebuilds such a tensor on the reader's default device: here, a
    worker with no card, the CPU."""
    t = torch.arange(48, dtype=torch.bfloat16).reshape(4, 12)
    ref = ray_tpu.put(_CudaTensorPayload(t))

    @ray_tpu.remote
    def read(x):
        return (x.device.type, str(x.dtype), tuple(x.shape),
                os.environ.get("CUDA_VISIBLE_DEVICES"), x.float().sum().item())

    assert ray_tpu.get(read.remote(ref), timeout=60) == (
        "cpu", "torch.bfloat16", (4, 12), "", float(t.float().sum()))
    back = ray_tpu.get(ref)
    assert back.device.type == "cpu" and torch.equal(back, t)


def test_cpu_tensors_go_out_of_band_with_zero_copies():
    t = torch.randn(256, 1024)                          # 1 MiB
    meta, bufs = serialization.serialize({"w": t, "b": torch.ones(3)})
    assert len(bufs) == 2 and len(meta) < 1024          # bytes out of band
    assert bufs[0].raw().nbytes == t.numel() * 4
    payload = bytearray(serialization.pack_parts(meta, bufs))
    out = serialization.unpack(memoryview(payload))
    assert torch.equal(out["w"], t) and torch.equal(out["b"], torch.ones(3))
    # the rebuilt tensor aliases the payload: no copy was made
    base = np.frombuffer(payload, dtype=np.uint8).ctypes.data
    assert base <= out["w"].data_ptr() < base + len(payload)
    # bf16 (no numpy dtype), 0-d and empty tensors, and requires_grad
    odd = {"h": torch.randn(5, 3).to(torch.bfloat16),
           "s": torch.tensor(2.5), "e": torch.zeros(0, 7),
           "p": torch.nn.Parameter(torch.randn(4))}
    back = serialization.unpack(serialization.pack(odd))
    for k, v in odd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k].detach(), v.detach())
    assert type(back["p"]) is torch.nn.Parameter and back["p"].requires_grad
