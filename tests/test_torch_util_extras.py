"""The port's util and experimental modules and its local cluster against
the reference's: one user program runs once under `ray_tpu` and once
under `ray_tpu_torch`, each in a subprocess of its own (never two
runtimes in one process), and each case's JSON result must be equal.

The cases are those of tests/test_observability.py (ActorPool, Queue),
tests/test_util_pool.py (Pool, check_serialize, internal_kv) and
tests/test_joblib.py, `experimental.tqdm_ray`, and a two-node
`cluster_utils.Cluster`. The programs run with RAY_TPU_GPUS=1, so the
port's head counts one (faked) card; its agent is started with
`--num-gpus 0` and the cluster's GPU total stays 1 (the reference has
no GPU resource).
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r'''
import io, json, sys, threading, time
from contextlib import redirect_stderr, redirect_stdout
from importlib import import_module
import numpy as np
pkg = sys.argv[1]
rt = import_module(pkg)
ActorPool = import_module(pkg + ".util.actor_pool").ActorPool
qmod = import_module(pkg + ".util.queue")
Pool = import_module(pkg + ".util.multiprocessing").Pool
check_serialize = import_module(pkg + ".util.check_serialize")
kv = import_module(pkg + ".experimental.internal_kv")
tqdm_ray = import_module(pkg + ".experimental.tqdm_ray")
joblib_backend = import_module(pkg + ".util.joblib_backend")
cluster_utils = import_module(pkg + ".cluster_utils")
strategies = import_module(pkg + ".util.scheduling_strategies")
import joblib

out = {}


ACTORS = []


def case(fn):
    """Run one case now; its actors are killed after it."""
    try:
        out[fn.__name__] = fn()
    except Exception as e:
        out[fn.__name__] = ["raised", type(e).__name__, str(e)[:200]]
    while ACTORS:
        rt.kill(ACTORS.pop())
    return fn


def doublers(n):
    ACTORS.extend(Doubler.remote() for _ in range(n))
    return ACTORS[-n:]


@rt.remote
class Doubler:
    def double(self, x):
        return 2 * x


def sq(x):
    return x * x


def addmul(a, b):
    return a + b, a * b


def rowsum(arr):
    return float(arr.sum())


rt.init(num_cpus=4)


@case
def queue_fifo_and_batch():
    q = qmod.Queue(maxsize=4)
    for i in range(3):
        q.put(i)
    got = [q.qsize(), [q.get() for _ in range(3)], q.empty()]
    try:
        q.get_nowait()
        got.append("no raise")
    except qmod.Empty:
        got.append("Empty")
    q.put_nowait_batch([7, 8])
    got.append(q.get_nowait_batch(5))
    q.shutdown()
    return got


@case
def queue_cross_task():
    q = qmod.Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i * 10)
        return n

    n = rt.get(producer.remote(q, 3))
    got = [n, sorted(q.get() for _ in range(3))]
    q.shutdown()
    return got


@case
def actor_pool_ordered_and_unordered():
    pool = ActorPool(doublers(2))
    ordered = list(pool.map(lambda a, v: a.double.remote(v), range(5)))
    unordered = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                          range(5)))
    return [ordered, unordered]


@case
def actor_pool_more_work_than_actors():
    pool = ActorPool(doublers(1))
    for v in range(4):
        pool.submit(lambda a, v: a.double.remote(v), v)
    return [[pool.get_next() for _ in range(4)], pool.has_next()]


@case
def actor_pool_survives_task_error():
    @rt.remote
    def boom(a, v):
        raise ValueError("kaboom")

    pool = ActorPool(doublers(1))
    pool.submit(lambda a, v: a.double.remote(v), 1)
    pool.submit(lambda a, v: boom.remote(a, v), 2)
    pool.submit(lambda a, v: a.double.remote(v), 3)
    got = [pool.get_next()]
    try:
        pool.get_next()
        got.append("no raise")
    except Exception as e:
        got.append("kaboom" in str(e))
    got += [pool.get_next(), pool.has_next()]
    return got


@case
def pool_map():
    with Pool(processes=4) as p:
        return p.map(sq, range(20), chunksize=5)


@case
def pool_starmap_and_chunksize():
    with Pool(processes=2) as p:
        return [list(r) for r in p.starmap(addmul, [(1, 2), (3, 4)],
                                           chunksize=1)]


@case
def pool_imap_and_unordered():
    with Pool(processes=4) as p:
        return [list(p.imap(sq, range(10), chunksize=2)),
                sorted(p.imap_unordered(sq, range(10), chunksize=3))]


@case
def pool_apply_and_async():
    with Pool(processes=2) as p:
        got = [list(p.apply(addmul, (2, 5)))]
        ar = p.apply_async(sq, (9,))
        ar.wait(timeout=30)
        got += [ar.ready(), ar.get(timeout=30), ar.successful()]
    return got


@case
def pool_closed_rejects_work():
    p = Pool(processes=2)
    p.close()
    p.join()
    try:
        p.map(sq, [1, 2])
        return "no raise"
    except ValueError:
        return "ValueError"


@case
def inspect_serializability():
    ok, failures = check_serialize.inspect_serializability(lambda x: x + 1)
    got = [ok, len(failures)]
    lock = threading.Lock()

    def uses_lock():
        return lock

    ok, failures = check_serialize.inspect_serializability(uses_lock)
    return got + [ok, any("lock" in f.name for f in failures)]


@case
def inspect_serializability_cycle():
    class A:
        pass

    a, b = A(), A()
    a.other, b.other = b, a
    a.lock = threading.Lock()
    b.lock = threading.Lock()
    ok, failures = check_serialize.inspect_serializability(a, name="a")
    return [ok, bool(failures)]


@case
def internal_kv_driver_and_worker():
    got = [kv._internal_kv_initialized(),
           kv._internal_kv_put("k1", b"v1"),
           kv._internal_kv_put("k1", b"v2", overwrite=False),
           kv._internal_kv_get("k1").decode(),
           kv._internal_kv_put("k1", b"v3"),
           kv._internal_kv_get("k1").decode(),
           kv._internal_kv_exists("k1")]
    kv._internal_kv_put("k1", b"other", namespace="ns2")
    got += [kv._internal_kv_get("k1").decode(),
            kv._internal_kv_get("k1", namespace="ns2").decode()]
    kv._internal_kv_put("pfx/a", b"1")
    kv._internal_kv_put("pfx/b", b"2")
    got += [sorted(k.decode() for k in kv._internal_kv_list("pfx/")),
            kv._internal_kv_del("pfx/", del_by_prefix=True),
            kv._internal_kv_del("k1"), kv._internal_kv_exists("k1")]

    @rt.remote
    def worker_kv():
        wkv = import_module(pkg + ".experimental.internal_kv")
        wkv._internal_kv_put("from-worker", b"hello")
        return wkv._internal_kv_get("from-worker")

    got += [rt.get(worker_kv.remote(), timeout=30).decode(),
            kv.kv_get("from-worker").decode()]
    return got


@case
def joblib_parallel_over_runtime():
    joblib_backend.register_ray_tpu()
    with joblib.parallel_backend(pkg):
        return joblib.Parallel(n_jobs=4)(
            joblib.delayed(sq)(i) for i in range(20))


@case
def joblib_arrays_and_n_jobs_cap():
    joblib_backend.register_ray_tpu()
    rows = [np.full(100, i, dtype=np.float64) for i in range(8)]
    with joblib.parallel_backend(pkg):
        return joblib.Parallel(n_jobs=-1)(
            joblib.delayed(rowsum)(r) for r in rows)


@case
def joblib_error_propagates():
    joblib_backend.register_ray_tpu()

    def boom(i):
        raise RuntimeError(f"joblib-boom-{i}")

    with joblib.parallel_backend(pkg):
        try:
            joblib.Parallel(n_jobs=2)(
                joblib.delayed(boom)(i) for i in range(3))
            return "no raise"
        except Exception as e:
            return "joblib-boom" in str(e)


@case
def tqdm_ray_bars():
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(buf):
        total = sum(tqdm_ray.tqdm(range(5), desc="sum"))
        bar = tqdm_ray.tqdm(total=3, desc="manual")
        bar.update(2)
        bar.set_description("renamed")
        bar.update(1)
        bar.close()
        tqdm_ray.safe_print("plain", 1)
    lines = buf.getvalue().splitlines()
    return [total, bar.n, bar.desc, "plain 1" in lines,
            any("sum" in ln and "5/5" in ln for ln in lines),
            any("renamed" in ln and "3/3" in ln for ln in lines)]


rt.shutdown()


@case
def cluster_two_nodes():
    cluster = cluster_utils.Cluster(head_cpus=2)
    try:
        head = rt.get_runtime_context().node_id
        agent = cluster.add_node(num_cpus=2)
        res = rt.cluster_resources()

        @rt.remote(num_cpus=1)
        def where():
            import os     # a worker's node, as its node stamped it
            return os.environ.get("RAY_TPU_NODE_ID")

        on_agent = rt.get(where.options(
            scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
                agent, soft=False)).remote(), timeout=60)
        got = {"cpus": res.get("CPU"), "nodes": len(rt.nodes()),
               "agent_ran": on_agent == agent, "head_is_not_agent":
               head != agent, "gpus": res.get("GPU", 0)}
        if pkg == "ray_tpu_torch":
            @rt.remote(num_gpus=1)
            def gpu_where():
                import os
                return [os.environ.get("RAY_TPU_NODE_ID"), rt.get_gpu_ids()]

            node, ids = rt.get(gpu_where.remote(), timeout=60)
            got["gpu_task"] = [node == head, ids]
    finally:
        agents = list(cluster._agents)
        cluster.shutdown()
    got["agents_left"] = sum(p.poll() is None for p in agents)
    return got


print("RESULT " + json.dumps(out))
'''


def _spawn(pkg):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               RAY_TPU_GPUS="1")
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
    """Both programs at once (each its own runtime and processes)."""
    procs = {pkg: _spawn(pkg) for pkg in ("ray_tpu", "ray_tpu_torch")}
    try:
        return {pkg: _result(p, pkg) for pkg, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


WANT = {
    "queue_fifo_and_batch": [3, [0, 1, 2], True, "Empty", [7, 8]],
    "queue_cross_task": [3, [0, 10, 20]],
    "actor_pool_ordered_and_unordered": [[0, 2, 4, 6, 8], [0, 2, 4, 6, 8]],
    "actor_pool_more_work_than_actors": [[0, 2, 4, 6], False],
    "actor_pool_survives_task_error": [2, True, 6, False],
    "pool_map": [i * i for i in range(20)],
    "pool_starmap_and_chunksize": [[3, 2], [7, 12]],
    "pool_imap_and_unordered": [[i * i for i in range(10)],
                                sorted(i * i for i in range(10))],
    "pool_apply_and_async": [[7, 10], True, 81, True],
    "pool_closed_rejects_work": "ValueError",
    "inspect_serializability": [True, 0, False, True],
    "inspect_serializability_cycle": [False, True],
    "internal_kv_driver_and_worker": [
        True, False, True, "v1", True, "v3", True, "v3", "other",
        ["pfx/a", "pfx/b"], 2, 1, False, "hello", "hello"],
    "joblib_parallel_over_runtime": [i * i for i in range(20)],
    "joblib_arrays_and_n_jobs_cap": [100.0 * i for i in range(8)],
    "joblib_error_propagates": True,
    "tqdm_ray_bars": [10, 3, "renamed", True, True, True],
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_same_case_same_result(runs, name):
    assert runs["ray_tpu_torch"][name] == runs["ray_tpu"][name]
    assert runs["ray_tpu_torch"][name] == WANT[name]


def test_cluster_counts_the_host_card_once(runs):
    """add_node passes --num-gpus 0: the agent inherits RAY_TPU_GPUS=1
    but adds no card, so the cluster has the head's one; a num_gpus=1
    task runs on the head, a task pinned to the agent runs there, and
    shutdown leaves no agent."""
    ref, port = runs["ray_tpu"]["cluster_two_nodes"], \
        runs["ray_tpu_torch"]["cluster_two_nodes"]
    gpu_task = port.pop("gpu_task")
    port_gpus = port.pop("gpus")
    ref.pop("gpus")
    assert port == ref
    assert port == {"cpus": 4.0, "nodes": 2, "agent_ran": True,
                    "head_is_not_agent": True, "agents_left": 0}
    assert port_gpus == 1.0
    assert gpu_task == [True, [0]]
