"""The port's runtime (ray_tpu_torch.core, api.py, dag.py) against the
reference runtime: one user program runs once under `ray_tpu` and once
under `ray_tpu_torch`, each in a subprocess of its own (the two runtimes
read the same RAY_TPU_* environment and the node sets os.environ), and
their JSON results must be equal. The port's run also reports what it
left behind after `shutdown`: no worker process and no /dev/shm segment
of its own prefix (`rtpt_`). Every knob the port declares has a reader
in the port.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r'''
import glob, json, os, sys, time
import numpy as np
import psutil
rt = __import__(sys.argv[1])
from importlib import import_module
exc = import_module(sys.argv[1] + ".exceptions")
pgmod = import_module(sys.argv[1] + ".util.placement_group")
dagmod = import_module(sys.argv[1] + ".dag")
prefix = sys.argv[2]
before = set(glob.glob(f"/dev/shm/{prefix}*"))
rt.init(num_cpus=4)
out = {}

@rt.remote
def square(x):
    return x * x

@rt.remote
def fan(n):
    return sum(rt.get([square.remote(i) for i in range(n)]))

@rt.remote(num_returns=3)
def three(x):
    return x, x + 1, x + 2

@rt.remote
def boom():
    raise ValueError("bad input 7")

@rt.remote
def inspect(a):
    # zero-copy: the array owns no data; its base chain ends in a view
    # of the node's shared memory
    chain, b = [], a
    while b is not None and len(chain) < 8:
        chain.append(type(b).__name__)
        b = b.obj if isinstance(b, memoryview) else getattr(b, "base", None)
    return [a.shape[0], str(a.dtype), bool(a.flags.owndata),
            "memoryview" in chain, bool(a.flags.writeable),
            float(a[:10].sum())]

@rt.remote
def sleeper(t):
    time.sleep(t)
    return t

@rt.remote
class Counter:
    def __init__(self, start):
        self.n = start
    def add(self, k):
        self.n += k
        return self.n

@rt.remote
def stage1(x):
    return x + 1

@rt.remote
def stage2(x):
    return x * 10

out["tasks"] = rt.get([square.remote(i) for i in range(6)])
out["nested"] = rt.get(fan.remote(5))
out["num_returns"] = rt.get(list(three.remote(10)))
try:
    rt.get(boom.remote())
    out["error"] = None
except exc.TaskError as e:
    out["error"] = [type(e).__name__, "ValueError" in str(e),
                    "bad input 7" in str(e)]
c = Counter.remote(5)
out["actor"] = rt.get([c.add.remote(1), c.add.remote(2), c.add.remote(3)])
named = Counter.options(name="ctr").remote(100)
h = rt.get_actor("ctr")
out["named"] = rt.get(h.add.remote(1))
rt.kill(named)
try:
    rt.get(h.add.remote(1), timeout=30)
    out["killed"] = None
except exc.RayTpuError as e:
    out["killed"] = type(e).__name__
arr = np.arange(1 << 20, dtype=np.float32)           # 4 MB
ref = rt.put(arr)
back = rt.get(ref)
out["put_get"] = [back.shape[0], bool(np.array_equal(back, arr))]
out["zero_copy_in_task"] = rt.get(inspect.remote(ref))
refs = [sleeper.remote(0.0), sleeper.remote(30.0)]
ready, pending = rt.wait(refs, num_returns=1, timeout=20)
out["wait"] = [len(ready), len(pending), rt.get(ready[0])]
rt.cancel(pending[0], force=True)
try:
    rt.get(pending[0], timeout=30)
    out["cancel"] = None
except (exc.TaskCancelledError, exc.WorkerCrashedError, exc.TaskError) as e:
    out["cancel"] = type(e).__name__
pg = pgmod.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
out["pg_ready"] = pg.wait(30)
out["pg_task"] = rt.get(square.options(placement_group=pg,
                                       bundle_index=1).remote(9))
pgmod.remove_placement_group(pg)
with dagmod.InputNode() as inp:
    dag = stage2.bind(stage1.bind(inp))
comp = dag.experimental_compile()
out["dag"] = [rt.get(comp.execute(i)) for i in range(3)]
comp.close()
me = psutil.Process()
rt.shutdown()
deadline = time.time() + 20
while time.time() < deadline:
    kids = [p for p in me.children(recursive=True)
            if "core.worker" in " ".join(p.cmdline())]
    left = sorted(set(glob.glob(f"/dev/shm/{prefix}*")) - before)
    left = [s for s in left if "_arena_" not in s
            or s.startswith(f"/dev/shm/{prefix}arena_{os.getpid()}_")]
    if not kids and not left:
        break
    time.sleep(0.2)
print("RESULT " + json.dumps(
    {"out": out, "workers_left": len(kids), "shm_left": left}))
'''


def _run(module: str, prefix: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM, module, prefix], env=env,
        capture_output=True, text=True, timeout=240, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, (
        f"{module} run failed (rc {proc.returncode}):\n"
        f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def test_same_program_same_results_and_nothing_left():
    ref = _run("ray_tpu", "rtpu_")
    port = _run("ray_tpu_torch", "rtpt_")
    assert port["out"] == ref["out"]
    out = port["out"]
    assert out["tasks"] == [0, 1, 4, 9, 16, 25]
    assert out["nested"] == 30
    assert out["error"] == ["TaskError", True, True]
    # a view of shared memory, not a copy (writable in both runtimes)
    assert out["zero_copy_in_task"][:4] == [1 << 20, "float32", False, True]
    assert out["dag"] == [10, 20, 30]
    assert port["workers_left"] == 0
    assert port["shm_left"] == []


def _knob_readers(root_dir):
    """{knob: [files under root_dir that name it outside a _declare]}."""
    from ray_tpu_torch.util import knobs
    readers = {}
    for root, _, files in os.walk(root_dir):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            declared = {id(c.args[0]) for c in ast.walk(tree)
                        if isinstance(c, ast.Call)
                        and getattr(c.func, "id", None) == "_declare"}
            for c in ast.walk(tree):
                if (isinstance(c, ast.Constant) and c.value in knobs.REGISTRY
                        and id(c) not in declared):
                    readers.setdefault(c.value, []).append(
                        os.path.relpath(path, REPO))
    return readers


def test_every_declared_knob_has_a_reader():
    """`python -m ray_tpu_torch.util.knobs` publishes every declared knob,
    so a declaration that no port module reads tells users they control
    something they do not."""
    from ray_tpu_torch.util import knobs
    read = _knob_readers(os.path.join(REPO, "ray_tpu_torch"))
    assert sorted(set(knobs.REGISTRY) - set(read)) == []


@pytest.mark.parametrize("knob,reader", [
    ("RAY_TPU_DATA_INFLIGHT_BYTES", "data/executor.py"),
    ("RAY_TPU_DATA_SERVICE_MIN_WORKERS", "data/service.py"),
    ("RAY_TPU_DATA_SERVICE_MAX_WORKERS", "data/service.py"),
    ("RAY_TPU_DATA_SERVICE_LEASE_S", "data/service.py"),
    ("RAY_TPU_DATA_SERVICE_TICK_S", "data/service.py"),
    ("RAY_TPU_DATA_SERVICE_PRODUCE_AHEAD", "data/service.py"),
    ("RAY_TPU_DATA_SERVICE_POLL_S", "data/service.py")])
def test_data_knobs_declared_beside_their_readers(knob, reader):
    """The data plane's seven knobs (the reference's names) are declared
    and read by the data module that uses them."""
    from ray_tpu_torch.util import knobs
    assert knob in knobs.REGISTRY
    assert reader in knobs.REGISTRY[knob].doc
    read = _knob_readers(os.path.join(REPO, "ray_tpu_torch", "data"))
    assert os.path.join("ray_tpu_torch", reader) in read.get(knob, [])


@pytest.mark.parametrize("knob,reader", [
    ("RAY_TPU_SERVE_HEALTH_PERIOD_S", "serve/controller.py"),
    ("RAY_TPU_SERVE_HEALTH_TIMEOUT_S", "serve/controller.py"),
    ("RAY_TPU_SERVE_HEALTH_THRESHOLD", "serve/controller.py"),
    ("RAY_TPU_SERVE_REQUEST_TIMEOUT_S", "serve/config.py"),
    ("RAY_TPU_SERVE_AFFINITY_BOUND", "serve/router.py"),
    ("RAY_TPU_SERVE_AFFINITY_SESSIONS", "serve/router.py")])
def test_serve_knobs_declared_beside_their_readers(knob, reader):
    """The serve plane's six knobs (the reference's names) are declared
    and read by the serve module that uses them."""
    from ray_tpu_torch.util import knobs
    assert knob in knobs.REGISTRY
    assert reader in knobs.REGISTRY[knob].doc
    read = _knob_readers(os.path.join(REPO, "ray_tpu_torch", "serve"))
    assert os.path.join("ray_tpu_torch", reader) in read.get(knob, [])
