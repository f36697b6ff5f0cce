"""Durable workflows on the port's runtime (ray_tpu_torch.workflow): the
workflow cases of tests/test_core_extras.py run on the port, then what
the port changes: values stored through the runtime's `pack` / `unpack`
(tensors included), equal tensor inputs giving equal salts, and tensor
literals keyed by their bytes, not by a repr that elides their middle.
This file imports nothing of JAX: the port's workers unpickle the steps
defined here."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from ray_tpu_torch.core.serialization import pack, unpack
from ray_tpu_torch.dag import InputNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runtime():
    handle = rt.init(num_cpus=4)
    yield handle
    rt.shutdown()


def _meta(workflow_id):
    return next(w for w in workflow.list_all()
                if w["workflow_id"] == workflow_id)


def test_workflow_run_and_resume(runtime, tmp_path):
    workflow.init(str(tmp_path))
    marker = str(tmp_path / "count.txt")

    @rt.remote
    def counted_double(x):
        with open(marker, "a") as f:
            f.write("x")
        return x * 2

    @rt.remote
    def plus_one(x):
        return x + 1

    with InputNode() as inp:
        dag = plus_one.bind(counted_double.bind(inp))

    out = workflow.run(dag, workflow_id="wf1", args=(5,))
    assert out == 11
    assert workflow.get_status("wf1") == "SUCCEEDED"
    assert workflow.get_output("wf1") == 11
    assert len(open(marker).read()) == 1

    # resume: steps load from the log, nothing re-executes (the output
    # step loads, so the step under it is never reached)
    out2 = workflow.resume("wf1", dag, args=(5,))
    assert out2 == 11
    assert len(open(marker).read()) == 1
    assert (_meta("wf1")["steps_run"], _meta("wf1")["steps_skipped"]) \
        == (0, 1)


def test_workflow_failure_then_resume(runtime, tmp_path):
    workflow.init(str(tmp_path))
    flag = str(tmp_path / "fail.flag")
    open(flag, "w").write("1")

    @rt.remote
    def base(x):
        return x + 100

    @rt.remote
    def maybe_fail(x, flag_path):
        if os.path.exists(flag_path):
            raise RuntimeError("injected")
        return x * 3

    with InputNode() as inp:
        dag = maybe_fail.bind(base.bind(inp), flag)

    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf2", args=(1,))
    assert workflow.get_status("wf2") == "FAILED"

    os.unlink(flag)     # clear the injected fault; base step is cached
    out = workflow.resume("wf2", dag, args=(1,))
    assert out == 303
    assert workflow.get_status("wf2") == "SUCCEEDED"
    assert (_meta("wf2")["steps_run"], _meta("wf2")["steps_skipped"]) \
        == (1, 1)


def test_workflow_different_inputs_not_replayed(runtime, tmp_path):
    """Same workflow_id + different args must re-execute input-dependent
    steps, not replay cached results computed from the old inputs."""
    workflow.init(str(tmp_path))

    @rt.remote
    def double(x):
        return x * 2

    with InputNode() as inp:
        dag = double.bind(inp)

    assert workflow.run(dag, workflow_id="wf3", args=(5,)) == 10
    assert workflow.run(dag, workflow_id="wf3", args=(7,)) == 14


def test_workflow_identical_siblings_run_separately(runtime, tmp_path):
    workflow.init(str(tmp_path))
    marker = str(tmp_path / "sib.txt")

    @rt.remote
    def stamp(x):
        with open(marker, "a") as f:
            f.write("s")
        import time as _t
        return _t.monotonic_ns()

    @rt.remote
    def pair(a, b):
        return a, b

    with InputNode() as inp:
        dag = pair.bind(stamp.bind(inp), stamp.bind(inp))
    a, b = workflow.run(dag, workflow_id="wfsib", args=(0,))
    assert a != b                       # two separate executions
    assert len(open(marker).read()) == 2


def test_tensor_step_values_go_through_pack(runtime, tmp_path):
    """Each step's value and the output are the runtime's `pack` bytes
    on disk; `unpack` of them, and `get_output` in a fresh process, give
    the tensors back bit for bit (bf16 too, which numpy has no type
    for)."""
    workflow.init(str(tmp_path))

    @rt.remote
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(64, 48, generator=g).to(torch.bfloat16),
                "b": torch.randn(48, generator=g)}

    @rt.remote
    def checksum(t):
        return t["w"].float().sum(0) + t["b"]

    with InputNode() as inp:
        dag = checksum.bind(make.bind(inp))
    out = workflow.run(dag, workflow_id="wft", args=(3,))
    steps = sorted(os.listdir(tmp_path / "wft" / "steps"))
    assert len(steps) == 2 and all(s.endswith(".bin") for s in steps)
    stored = [unpack((tmp_path / "wft" / "steps" / s).read_bytes())
              for s in steps]
    made = next(v for v in stored if isinstance(v, dict))
    assert made["w"].dtype == torch.bfloat16
    assert torch.equal(made["w"].float().sum(0) + made["b"], out)
    raw = (tmp_path / "wft" / "output.bin").read_bytes()
    assert raw == pack(out)
    prog = ("import sys, torch; from ray_tpu_torch import workflow; "
            "workflow.init(sys.argv[1]); t = workflow.get_output('wft'); "
            "print(t.dtype, t.device, t.numpy().tobytes().hex())")
    res = subprocess.run(
        [sys.executable, "-c", prog, str(tmp_path)], capture_output=True,
        text=True, timeout=120, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    dtype, device, hexed = res.stdout.split()
    assert (dtype, device) == ("torch.float32", "cpu")
    assert hexed == out.numpy().tobytes().hex()


def test_equal_tensor_inputs_give_equal_salts(runtime, tmp_path):
    """The input salt is a digest of the runtime's serialization: two
    equal tensors (distinct objects) salt alike, a one-element change
    does not, and a rerun with an equal tensor replays every step."""
    a = torch.arange(4096, dtype=torch.float32)
    b = a.clone()
    c = a.clone()
    c[2048] += 1
    assert workflow._input_digest((a,), {}) == \
        workflow._input_digest((b,), {})
    assert workflow._input_digest((a,), {}) != \
        workflow._input_digest((c,), {})
    assert workflow._input_digest((), {"x": a}) == \
        workflow._input_digest((), {"x": b})

    workflow.init(str(tmp_path))

    @rt.remote
    def total(t):
        return float(t.sum())

    with InputNode() as inp:
        dag = total.bind(inp)
    assert workflow.run(dag, workflow_id="wfs", args=(a,)) == float(a.sum())
    assert workflow.run(dag, workflow_id="wfs", args=(b,)) == float(a.sum())
    assert _meta("wfs")["steps_run"] == 0
    assert workflow.run(dag, workflow_id="wfs", args=(c,)) == float(c.sum())
    assert _meta("wfs")["steps_run"] == 1


@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_literals_that_repr_alike_get_different_step_keys(runtime, tmp_path,
                                                          kind):
    """Two literals past repr's 1000-element cut that differ only in the
    elided middle: the reference's repr keys would match, so one step
    would replay the other's value; the port keys them by their bytes."""
    x = np.zeros(2000, np.float32)
    y = x.copy()
    y[1000] = 1.0
    if kind == "tensor":
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    assert repr(x) == repr(y)
    workflow.init(str(tmp_path))

    @rt.remote
    def total(t):
        return float(t.sum())

    keys = {workflow._step_key(total.bind(v), []) for v in (x, y)}
    assert len(keys) == 2
    assert workflow.run(total.bind(x), workflow_id="wfl") == 0.0
    assert workflow.run(total.bind(y), workflow_id="wfl") == 1.0
    assert _meta("wfl")["steps_run"] == 1
    assert len(os.listdir(tmp_path / "wfl" / "steps")) == 2
    # the same literal again is a replay
    assert workflow.run(total.bind(y.clone() if kind == "tensor"
                                   else y.copy()),
                        workflow_id="wfl") == 1.0
    assert _meta("wfl")["steps_run"] == 0
    assert json.loads((tmp_path / "wfl" / "meta.json").read_text())[
        "status"] == "SUCCEEDED"
