"""Cross-language C++ tasks/actors on the port's runtime
(ray_tpu_torch.cross_language): tests/test_cross_language.py's cases on
the port. The example library is built once with g++ against the port's
copy of the header (`-I ray_tpu_torch/_native`); the wire format is the
reference's byte for byte, held here by encoding every codec case with
both packages. A torch tensor raises TypeError, as a jax.Array does in
the reference."""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray_tpu
from ray_tpu import cross_language as ref_xl
from ray_tpu_torch import cross_language as xl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt():
    handle = ray_tpu.init(num_cpus=8)
    yield handle
    ray_tpu.shutdown()


@pytest.fixture(scope="session")
def mathlib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("xl") / "libmathlib.so"
    src = f"{REPO}/examples/cpp_tasks/mathlib.cc"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         "-I", f"{REPO}/ray_tpu_torch/_native", src, "-o", str(out)],
        check=True, capture_output=True, timeout=120)
    return str(out)


# ------------------------------------------------------------- codec-only
# (no compiler needed: Python encode/decode round-trips)

CODEC_CASES = [
    None, True, False, 0, -7, 2**40, 3.5, -0.0, "héllo", b"\x00\xffraw",
    [1, "two", 3.0, None], {"a": 1, "b": [True, {"c": b"x"}]},
    (1, 2),  # tuples encode as lists
]


@pytest.mark.parametrize("obj", CODEC_CASES,
                         ids=[repr(c)[:24] for c in CODEC_CASES])
def test_codec_roundtrip(obj):
    assert xl.encode(obj) == ref_xl.encode(obj)
    got = xl.decode(xl.encode(obj))
    expected = list(obj) if isinstance(obj, tuple) else obj
    assert got == expected


@pytest.mark.parametrize("dtype", [
    np.float32, np.float64, np.int8, np.int32, np.int64,
    np.uint8, np.uint32, np.uint64, np.bool_])
def test_codec_ndarray_roundtrip(dtype):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 4)) * 10).astype(dtype)
    assert xl.encode(arr) == ref_xl.encode(arr)
    got = xl.decode(xl.encode(arr))
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)


def test_codec_rejects_unsupported():
    with pytest.raises(TypeError, match="cannot cross"):
        xl.encode(object())
    with pytest.raises(TypeError, match="arrays support"):
        xl.encode(np.zeros(2, dtype=np.complex64))
    with pytest.raises(TypeError, match="int64 wire range"):
        xl.encode(2**63)


def test_codec_rejects_torch_tensors():
    with pytest.raises(TypeError, match="numpy"):
        xl.encode(torch.zeros(3))
    with pytest.raises(TypeError, match="numpy"):
        xl.encode([1, {"w": torch.nn.Parameter(torch.ones(2))}])


def test_cpp_task_tensor_argument_raises(mathlib, rt):
    scale = xl.cpp_function(mathlib, "scale")
    # the worker's TypeError comes back wrapped, as C++ errors do
    with pytest.raises(Exception, match="TypeError.*numpy"):
        ray_tpu.get(scale.remote(torch.arange(4.0), 2.0))
    out = ray_tpu.get(scale.remote(torch.arange(4.0).double().numpy(), 2.0))
    np.testing.assert_array_equal(out, np.arange(4.0) * 2)


def test_codec_truncated_array_payload():
    wire = xl.encode(np.arange(8, dtype=np.float64))
    with pytest.raises(xl.CrossLanguageError, match="truncated"):
        xl.decode(wire[:-8])


def test_codec_numpy_scalars():
    assert xl.decode(xl.encode(np.bool_(True))) is True
    assert xl.decode(xl.encode(np.int32(-5))) == -5
    assert xl.decode(xl.encode(np.float32(1.5))) == pytest.approx(1.5)


# ------------------------------------------------------------------ tasks

def test_manifest(mathlib):
    m = xl.manifest(mathlib)
    assert set(m["functions"]) >= {"add", "dot", "scale", "describe", "fail"}
    assert set(m["actors"]) >= {"Counter", "Stats"}


def test_cpp_task_basic(mathlib, rt):
    add = xl.cpp_function(mathlib, "add")
    assert ray_tpu.get(add.remote(2, 3)) == 5
    assert ray_tpu.get(add.remote(-10, 4)) == -6


def test_cpp_task_ndarray(mathlib, rt):
    dot = xl.cpp_function(mathlib, "dot")
    x = np.arange(64, dtype=np.float64)
    y = np.ones(64, dtype=np.float64)
    assert ray_tpu.get(dot.remote(x, y)) == pytest.approx(x.sum())

    scale = xl.cpp_function(mathlib, "scale")
    out = ray_tpu.get(scale.remote(x, 2.5))
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    np.testing.assert_allclose(out, x * 2.5)


def test_cpp_task_compose_with_python(mathlib, rt):
    """ObjectRef args from Python tasks resolve before the C++ call, and
    C++ results feed Python tasks — full interop through the runtime."""
    @ray_tpu.remote
    def make(n):
        return np.full(n, 2.0)

    @ray_tpu.remote
    def total(arr):
        return float(arr.sum())

    scale = xl.cpp_function(mathlib, "scale")
    scaled = scale.remote(make.remote(8), 3.0)   # ref arg into C++
    assert ray_tpu.get(total.remote(scaled)) == pytest.approx(48.0)


def test_cpp_task_error_propagates(mathlib, rt):
    fail = xl.cpp_function(mathlib, "fail")
    with pytest.raises(Exception, match="custom message"):
        ray_tpu.get(fail.remote("custom message"))

    missing = xl.cpp_function(mathlib, "no_such_fn")
    with pytest.raises(Exception, match="no cross-language function"):
        ray_tpu.get(missing.remote())


def test_cpp_task_structured_values(mathlib, rt):
    describe = xl.cpp_function(mathlib, "describe")
    out = ray_tpu.get(describe.remote(1, "s", [1, 2], {"k": None}))
    assert out["n_args"] == 4 and len(out["kinds"]) == 4


# ----------------------------------------------------------------- actors

def test_cpp_actor_stateful(mathlib, rt):
    Counter = xl.cpp_actor(mathlib, "Counter", methods=("inc", "get"))
    c = Counter.remote(10)
    assert ray_tpu.get(c.inc.remote()) == 11
    assert ray_tpu.get(c.inc.remote(5)) == 16
    assert ray_tpu.get(c.get.remote()) == 16
    # independent instances
    d = Counter.remote()
    assert ray_tpu.get(d.get.remote()) == 0
    assert ray_tpu.get(c.get.remote()) == 16


def test_cpp_actor_array_state(mathlib, rt):
    Stats = xl.cpp_actor(mathlib, "Stats",
                         methods=("observe", "mean", "var"))
    s = Stats.remote()
    data = np.array([1.0, 2.0, 3.0, 4.0])
    assert ray_tpu.get(s.observe.remote(data)) == 4
    assert ray_tpu.get(s.mean.remote()) == pytest.approx(2.5)
    assert ray_tpu.get(s.var.remote()) == pytest.approx(np.var(data, ddof=1))


def test_cpp_actor_generic_invoke_and_manifest_check(mathlib, rt):
    Counter = xl.cpp_actor(mathlib, "Counter")  # manifest-validated
    c = Counter.remote(3)
    assert ray_tpu.get(c.invoke.remote("inc", 4)) == 7
    with pytest.raises(xl.CrossLanguageError, match="no actor class"):
        xl.cpp_actor(mathlib, "Ghost")


def test_cpp_actor_closed_handle_raises(mathlib, rt):
    Counter = xl.cpp_actor(mathlib, "Counter", methods=("inc", "get"))
    c = Counter.remote()
    assert ray_tpu.get(c.inc.remote()) == 1
    ray_tpu.get(c.close.remote())
    with pytest.raises(Exception, match="closed"):
        ray_tpu.get(c.get.remote())


def test_cpp_actor_close_defers_until_calls_drain(mathlib, rt):
    """close() racing in-flight methods on a concurrent actor must not
    delete the C++ object mid-call (deferred-deletion refcount)."""
    Counter = xl.cpp_actor(mathlib, "Counter", methods=("inc", "get"),
                           max_concurrency=4)
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(20)]
    c.close.remote()  # races the incs on the worker's thread pool
    done = 0
    for r in refs:
        try:
            ray_tpu.get(r)
            done += 1
        except Exception as e:  # closed-handle rejections are orderly
            assert "closed" in str(e)
    assert done >= 1  # at least the in-flight ones completed, no segfault
    with pytest.raises(Exception, match="closed"):
        ray_tpu.get(c.get.remote())


def test_cpp_actor_bad_method(mathlib, rt):
    Counter = xl.cpp_actor(mathlib, "Counter", methods=("bogus",))
    c = Counter.remote()
    with pytest.raises(Exception, match="unknown method"):
        ray_tpu.get(c.bogus.remote())
