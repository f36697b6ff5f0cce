"""Cross-language C++ tasks and actors (counterpart of
ray_tpu/cross_language.py).

Reference parity: ``ray.cross_language`` + the Ray C++ worker API
(reference: python/ray/cross_language.py — ``java_function`` /
``cpp_function`` descriptors; cpp/include/ray/api.h).  Ray routes a
cross-language call to a dedicated C++ worker process speaking the raylet
protocol.  Here, as in the reference, C++ runs IN-PROCESS: the scheduler
places the task/actor on an ordinary worker exactly like any other
(resources, placement groups, retries, lineage all apply), and the worker
``dlopen``s the user's shared library and calls through the stable C ABI
declared in ``ray_tpu_torch/_native/cross_lang.hpp`` (the reference's
header, copied; the wire format below is the reference's byte for byte,
so one library serves both packages).  A task with no GPU resources runs
in a worker with ``CUDA_VISIBLE_DEVICES=""``.

Usage::

    import ray_tpu_torch as rt
    from ray_tpu_torch import cross_language as xl

    add = xl.cpp_function("libmy.so", "add")
    rt.get(add.remote(2, 3))                           # -> 5

    Counter = xl.cpp_actor("libmy.so", "Counter", methods=("inc", "get"))
    c = Counter.remote(10)
    rt.get(c.inc.remote())                             # -> 11

Value interchange (both directions): None, bool, int, float, str, bytes,
list/tuple, dict, numpy ndarray (f32/f64/i8/i32/i64/u8/u32/u64/bool).
A torch tensor raises TypeError, as a jax.Array does in the reference:
pass ``t.cpu().numpy()``.  ObjectRef arguments work like on any task —
the worker resolves them before invoking the C++ function.  Errors raised
in C++ (or unknown function/class names) surface to the caller as
``CrossLanguageError`` wrapped in the normal ``TaskError`` machinery.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .exceptions import RayTpuError

__all__ = [
    "CrossLanguageError", "cpp_function", "cpp_actor", "manifest",
    "encode", "decode",
]


class CrossLanguageError(RayTpuError):
    """An error raised inside a cross-language C++ function/actor."""


# ------------------------------------------------------------------ codec
# Wire format shared with _native/cross_lang.hpp (see header comment there).

_DTYPE_TO_CODE = {
    np.dtype(np.float32): 1, np.dtype(np.float64): 2,
    np.dtype(np.int8): 3, np.dtype(np.int32): 4, np.dtype(np.int64): 5,
    np.dtype(np.uint8): 6, np.dtype(np.uint32): 7, np.dtype(np.uint64): 8,
    np.dtype(np.bool_): 9,
}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}

_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _encode_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"N"
    elif isinstance(obj, (bool, np.bool_)):
        out += b"T" if obj else b"F"
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if not -(1 << 63) <= v < (1 << 63):
            raise TypeError(
                f"int {v} exceeds the cross-language int64 wire range")
        out += b"i" + _I64.pack(v)
    elif isinstance(obj, (float, np.floating)):
        out += b"d" + _F64.pack(float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += b"s" + _U32.pack(len(raw)) + raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += b"b" + _U32.pack(len(raw)) + raw
    elif isinstance(obj, (list, tuple)):
        out += b"l" + _U32.pack(len(obj))
        for item in obj:
            _encode_into(item, out)
    elif isinstance(obj, dict):
        out += b"m" + _U32.pack(len(obj))
        for k, v in obj.items():
            _encode_into(k, out)
            _encode_into(v, out)
    elif type(obj).__module__.startswith("torch"):
        raise TypeError(
            f"{type(obj).__name__} cannot cross the C++ boundary; pass a "
            f"numpy array (t.cpu().numpy())")
    elif isinstance(obj, np.ndarray):
        code = _DTYPE_TO_CODE.get(obj.dtype)
        if code is None:
            raise TypeError(
                f"cross-language arrays support "
                f"{sorted(str(d) for d in _DTYPE_TO_CODE)}; got {obj.dtype}")
        arr = np.ascontiguousarray(obj)
        out += b"a" + bytes([code, arr.ndim])
        for dim in arr.shape:
            out += _U64.pack(dim)
        out += arr.tobytes()
    else:
        raise TypeError(
            f"type {type(obj).__name__} cannot cross the C++ boundary; "
            "supported: None/bool/int/float/str/bytes/list/dict/ndarray")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _encode_into(obj, out)
    return bytes(out)


def _decode_one(buf: memoryview, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == 0x4E:  # N
        return None, pos
    if tag == 0x54:  # T
        return True, pos
    if tag == 0x46:  # F
        return False, pos
    if tag == 0x69:  # i
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x64:  # d
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag in (0x73, 0x62):  # s / b
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if tag == 0x73 else raw), pos + n
    if tag == 0x6C:  # l
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _decode_one(buf, pos)
            items.append(item)
        return items, pos
    if tag == 0x6D:  # m
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        d: Dict[Any, Any] = {}
        for _ in range(n):
            k, pos = _decode_one(buf, pos)
            v, pos = _decode_one(buf, pos)
            d[k] = v
        return d, pos
    if tag == 0x61:  # a
        code, ndim = buf[pos], buf[pos + 1]
        pos += 2
        dtype = _CODE_TO_DTYPE.get(code)
        if dtype is None:
            raise CrossLanguageError(f"bad ndarray dtype code {code}")
        shape = []
        for _ in range(ndim):
            shape.append(_U64.unpack_from(buf, pos)[0])
            pos += 8
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        if len(buf) - pos < nbytes:
            raise CrossLanguageError(
                f"truncated ndarray payload: need {nbytes} bytes, "
                f"have {len(buf) - pos}")
        # zero-copy view over the reply buffer (kept alive via .base)
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
        return arr.reshape(shape), pos + nbytes
    raise CrossLanguageError(f"bad wire tag {tag!r}")


def decode(buf: bytes) -> Any:
    obj, pos = _decode_one(memoryview(buf), 0)
    if pos != len(buf):
        raise CrossLanguageError(
            f"trailing bytes after decode ({len(buf) - pos})")
    return obj


# ------------------------------------------------------------- lib loading

_LIBS: Dict[str, "_CppLib"] = {}
_LIBS_LOCK = threading.Lock()


class _CppLib:
    """A dlopen()ed user library exposing the xl C ABI (cached per
    process; workers are processes, so each worker loads at most once)."""

    def __init__(self, path: str):
        self.path = path
        self.cdll = ctypes.CDLL(path)
        f = self.cdll
        f.xl_invoke.restype = ctypes.c_int
        f.xl_invoke.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_char_p)]
        f.xl_actor_new.restype = ctypes.c_void_p
        f.xl_actor_new.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.c_char_p)]
        f.xl_actor_invoke.restype = ctypes.c_int
        f.xl_actor_invoke.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_char_p)]
        f.xl_actor_del.restype = None
        f.xl_actor_del.argtypes = [ctypes.c_void_p]
        f.xl_free.restype = None
        f.xl_free.argtypes = [ctypes.c_void_p]
        f.xl_manifest.restype = ctypes.c_char_p
        f.xl_manifest.argtypes = []

    def _take_out(self, rc: int, out, out_len, err) -> bytes:
        if rc != 0:
            msg = err.value.decode("utf-8", "replace") if err.value \
                else f"cross-language call failed (rc={rc})"
            if err.value is not None:
                self.cdll.xl_free(err)
            raise CrossLanguageError(f"[{os.path.basename(self.path)}] {msg}")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            if out:
                self.cdll.xl_free(out)

    def invoke(self, name: str, payload: bytes) -> Any:
        out = ctypes.POINTER(ctypes.c_ubyte)()
        out_len = ctypes.c_ulonglong(0)
        err = ctypes.c_char_p()
        rc = self.cdll.xl_invoke(
            name.encode(), payload, len(payload),
            ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(err))
        return decode(self._take_out(rc, out, out_len, err))

    def actor_new(self, cls: str, payload: bytes) -> int:
        err = ctypes.c_char_p()
        handle = self.cdll.xl_actor_new(
            cls.encode(), payload, len(payload), ctypes.byref(err))
        if not handle:
            msg = err.value.decode("utf-8", "replace") if err.value \
                else f"failed to construct C++ actor {cls}"
            if err.value is not None:
                self.cdll.xl_free(err)
            raise CrossLanguageError(f"[{os.path.basename(self.path)}] {msg}")
        return handle

    def actor_invoke(self, handle: int, method: str, payload: bytes) -> Any:
        out = ctypes.POINTER(ctypes.c_ubyte)()
        out_len = ctypes.c_ulonglong(0)
        err = ctypes.c_char_p()
        rc = self.cdll.xl_actor_invoke(
            ctypes.c_void_p(handle), method.encode(), payload, len(payload),
            ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(err))
        return decode(self._take_out(rc, out, out_len, err))

    def actor_del(self, handle: int) -> None:
        self.cdll.xl_actor_del(ctypes.c_void_p(handle))

    def manifest(self) -> str:
        return self.cdll.xl_manifest().decode()


def _load(path: str) -> _CppLib:
    path = os.path.abspath(path)
    with _LIBS_LOCK:
        lib = _LIBS.get(path)
        if lib is None:
            lib = _CppLib(path)
            _LIBS[path] = lib
        return lib


def manifest(lib_path: str) -> Dict[str, list]:
    """List the functions/actor classes a library registers, e.g.
    ``{"functions": ["add"], "actors": ["Counter"]}``."""
    fns, actors = [], []
    for line in _load(lib_path).manifest().splitlines():
        kind, _, name = line.partition(" ")
        (fns if kind == "fn" else actors).append(name)
    return {"functions": fns, "actors": actors}


def _encode_call(args: tuple, kwargs: dict) -> bytes:
    # kwargs piggyback as a trailing {"__xl_kwargs__": {...}} map so the
    # C++ side (positional-only by convention) can opt in via Value::find.
    items = list(args)
    if kwargs:
        items.append({"__xl_kwargs__": dict(kwargs)})
    return encode(items)


# ---------------------------------------------------------------- task API

def cpp_function(lib_path: str, name: str, **task_options):
    """A remote-callable for C++ function `name` in shared library
    `lib_path` (built against cross_lang.hpp; see module docstring).
    Accepts the same options as ``@ray_tpu_torch.remote`` (num_cpus, resources,
    max_retries, ...)."""
    from . import api

    lib_path = os.path.abspath(lib_path)

    def _cpp_shim(*args, **kwargs):
        return _load(lib_path).invoke(name, _encode_call(args, kwargs))

    _cpp_shim.__name__ = _cpp_shim.__qualname__ = f"cpp:{name}"
    _cpp_shim.__doc__ = f"cross-language C++ task {name} [{lib_path}]"
    return api.RemoteFunction(_cpp_shim, **task_options)


# --------------------------------------------------------------- actor API

def cpp_actor(lib_path: str, cls: str,
              methods: Optional[Sequence[str]] = None, **actor_options):
    """An actor class backed by C++ class `cls` in `lib_path`.

    `methods` names the Python-visible methods (each dispatches to
    ``Actor::call(method, args)`` on the C++ side).  If omitted, the
    driver loads the library locally to check the class exists and
    exposes only the generic ``invoke(method, *args)``.  Accepts the same
    options as ``@ray_tpu_torch.remote`` on a class (num_cpus, resources,
    max_restarts, ...).
    """
    from . import api

    lib_path = os.path.abspath(lib_path)
    if methods is None:
        listed = manifest(lib_path)
        if cls not in listed["actors"]:
            raise CrossLanguageError(
                f"library {lib_path} registers no actor class {cls!r} "
                f"(has: {listed['actors']})")
        methods = ()

    def _make_method(mname: str):
        def method(self, *args, **kwargs):
            return _cpp_actor_invoke_generic(self, mname, *args, **kwargs)
        method.__name__ = mname
        return method

    ns = {
        "__init__": _cpp_actor_init,
        "__module__": __name__,
        "__doc__": f"cross-language C++ actor {cls} [{lib_path}]",
        "_xl_lib_path": lib_path,
        "_xl_cls": cls,
        "invoke": _cpp_actor_invoke_generic,
        "close": _cpp_actor_exit,
    }
    for mname in methods:
        if mname in ns:
            raise CrossLanguageError(
                f"method name {mname!r} collides with the actor protocol")
        ns[mname] = _make_method(mname)
    proxy = type(f"Cpp{cls}", (), ns)
    return api.remote(**actor_options)(proxy)


def _cpp_actor_init(self, *args, **kwargs):
    self._xl_lib = _load(type(self)._xl_lib_path)
    self._xl_lock = threading.Lock()
    self._xl_inflight = 0
    self._xl_close_pending = False
    self._xl_handle = self._xl_lib.actor_new(
        type(self)._xl_cls, _encode_call(args, kwargs))


def _cpp_actor_invoke_generic(self, method: str, *args, **kwargs):
    # With max_concurrency>1 methods run on worker threads; the inflight
    # count keeps close() from deleting the C++ object mid-call.  (Method
    # bodies themselves may still run concurrently — thread-safety INSIDE
    # Actor::call is the C++ class's responsibility, as for any actor.)
    with self._xl_lock:
        if not self._xl_handle:
            raise CrossLanguageError(
                f"C++ actor {type(self).__name__} is closed "
                f"(handle destroyed)")
        handle = self._xl_handle
        self._xl_inflight += 1
    try:
        return self._xl_lib.actor_invoke(
            handle, method, _encode_call(args, kwargs))
    finally:
        with self._xl_lock:
            self._xl_inflight -= 1
            last_out = self._xl_inflight == 0
            deferred = self._xl_close_pending and last_out \
                and self._xl_handle
            if deferred:
                handle, self._xl_handle = self._xl_handle, None
                self._xl_close_pending = False
        if deferred:
            self._xl_lib.actor_del(handle)


def _cpp_actor_exit(self):
    """Destroy the underlying C++ object (optional — the worker process
    owns the actor, so process exit reclaims it either way).  If calls
    are in flight, deletion is deferred to the last one to drain."""
    with self._xl_lock:
        if not getattr(self, "_xl_handle", None):
            return
        if self._xl_inflight:
            self._xl_close_pending = True
            return
        handle, self._xl_handle = self._xl_handle, None
    self._xl_lib.actor_del(handle)
