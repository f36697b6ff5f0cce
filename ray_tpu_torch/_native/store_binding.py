"""ctypes binding for the C++ shared-memory object arena.

NativeStore implements the same interface as core.object_store.ShmStore
(put_value/get_value/release/delete_segment/used_bytes/shutdown) but backs
large objects with the single C++ arena instead of one POSIX segment per
object: allocation, refcounts, and LRU eviction all happen in native code
under one process-shared lock (reference parity:
src/ray/object_manager/plasma/store.cc).

Arena discovery: the owner (driver) picks a segment name and exports it as
RAY_TPU_ARENA_NAME so spawned workers attach the same arena. Writes are
zero-copy (serialize directly into the mapping); reads pin the object and
hand numpy views over shared pages until release().
"""
from __future__ import annotations

import ctypes
import itertools
import os
import threading
from typing import Any

from .build import build_library
from ..util import knobs
from ..core import serialization
from ..core.object_store import INLINE_MAX, ObjectLocation
from ..exceptions import ObjectLostError, ObjectStoreFullError

# nonce for reseal-under-pin fallback names (see put_value)
_RESEAL_SEQ = itertools.count()

_ENV_NAME = "RAY_TPU_ARENA_NAME"


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library("object_store"))
    lib.rtpu_arena_create.restype = ctypes.c_void_p
    lib.rtpu_arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_int]
    lib.rtpu_arena_close.restype = None
    lib.rtpu_arena_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtpu_arena_unlink.restype = None
    lib.rtpu_arena_unlink.argtypes = [ctypes.c_void_p]
    lib.rtpu_arena_base.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rtpu_arena_base.argtypes = [ctypes.c_void_p]
    lib.rtpu_arena_create_object.restype = ctypes.c_int64
    lib.rtpu_arena_create_object.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p,
                                             ctypes.c_uint64]
    lib.rtpu_arena_seal.restype = ctypes.c_int
    lib.rtpu_arena_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_arena_get.restype = ctypes.c_int64
    lib.rtpu_arena_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.rtpu_arena_release.restype = ctypes.c_int
    lib.rtpu_arena_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_arena_delete.restype = ctypes.c_int
    lib.rtpu_arena_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_arena_contains.restype = ctypes.c_int
    lib.rtpu_arena_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_arena_used.restype = ctypes.c_uint64
    lib.rtpu_arena_used.argtypes = [ctypes.c_void_p]
    lib.rtpu_arena_capacity.restype = ctypes.c_uint64
    lib.rtpu_arena_capacity.argtypes = [ctypes.c_void_p]
    lib.rtpu_arena_count.restype = ctypes.c_uint32
    lib.rtpu_arena_count.argtypes = [ctypes.c_void_p]
    return lib


_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load_lib()
        return _lib


def _sweep_stale_arenas() -> None:
    """Unlink arenas whose owner pid is dead (a SIGKILLed/SIGTERMed
    driver never runs its atexit unlink, and a multi-GB /dev/shm segment
    would otherwise leak until reboot). Arena names embed the creator's
    pid: /rtpt_arena_<pid>_<hex>."""
    try:
        entries = os.listdir("/dev/shm")
    except OSError:
        return
    for fname in entries:
        if not fname.startswith("rtpt_arena_"):
            continue
        parts = fname.split("_")
        try:
            pid = int(parts[2])
        except (IndexError, ValueError):
            continue
        try:
            os.kill(pid, 0)
            continue  # owner alive: not ours to touch
        except ProcessLookupError:
            pass
        except OSError:
            continue
        try:
            os.unlink(os.path.join("/dev/shm", fname))
        except OSError:
            pass


class NativeStore:
    """Per-process view of the node's C++ shared-memory arena."""

    def __init__(self, capacity_bytes: int = 8 << 30,
                 is_owner: bool = False):
        self._lib = get_lib()
        self.capacity = capacity_bytes
        self.is_owner = is_owner
        if is_owner:
            _sweep_stale_arenas()
            name = f"/rtpt_arena_{os.getpid()}_{os.urandom(4).hex()}"
            os.environ[_ENV_NAME] = name
        else:
            name = knobs.get_str(_ENV_NAME, default="")
            if not name:
                raise RuntimeError(
                    "no arena to attach: RAY_TPU_ARENA_NAME unset "
                    "(driver store is not the native backend)")
        self._name = name
        self._handle = self._lib.rtpu_arena_create(
            name.encode(), capacity_bytes, 1 if is_owner else 0)
        if not self._handle:
            raise RuntimeError(f"failed to map arena {name}")
        base = self._lib.rtpu_arena_base(self._handle)
        cap = self._lib.rtpu_arena_capacity(self._handle)
        self._base_addr = ctypes.addressof(base.contents)
        # One memoryview over the whole data region; object views slice it.
        self._data = memoryview(
            (ctypes.c_uint8 * cap).from_address(self._base_addr)).cast("B")
        self._lock = threading.Lock()

    def _pinned_view(self, name: str, off: int, size: int) -> memoryview:
        """Zero-copy view of a gotten (refcount-pinned) object whose pin
        releases when the LAST derived view dies. The exporter is a
        per-call ctypes array over the mapped pages with a
        weakref.finalize dropping the refcount: numpy views built by
        serialization.unpack keep the exporter alive through the buffer
        chain. (A PEP 688 __buffer__ wrapper class would be neater, but
        plain classes only export buffers from Python 3.12 — this must
        run on 3.10.)"""
        import weakref  # noqa: PLC0415
        carr = (ctypes.c_uint8 * size).from_address(self._base_addr + off)
        weakref.finalize(carr, self._release_one, name)
        return memoryview(carr).cast("B")

    # -- write path ---------------------------------------------------------
    def put_value(self, oid: str, value: Any) -> ObjectLocation:
        meta, bufs = serialization.serialize(value)
        size = serialization.packed_size(meta, bufs)
        if size <= INLINE_MAX:
            return ObjectLocation(kind="inline", size=size,
                                  data=serialization.pack_parts(meta, bufs))
        name = oid
        off = self._lib.rtpu_arena_create_object(
            self._handle, name.encode(), size)
        if off == -2:
            # lineage re-execution resealing an oid whose stale segment
            # survives in this arena (same-node re-run after a loss, or
            # a rejoined host): drop the old copy (refcount-safe — a
            # pinned reader defers the free) and seal fresh
            self._lib.rtpu_arena_delete(self._handle, name.encode())
            off = self._lib.rtpu_arena_create_object(
                self._handle, name.encode(), size)
        if off == -2:
            # the stale entry is pin-held (delete pending): seal under a
            # nonce-suffixed name instead, like put_packed — the nonce
            # keeps REPEATED reseals of one oid from colliding with
            # their own earlier suffixed entries (those are unpinned
            # once read, so the arena LRU reclaims them)
            name = f"{oid}r{os.getpid():x}x{next(_RESEAL_SEQ)}"
            off = self._lib.rtpu_arena_create_object(
                self._handle, name.encode(), size)
        if off == -2:
            raise ValueError(f"object {oid} already exists in the arena")
        if off < 0:
            raise ObjectStoreFullError(
                f"object {oid} ({size} B) does not fit in the arena "
                f"({self.used_bytes()}/{self.capacity} B used, "
                f"nothing evictable)")
        try:
            serialization.pack_into(self._data[off:off + size], meta, bufs)
        except BaseException:
            self._lib.rtpu_arena_seal(self._handle, name.encode())
            self._lib.rtpu_arena_delete(self._handle, name.encode())
            raise
        self._lib.rtpu_arena_seal(self._handle, name.encode())
        from ..core.object_store import current_node_id  # noqa: PLC0415
        return ObjectLocation(kind="native", size=size, name=name,
                              node_id=current_node_id())

    # -- read path ----------------------------------------------------------
    def get_value(self, loc: ObjectLocation) -> Any:
        from ..core.object_store import record_read  # noqa: PLC0415
        if loc.kind == "inline":
            record_read("inline")
            return serialization.unpack(loc.data)
        if loc.kind == "spill":
            from ..core.object_store import _read_spill_loc  # noqa: PLC0415
            record_read("spill")
            return serialization.unpack(_read_spill_loc(loc))
        if loc.kind == "native":
            size = ctypes.c_uint64()
            off = self._lib.rtpu_arena_get(
                self._handle, loc.name.encode(), ctypes.byref(size))
            if off < 0:
                if loc.spill_path:
                    from ..core.object_store import \
                        _read_spill_loc  # noqa: PLC0415
                    record_read("spill")
                    return serialization.unpack(_read_spill_loc(loc))
                raise ObjectLostError(
                    f"object {loc.name} is gone from the arena (evicted?)")
            record_read("hit")
            # The pin (refcount) lives exactly as long as the deserialized
            # value: zero-copy numpy views keep the exporter alive through
            # the memoryview chain; when the last view dies, the finalizer
            # unpins and the object becomes evictable again. Values with
            # no out-of-band buffers drop the pin on return.
            return serialization.unpack(
                self._pinned_view(loc.name, off, size.value))
        if loc.kind == "shm":
            # A peer fell back to the pure-Python store; read its segment.
            return self._shm_fallback().get_value(loc)
        raise ObjectLostError(f"unknown location kind {loc.kind!r}")

    def get_bytes(self, loc: ObjectLocation) -> bytes:
        """Raw packed payload for cross-node transfer (copies out of the
        arena; the pin lives only for the copy)."""
        from ..core.object_store import record_read  # noqa: PLC0415
        if loc.kind == "inline":
            record_read("inline")
            return loc.data
        if loc.kind == "spill":
            from ..core.object_store import _read_spill_loc  # noqa: PLC0415
            record_read("spill")
            return _read_spill_loc(loc)
        if loc.kind == "native":
            size = ctypes.c_uint64()
            off = self._lib.rtpu_arena_get(
                self._handle, loc.name.encode(), ctypes.byref(size))
            if off < 0:
                if loc.spill_path:
                    from ..core.object_store import \
                        _read_spill_loc  # noqa: PLC0415
                    record_read("spill")
                    return _read_spill_loc(loc)
                raise ObjectLostError(
                    f"object {loc.name} is gone from the arena (evicted?)")
            record_read("hit")
            try:
                return bytes(self._data[off:off + size.value])
            finally:
                self._release_one(loc.name)
        if loc.kind == "shm":
            return self._shm_fallback().get_bytes(loc)
        raise ObjectLostError(f"unknown location kind {loc.kind!r}")

    def get_buffer(self, loc: ObjectLocation):
        """Packed payload as a buffer for the transfer plane: a pinned
        zero-copy arena view when resident (the holder streams straight
        out of shared memory), bytes otherwise (inline / spill)."""
        if loc.kind == "native":
            size = ctypes.c_uint64()
            off = self._lib.rtpu_arena_get(
                self._handle, loc.name.encode(), ctypes.byref(size))
            if off >= 0:
                from ..core.object_store import record_read  # noqa: PLC0415
                record_read("hit")
                return self._pinned_view(loc.name, off, size.value)
        return self.get_bytes(loc)

    def put_packed(self, oid: str, data: bytes) -> ObjectLocation:
        """Seal an already-packed payload (cross-node fetch re-hosting)."""
        size = len(data)
        if size <= INLINE_MAX:
            return ObjectLocation(kind="inline", size=size, data=data)
        # pid-suffixed (see ShmStore.put_packed): concurrent re-hosts
        # from different processes sharing this arena must not race one
        # unsealed entry
        key = f"{oid}c{os.getpid():x}"
        off = self._lib.rtpu_arena_create_object(
            self._handle, key.encode(), size)
        if off == -2:
            from ..core.object_store import current_node_id  # noqa: PLC0415
            return ObjectLocation(kind="native", size=size, name=key,
                                  node_id=current_node_id())
        if off < 0:
            raise ObjectStoreFullError(
                f"re-hosted object {oid} ({size} B) does not fit in the "
                f"arena")
        self._data[off:off + size] = data
        self._lib.rtpu_arena_seal(self._handle, key.encode())
        from ..core.object_store import current_node_id  # noqa: PLC0415
        return ObjectLocation(kind="native", size=size, name=key,
                              node_id=current_node_id())

    def _shm_fallback(self):
        if not hasattr(self, "_fallback"):
            from ..core.object_store import ShmStore  # noqa: PLC0415
            self._fallback = ShmStore(capacity_bytes=self.capacity,
                                      is_owner=self.is_owner)
        return self._fallback

    # -- lifecycle ----------------------------------------------------------
    def _release_one(self, name: str) -> None:
        if self._handle:
            self._lib.rtpu_arena_release(self._handle, name.encode())

    def release(self, name: str) -> None:
        """Pins are lifetime-managed (_Pin); explicit release is a no-op."""

    def delete_segment(self, name: str, size: int) -> None:
        if name.startswith("rtpt_"):
            # Segment written by a ShmStore-fallback peer.
            self._shm_fallback().delete_segment(name, size)
        else:
            self._lib.rtpu_arena_delete(self._handle, name.encode())

    def contains(self, name: str) -> bool:
        return bool(self._lib.rtpu_arena_contains(self._handle,
                                                  name.encode()))

    def used_bytes(self) -> int:
        return int(self._lib.rtpu_arena_used(self._handle))

    def num_objects(self) -> int:
        return int(self._lib.rtpu_arena_count(self._handle))

    def shutdown(self) -> None:
        if self._handle:
            # Readers may still hold zero-copy numpy views into the
            # mapping, so never munmap mid-process: unlink the name (owner)
            # and let the kernel reclaim pages at process exit.
            if self.is_owner:
                self._lib.rtpu_arena_unlink(self._handle)
            self._handle = None
        if self.is_owner:
            os.environ.pop(_ENV_NAME, None)
