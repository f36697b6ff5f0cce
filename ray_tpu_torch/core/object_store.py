"""Shared-memory object store (plasma equivalent).

Reference parity: src/ray/object_manager/plasma/ — a per-node shared-memory
arena holding immutable sealed objects, with eviction and zero-copy reads.

Two backends behind one interface:
  * NativeStore — the C++ arena in ray_tpu/_native/object_store.cc (one mmap
    region, allocator + refcounts + LRU in native code), used when the
    compiled library is available.
  * ShmStore — pure-Python fallback using one POSIX shared-memory segment
    per large object.

Small objects (<= INLINE_MAX) never touch shared memory: they ride inline in
control-plane messages and live in the driver's in-memory table, mirroring
the reference's in-band "plasma promotion" threshold
(src/ray/common/ray_config_def.h RAY_CONFIG(int64_t, max_direct_call_object_size)).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Optional

from multiprocessing import shared_memory, resource_tracker

from . import serialization
from ..exceptions import ObjectStoreFullError, ObjectLostError
from ..util import knobs

INLINE_MAX = 64 * 1024


_mcat_mod = None


def record_read(result: str) -> None:
    """Count one object read by outcome ("inline" | "hit" | "spill").
    Shared by ShmStore and the native arena binding; never raises — a
    metrics hiccup must not fail a read. The catalog module is cached
    after the first call (reads are per-get hot)."""
    global _mcat_mod
    try:
        if _mcat_mod is None:
            from ..util import metrics_catalog  # noqa: PLC0415
            _mcat_mod = metrics_catalog
        _mcat_mod.get("ray_tpu_object_store_reads_total").inc(
            tags={"result": result})
    except Exception:
        pass


@dataclasses.dataclass
class ObjectLocation:
    """Picklable descriptor of where a sealed object's payload lives."""
    kind: str                      # "inline" | "shm" | "native" | "spill"
    size: int
    data: Optional[bytes] = None   # inline payload
    name: Optional[str] = None     # shm segment name / spill file path
    # Which node's store holds the payload. None = the driver's node (the
    # single-host case and all pre-multihost callers). Cross-node reads go
    # through the driver's fetch path instead of attaching shm.
    node_id: Optional[str] = None
    # Disk copy written by the SpillManager; readers fall back to it when
    # the arena copy has been evicted (core/spilling.py).
    spill_path: Optional[str] = None
    # Which seal GENERATION of the object this location belongs to
    # (stamped by GCS.seal_object): a reader's unreachable report names
    # the generation it failed against, so a report that raced a
    # lineage reseal can't prune the fresh copy.
    seal_seq: Optional[int] = None


def current_node_id() -> Optional[str]:
    """The node this process's store writes into (env-inherited from the
    driver or node agent that spawned it)."""
    return knobs.get_raw("RAY_TPU_NODE_ID")


def _read_spill_loc(loc: "ObjectLocation") -> bytes:
    path = loc.spill_path or (loc.name if loc.kind == "spill" else None)
    if not path:
        raise ObjectLostError(
            f"segment {loc.name} is gone (evicted?) and has no spill copy")
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise ObjectLostError(
            f"spill file {path} unreadable: {e}") from e


def _untrack(shm: shared_memory.SharedMemory) -> None:
    # Attachments must not be auto-unlinked by this process's resource
    # tracker: the creator (driver store) owns segment lifecycle.
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass


class ShmStore:
    """Per-process view of the node's shared-memory object space."""

    def __init__(self, capacity_bytes: int = 8 << 30, is_owner: bool = False):
        self.capacity = capacity_bytes
        self.is_owner = is_owner
        self._used = 0
        self._segments: Dict[str, shared_memory.SharedMemory] = {}
        # Names THIS process created via put_value: _used only ever counted
        # those, so deletes must only decrement for them — unlinking a
        # worker-created segment must not corrupt the owner's accounting.
        self._created: set = set()
        self._lock = threading.Lock()
        # put_packed re-host synchronization: names this process is
        # mid-write on; waiters block on the condition until the seal
        # completes (a FileExistsError alone can't distinguish "sealed"
        # from "still being written")
        self._packing: set = set()
        self._pack_cond = threading.Condition(self._lock)

    # -- write path ---------------------------------------------------------
    def put_value(self, oid: str, value: Any) -> ObjectLocation:
        """Serialize and seal a value; choose inline vs shm by size."""
        meta, bufs = serialization.serialize(value)
        size = serialization.packed_size(meta, bufs)
        if size <= INLINE_MAX:
            return ObjectLocation(kind="inline", size=size,
                                  data=serialization.pack_parts(meta, bufs))
        name = "rtpt_" + oid.replace("-", "")
        with self._lock:
            # a reseal of an oid THIS process already holds replaces the
            # stale segment (see the FileExistsError path below), so its
            # size must not count against the new copy's admission
            old_seg = self._segments.get(name)
            stale_sz = old_seg.size \
                if old_seg is not None and name in self._created else 0
            if self._used - stale_sz + size > self.capacity:
                raise ObjectStoreFullError(
                    f"object {oid} ({size} B) exceeds store capacity "
                    f"({self._used}/{self.capacity} B used)")
        try:
            seg = shared_memory.SharedMemory(name=name, create=True,
                                             size=size)
        except FileExistsError:
            # lineage re-execution resealing an oid whose stale segment
            # still lives on this node (same-node re-run after a loss,
            # or a rejoined host): unlink the old copy — readers already
            # attached keep their mappings — and seal fresh
            with self._lock:
                old = self._segments.pop(name, None)
                if name in self._created:
                    self._created.discard(name)
                    self._used -= old.size if old is not None else 0
            # unlink via a FRESH attach handle, never via `old`: the old
            # handle may hold exported zero-copy views whose close()
            # raises BufferError and would skip the unlink. The old
            # mapping (and any readers') stays valid after unlink.
            try:
                stale = shared_memory.SharedMemory(name=name)
                stale.unlink()
                stale.close()
            except Exception:
                pass
            if old is not None:
                try:
                    old.close()   # release this process's stale mmap/fd
                except BufferError:
                    pass  # live zero-copy exports: mapping must stay
            seg = shared_memory.SharedMemory(name=name, create=True,
                                             size=size)
        try:
            serialization.pack_into(seg.buf, meta, bufs)
        except BaseException:
            seg.close()
            seg.unlink()
            raise
        with self._lock:
            self._segments[name] = seg
            self._created.add(name)
            self._used += size
        return ObjectLocation(kind="shm", size=size, name=name,
                              node_id=current_node_id())

    # -- read path ----------------------------------------------------------
    def get_value(self, loc: ObjectLocation) -> Any:
        if loc.kind == "inline":
            record_read("inline")
            return serialization.unpack(loc.data)
        if loc.kind == "spill":
            record_read("spill")
            return serialization.unpack(_read_spill_loc(loc))
        if loc.kind == "shm":
            try:
                seg = self._attach(loc.name)
            except ObjectLostError:
                # evicted from shm, but a spill copy survives on disk
                record_read("spill")
                return serialization.unpack(_read_spill_loc(loc))
            # memoryview aliases the mapped pages -> zero-copy numpy reads.
            record_read("hit")
            return serialization.unpack(seg.buf[:loc.size])
        raise ObjectLostError(f"unknown location kind {loc.kind!r}")

    def get_bytes(self, loc: ObjectLocation) -> bytes:
        """Raw packed payload — the cross-node transfer unit (the remote
        side rebuilds the value with serialization.unpack)."""
        if loc.kind == "inline":
            record_read("inline")
            return loc.data
        if loc.kind == "spill":
            record_read("spill")
            return _read_spill_loc(loc)
        if loc.kind == "shm":
            try:
                seg = self._attach(loc.name)
            except ObjectLostError:
                record_read("spill")
                return _read_spill_loc(loc)
            record_read("hit")
            return bytes(seg.buf[:loc.size])
        raise ObjectLostError(f"unknown location kind {loc.kind!r}")

    def get_buffer(self, loc: ObjectLocation):
        """Packed payload as a buffer for the transfer plane: a
        zero-copy view of the mapped shm pages when the segment is
        resident, bytes otherwise (inline / spill fallback)."""
        if loc.kind == "shm":
            try:
                seg = self._attach(loc.name)
            except ObjectLostError:
                record_read("spill")
                return _read_spill_loc(loc)
            record_read("hit")
            return seg.buf[:loc.size]
        return self.get_bytes(loc)

    def put_packed(self, oid: str, data: bytes) -> ObjectLocation:
        """Seal an already-packed payload (a cross-node fetch re-hosted
        into this node's store, so local readers get zero-copy shm)."""
        size = len(data)
        if size <= INLINE_MAX:
            return ObjectLocation(kind="inline", size=size, data=data)
        # pid-suffixed: two PROCESSES re-hosting one object (driver relay
        # + agent pull on a shared-host topology) must never share a
        # segment name — a FileExistsError there can't distinguish
        # "sealed" from "mid-write", and a torn read is silent corruption
        name = f"rtpt_{oid.replace('-', '')}c{os.getpid():x}"
        loc = ObjectLocation(kind="shm", size=size, name=name,
                             node_id=current_node_id())
        with self._pack_cond:
            # concurrent re-hosts of the same object (two helper threads
            # fetching it for two requesters): wait for the writer, then
            # reuse its sealed segment instead of reading a torn copy —
            # BEFORE the capacity check, or a repeat seal of a large
            # already-hosted object would spuriously report a full store
            while name in self._packing:
                self._pack_cond.wait(timeout=30)
            if name in self._segments:
                return loc
            if self._used + size > self.capacity:
                raise ObjectStoreFullError(
                    f"object {oid} ({size} B) exceeds store capacity")
            try:
                seg = shared_memory.SharedMemory(name=name, create=True,
                                                 size=size)
            except FileExistsError:
                # another PROCESS sealed (or is sealing) it — objects are
                # immutable, so an existing segment is this payload; the
                # cross-process mid-write window only exists when two
                # stores share one host's shm namespace (test topologies)
                return loc
            self._packing.add(name)
        ok = False
        try:
            seg.buf[:size] = data
            ok = True
        finally:
            with self._pack_cond:
                self._packing.discard(name)
                if ok:
                    self._segments[name] = seg
                    self._created.add(name)
                    self._used += size
                self._pack_cond.notify_all()
            if not ok:
                seg.close()
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
        return loc

    def _attach(self, name: str) -> shared_memory.SharedMemory:
        with self._lock:
            seg = self._segments.get(name)
            if seg is not None:
                return seg
        try:
            seg = shared_memory.SharedMemory(name=name, create=False)
        except FileNotFoundError as e:
            raise ObjectLostError(f"segment {name} is gone (evicted?)") from e
        _untrack(seg)
        with self._lock:
            self._segments.setdefault(name, seg)
        return self._segments[name]

    # -- lifecycle ----------------------------------------------------------
    def release(self, name: str) -> None:
        """Drop this process's mapping (not the segment itself)."""
        with self._lock:
            seg = self._segments.pop(name, None)
        if seg is not None:
            seg.close()

    def delete_segment(self, name: str, size: int) -> None:
        """Owner-side unlink (eviction / free)."""
        with self._lock:
            seg = self._segments.pop(name, None)
            created_here = name in self._created
            self._created.discard(name)
        if seg is None:
            try:
                seg = shared_memory.SharedMemory(name=name, create=False)
                _untrack(seg)
            except FileNotFoundError:
                return
        seg.close()
        if self.is_owner:
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
            if created_here:
                with self._lock:
                    self._used = max(0, self._used - size)

    def used_bytes(self) -> int:
        return self._used

    def shutdown(self) -> None:
        with self._lock:
            segments = dict(self._segments)
            self._segments.clear()
        for name, seg in segments.items():
            seg.close()
            if self.is_owner:
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
        self._used = 0


class ChannelSegment:
    """A reusable shared-memory window for one compiled-DAG channel.

    Unlike store objects (immutable, allocate/seal/free per value), a
    channel segment is REWRITTEN every execution: the writer copies the
    packed payload at offset 0 and notifies the reader with
    (seqno, size, segment_name) over the channel socket; the depth-1
    ack handshake guarantees the reader consumed seqno N before the
    writer overwrites with N+1, so no header or fence lives in the
    segment itself. Growth allocates a fresh generation-suffixed
    segment (the notify frame carries the name, so readers re-attach
    lazily) and unlinks the outgrown one."""

    def __init__(self, base_name: str, capacity: int):
        self.base_name = base_name
        self.capacity = max(int(capacity), 1 << 12)
        self.gen = 0
        self._seg = shared_memory.SharedMemory(
            name=self._name(), create=True, size=self.capacity)

    def _name(self) -> str:
        return f"{self.base_name}g{self.gen}"

    @property
    def name(self) -> str:
        return self._name()

    def write(self, payload) -> str:
        """Copy payload into the segment (growing it if needed);
        returns the segment name the reader should attach."""
        size = len(payload)
        if size > self.capacity:
            old = self._seg
            while self.capacity < size:
                self.capacity *= 2
            self.gen += 1
            self._seg = shared_memory.SharedMemory(
                name=self._name(), create=True, size=self.capacity)
            old.close()
            try:
                old.unlink()
            except FileNotFoundError:
                pass
        self._seg.buf[:size] = payload
        return self._name()

    def close(self) -> None:
        seg, self._seg = self._seg, None
        if seg is not None:
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass


class ChannelSegmentReader:
    """Reader-side attachment cache for a channel's segments. The
    writer's growth protocol changes the segment name at most a few
    times over a channel's life; everything else is one cached-mmap
    memoryview slice per read."""

    def __init__(self):
        self._seg = None
        self._name = None

    def view(self, name: str, size: int) -> memoryview:
        if name != self._name:
            self.close()
            seg = shared_memory.SharedMemory(name=name, create=False)
            _untrack(seg)
            self._seg, self._name = seg, name
        return self._seg.buf[:size]

    def close(self) -> None:
        seg, self._seg = self._seg, None
        self._name = None
        if seg is not None:
            seg.close()


def make_store(capacity_bytes: int, is_owner: bool):
    """Return the best available store backend (native C++ if built)."""
    try:
        from .._native.store_binding import NativeStore  # noqa: PLC0415
        return NativeStore(capacity_bytes=capacity_bytes, is_owner=is_owner)
    except Exception:
        return ShmStore(capacity_bytes=capacity_bytes, is_owner=is_owner)
