"""Object spilling: live objects survive arena eviction via disk copies.

Reference parity: src/ray/object_manager/plasma/eviction_policy.cc +
the spill-to-external-storage path of src/ray/core_worker (objects are
spilled under memory pressure and restored transparently on get).

Design for the single-controller runtime: the shared-memory arena keeps
its silent LRU eviction (it is the memory-pressure valve that keeps puts
fast), and the DRIVER stays ahead of it — after every seal, objects are
spilled oldest-first to RAY_TPU_SPILL_DIR once the arena passes a
watermark, so by the time the LRU evicts an object its bytes already
live on disk. A get() that finds the arena copy gone falls back to the
spill file via ObjectLocation.spill_path. Spill files are deleted when
the object is freed.

Window: an object sealed by a worker is spill-protected only once the
driver processes the seal; a burst larger than (capacity - watermark)
between those two points can still evict it unspilled. The watermark
(default 60% of capacity) sizes that safety margin.
"""
from __future__ import annotations

import os
from typing import Optional

from ..util import knobs


def spill_threshold() -> float:
    return knobs.get_float("RAY_TPU_SPILL_THRESHOLD")


class SpillManager:
    """Driver-side: copies sealed local objects to disk oldest-first when
    the arena crosses the watermark. Mutates ObjectLocation.spill_path in
    place so every later reply carrying the loc advertises the copy."""

    def __init__(self, store, spill_dir: str, node_id: Optional[str]):
        import threading  # noqa: PLC0415
        self.store = store
        self.spill_dir = spill_dir
        self.node_id = node_id
        os.makedirs(spill_dir, exist_ok=True)
        # Insertion-ordered oid -> loc of live, unspilled local objects.
        # Freed objects are pruned (on_free) and duplicate seals (driver
        # puts register both synchronously and via the dispatcher) dedupe
        # on the oid key, so this tracks exactly the live set.
        self._tracked: "dict[str, object]" = {}
        # Called from both the dispatcher (worker seals) and API threads
        # (driver puts register synchronously so a burst of puts can't
        # evict an object the dispatcher hasn't seen yet).
        self._lock = threading.Lock()

    def on_seal(self, oid: str, loc) -> None:
        if loc is None or loc.kind not in ("shm", "native"):
            return
        if (loc.node_id or self.node_id) != self.node_id:
            return  # remote nodes spill on their own host
        with self._lock:
            if oid not in self._tracked:
                self._tracked[oid] = loc
            self._spill_locked()

    def _spill_locked(self) -> None:
        cap = getattr(self.store, "capacity", 0) or 0
        if cap <= 0:
            return
        limit = cap * spill_threshold()
        while self.store.used_bytes() > limit and self._tracked:
            oid = next(iter(self._tracked))        # oldest live object
            loc = self._tracked.pop(oid)
            if loc.spill_path is not None:
                continue
            try:
                data = self.store.get_bytes(loc)
            except Exception:
                continue  # already evicted: nothing left to protect
            path = os.path.join(self.spill_dir, f"{oid}.bin")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            loc.spill_path = path
            try:
                from ..util import events as events_mod  # noqa: PLC0415
                events_mod.emit("object.spill", object_id=oid,
                                node_id=self.node_id,
                                size=len(data), path=path)
            except Exception:
                pass
            # Drop the arena copy: the spill file is now authoritative and
            # the freed space is what keeps the next puts from evicting
            # not-yet-spilled objects.
            try:
                self.store.delete_segment(loc.name, loc.size)
            except Exception:
                pass

    def on_free(self, loc, oid: Optional[str] = None) -> None:
        if oid is not None:
            with self._lock:
                self._tracked.pop(oid, None)
        if (getattr(loc, "node_id", None) or self.node_id) != self.node_id:
            return  # remote spill files are the remote agent's to delete
        path = getattr(loc, "spill_path", None)
        if path:
            try:
                os.remove(path)
            except OSError:
                pass


def put_value_or_spill(store, oid: str, value):
    """store.put_value with a spill fallback: when the arena is full and
    nothing is evictable, the new object goes straight to this node's
    spill dir instead of failing the put. Used by workers and the driver
    alike (env RAY_TPU_SPILL_DIR names the node's dir)."""
    from ..exceptions import ObjectStoreFullError  # noqa: PLC0415
    try:
        return store.put_value(oid, value)
    except ObjectStoreFullError:
        spill_dir = knobs.get_raw("RAY_TPU_SPILL_DIR")
        if not spill_dir:
            raise
        from . import serialization  # noqa: PLC0415
        from .object_store import (ObjectLocation,  # noqa: PLC0415
                                   current_node_id)
        data = serialization.pack(value)
        os.makedirs(spill_dir, exist_ok=True)
        path = os.path.join(spill_dir, f"{oid}.bin")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return ObjectLocation(kind="spill", size=len(data), name=path,
                              node_id=current_node_id(), spill_path=path)
