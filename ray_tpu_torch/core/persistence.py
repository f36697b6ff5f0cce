"""Driver control-plane persistence: write-ahead log + snapshots.

Reference parity: the fault-tolerant GCS the Ray paper makes the
centerpiece of its architecture (gcs_server backed by a replicated
store; here src/ray/gcs/gcs_server/store_client with a Redis/memory
backend). In the single-controller runtime the driver process IS the
GCS, so a driver crash used to destroy every table. This module makes
the control plane durable under a state dir (``RAY_TPU_STATE_DIR``):

* every table mutation appends one WAL record (object seal/free, actor
  create/state/checkpoint, node register/death, lineage retain/evict,
  internal-KV put/del),
* a periodic snapshot (atomic tmp+rename) bounds replay time and
  rotates the WAL,
* ``load()`` rebuilds the tables from snapshot + WAL for
  ``ray_tpu_torch.init(resume=True)``, stopping cleanly at a torn tail
  (a record half-written when the driver died).

Layout of the state dir::

    MANIFEST.json      # incarnation, active snapshot/wal names, listen
    snapshot-<n>.bin   # pickled table snapshot (atomic rename)
    wal-<n>.log        # records since snapshot <n> (crc32-framed)

Record framing: ``<u32 len><u32 crc32(payload)><payload>`` where the
payload is a pickled tuple ``(kind, ...)`` (plain pickle on the hot
path, cloudpickle for records only it can serialize). Replay verifies
length and CRC and stops at the first incomplete/corrupt record —
everything before the tear is recovered, nothing after it is trusted;
an intact-but-undeserializable record is skipped, not a tear.

The WAL is flushed (not fsynced) per record by default: a driver
SIGKILL loses nothing, only a whole-host power loss can drop the OS
buffer tail. ``RAY_TPU_WAL_FSYNC=1`` forces fsync per append for the
paranoid-durability case.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import pickle

import cloudpickle

from ..util import knobs


# Record kinds that can carry USER objects (actor constructor args in
# the create spec, by-value task args in lineage specs): these must use
# cloudpickle — plain pickle would serialize a driver-script class
# instance BY REFERENCE, which dumps fine here but fails to resolve in
# the resumed process's different __main__ (the record would then be
# skipped at replay and its entry silently lost).
_USER_CONTENT_KINDS = frozenset({"acreate", "lret"})


def _dumps(rec: tuple) -> bytes:
    """Plain pickle for framework-pure records (2.7x cheaper on the
    dispatcher hot path — object seals dominate), cloudpickle whenever
    user content may be present (and as the fallback)."""
    if rec[0] not in _USER_CONTENT_KINDS:
        try:
            return pickle.dumps(rec, protocol=5)
        except Exception:
            pass
    return cloudpickle.dumps(rec, protocol=5)


_FRAME = struct.Struct("<II")   # (payload length, crc32)
MANIFEST = "MANIFEST.json"
_GEN_RE = re.compile(r"^(?:snapshot|wal)-(\d+)\.(?:bin|log)$")


def _max_generation(state_dir: str) -> int:
    """Highest snapshot/WAL generation number present on disk. A new
    life must start PAST every leftover file: opening a prior life's
    wal-<n>.log in append mode would mix two lives' records, and a
    same-named snapshot would shadow the one the manifest names."""
    mx = 0
    try:
        names = os.listdir(state_dir)
    except OSError:
        return 0
    for name in names:
        m = _GEN_RE.match(name)
        if m:
            mx = max(mx, int(m.group(1)))
    return mx


def default_state_dir() -> Optional[str]:
    return knobs.get_raw("RAY_TPU_STATE_DIR")


@dataclasses.dataclass
class RecoveredState:
    """Control-plane tables rebuilt from snapshot + WAL replay."""
    objects: Dict[str, Any] = dataclasses.field(default_factory=dict)
    actors: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checkpoints: Dict[str, bytes] = dataclasses.field(
        default_factory=dict)
    named_actors: Dict[Tuple[str, str], str] = dataclasses.field(
        default_factory=dict)
    nodes: Dict[str, dict] = dataclasses.field(default_factory=dict)
    lineage: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kv: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    # manifest metadata
    incarnation: int = 0
    job_id: str = ""
    node_id: str = ""                 # the DEAD driver's node id
    listen: Optional[str] = None      # bound control address to re-bind
    clean: bool = False               # graceful shutdown wrote this
    snapshot_ts: float = 0.0
    # replay forensics
    replayed_records: int = 0
    torn_tail: bool = False


def _apply(st: RecoveredState, rec: tuple) -> None:
    """Apply one WAL record to the recovered tables. Snapshot load and
    WAL replay share this single definition of record semantics."""
    kind = rec[0]
    if kind == "oseal":
        e = rec[1]
        st.objects[e.object_id] = e
    elif kind == "ofree":
        st.objects.pop(rec[1], None)
    elif kind == "acreate":
        ae = rec[1]
        st.actors[ae.actor_id] = ae
        if ae.name and ae.state != "DEAD":
            st.named_actors[(ae.namespace, ae.name)] = ae.actor_id
    elif kind == "astate":
        aid, state, cause, num_restarts = rec[1:5]
        ae = st.actors.get(aid)
        if ae is not None:
            ae.state = state
            if cause:
                ae.death_cause = cause
            ae.num_restarts = num_restarts
            if state == "DEAD":
                st.checkpoints.pop(aid, None)
    elif kind == "ackpt":
        st.checkpoints[rec[1]] = rec[2]
    elif kind == "nreg":
        info = dict(rec[1])
        info["alive"] = True
        st.nodes[info["node_id"]] = info
    elif kind == "ndeath":
        n = st.nodes.get(rec[1])
        if n is not None:
            n["alive"] = False
    elif kind == "lret":
        st.lineage[rec[1]] = rec[2]
        for oid in getattr(rec[2], "return_ids", ()):
            e = st.objects.get(oid)
            if e is not None:
                e.lineage_evicted = False
    elif kind == "levict":
        spec = st.lineage.pop(rec[1], None)
        for oid in getattr(spec, "return_ids", ()):
            e = st.objects.get(oid)
            if e is not None:
                e.lineage_evicted = True
    elif kind == "kvput":
        st.kv[rec[1]] = rec[2]
    elif kind == "kvdel":
        key, by_prefix = rec[1], rec[2]
        if by_prefix:
            for k in [k for k in st.kv if k.startswith(key)]:
                del st.kv[k]
        else:
            st.kv.pop(key, None)
    # unknown kinds are skipped: an older driver can replay a newer
    # dir's known prefix instead of refusing to start


def replay_wal(path: str) -> Tuple[List[tuple], bool, int]:
    """Read records from a WAL file. Returns (records, torn, bytes_read
    of VALID prefix). Stops cleanly at the first torn/corrupt record —
    a partial header, a short payload, or a CRC mismatch ends the
    valid prefix (crash-consistency: the tail record may have been
    half-written when the driver died). A record whose framing+CRC is
    INTACT but whose payload won't deserialize (e.g. a by-reference
    pickle of a driver-script type, or version drift) is SKIPPED, not
    treated as a tear: one unreadable record degrades one entry, it
    must not silently truncate everything after it."""
    records: List[tuple] = []
    torn = False
    valid_bytes = 0
    try:
        f = open(path, "rb")
    except OSError:
        return records, torn, valid_bytes
    with f:
        while True:
            hdr = f.read(_FRAME.size)
            if not hdr:
                break                       # clean EOF
            if len(hdr) < _FRAME.size:
                torn = True
                break
            length, crc = _FRAME.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length or \
                    zlib.crc32(payload) & 0xFFFFFFFF != crc:
                torn = True
                break
            try:
                records.append(pickle.loads(payload))
            except Exception:
                pass                        # intact frame, skip record
            valid_bytes += _FRAME.size + length
    return records, torn, valid_bytes


def load(state_dir: str) -> Optional[RecoveredState]:
    """Rebuild the control-plane tables from `state_dir`; None when the
    dir holds no manifest (nothing to resume)."""
    mpath = os.path.join(state_dir, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    st = RecoveredState(
        incarnation=int(manifest.get("incarnation", 0)),
        job_id=manifest.get("job_id", ""),
        node_id=manifest.get("node_id", ""),
        listen=manifest.get("listen"),
        clean=bool(manifest.get("clean", False)),
        snapshot_ts=float(manifest.get("snapshot_ts", 0.0)))
    snap = manifest.get("snapshot")
    if snap:
        try:
            with open(os.path.join(state_dir, snap), "rb") as f:
                tables = pickle.loads(f.read())
            st.objects = tables.get("objects", {})
            st.actors = tables.get("actors", {})
            st.checkpoints = tables.get("checkpoints", {})
            st.named_actors = tables.get("named_actors", {})
            st.nodes = tables.get("nodes", {})
            st.lineage = tables.get("lineage", {})
            st.kv = tables.get("kv", {})
        except Exception:  # noqa: BLE001
            # a missing/corrupt snapshot falls back to pure WAL replay
            # of whatever the manifest's wal still holds
            pass
    wal = manifest.get("wal")
    if wal:
        records, torn, _ = replay_wal(os.path.join(state_dir, wal))
        for rec in records:
            _apply(st, rec)
        st.replayed_records = len(records)
        st.torn_tail = torn
    return st


def wipe(state_dir: str) -> bool:
    """Remove prior persisted state from `state_dir` (fresh `init()`
    over a stale dir). Only this module's files are touched; returns
    True when anything was removed."""
    removed = False
    try:
        names = os.listdir(state_dir)
    except OSError:
        return False
    for name in names:
        if name == MANIFEST or name.startswith(("snapshot-", "wal-")):
            try:
                os.remove(os.path.join(state_dir, name))
                removed = True
            except OSError:
                pass
    return removed


class GCSPersistence:
    """The driver's WAL writer + snapshotter. All append_* methods are
    cheap no-raise calls (telemetry-grade: a persistence failure must
    not take down the dispatcher); `maybe_snapshot` is driven from the
    dispatcher tick."""

    def __init__(self, state_dir: str, *, incarnation: int = 0,
                 job_id: str = "", node_id: str = "",
                 listen: Optional[str] = None, resuming: bool = False):
        self.state_dir = state_dir
        self.incarnation = incarnation
        self.job_id = job_id
        self.node_id = node_id
        self.listen = listen
        self._lock = threading.Lock()
        self._fsync = knobs.get_bool("RAY_TPU_WAL_FSYNC")
        self._interval = knobs.get_float(
            "RAY_TPU_GCS_SNAPSHOT_INTERVAL_S")
        self._wal_cap = knobs.get_int("RAY_TPU_GCS_SNAPSHOT_WAL_BYTES")
        os.makedirs(state_dir, exist_ok=True)
        # counters for the state API / CLI
        self.records_appended = 0
        self.append_seconds = 0.0      # cumulative wall time in _append
        self.wal_bytes = 0
        self.snapshots_taken = 0
        self.last_snapshot_ts = time.time()
        self.replayed_records = 0
        self.torn_tail_recovered = False
        # generation counter: strictly past every file on disk, so a
        # resumed life can never append into (or shadow) a file the
        # crashed life wrote
        self._seq = _max_generation(state_dir) + 1
        self._snap_name: Optional[str] = None
        self._wal_name = f"wal-{self._seq:06d}.log"
        self._wal = open(os.path.join(state_dir, self._wal_name), "ab")
        if resuming:
            # DEFER the manifest swap: the crashed life's manifest must
            # stay authoritative until the restored tables are safely
            # snapshotted (runtime calls snapshot() right after
            # restore) — otherwise a second crash inside the snapshot
            # interval would resume from an empty generation and lose
            # everything the first life persisted
            pass
        else:
            self._write_manifest(clean=False)

    # ---- manifest ---------------------------------------------------------
    def _write_manifest(self, clean: bool) -> None:
        manifest = {
            "version": 1,
            "incarnation": self.incarnation,
            "job_id": self.job_id,
            "node_id": self.node_id,
            "listen": self.listen,
            "snapshot": self._snap_name,
            "wal": self._wal_name,
            "snapshot_ts": self.last_snapshot_ts,
            "clean": clean,
        }
        tmp = os.path.join(self.state_dir, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.state_dir, MANIFEST))

    # ---- WAL appends ------------------------------------------------------
    def _append(self, rec: tuple) -> None:
        t0 = time.perf_counter()
        try:
            payload = _dumps(rec)
            frame = _FRAME.pack(len(payload),
                                zlib.crc32(payload) & 0xFFFFFFFF)
            with self._lock:
                self._wal.write(frame)
                self._wal.write(payload)
                self._wal.flush()
                if self._fsync:
                    os.fsync(self._wal.fileno())
                self.records_appended += 1
                self.wal_bytes += len(frame) + len(payload)
        except Exception:
            pass  # persistence must never break the control plane
        self.append_seconds += time.perf_counter() - t0

    def object_seal(self, entry) -> None:
        self._append(("oseal", entry))

    def object_free(self, oid: str) -> None:
        self._append(("ofree", oid))

    def actor_create(self, entry) -> None:
        self._append(("acreate", entry))

    def actor_state(self, entry) -> None:
        self._append(("astate", entry.actor_id, entry.state,
                      entry.death_cause, entry.num_restarts))

    def actor_ckpt(self, aid: str, blob: bytes) -> None:
        self._append(("ackpt", aid, blob))

    def node_register(self, info: dict) -> None:
        self._append(("nreg", info))

    def node_death(self, nid: str) -> None:
        self._append(("ndeath", nid))

    def lineage_retain(self, task_id: str, spec) -> None:
        self._append(("lret", task_id, spec))

    def lineage_evict(self, task_id: str) -> None:
        self._append(("levict", task_id))

    def kv_put(self, key: str, value) -> None:
        self._append(("kvput", key, value))

    def kv_del(self, key: str, by_prefix: bool) -> None:
        self._append(("kvdel", key, by_prefix))

    def append(self, rec: tuple) -> None:
        """Append one pre-built record (the runtime routes API-thread
        mutations — internal KV — through the dispatcher to here, so
        every append is serialized with snapshot rotation and a racing
        record can never land in a WAL generation about to be
        deleted)."""
        self._append(rec)

    # ---- snapshots --------------------------------------------------------
    def maybe_snapshot(self, tables_fn) -> bool:
        """Take a snapshot when the interval elapsed or the WAL grew
        past the rotation cap. `tables_fn` builds the table dict (runs
        on the caller's — dispatcher's — thread, so the tables are
        consistent without locks)."""
        if self._interval <= 0:
            return False
        due = (time.time() - self.last_snapshot_ts >= self._interval
               or self.wal_bytes >= self._wal_cap)
        if not due:
            return False
        return self.snapshot(tables_fn)

    def snapshot(self, tables_fn) -> bool:
        """Write snapshot-<n+1>, rotate to wal-<n+1>, swap the manifest
        atomically, then delete the superseded generation. A crash at
        any point leaves the manifest naming one intact
        (snapshot, wal) pair."""
        try:
            # cloudpickle: the tables hold actor create specs and
            # lineage specs whose args may be driver-script objects
            blob = cloudpickle.dumps(tables_fn(), protocol=5)
        except Exception:
            return False
        try:
            with self._lock:
                self._seq += 1
                snap_name = f"snapshot-{self._seq:06d}.bin"
                tmp = os.path.join(self.state_dir, snap_name + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp,
                           os.path.join(self.state_dir, snap_name))
                wal_name = f"wal-{self._seq:06d}.log"
                new_wal = open(
                    os.path.join(self.state_dir, wal_name), "ab")
                self._wal.close()
                self._wal = new_wal
                self._snap_name, self._wal_name = snap_name, wal_name
                self.wal_bytes = 0
                self.last_snapshot_ts = time.time()
                self.snapshots_taken += 1
            self._write_manifest(clean=False)
            # the manifest now names the new pair: every OTHER
            # generation file (the rotated-out pair, and any leftovers
            # from the crashed life a resume replayed) is garbage
            keep = {snap_name, wal_name}
            try:
                for name in os.listdir(self.state_dir):
                    if _GEN_RE.match(name) and name not in keep:
                        try:
                            os.remove(
                                os.path.join(self.state_dir, name))
                        except OSError:
                            pass
            except OSError:
                pass
            return True
        except Exception:
            return False

    def close(self, tables_fn=None) -> None:
        """Graceful shutdown: final snapshot (planned restarts replay
        nothing) and a manifest marked clean."""
        try:
            if tables_fn is not None:
                self.snapshot(tables_fn)
            self._write_manifest(clean=True)
            with self._lock:
                self._wal.close()
        except Exception:
            pass

    # ---- introspection ----------------------------------------------------
    def stats(self) -> dict:
        return {
            "state_dir": self.state_dir,
            "driver_incarnation": self.incarnation,
            "wal_records": self.records_appended,
            "wal_bytes": self.wal_bytes,
            "wal_append_seconds": round(self.append_seconds, 6),
            "snapshots_taken": self.snapshots_taken,
            "last_snapshot_age_s": round(
                time.time() - self.last_snapshot_ts, 3),
            "replayed_records": self.replayed_records,
            "torn_tail_recovered": self.torn_tail_recovered,
            "fsync": self._fsync,
        }
