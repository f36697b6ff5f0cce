"""Structured cluster event plane: bounded buffers + driver-side store.

Reference counterpart: the reference runtime's task-event subsystem
(task_event_buffer.cc shipping worker-side lifecycle transitions to the
GCS, surfaced by `ray list tasks --detail` and the export API). Shape
here mirrors the metrics plane (util/metrics.py):

* every process appends lifecycle events to a bounded in-process
  `EventBuffer` via `emit()` — task submit/sched/retry/finish/fail,
  actor create/restart/death, object seal/spill/transfer/free, node
  register/heartbeat-miss/death, engine admit/preempt/finish, ... —
  each typed against the catalog (`util/events_catalog.py`);
* workers and node agents drain delta batches to the driver over the
  existing telemetry channels (report channel `sys.events`, node msg
  `"events"`), exactly like `sys.metrics`;
* the driver merges them into a `ClusterEventStore`, indexed by
  task/actor/object/node id, queried by `util.state.list_events`, the
  `events` CLI, `GET /api/events`, and the post-mortem bundler
  (observability/forensics.py).

Emission must never fail or slow user work: `emit` is a dict build and
a deque append under a lock, and the whole plane can be switched off
with RAY_TPU_EVENTS=0 (bench.py --phase events measures the on/off
task-throughput delta).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import events_catalog
from . import knobs

# Fields promoted to top-level columns (everything else lands in attrs).
ID_KEYS = ("task_id", "actor_id", "object_id", "node_id", "worker_id")

_enabled = knobs.get_bool("RAY_TPU_EVENTS")


def set_enabled(on: bool) -> None:
    """Flip the whole plane (bench overhead A/B; emit becomes a no-op)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class EventBuffer:
    """Bounded per-process event buffer. Oldest events drop first once
    past maxlen (RAY_TPU_EVENT_BUFFER, default 4096); `dropped` counts
    them so a saturated buffer is visible, never silent."""

    def __init__(self, maxlen: Optional[int] = None):
        self.maxlen = maxlen or knobs.get_int("RAY_TPU_EVENT_BUFFER")
        self._events: collections.deque = collections.deque(
            maxlen=self.maxlen)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self._dropped_reported = 0

    def emit(self, event_type: str, message: str = "",
             severity: Optional[str] = None, **fields: Any) -> None:
        if not _enabled:
            return
        if severity is None:
            severity = events_catalog.spec(event_type)[0]
        ev: Dict[str, Any] = {"type": event_type, "ts": time.time(),
                              "severity": severity, "message": message}
        if fields:
            attrs = None
            for k, v in fields.items():
                if v is None:
                    continue
                if k in ID_KEYS:
                    ev[k] = v
                elif attrs is None:
                    attrs = ev["attrs"] = {k: v}
                else:
                    attrs[k] = v
        with self._lock:
            self._seq += 1
            ev["src_seq"] = self._seq
            if len(self._events) >= self.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def drain(self) -> List[Dict[str, Any]]:
        """Take everything buffered so far (the shipping delta). Local
        overflow since the last drain ships as a synthetic
        `events.dropped` record, so buffer loss in a worker is visible
        at the driver, not just in this process."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
            newly_dropped = self.dropped - self._dropped_reported
            self._dropped_reported = self.dropped
        if newly_dropped:
            out.append({"type": "events.dropped", "ts": time.time(),
                        "severity": "warning",
                        "message": f"local event buffer overflowed; "
                                   f"{newly_dropped} events dropped "
                                   "since the last flush",
                        "attrs": {"dropped": newly_dropped},
                        "src_seq": 0})
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# The process-wide buffer every instrumentation site writes to.
_buffer = EventBuffer()


def emit(event_type: str, message: str = "",
         severity: Optional[str] = None, **fields: Any) -> None:
    _buffer.emit(event_type, message, severity=severity, **fields)


def emit_safe(event_type: Optional[str] = None, message: str = "",
              counter: Optional[str] = None,
              counter_tags: Optional[Dict[str, str]] = None,
              **fields: Any) -> None:
    """Never-fail telemetry: emit an event and/or bump a cataloged
    counter, swallowing every exception — instrumentation must not
    fail the work it observes. One shared helper so the serve plane's
    event+counter sites don't each re-copy the try/except pattern."""
    try:
        if event_type is not None:
            emit(event_type, message, **fields)
        if counter is not None:
            from . import metrics_catalog as mcat  # noqa: PLC0415
            mcat.get(counter).inc(1.0, tags=counter_tags or {})
    except Exception:  # noqa: BLE001
        pass


def drain() -> List[Dict[str, Any]]:
    return _buffer.drain()


def buffer() -> EventBuffer:
    return _buffer


class ClusterEventStore:
    """Driver-side merge of event batches from every process, indexed
    by task/actor/object/node/worker id for causal-chain queries.

    Bounds: the main log keeps the newest RAY_TPU_EVENT_STORE events
    (default 16384); per-id index deques keep the newest 512 references
    each, and the id-key universe itself is capped so unbounded id churn
    (millions of objects) cannot grow the index forever. Evicted counts
    surface in summarize() — truncation is reported, never silent."""

    _PER_ID_CAP = 512
    _ID_KEY_CAP = 8192

    def __init__(self, maxlen: Optional[int] = None):
        self.maxlen = maxlen or knobs.get_int("RAY_TPU_EVENT_STORE")
        self._events: collections.deque = collections.deque(
            maxlen=self.maxlen)
        # id value -> deque of event dicts referencing it (insertion
        # ordered across ids via the "ordered dict as LRU" idiom)
        self._by_id: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0

    def ingest(self, source_tags: Optional[Dict[str, str]],
               batch: Sequence[Dict[str, Any]]) -> None:
        if not batch:
            return
        src = list((source_tags or {}).items())
        with self._lock:
            for ev in batch:
                if not isinstance(ev, dict) or "type" not in ev:
                    continue
                # ingest OWNS the batch (drain()/decode hand the dicts
                # over), so tags stamp in place — no per-event copy
                for k, v in src:
                    if k not in ev:
                        ev[k] = v
                self._seq += 1
                ev["seq"] = self._seq
                if len(self._events) >= self.maxlen:
                    self.dropped += 1
                self._events.append(ev)
                for key in ID_KEYS:
                    idv = ev.get(key)
                    if not idv:
                        continue
                    dq = self._by_id.get(idv)
                    if dq is None:
                        dq = self._by_id[idv] = collections.deque(
                            maxlen=self._PER_ID_CAP)
                        while len(self._by_id) > self._ID_KEY_CAP:
                            self._by_id.popitem(last=False)
                    else:
                        # true LRU: a long-lived hot id (the head
                        # node, "driver") must outlive the one-shot
                        # object-id churn that fills the key cap
                        self._by_id.move_to_end(idv)
                    dq.append(ev)

    # ---- queries (any thread) ----
    def for_id(self, idv: str) -> List[Dict[str, Any]]:
        """Events referencing `idv` in any id column, oldest first."""
        with self._lock:
            return list(self._by_id.get(idv, ()))

    def query(self, ids: Optional[Sequence[str]] = None,
              types: Optional[Sequence[str]] = None,
              severities: Optional[Sequence[str]] = None,
              since_seq: int = 0,
              limit: int = 100) -> Tuple[List[Dict[str, Any]], int]:
        """(rows, total_matched): newest-biased slice of matching
        events, oldest first. total_matched > len(rows) means the limit
        clipped the result."""
        with self._lock:
            if ids:
                seen: Dict[int, Dict[str, Any]] = {}
                for idv in ids:
                    for ev in self._by_id.get(idv, ()):
                        seen[ev["seq"]] = ev
                pool: List[Dict[str, Any]] = [seen[s]
                                              for s in sorted(seen)]
            elif (types is None and severities is None
                    and since_seq == 0 and limit):
                # fast path for the dashboard/CLI poll: keep only the
                # newest window instead of materializing the whole log
                total = len(self._events)
                tail: collections.deque = collections.deque(
                    self._events, maxlen=limit)
                return list(tail), total
            else:
                pool = list(self._events)
        tset = set(types) if types else None
        sset = set(severities) if severities else None
        matched = [ev for ev in pool
                   if ev.get("seq", 0) > since_seq
                   and (tset is None or ev.get("type") in tset)
                   and (sset is None or ev.get("severity") in sset)]
        total = len(matched)
        if limit and total > limit:
            matched = matched[-limit:]     # the newest window
        return matched, total

    def summarize(self) -> Dict[str, Any]:
        with self._lock:
            pool = list(self._events)
            dropped = self.dropped
            last_seq = self._seq
        by_type: Dict[str, int] = {}
        by_sev: Dict[str, int] = {}
        for ev in pool:
            by_type[ev.get("type", "?")] = \
                by_type.get(ev.get("type", "?"), 0) + 1
            sev = ev.get("severity", "info")
            by_sev[sev] = by_sev.get(sev, 0) + 1
        return {"total": len(pool), "last_seq": last_seq,
                "dropped": dropped, "by_type": by_type,
                "by_severity": by_sev}
