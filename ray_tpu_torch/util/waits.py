"""Wait-state plane: every blocking edge registers a WaitRecord.

The event plane (util/events.py) answers "what happened"; this plane
answers "why is nothing happening right now". Every park site in the
package — `get()`/`wait()` reply settles, direct-call waits,
collective round polls, compiled-DAG ack-window and read-barrier
stalls, node-agent lease-queue heads, data-service grant polls —
registers a structured record in a bounded per-process `WaitTable`:

    token = waits.park("object", oid, target_actor=aid)
    try:
        ... block ...
    finally:
        waits.unpark(token)

Cost discipline (the plane is always on): park is one dict build and
one dict store under a lock, unpark one pop — no syscalls, no
telemetry frames. Shipping rides the existing 1s telemetry heartbeat
(report channel `sys.waits`, node msg `"waits"`) and ships ONLY waits
older than `SHIP_MIN_AGE_S`, and only when that aged set changed
since the last flush: a healthy pipeline whose waits are all
micro-waits ships zero frames, so steady-state control traffic is
unchanged (counter-asserted in tests/test_waits.py). Each shipped
payload is a full snapshot per source — idempotent, so a dropped
frame self-heals on the next change.

The driver folds every source's snapshot (plus its own local table)
into `ClusterWaitStore`, which `observability/waitgraph.py` walks at
`RAY_TPU_HANG_PROBE_S` cadence for cycles, stale waits, and
stragglers. `RAY_TPU_WAITS=0` is the kill switch (park becomes a
no-op returning 0).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import knobs

# Resource kinds a waiter can block on (the record's `kind` field).
RESOURCE_KINDS = ("object", "actor-call", "collective-round",
                  "dag-channel", "lease-slot", "data-grant",
                  "serve-stream", "other")

# Waits younger than this never ship: the telemetry flush skips them,
# so a healthy pipeline's micro-waits cost zero frames. Anything the
# hang watchdog could care about is orders of magnitude older.
SHIP_MIN_AGE_S = 1.0

# Hot-path park sites (compiled-DAG channel hops, slot settles) defer
# the park until the caller has already blocked this long: steady-state
# pipeline waits are microseconds, so the grace makes them literally
# free, while anything the watchdog could flag (>= SHIP_MIN_AGE_S) is
# recorded with at most this much start-time skew.
PARK_GRACE_S = 0.05

_enabled = knobs.get_bool("RAY_TPU_WAITS")


def set_enabled(on: bool) -> None:
    """Flip the whole plane (kill switch / bench A/B)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def current_task_id() -> Optional[str]:
    """The task id attributed to the calling thread (the same
    thread→task map the sampling profiler uses, stamped by
    core/logging.mark_current_task)."""
    from ..observability import sampling_profiler  # noqa: PLC0415
    return sampling_profiler._marks.get(threading.get_ident())


class WaitTable:
    """Bounded per-process table of in-progress waits, keyed by an
    opaque int token. Overflow past maxlen drops the record (park
    still returns a token; unpark of a dropped token is a no-op) and
    counts it, so saturation is visible, never silent."""

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self._recs: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        # per-resource-kind completed-wait seconds, flushed to the
        # `ray_tpu_wait_seconds` counter at collect cadence
        self._secs: Dict[str, float] = {}
        # aged-set fingerprint from the last ship: payloads go out
        # only when this changes. Starts EMPTY (not None) so a fresh
        # process with no aged waits ships nothing at all.
        self._last_shipped: frozenset = frozenset()

    def park(self, kind: str, resource_id: str = "",
             waiter: Optional[str] = None,
             **ctx: Any) -> int:
        """Register a wait; returns the token for unpark. `waiter`
        overrides thread-mark task attribution (driver-side callers,
        synthesized queue records)."""
        if not _enabled:
            return 0
        if waiter is None:
            waiter = current_task_id()
        rec: Dict[str, Any] = {"kind": kind, "rid": resource_id,
                               "ts": time.time()}
        if waiter:
            rec["task_id"] = waiter
        if ctx:
            rec["ctx"] = {k: v for k, v in ctx.items() if v is not None}
        with self._lock:
            self._seq += 1
            tok = self._seq
            if len(self._recs) >= self.maxlen:
                self.dropped += 1
                return tok
            rec["tok"] = tok
            self._recs[tok] = rec
        return tok

    def unpark(self, token: int) -> None:
        if not token:
            return
        with self._lock:
            rec = self._recs.pop(token, None)
            if rec is not None:
                kind = rec["kind"]
                self._secs[kind] = self._secs.get(kind, 0.0) + \
                    (time.time() - rec["ts"])

    def touch(self, token: int, **ctx: Any) -> None:
        """Update a parked record's context in place (e.g. a
        collective poller advancing through rounds keeps one park
        across rounds but refreshes the round key)."""
        if not token:
            return
        with self._lock:
            rec = self._recs.get(token)
            if rec is not None:
                rec.setdefault("ctx", {}).update(ctx)
                rec["v"] = rec.get("v", 0) + 1

    def snapshot(self) -> List[Dict[str, Any]]:
        """Copies of every in-progress wait (driver-local reads)."""
        with self._lock:
            return [dict(r) for r in self._recs.values()]

    def replace_synth(self, prefix: str,
                      recs: List[Tuple[str, str, float, Dict]]) -> None:
        """Replace the synthesized records under `prefix` (node-agent
        lease queues are data structures, not parked threads: the
        agent re-synthesizes their wait records each metrics tick as
        (kind, rid, start_ts, ctx) tuples)."""
        if not _enabled:
            return
        with self._lock:
            for tok in [t for t in self._recs
                        if isinstance(t, str) and t.startswith(prefix)]:
                del self._recs[tok]
            for i, (kind, rid, ts, ctx) in enumerate(recs):
                tok = f"{prefix}{kind}:{rid}:{i}"
                rec = {"kind": kind, "rid": rid, "ts": ts, "tok": tok}
                if ctx:
                    rec["ctx"] = ctx
                self._recs[tok] = rec

    def collect(self, min_age: float = SHIP_MIN_AGE_S
                ) -> Optional[Dict[str, Any]]:
        """The telemetry-flush delta: a full snapshot of waits older
        than `min_age`, or None when that set is unchanged since the
        last ship (including the steady state of "no aged waits", so
        healthy processes ship nothing). Also flushes completed-wait
        seconds into the metrics plane, which piggybacks the
        sys.metrics channel it already rides."""
        now = time.time()
        with self._lock:
            secs, self._secs = self._secs, {}
            aged = [r for r in self._recs.values()
                    if now - r["ts"] >= min_age]
            fp = frozenset((r["tok"], r.get("v", 0)) for r in aged)
            changed = fp != self._last_shipped
            if changed:
                self._last_shipped = fp
                out = [dict(r) for r in aged]
            n_recs = len(self._recs)
        if secs:
            try:
                from . import metrics_catalog as mcat  # noqa: PLC0415
                for kind, s in secs.items():
                    mcat.get("ray_tpu_wait_seconds").inc(
                        s, tags={"kind": kind})
            except Exception:  # noqa: BLE001
                pass
        if n_recs:
            try:
                from . import metrics_catalog as mcat  # noqa: PLC0415
                mcat.get("ray_tpu_wait_records").set(float(n_recs))
            except Exception:  # noqa: BLE001
                pass
        if not changed:
            return None
        return {"records": out, "dropped": self.dropped}

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)


# The process-wide table every park site writes to.
_table = WaitTable()


def park(kind: str, resource_id: str = "",
         waiter: Optional[str] = None, **ctx: Any) -> int:
    return _table.park(kind, resource_id, waiter=waiter, **ctx)


def unpark(token: int) -> None:
    _table.unpark(token)


def touch(token: int, **ctx: Any) -> None:
    _table.touch(token, **ctx)


def collect(min_age: float = SHIP_MIN_AGE_S) -> Optional[Dict[str, Any]]:
    return _table.collect(min_age)


def snapshot() -> List[Dict[str, Any]]:
    return _table.snapshot()


def table() -> WaitTable:
    return _table


class ClusterWaitStore:
    """Driver-side fold of per-source wait snapshots. Each source's
    payload REPLACES its previous one (full-snapshot semantics: a
    dropped frame self-heals on the next change; an unparked wait
    disappears on the next ship). Sources are dropped when their
    worker/node dies so ghost waits cannot poison the graph."""

    def __init__(self):
        self._by_source: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def ingest(self, src: str, source_tags: Optional[Dict[str, str]],
               payload: Optional[Dict[str, Any]]) -> None:
        """`src` is the replacement key (worker id, or "agent:<nid>"
        for node agents — "node-agent" alone would collide across
        nodes); `source_tags` stamp each record for display."""
        if not isinstance(payload, dict):
            return
        tags = source_tags or {}
        recs = payload.get("records") or []
        for r in recs:
            if isinstance(r, dict):
                for k, v in tags.items():
                    if k not in r:
                        r[k] = v
        with self._lock:
            if recs:
                self._by_source[src] = {"records": recs,
                                        "recv_ts": time.time(),
                                        "dropped":
                                            payload.get("dropped", 0)}
            else:
                self._by_source.pop(src, None)

    def drop_source(self, src: str) -> None:
        with self._lock:
            self._by_source.pop(src, None)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Every known remote wait record (shipped copies — safe for
        callers to annotate)."""
        with self._lock:
            out: List[Dict[str, Any]] = []
            for ent in self._by_source.values():
                out.extend(dict(r) for r in ent["records"])
            return out

    def sources(self) -> Dict[str, int]:
        with self._lock:
            return {s: len(e["records"])
                    for s, e in self._by_source.items()}
