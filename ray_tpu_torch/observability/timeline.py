"""Chrome-trace timeline export of task/actor spans.

Reference counterpart: ray.timeline() (python/ray/_private/profiling.py,
state API timeline export) — emits the chrome://tracing "trace events"
JSON array format. Rows are workers; spans are task executions; instant
events mark actor state changes.

Cross-process spans: each task's driver-side SUBMIT span (queued →
dispatched, drawn on the driver lane) carries the span_id stamped on its
TaskSpec (util/tracing.py); worker processes ship their execution spans
back over the telemetry channel and they render here parented to the
submit span (args.parent_span_id + chrome flow arrows), so one export
shows the full submit → dispatch → execute tree across processes.

Zero-driver fast paths ride the same channel (the flight recorder,
docs/OBSERVABILITY.md): direct-call submit spans (cat "dcall_submit"),
lease grants ("lease_grant"), and compiled-DAG per-stage spans
("dag_stage", parented across worker processes by DERIVED ids —
util/tracing.derived_span_id — with ack-window stall time as an
`ack_stall_s` arg) all merge into this one export.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ..core.runtime import get_runtime

_US = 1_000_000.0


def timeline_events() -> List[Dict[str, Any]]:
    rt = get_runtime()
    try:
        # compiled-DAG controllers defer driver-side submit/result
        # spans in bounded rings; surface them before reading the store
        rt.drain_fastpath_spans()
    except Exception:
        pass
    events: List[Dict[str, Any]] = []
    pid = 1   # single "process": the cluster; tid = worker lane

    lanes: Dict[str, int] = {}

    def lane(wid: Optional[str]) -> int:
        key = wid or "driver"
        if key not in lanes:
            lanes[key] = len(lanes) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": lanes[key], "args": {"name": f"worker:{key}"}})
        return lanes[key]

    for te in list(rt.gcs.tasks.values()):
        span_id = getattr(te, "span_id", "")
        if te.submitted_at:
            # driver-side submit span: queued -> dispatched (or queued ->
            # now for still-pending tasks — those are exactly the bars a
            # queueing investigation needs to see); worker execution
            # spans parent to its span_id
            sub_end = te.started_at or te.finished_at or time.time()
            events.append({
                "name": f"submit:{te.name}", "cat": "submit", "ph": "X",
                "ts": te.submitted_at * _US,
                "dur": max(1.0, (sub_end - te.submitted_at) * _US),
                "pid": pid, "tid": lane("driver"),
                "args": {"task_id": te.task_id, "state": te.state,
                         "span_id": span_id,
                         "parent_span_id": getattr(te, "parent_span_id",
                                                   ""),
                         "trace_id": getattr(te, "trace_id", "")},
            })
            if span_id:
                events.append({
                    "name": "task", "cat": "submit_flow", "ph": "s",
                    "id": span_id, "ts": te.submitted_at * _US,
                    "pid": pid, "tid": lane("driver")})
        if not te.started_at:
            continue
        end = te.finished_at or te.started_at
        cat = "actor_task" if te.actor_id else "task"
        events.append({
            "name": te.name, "cat": cat, "ph": "X",
            "ts": te.started_at * _US,
            "dur": max(1.0, (end - te.started_at) * _US),
            "pid": pid, "tid": lane(te.worker_id),
            "args": {"task_id": te.task_id, "state": te.state,
                     "actor_id": te.actor_id,
                     "span_id": span_id,
                     "queued_s": round(te.started_at - te.submitted_at, 6)
                     if te.submitted_at else None},
        })
    # worker-side execution spans shipped over the telemetry channel
    # (core/worker.py): true in-process timing, parented to the driver's
    # submit span and linked with a chrome flow arrow
    for sp in list(getattr(rt, "trace_spans", ())):
        try:
            start, end = sp["start"], sp["end"]
        except (KeyError, TypeError):
            continue
        args = {"task_id": sp.get("task_id"),
                "span_id": sp.get("span_id"),
                "parent_span_id": sp.get("parent_span_id"),
                "trace_id": sp.get("trace_id"),
                "status": sp.get("status"),
                "node_id": sp.get("node_id"),
                "worker_pid": sp.get("pid")}
        # fast-path span attributes (compiled-DAG stages, lease grants,
        # direct calls) pass straight through to the trace viewer
        for extra in ("dag_id", "sid", "seqno", "ack_stall_s",
                      "lease_id", "slots"):
            if sp.get(extra) is not None:
                args[extra] = sp[extra]
        events.append({
            "name": sp.get("name", "task"),
            "cat": sp.get("cat", "task_exec"),
            "ph": "X", "ts": start * _US,
            "dur": max(1.0, (end - start) * _US),
            "pid": pid, "tid": lane(sp.get("worker_id")),
            "args": args,
        })
        if sp.get("parent_span_id"):
            events.append({
                "name": "task", "cat": "submit_flow", "ph": "f",
                "bp": "e", "id": sp["parent_span_id"],
                "ts": start * _US, "pid": pid,
                "tid": lane(sp.get("worker_id"))})
    for ae in list(rt.gcs.actors.values()):
        if ae.worker_id is None:
            continue
        events.append({
            "name": f"actor:{ae.class_name}[{ae.state}]", "cat": "actor",
            "ph": "i", "s": "t",
            "ts": 0 if not rt.gcs.tasks else min(
                (t.submitted_at for t in list(rt.gcs.tasks.values())
                 if t.submitted_at), default=0) * _US,
            "pid": pid, "tid": lane(ae.worker_id),
            "args": {"actor_id": ae.actor_id}})
    return events


def span_subtree(trace_id: str = "",
                 subject_id: str = "") -> List[Dict[str, Any]]:
    """The timeline events belonging to one trace (driver submit spans
    + worker execution spans sharing `trace_id`), plus any event whose
    args reference `subject_id` as its task/actor — the span slice a
    post-mortem bundle carries (observability/forensics.py)."""
    out = []
    for e in timeline_events():
        args = e.get("args") or {}
        if trace_id and args.get("trace_id") == trace_id:
            out.append(e)
        elif subject_id and (args.get("task_id") == subject_id
                             or args.get("actor_id") == subject_id):
            out.append(e)
    return out


def timeline(filename: Optional[str] = None) -> Any:
    """Export the trace; returns the event list, optionally writing JSON
    loadable in chrome://tracing / Perfetto."""
    events = timeline_events()
    if filename is not None:
        with open(filename, "w") as f:
            json.dump(events, f)
        return filename
    return events
