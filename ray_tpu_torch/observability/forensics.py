"""Failure forensics: post-mortem bundles for tasks and actors.

When a task or actor dies, the answer to "what happened?" is scattered
across four planes: the lifecycle event log (util/events.py), the trace
timeline (observability/timeline.py), the per-task-tagged worker logs
(core/logging.py), and the metrics registries. `build_post_mortem`
assembles all four into one JSON artifact — the causally-linked event
chain, the span subtree, the tagged log tail, and a metrics snapshot —
the way the reference's `ray list tasks --detail` + log tailing would
be combined by hand. Served at `GET /api/post_mortem?id=...` and by the
`post-mortem` CLI subcommand.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set

from ..core.runtime import get_runtime

# How many neighbouring-id events / log lines / metric chars a bundle
# carries — post-mortems are for reading, not for archiving the world.
MAX_CHAIN_EVENTS = 500
MAX_LOG_LINES = 200
MAX_METRICS_CHARS = 200_000


def _subject(rt, subject_id: str) -> Dict[str, Any]:
    """The GCS row(s) for the id: kind + task/actor table entries."""
    te = rt.gcs.tasks.get(subject_id)
    if te is not None:
        return {"kind": "task", "task": {
            "task_id": te.task_id, "name": te.name, "state": te.state,
            "worker_id": te.worker_id, "actor_id": te.actor_id,
            "submitted_at": te.submitted_at,
            "started_at": te.started_at, "finished_at": te.finished_at,
            "retries_left": te.retries_left,
            "trace_id": getattr(te, "trace_id", ""),
            "span_id": getattr(te, "span_id", "")}}
    ae = rt.gcs.actors.get(subject_id)
    if ae is not None:
        return {"kind": "actor", "actor": {
            "actor_id": ae.actor_id, "class_name": ae.class_name,
            "state": ae.state, "worker_id": ae.worker_id,
            "num_restarts": ae.num_restarts,
            "max_restarts": ae.max_restarts,
            "death_cause": ae.death_cause}}
    return {"kind": "unknown"}


def _event_chain(rt, subject_id: str) -> List[Dict[str, Any]]:
    """Causally-linked events: the subject's own events, widened one hop
    through every id they reference (worker, node, objects, sibling
    task/actor) so the chain shows WHY — a task.retry sits next to the
    worker.death and node.death that caused it."""
    from ..util.events import ID_KEYS
    store = rt.cluster_events
    own = store.for_id(subject_id)
    linked: Set[str] = {subject_id}
    nodes: Set[str] = set()
    for ev in own:
        for key in ID_KEYS:
            v = ev.get(key)
            if not v:
                continue
            # node ids link to EVERYTHING on the node; widening through
            # them verbatim would bury the chain in unrelated seals —
            # keep only the node's own lifecycle (node.*) events
            (nodes if key == "node_id" else linked).add(v)
    rows, _total = store.query(ids=sorted(linked | nodes),
                               limit=MAX_CHAIN_EVENTS)
    out = []
    for ev in rows:
        direct = any(ev.get(k) in linked for k in ID_KEYS)
        if direct or (ev.get("type", "").startswith("node.")
                      and ev.get("node_id") in nodes):
            out.append(ev)
    return out


def _span_subtree(rt, subject: Dict[str, Any],
                  subject_id: str) -> List[Dict[str, Any]]:
    """Every timeline event sharing the subject's trace (driver submit
    spans from the task table + worker execution spans shipped over the
    telemetry channel)."""
    # note: `from . import timeline` would resolve to the same-named
    # FUNCTION re-exported by the package __init__, not the module
    from .timeline import span_subtree
    trace_id = ""
    if subject["kind"] == "task":
        trace_id = subject["task"].get("trace_id") or ""
    return span_subtree(trace_id=trace_id, subject_id=subject_id)


def _log_tail(rt, subject: Dict[str, Any],
              subject_id: str) -> Dict[str, Any]:
    """Task-attributed log lines captured on the driver's host (remote
    workers log into their own agent's dir — marked unavailable rather
    than silently empty)."""
    from ..core import logging as logging_mod
    if subject["kind"] == "task":
        lines = logging_mod.task_log_tail(rt.log_dir, subject_id,
                                          max_lines=MAX_LOG_LINES)
        note = None
        te = subject.get("task", {})
        wid = te.get("worker_id")
        if not lines and wid is not None:
            w = rt.workers.get(wid)
            if w is not None and w.node_id not in (None, rt.node_id):
                note = (f"worker {wid} ran on remote node {w.node_id}; "
                        "its log file lives in that agent's log dir")
        return {"lines": lines, "note": note}
    if subject["kind"] == "actor":
        wid = subject["actor"].get("worker_id")
        if wid:
            # an actor's whole worker log is its log; tail it raw
            import os
            path = os.path.join(rt.log_dir, f"worker-{wid}.log")
            try:
                text = logging_mod.read_log_tail(path)
                pairs, _cur = logging_mod.attribute_lines(text)
                lines = [{"worker": f"worker-{wid}",
                          "task_id": tid, "line": line}
                         for tid, line in pairs if line.strip()]
                return {"lines": lines[-MAX_LOG_LINES:], "note": None}
            except OSError:
                return {"lines": [], "note": f"no local log at {path}"}
    return {"lines": [], "note": "no log attribution for this subject"}


def _reconstruction_chain(rt, subject_id: str) -> List[Dict[str, Any]]:
    """The lineage walk behind any reconstructions touching the
    subject: starting from the subject task, follow dep-object edges
    upstream through their producing tasks (bounded hops) and collect
    each hop's object.lost / object.reconstruct / task.retry events —
    so a post-mortem shows WHICH producers re-executed and why, not
    just that the final task retried."""
    recon_types = ("object.lost", "object.reconstruct", "task.retry")
    out: List[Dict[str, Any]] = []
    seen: set = set()
    frontier = [subject_id]
    for hop in range(8):
        nxt: List[str] = []
        for tid in frontier:
            if tid in seen:
                continue
            seen.add(tid)
            spec = rt._lineage_specs.get(tid) \
                or rt._respawnable_specs.get(tid)
            events = [ev for ev in rt.cluster_events.for_id(tid)
                      if ev.get("type") in recon_types]
            for dep in list(getattr(spec, "dep_object_ids", []) or []):
                events.extend(
                    ev for ev in rt.cluster_events.for_id(dep)
                    if ev.get("type") in recon_types)
                de = rt.gcs.objects.get(dep)
                if de is not None and de.owner_task:
                    nxt.append(de.owner_task)
            if events:
                te = rt.gcs.tasks.get(tid)
                out.append({
                    "task_id": tid,
                    "name": te.name if te is not None else None,
                    "hop": hop,
                    "reconstructions": getattr(spec, "reconstructions",
                                               0) if spec else 0,
                    "events": sorted(events,
                                     key=lambda ev: ev.get("ts", 0))})
        if not nxt:
            break
        frontier = nxt
    return out


def build_post_mortem(subject_id: str) -> Dict[str, Any]:
    """One JSON artifact: event chain + span subtree + tagged log tail
    + metrics snapshot for a task_id or actor_id."""
    rt = get_runtime()
    rt.drain_local_events()
    subject = _subject(rt, subject_id)
    chain = _event_chain(rt, subject_id)
    spans = _span_subtree(rt, subject, subject_id)
    logs = _log_tail(rt, subject, subject_id)
    from ..util import metrics as metrics_mod
    try:
        metrics_text = metrics_mod.cluster_exposition()
        if len(metrics_text) > MAX_METRICS_CHARS:
            metrics_text = metrics_text[:MAX_METRICS_CHARS] \
                + "\n# ...truncated...\n"
    except Exception as e:  # noqa: BLE001
        metrics_text = f"# metrics snapshot failed: {e!r}\n"
    # the wait plane's view: chains touching the subject first, else
    # every live chain — a post-mortem on a HUNG subject leads with
    # why it is (or was) not making progress
    try:
        from ..util import state as state_mod
        wait_chains = state_mod.wait_chains(subject_id=subject_id)
        if not wait_chains:
            wait_chains = state_mod.wait_chains()
    except Exception:  # noqa: BLE001
        wait_chains = []
    bundle = {
        "subject_id": subject_id,
        "generated_at": time.time(),
        "subject": subject,
        "events": chain,
        "spans": spans,
        "log_tail": logs,
        "wait_chains": wait_chains,
        "reconstruction": _reconstruction_chain(rt, subject_id),
        "metrics": metrics_text,
        "event_summary": rt.cluster_events.summarize(),
    }
    if getattr(rt, "incarnation", 0) or getattr(rt, "resumed", False):
        # a post-mortem read on a RESUMED driver leads with the restart
        # context: the driver.restart / node.reattach / gcs.snapshot
        # chain explains why the subject's history starts mid-life
        rows, _tot = rt.cluster_events.query(
            types=["driver.restart", "node.reattach", "gcs.snapshot"],
            limit=50)
        bundle["driver_recovery"] = {
            "incarnation": rt.incarnation,
            "persistence": rt.persistence_stats(),
            "events": rows,
        }
    return bundle


def write_post_mortem(subject_id: str,
                      path: Optional[str] = None) -> str:
    """Build and write the bundle; returns the path."""
    import json
    bundle = build_post_mortem(subject_id)
    path = path or f"post-mortem-{subject_id}.json"
    with open(path, "w") as f:
        json.dump(bundle, f, indent=1, default=str)
    return path
