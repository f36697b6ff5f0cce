"""State API: live introspection of the running cluster.

Reference counterpart: python/ray/util/state (list_actors/list_tasks/
list_objects/list_nodes/list_workers/list_events, summarize_*) backed by
python/ray/_private/state.py. Here the driver IS the control store, so
these read GCS tables directly and return plain dicts.

Filters are (key, op, value) triples; supported ops: "=", "==", "!=",
numeric "<", "<=", ">", ">=", and substring "contains". Every list_*
returns a `ListResult` (a list subclass): when `limit` clips rows,
`.truncated` is True and `.total` holds the full match count instead of
rows silently disappearing.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..core.runtime import get_runtime


class ListResult(list):
    """A plain list plus truncation metadata (`.truncated`, `.total`).
    Serializes like a list, so HTTP/JSON consumers are unchanged."""

    def __init__(self, rows, total: Optional[int] = None):
        super().__init__(rows)
        self.total = len(self) if total is None else total
        self.truncated = self.total > len(self)


def _numeric(op: str, have: Any, val: Any) -> bool:
    try:
        a, b = float(have), float(val)
    except (TypeError, ValueError):
        return False
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _match(row: Dict[str, Any], filters) -> bool:
    for f in filters or ():
        key, op, val = f
        have = row.get(key)
        if op in ("=", "=="):
            if str(have) != str(val):
                return False
        elif op == "!=":
            if str(have) == str(val):
                return False
        elif op in ("<", "<=", ">", ">="):
            if not _numeric(op, have, val):
                return False
        elif op == "contains":
            if have is None or str(val) not in str(have):
                return False
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return True


def _clip(rows, filters, limit: int) -> ListResult:
    matched = [r for r in rows if _match(r, filters)]
    return ListResult(matched[:limit], total=len(matched))


def list_actors(filters=None, limit: int = 100) -> ListResult:
    rt = get_runtime()
    rows = []
    for ae in list(rt.gcs.actors.values()):
        rows.append({
            "actor_id": ae.actor_id, "class_name": ae.class_name,
            "state": ae.state, "name": ae.name or "",
            "namespace": ae.namespace, "worker_id": ae.worker_id,
            "num_restarts": ae.num_restarts,
            "death_cause": ae.death_cause,
            "resources": dict(ae.resources),
        })
    return _clip(rows, filters, limit)


def list_tasks(filters=None, limit: int = 100) -> ListResult:
    rt = get_runtime()
    rows = []
    for te in list(rt.gcs.tasks.values()):
        rows.append({
            "task_id": te.task_id, "name": te.name, "state": te.state,
            "worker_id": te.worker_id, "actor_id": te.actor_id,
            "submitted_at": te.submitted_at, "started_at": te.started_at,
            "finished_at": te.finished_at,
            "duration_s": (te.finished_at - te.started_at
                           if te.finished_at and te.started_at else None),
        })
    return _clip(rows, filters, limit)


def list_objects(filters=None, limit: int = 100) -> ListResult:
    rt = get_runtime()
    rows = []
    for oe in list(rt.gcs.objects.values()):
        loc = oe.loc
        rows.append({
            "object_id": oe.object_id, "state": oe.state,
            "owner_task": oe.owner_task,
            "size_bytes": getattr(loc, "size", None),
            "store_kind": getattr(loc, "kind", None),
            "created_at": oe.created_at,
        })
    return _clip(rows, filters, limit)


def list_nodes(filters=None, limit: int = 100) -> ListResult:
    rt = get_runtime()
    rows = []
    for ne in list(rt.gcs.nodes.values()):
        ns = getattr(rt, "cluster_nodes", {}).get(ne.node_id)
        rows.append({
            "node_id": ne.node_id, "hostname": ne.hostname,
            "alive": ne.alive, "resources": dict(ne.resources),
            "resources_available": dict(ns.avail) if ns else {},
            "labels": dict(ne.labels),
            "is_driver": ne.node_id == rt.node_id,
        })
    return _clip(rows, filters, limit)


def list_workers(filters=None, limit: int = 100) -> ListResult:
    rt = get_runtime()
    rows = []
    for w in list(rt.workers.values()):
        rows.append({
            "worker_id": w.worker_id, "pid": w.pid, "state": w.state,
            "current_task": w.current_task, "actor_id": w.actor_id,
            "gpu_capable": w.gpu_capable,
            "gpu_ids": list(w.held_gpu_ids),
            "uptime_s": time.time() - w.started_at,
        })
    return _clip(rows, filters, limit)


def list_placement_groups(filters=None, limit: int = 100) -> ListResult:
    rt = get_runtime()
    rows = []
    for pg in list(rt.placement_groups.values()):
        rows.append({"placement_group_id": pg.pg_id, "name": pg.name,
                     "strategy": pg.strategy, "state": pg.state,
                     "bundles": list(pg.bundles)})
    return _clip(rows, filters, limit)


def list_events(filters=None, limit: int = 100,
                ids: Optional[List[str]] = None,
                types: Optional[List[str]] = None,
                severities: Optional[List[str]] = None,
                since_seq: int = 0) -> ListResult:
    """Cluster lifecycle events from the driver's ClusterEventStore
    (util/events.py), oldest first. `ids` restricts to events that
    reference any of the given task/actor/object/node/worker ids via
    the store's causal index; `filters` then applies the generic
    (key, op, value) predicates on the event rows (attrs are flattened
    into the row for filtering)."""
    rt = get_runtime()
    rt.drain_local_events()   # just-emitted driver events are queryable
    # no generic filters -> the store's own newest-window clip serves
    # directly (no full-log copy per dashboard/CLI poll); with filters
    # the clip must happen after them, so fetch everything matching
    rows, total = rt.cluster_events.query(
        ids=ids, types=types, severities=severities,
        since_seq=since_seq, limit=0 if filters else limit)
    if filters:
        flat = []
        for ev in rows:
            r = dict(ev)
            for k, v in (ev.get("attrs") or {}).items():
                r.setdefault(k, v)
            flat.append((r, ev))
        rows = [ev for r, ev in flat if _match(r, filters)]
        total = len(rows)
        if limit and len(rows) > limit:
            rows = rows[-limit:]   # the newest window
    return ListResult(rows, total=total)


def summarize_events() -> Dict[str, Any]:
    rt = get_runtime()
    rt.drain_local_events()
    return rt.cluster_events.summarize()


def wait_chains(subject_id: Optional[str] = None,
                min_age_s: float = 0.0) -> List[Dict[str, Any]]:
    """Every in-progress wait the cluster knows about, each annotated
    with its waits-on chain and a resolved root cause — the answer to
    "why is X stuck" (`ray_tpu stuck`). `subject_id` restricts to
    chains touching that task/actor/worker/object id."""
    from ..observability import waitgraph as wg_mod
    rt = get_runtime()
    now = time.time()
    records = wg_mod.gather_records(rt)
    g = wg_mod.build_graph(records, rt.gcs, now=now)
    rows: List[Dict[str, Any]] = []
    for i, r in enumerate(records):
        age = now - float(r.get("ts", now))
        if age < min_age_s:
            continue
        chain = g.chain(i)
        if subject_id is not None and not any(
                k.split(":", 1)[-1].startswith(subject_id)
                for k in chain):
            continue
        rows.append({
            "kind": r.get("kind"), "rid": r.get("rid"),
            "waiter": g.waiter_of.get(i),
            "worker_id": r.get("worker_id"),
            "node_id": r.get("node_id"),
            "task_id": r.get("task_id"),
            "age_s": round(age, 1),
            "ctx": r.get("ctx") or {},
            "chain": [g.label(k) for k in chain],
            "root_cause": g.root_cause(i),
        })
    rows.sort(key=lambda r: -r["age_s"])
    return rows


def waitgraph() -> Dict[str, Any]:
    """The folded cluster waits-on graph plus the watchdog's latest
    findings (deadlocks / suspected hangs / stragglers)."""
    from ..observability import waitgraph as wg_mod
    rt = get_runtime()
    records = wg_mod.gather_records(rt)
    g = wg_mod.build_graph(records, rt.gcs)
    out = g.to_dict()
    out["sources"] = rt.cluster_waits.sources()
    out["cycles"] = g.cycles()
    mon = getattr(rt, "_hang_monitor", None)
    out["last_probe"] = dict(mon.last_probe) if mon is not None else {}
    return out


def summarize_tasks() -> Dict[str, Any]:
    """Reference: `ray summary tasks` — counts per (name, state)."""
    rt = get_runtime()
    summary: Dict[str, Dict[str, int]] = {}
    for te in list(rt.gcs.tasks.values()):
        per = summary.setdefault(te.name, {})
        per[te.state] = per.get(te.state, 0) + 1
    return {"by_func_name": summary,
            "total": len(rt.gcs.tasks)}


def summarize_actors() -> Dict[str, Any]:
    rt = get_runtime()
    summary: Dict[str, Dict[str, int]] = {}
    for ae in list(rt.gcs.actors.values()):
        per = summary.setdefault(ae.class_name, {})
        per[ae.state] = per.get(ae.state, 0) + 1
    return {"by_class_name": summary, "total": len(rt.gcs.actors)}


def summarize_objects() -> Dict[str, Any]:
    rt = get_runtime()
    counts: Dict[str, int] = {}
    total_bytes = 0
    for oe in list(rt.gcs.objects.values()):
        counts[oe.state] = counts.get(oe.state, 0) + 1
        total_bytes += getattr(oe.loc, "size", 0) or 0
    return {"by_state": counts, "total": len(rt.gcs.objects),
            "total_size_bytes": total_bytes,
            "store_used_bytes": rt.store.used_bytes(),
            "store_capacity_bytes": getattr(rt.store, "capacity",
                                            None)}


def dispatch_summary() -> Dict[str, Any]:
    """Batched-dispatch plane health (docs/SCHEDULING.md): submit
    coalescing, worker-lease lifecycle, direct-call counters, and the
    control-plane message/frame counts the batching exists to shrink.
    Also folds in worker-reported direct-call series from the cluster
    metrics store when present."""
    rt = get_runtime()
    out: Dict[str, Any] = {"enabled": True}
    fn = getattr(rt, "dispatch_stats", None)
    if callable(fn):
        out.update(fn())
    else:   # thin client / worker runtime: no dispatcher-side stats
        out["enabled"] = False
    try:
        from . import metrics as metrics_mod  # noqa: PLC0415
        expo = metrics_mod.cluster_exposition(rt.cluster_metrics)
        direct = 0
        fallbacks = 0
        for line in expo.splitlines():
            if line.startswith("ray_tpu_direct_actor_calls_total"):
                direct += int(float(line.rsplit(" ", 1)[-1]))
            elif line.startswith("ray_tpu_direct_call_fallbacks_total"):
                fallbacks += int(float(line.rsplit(" ", 1)[-1]))
        out["direct_actor_calls"] = direct
        out["direct_call_fallbacks"] = fallbacks
    except Exception:
        pass
    return out


def persistence_summary() -> Dict[str, Any]:
    """Control-plane persistence health (core/persistence.py): driver
    incarnation, WAL length/bytes, last-snapshot age, and — after a
    resume — replayed-record count. `enabled` False when no
    RAY_TPU_STATE_DIR / init(state_dir=...) is configured."""
    rt = get_runtime()
    stats = None
    fn = getattr(rt, "persistence_stats", None)
    if callable(fn):
        stats = fn()
    if stats is None:
        return {"enabled": False,
                "driver_incarnation": getattr(rt, "incarnation", 0),
                "resumed": bool(getattr(rt, "resumed", False))}
    stats["enabled"] = True
    return stats


def _serve_controller(timeout: float = 0.2):
    """The running serve controller actor (serve/controller.py); raises
    when `serve.start`/`serve.run` has not started one."""
    import ray_tpu_torch
    from ..serve.controller import CONTROLLER_NAME
    return ray_tpu_torch.get_actor(CONTROLLER_NAME, timeout=timeout)


def serve_router_table() -> Dict[str, Any]:
    """Scale-out router view per deployment: RUNNING replica ids (the
    affinity hash-ring membership), registered prefixes with their
    current ring owner, and the recent sticky session bindings handles
    reported. {"running": False} when no serve controller exists."""
    import ray_tpu_torch
    try:
        ctrl = _serve_controller()
    except Exception:  # noqa: BLE001  controller not running
        return {"running": False, "deployments": {}}
    return {"running": True,
            "deployments": ray_tpu_torch.get(ctrl.get_router_table.remote(),
                                       timeout=5.0)}


def serve_autoscaler_status() -> Dict[str, Any]:
    """Serve autoscaler targets + recent decision log (scale_up /
    scale_down rows with reasons and placement annotations)."""
    import ray_tpu_torch
    try:
        ctrl = _serve_controller()
    except Exception:  # noqa: BLE001
        return {"running": False, "deployments": {}, "decisions": []}
    out = ray_tpu_torch.get(ctrl.get_autoscaler_status.remote(), timeout=5.0)
    out["running"] = True
    return out


def cluster_summary() -> Dict[str, Any]:
    rt = get_runtime()
    return {
        "job_id": rt.job_id,
        "namespace": rt.namespace,
        "driver_incarnation": getattr(rt, "incarnation", 0),
        "persistence": persistence_summary(),
        "nodes": len(rt.gcs.nodes),
        "workers": {s: sum(1 for w in list(rt.workers.values()) if w.state == s)
                    for s in ("starting", "idle", "busy", "actor", "dead")},
        "resources_total": rt.get_resources(),
        "resources_available": rt.available_resources(),
        "tasks": summarize_tasks()["total"],
        "actors": summarize_actors()["total"],
        "objects": summarize_objects()["total"],
    }
