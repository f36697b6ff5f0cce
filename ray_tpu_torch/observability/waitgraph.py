"""Cluster wait graph: "why is nothing happening right now".

The wait plane (util/waits.py) ships every park site's in-progress
waits to the driver; this module folds those records with the GCS
task/object/actor tables into a directed *waits-on* graph and walks it
for the three shapes of stuck:

  * **Deadlock** — a cycle. The canonical case: actor A's running
    method blocks on a call into actor B whose running method blocks
    on a call back into A. Edges close through the tables (task →
    object → producing task, actor-call → target actor → its running
    tasks), so the cycle is detected and NAMED even though no single
    process can see it.
  * **Stale wait** — a record older than `RAY_TPU_HANG_WARN_S` that is
    not part of a cycle. The chain walk follows waits-on edges to a
    terminal node — "task t parked on object o, produced by task p,
    which is EXECUTING on worker w" — so the report carries a live
    root cause, not just "something is slow".
  * **Straggler** — a collective round where some ranks have been
    parked (contributed, polling) far longer than the round should
    take while other ranks are absent: the missing ranks are still
    computing, frozen, or dead, and they are named. A SIGSTOP'd rank
    ships nothing, so detection works from the *siblings'* records.

`HangMonitor.probe()` runs the walk; the driver calls it from a
watchdog thread every `RAY_TPU_HANG_PROBE_S` and it emits
`sched.deadlock.detected` / `sched.hang.suspected` /
`sched.hang.resolved` plus `ray_tpu_hangs_detected_total{kind}`.
Every emission is once-per-incident (fingerprinted), and a suspected
hang auto-writes a forensics post-mortem for its subject so the
evidence survives the eventual mitigation.

Graph nodes are string keys: `task:<id>`, `actor:<id>`, `object:<id>`,
`collective:<rid>`, `channel:<id>`, `lease:<lid>@<node>`,
`grant:<job>`, `worker:<wid>`, `driver`.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ..util import knobs

__all__ = ["WaitGraph", "HangMonitor", "build_graph", "gather_records"]

# A chain walk stops after this many hops — wait chains are short in
# practice; anything longer is a cycle the SCC pass already found.
MAX_CHAIN_HOPS = 16

# The data-service producer pool's actor-name prefix (data/service.py
# _WORKER_NAME_FMT): stale data-grant waits chain to these actors.
_DATA_WORKER_PREFIX = "_rtpu_data_worker_"


def gather_records(rt) -> List[Dict[str, Any]]:
    """Every known wait record: remote snapshots from ClusterWaitStore
    plus the driver's own local table (stamped like a shipped source
    would be)."""
    from ..util import waits as waits_mod
    recs = rt.cluster_waits.snapshot()
    for r in waits_mod.snapshot():
        r.setdefault("worker_id", "driver")
        r.setdefault("node_id", rt.node_id)
        recs.append(r)
    return recs


class WaitGraph:
    """The folded waits-on digraph plus per-record chain context."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.nodes: Dict[str, Dict[str, Any]] = {}
        self.edges: List[Tuple[str, str, str]] = []   # (src, dst, why)
        self.adj: Dict[str, List[str]] = {}
        # record index -> its waiter node key (chain walk entry point)
        self.waiter_of: Dict[int, str] = {}

    # ---- construction ------------------------------------------------------
    def _node(self, key: str, **attrs: Any) -> str:
        n = self.nodes.get(key)
        if n is None:
            n = self.nodes[key] = {"key": key}
        for k, v in attrs.items():
            if v is not None:
                n.setdefault(k, v)
        return key

    def _edge(self, src: str, dst: str, why: str) -> None:
        if src == dst:
            return
        lst = self.adj.setdefault(src, [])
        if dst not in lst:
            lst.append(dst)
            self.edges.append((src, dst, why))

    def label(self, key: str) -> str:
        """Human line for a node: `task:abc (foo, RUNNING on w3)`."""
        n = self.nodes.get(key, {})
        bits = [str(v) for v in (n.get("name"), n.get("state")) if v]
        if n.get("worker_id"):
            bits.append(f"on {n['worker_id']}")
        return f"{key} ({', '.join(bits)})" if bits else key

    # ---- analysis ----------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Strongly-connected components with >1 node (iterative
        Tarjan — the graph is small but recursion depth is not ours to
        gamble with)."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        for root in list(self.nodes):
            if root in index:
                continue
            work: List[Tuple[str, int]] = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on_stack.add(v)
                nbrs = self.adj.get(v, [])
                advanced = False
                while pi < len(nbrs):
                    w = nbrs[pi]
                    pi += 1
                    work[-1] = (v, pi)
                    if w not in index:
                        work.append((w, 0))
                        advanced = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if low[v] == index[v]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == v:
                            break
                    if len(scc) > 1:
                        out.append(sorted(scc))
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
        return out

    def chain(self, rec_idx: int) -> List[str]:
        """Greedy waits-on walk from a record's waiter node: the
        first-listed edge at each hop, stopping on a terminal node, a
        revisit (cycle), or MAX_CHAIN_HOPS."""
        key = self.waiter_of.get(rec_idx)
        if key is None:
            return []
        seen = [key]
        cur = key
        for _ in range(MAX_CHAIN_HOPS):
            nxt = self.adj.get(cur, [])
            if not nxt:
                break
            cur = nxt[0]
            if cur in seen:
                seen.append(cur)   # show the back-edge, then stop
                break
            seen.append(cur)
        return seen

    def root_cause(self, rec_idx: int) -> str:
        ch = self.chain(rec_idx)
        if not ch:
            return "no wait chain"
        if len(ch) >= 2 and ch[-1] in ch[:-1]:
            return "cycle: " + " -> ".join(self.label(k) for k in ch)
        term = self.nodes.get(ch[-1], {})
        tail = self.label(ch[-1])
        if term.get("state") == "RUNNING":
            cause = f"{tail} is executing"
        elif ch[-1].startswith("collective:"):
            cause = f"{tail} round incomplete"
        else:
            cause = f"{tail} has no further waits-on edge"
        prefix = " -> ".join(self.label(k) for k in ch[:-1])
        return f"{prefix} -> {cause}" if prefix else cause

    def to_dict(self) -> Dict[str, Any]:
        return {
            "nodes": [dict(n) for n in self.nodes.values()],
            "edges": [{"src": s, "dst": d, "why": w}
                      for s, d, w in self.edges],
            "records": len(self.records),
        }


def build_graph(records: List[Dict[str, Any]], gcs,
                now: Optional[float] = None) -> WaitGraph:
    """Fold wait records + GCS tables into the waits-on digraph.

    Edge direction is "X cannot make progress until Y does":
      waiter task/driver -> resource -> responsible task/actor -> ...
    An actor node points at its RUNNING tasks (it cannot serve the
    waiter's call until they finish), which is the resource-allocation
    -graph approximation that closes call cycles.
    """
    now = time.time() if now is None else now
    g = WaitGraph()
    # point-in-time copies: the dispatcher thread mutates these dicts
    tasks = dict(gcs.tasks)
    objects = dict(gcs.objects)
    actors = dict(gcs.actors)

    def task_node(tid: str) -> str:
        te = tasks.get(tid)
        return g._node(f"task:{tid}",
                       name=te.name if te else None,
                       state=te.state if te else None,
                       worker_id=te.worker_id if te else None,
                       actor_id=te.actor_id if te else None)

    def actor_node(aid: str) -> str:
        ae = actors.get(aid)
        return g._node(f"actor:{aid}",
                       name=ae.class_name if ae else None,
                       state=ae.state if ae else None,
                       worker_id=ae.worker_id if ae else None)

    # An actor's worker runs only that actor's methods, so a parked
    # record from that worker IS the actor's current task even when
    # the task itself is invisible to the driver (direct calls).
    actor_on_worker: Dict[str, str] = {
        ae.worker_id: aid for aid, ae in actors.items()
        if ae.worker_id and ae.state != "DEAD"}

    # ---- pass 1: waiter -> resource edges ---------------------------------
    grant_jobs: Set[str] = set()
    for i, r in enumerate(records):
        g.records.append(r)
        kind, rid = r.get("kind", "other"), r.get("rid", "")
        ctx = r.get("ctx") or {}
        tid = r.get("task_id") or ctx.get("task")
        if tid:
            waiter = task_node(tid)
            te = tasks.get(tid)
            # the actor cannot serve other callers while this (running,
            # parked) task occupies it; for direct-call tasks the GCS
            # has no entry, so fall back to the record's worker
            aid = (te.actor_id if te is not None and te.actor_id
                   else actor_on_worker.get(r.get("worker_id", "")))
            if aid:
                g._edge(actor_node(aid), waiter, "running-task")
        elif r.get("worker_id") == "driver" or ctx.get("waiter") == "driver":
            waiter = g._node("driver")
        else:
            waiter = g._node(f"worker:{r.get('worker_id', '?')}")
        g.waiter_of[i] = waiter
        g.nodes[waiter].setdefault("parked_since", r.get("ts"))

        if kind == "object":
            res = g._node(f"object:{rid}")
            g._edge(waiter, res, "get")
        elif kind == "actor-call":
            target = ctx.get("target_actor")
            if not target:
                oe = objects.get(rid)
                if oe is not None and oe.owner_task:
                    te = tasks.get(oe.owner_task)
                    target = te.actor_id if te else None
            if target:
                res = actor_node(target)
            else:
                res = g._node(f"object:{rid}")
            g._edge(waiter, res, "call")
        elif kind == "collective-round":
            res = g._node(f"collective:{rid}",
                          group=ctx.get("group"), seq=ctx.get("seq"),
                          world=ctx.get("world"))
            g._edge(waiter, res, "round")
        elif kind == "dag-channel":
            res = g._node(f"channel:{rid}", op=ctx.get("op"))
            g._edge(waiter, res, ctx.get("op") or "dag")
        elif kind == "lease-slot":
            res = g._node(f"lease:{rid}@{r.get('node_id', '?')}",
                          queued=ctx.get("queued"))
            g._edge(waiter, res, "queue")
        elif kind == "data-grant":
            job = ctx.get("job") or rid
            res = g._node(f"grant:{job}")
            g._edge(waiter, res, "next_shard")
            grant_jobs.add(job)
        else:
            res = g._node(f"other:{rid}")
            g._edge(waiter, res, kind)

    # ---- pass 2: resource -> responsible-party edges ----------------------
    # a pending object is produced by its owner task; a queued (not
    # yet running) actor call waits on its target actor. Together with
    # the actor -> running-parked-task edges these close driver-path
    # call cycles the same way ctx.target_actor closes direct-call
    # ones: tA -> obj -> tB2(queued) -> actor:B -> tB -> obj' -> ...
    for key in list(g.nodes):
        if key.startswith("object:"):
            oid = key[len("object:"):]
            oe = objects.get(oid)
            if oe is not None and oe.state == "pending" and oe.owner_task:
                g._edge(key, task_node(oe.owner_task), "produced-by")
    for key in list(g.nodes):
        if key.startswith("task:"):
            te = tasks.get(key[len("task:"):])
            if te is not None and te.actor_id \
                    and te.state in ("PENDING", "SCHEDULED"):
                g._edge(key, actor_node(te.actor_id), "queued-on")
    # a starved data-service job waits on the producer pool
    if grant_jobs:
        for aid, ae in actors.items():
            if (ae.name or "").startswith(_DATA_WORKER_PREFIX) \
                    and ae.state != "DEAD":
                for job in grant_jobs:
                    g._edge(f"grant:{job}", actor_node(aid), "producer")
    # every actor anyone waits on cannot make progress until its
    # RUNNING tasks finish (parked ones continue the chain / close the
    # cycle; computing ones terminate it with a live "is executing"
    # root cause)
    running_by_actor: Dict[str, List[str]] = {}
    for tid, te in tasks.items():
        if te.state == "RUNNING" and te.actor_id:
            running_by_actor.setdefault(te.actor_id, []).append(tid)
    for akey in [k for k in g.nodes if k.startswith("actor:")]:
        for tid in running_by_actor.get(akey[len("actor:"):], []):
            g._edge(akey, task_node(tid), "running-task")
    return g


def detect_stragglers(records: List[Dict[str, Any]], now: float,
                      warn_s: float) -> List[Dict[str, Any]]:
    """Collective rounds where parked ranks have aged past `warn_s`
    while other ranks are absent (still computing / frozen / dead) or
    parked on an earlier round: name the laggards.

    Grouping key is (group, epoch, generation): ranks of the same
    group incarnation. Within it, ranks parked on the HIGHEST seq are
    up to date; everyone else — missing or parked behind — is a
    straggler candidate."""
    groups: Dict[Tuple, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("kind") != "collective-round":
            continue
        ctx = r.get("ctx") or {}
        key = (ctx.get("group"), ctx.get("epoch"), ctx.get("generation"))
        groups.setdefault(key, []).append(r)
    out: List[Dict[str, Any]] = []
    for (group, epoch, gen), recs in groups.items():
        oldest = min(r.get("ts", now) for r in recs)
        if now - oldest < warn_s:
            continue
        world = max(int((r.get("ctx") or {}).get("world") or 0)
                    for r in recs)
        seqs = {int((r.get("ctx") or {}).get("seq") or 0) for r in recs}
        head = max(seqs) if seqs else 0
        parked = {}
        for r in recs:
            rk = (r.get("ctx") or {}).get("rank")
            if rk is not None:
                parked[int(rk)] = r
        at_head = {rk for rk, r in parked.items()
                   if int((r.get("ctx") or {}).get("seq") or 0) == head}
        missing = [rk for rk in range(world) if rk not in parked]
        behind = sorted(set(parked) - at_head)
        if not missing and not behind:
            continue   # everyone parked on the same round: not a
            # straggler shape (could be a stale/deadlocked round)
        rounds = sorted({(r.get("ctx") or {}).get("round")
                         for r in recs if (r.get("ctx") or {}).get("round")})
        out.append({"group": group, "epoch": epoch, "generation": gen,
                    "world": world, "seq": head,
                    "round": rounds[0] if rounds else None,
                    "parked_ranks": sorted(at_head),
                    "behind_ranks": behind,
                    "missing_ranks": missing,
                    "stuck_s": round(now - oldest, 1)})
    return out


class HangMonitor:
    """Stateful watchdog: fingerprints incidents so each deadlock /
    suspected hang / straggler emits exactly once, and emits
    `sched.hang.resolved` when a previously-suspected wait drains."""

    def __init__(self, rt) -> None:
        self.rt = rt
        self._lock = threading.Lock()
        self._cycles_seen: Set[frozenset] = set()
        # incident key -> {"first": ts, "info": {...}} for resolution
        self._suspected: Dict[Any, Dict[str, Any]] = {}
        self._snapshots = 0
        self.max_snapshots = 8    # forensics bundles per driver life
        self.last_probe: Dict[str, Any] = {}

    # ---- helpers -----------------------------------------------------------
    def _emit(self, etype: str, msg: str, **fields: Any) -> None:
        try:
            from ..util import events as events_mod
            events_mod.emit_safe(etype, msg, **fields)
        except Exception:  # noqa: BLE001
            pass

    def _count(self, kind: str) -> None:
        try:
            from ..util import metrics_catalog as mcat
            mcat.get("ray_tpu_hangs_detected_total").inc(
                tags={"kind": kind})
        except Exception:  # noqa: BLE001
            pass

    def _forensics(self, subject_id: Optional[str]) -> None:
        """Best-effort post-mortem for a suspected hang's subject so
        the wait chain's evidence survives mitigation. Bounded: hangs
        can be recurrent, disks are not. Snapshots land in the temp
        dir, not the driver's cwd — an auto-writer must not litter."""
        if not subject_id or self._snapshots >= self.max_snapshots:
            return
        self._snapshots += 1
        try:
            import os  # noqa: PLC0415
            import tempfile  # noqa: PLC0415

            from . import forensics
            forensics.write_post_mortem(subject_id, os.path.join(
                tempfile.gettempdir(),
                f"rtpu-hang-{subject_id}.json"))
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _rec_key(r: Dict[str, Any]) -> Tuple:
        return (r.get("worker_id"), r.get("tok"),
                round(float(r.get("ts", 0.0)), 2))

    @staticmethod
    def _rec_subject(r: Dict[str, Any]) -> Optional[str]:
        return r.get("task_id") or (r.get("ctx") or {}).get("task")

    # ---- the probe ---------------------------------------------------------
    def probe(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One watchdog pass. Returns a summary (tests call this
        directly instead of waiting out the thread cadence)."""
        now = time.time() if now is None else now
        warn_s = knobs.get_float("RAY_TPU_HANG_WARN_S")
        records = gather_records(self.rt)
        g = build_graph(records, self.rt.gcs, now=now)
        summary: Dict[str, Any] = {"records": len(records),
                                   "deadlocks": [], "suspected": [],
                                   "stragglers": [], "resolved": []}

        # -- deadlocks: cycles in the waits-on graph ------------------------
        in_cycle: Set[str] = set()
        for scc in g.cycles():
            in_cycle.update(scc)
            fp = frozenset(scc)
            cyc = {"nodes": scc,
                   "edges": [{"src": s, "dst": d, "why": w}
                             for s, d, w in g.edges
                             if s in fp and d in fp],
                   "labels": [g.label(k) for k in scc]}
            summary["deadlocks"].append(cyc)
            with self._lock:
                new = fp not in self._cycles_seen
                if new:
                    self._cycles_seen.add(fp)
            if new:
                parts = ", ".join(cyc["labels"])
                self._emit(
                    "sched.deadlock.detected",
                    f"waits-on cycle among {len(scc)} nodes: {parts}",
                    kind="deadlock", nodes=scc, edges=cyc["edges"],
                    task_id=next((k.split(":", 1)[1] for k in scc
                                  if k.startswith("task:")), None),
                    actor_id=next((k.split(":", 1)[1] for k in scc
                                   if k.startswith("actor:")), None))
                self._count("deadlock")
                self._forensics(next(
                    (k.split(":", 1)[1] for k in scc
                     if k.startswith(("task:", "actor:"))), None))

        # -- stale waits: aged records outside any cycle --------------------
        live: Set[Any] = set()
        for i, r in enumerate(records):
            age = now - float(r.get("ts", now))
            if age < warn_s:
                continue
            key = self._rec_key(r)
            live.add(key)
            waiter = g.waiter_of.get(i, "?")
            if waiter in in_cycle:
                continue      # already reported as a deadlock
            cause = g.root_cause(i)
            info = {"kind": r.get("kind"), "rid": r.get("rid"),
                    "waiter": waiter, "worker_id": r.get("worker_id"),
                    "age_s": round(age, 1), "root_cause": cause}
            summary["suspected"].append(info)
            with self._lock:
                new = key not in self._suspected
                if new:
                    self._suspected[key] = {"first": now, "info": info,
                                            "ts": r.get("ts")}
            if new:
                self._emit(
                    "sched.hang.suspected",
                    f"{waiter} stuck {age:.0f}s on "
                    f"{r.get('kind')}:{r.get('rid')} — {cause}",
                    kind="stale", wait_kind=r.get("kind"),
                    rid=r.get("rid"), age_s=round(age, 1),
                    root_cause=cause,
                    task_id=self._rec_subject(r),
                    worker_id=r.get("worker_id"),
                    node_id=r.get("node_id"))
                self._count("stale")
                self._forensics(self._rec_subject(r))

        # -- resolved: previously-suspected waits that drained --------------
        with self._lock:
            gone = [k for k in self._suspected if k not in live]
            for k in gone:
                ent = self._suspected.pop(k)
                stuck = now - float(ent.get("ts") or ent["first"])
                info = ent["info"]
                summary["resolved"].append(info)
                self._emit(
                    "sched.hang.resolved",
                    f"{info['waiter']} unstuck after {stuck:.0f}s "
                    f"({info['kind']}:{info['rid']})",
                    kind=info.get("kind"), stuck_s=round(stuck, 1),
                    worker_id=info.get("worker_id"))

        # -- collective stragglers ------------------------------------------
        for s in detect_stragglers(records, now, warn_s):
            summary["stragglers"].append(s)
            skey = ("straggler", s["group"], s["epoch"],
                    s["generation"], s["seq"])
            with self._lock:
                new = skey not in self._suspected
                if new:
                    self._suspected[skey] = {
                        "first": now, "ts": now - s["stuck_s"],
                        "info": {"kind": "straggler",
                                 "rid": f"{s['group']}:{s['seq']}",
                                 "waiter": f"collective:{s['group']}",
                                 "worker_id": None}}
            if new:
                lag = s["missing_ranks"] + s["behind_ranks"]
                self._emit(
                    "sched.hang.suspected",
                    f"collective group {s['group']!r} round "
                    f"{s['round']} seq {s['seq']}: ranks "
                    f"{s['parked_ranks']} parked {s['stuck_s']}s "
                    f"waiting on ranks {lag} "
                    f"(missing={s['missing_ranks']}, "
                    f"behind={s['behind_ranks']})",
                    kind="straggler", group=s["group"],
                    seq=s["seq"], round=s["round"],
                    missing_ranks=s["missing_ranks"],
                    behind_ranks=s["behind_ranks"],
                    stuck_s=s["stuck_s"])
                self._count("straggler")
        # straggler incidents resolve through the same `gone` path on
        # the next probe once the group's rounds start completing

        self.last_probe = summary
        return summary
