"""Global Control Store — cluster metadata tables.

Reference parity: src/ray/gcs/gcs_server/ (actor table, node table, job
table, named-actor index, pubsub). In a single-controller runtime these are
in-driver dictionaries mutated only by the runtime dispatcher thread, so no
locks are needed on the hot path; read-only snapshots are exposed to the
state API (ray_tpu/util/state.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ObjectEntry:
    object_id: str
    state: str = "pending"            # pending | ready | error
    loc: Any = None                   # ObjectLocation when ready
    error: Any = None                 # serialized TaskError when state=error
    owner_task: str = ""
    created_at: float = 0.0
    pinned: bool = True
    # Additional locations (e.g. the original remote copy after a fetch
    # re-hosted the payload locally); all are freed together.
    copies: List[Any] = dataclasses.field(default_factory=list)
    # The producing task's spec was evicted from the driver's lineage
    # table (RAY_TPU_LINEAGE_BYTES): this object can no longer be
    # reconstructed and loss reports must say so.
    lineage_evicted: bool = False
    # Bumped on every seal (initial + lineage reseals); locations are
    # stamped with it so stale unreachable reports are ignorable.
    seal_seq: int = 0


@dataclasses.dataclass
class ActorEntry:
    actor_id: str
    name: Optional[str]
    namespace: str
    class_name: str
    state: str = "PENDING"            # PENDING|ALIVE|RESTARTING|DEAD
    worker_id: Optional[str] = None
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    max_restarts: int = 0
    num_restarts: int = 0
    death_cause: str = ""
    create_spec: Any = None           # retained for restarts


@dataclasses.dataclass
class TaskEntry:
    task_id: str
    name: str
    state: str = "PENDING"            # PENDING|SCHEDULED|RUNNING|FINISHED|FAILED|CANCELLED
    worker_id: Optional[str] = None
    actor_id: Optional[str] = None
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    retries_left: int = 0
    # actor-method concurrency group this task dispatched under (None =
    # the default lane); read back to decrement the right counter
    concurrency_group: Optional[str] = None
    # trace linkage (util/tracing.py): the submit span this entry
    # represents in the timeline, and the span it parents to
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""


@dataclasses.dataclass
class NodeEntry:
    node_id: str
    hostname: str
    resources: Dict[str, float]
    alive: bool = True
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Bumped each time the same node_id re-registers after a declared
    # death (preempted host rejoining); messages from older incarnations
    # are fenced by the driver.
    incarnation: int = 0


class GCS:
    def __init__(self) -> None:
        self.objects: Dict[str, ObjectEntry] = {}
        self.actors: Dict[str, ActorEntry] = {}
        self.tasks: Dict[str, TaskEntry] = {}
        self.nodes: Dict[str, NodeEntry] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}   # (ns, name) -> actor_id
        self._subscribers: Dict[str, List[Callable[[Any], None]]] = {}
        self.kv: Dict[str, bytes] = {}                       # internal KV (jobs, serve)

    # -- objects ------------------------------------------------------------
    def add_pending_object(self, oid: str, owner_task: str = "") -> ObjectEntry:
        e = ObjectEntry(object_id=oid, owner_task=owner_task,
                        created_at=time.time())
        self.objects[oid] = e
        return e

    def seal_object(self, oid: str, loc: Any) -> ObjectEntry:
        e = self.objects.get(oid) or self.add_pending_object(oid)
        e.state, e.loc = "ready", loc
        e.seal_seq += 1
        try:
            loc.seal_seq = e.seal_seq
        except Exception:
            pass
        return e

    def fail_object(self, oid: str, error: Any) -> ObjectEntry:
        e = self.objects.get(oid) or self.add_pending_object(oid)
        e.state, e.error = "error", error
        return e

    # -- actors -------------------------------------------------------------
    def register_named_actor(self, ns: str, name: str, actor_id: str) -> bool:
        key = (ns, name)
        if key in self.named_actors:
            existing = self.actors.get(self.named_actors[key])
            if existing is not None and existing.state != "DEAD":
                return False
        self.named_actors[key] = actor_id
        return True

    def lookup_named_actor(self, ns: str, name: str) -> Optional[str]:
        aid = self.named_actors.get((ns, name))
        if aid is None:
            return None
        entry = self.actors.get(aid)
        if entry is None or entry.state == "DEAD":
            return None
        return aid

    # -- pubsub -------------------------------------------------------------
    def publish(self, channel: str, msg: Any) -> None:
        for cb in self._subscribers.get(channel, []):
            cb(msg)

    def subscribe(self, channel: str, cb: Callable[[Any], None]) -> None:
        self._subscribers.setdefault(channel, []).append(cb)
