"""Worker process: executes tasks and hosts actors.

Reference parity: src/ray/core_worker/core_worker.cc (task execution,
arg resolution, return-object sealing) + python/ray/_private/worker.py
(the Python worker loop). One OS process per worker; a reader thread
demultiplexes driver messages into an execution queue and reply slots, so
user code can block in `get()` while new messages keep flowing.

Run as: python -m ray_tpu_torch.core.worker <socket_path> <worker_id>
"""
from __future__ import annotations

import collections
import os
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from . import logging as logging_mod
from . import scheduling as sched_mod
from . import serialization
from .ids import new_object_id
from .object_ref import ObjectRef
from .object_store import ShmStore, ObjectLocation, INLINE_MAX, make_store
from .protocol import Connection, ConnectionClosed, connect_address
from .task import TaskSpec, ActorCreationSpec
from ..exceptions import (ActorDiedError, TaskError, GetTimeoutError,
                          ObjectLostError)
from ..util import events as events_mod
from ..util import metrics as metrics_mod
from ..util import knobs
from ..util import metrics_catalog as mcat
from ..util import tracing
from ..util import waits as waits_mod


class _MsgBatcher:
    """Coalesces worker->driver control messages (task_done / put /
    gen_item / submit) into ("batch", [...]) frames under a size + time
    flush window, so a map-style fan-out (or a storm of sub-millisecond
    completions) costs one frame per batch instead of one per message.
    Send order is preserved across message kinds — dependent verbs
    (get_request after a buffered put) flush first. urgent=True flushes
    synchronously: the task queue drained, or a verb the driver must
    see NOW (actor_exit's final result) depends on the message."""

    def __init__(self, conn: Connection, max_n: int = 64,
                 window: float = 0.001, enabled: bool = True):
        self.conn = conn
        self.max_n = max_n
        self.window = window
        self.enabled = enabled and max_n > 1
        self._buf: List[tuple] = []
        self._lock = threading.Lock()
        # serializes swap+send so flush() only returns once every
        # message buffered BEFORE the call is on the socket — the
        # ordering fences (actor_exit / kill / get after buffered put)
        # rely on that, and a bare buffer-swap in the loop thread would
        # let flush() return with the frame still unsent
        self._send_lock = threading.Lock()
        self._event = threading.Event()
        if self.enabled:
            threading.Thread(target=self._loop, daemon=True,
                             name="worker-msg-flush").start()

    def send(self, msg: tuple, urgent: bool = False) -> None:
        if not self.enabled:
            self.conn.send(msg)
            return
        with self._lock:
            self._buf.append(msg)
            n = len(self._buf)
        if urgent or n >= self.max_n:
            self.flush()
        else:
            self._event.set()

    def flush(self) -> None:
        with self._send_lock:
            with self._lock:
                if not self._buf:
                    return
                buf, self._buf = self._buf, []
            if len(buf) == 1:
                # raylint: disable=RT001 deliberate: swap+send serialize under
                # the send lock so the flush ordering fence holds
                # (SCHEDULING.md); the one re-entry path (_publish_direct)
                # bypasses the batcher and sends straight on the Connection
                self.conn.send(buf[0])
            else:
                # raylint: disable=RT001 deliberate: same ordering fence as the
                # single-message branch above
                self.conn.send(("batch", buf))

    def _loop(self) -> None:
        while True:
            if not self._event.wait(timeout=0.5):
                continue
            self._event.clear()
            if self.window > 0:
                time.sleep(self.window)
            try:
                self.flush()
            except Exception:
                pass   # ConnectionClosed: read loop handles the death


class _DirectFuture:
    """Local future for one driver-bypass actor call (the caller owns
    the result; the driver never hears about the task). `failover`
    flips when the channel died and the spec was resubmitted through
    the driver — the oid then resolves via the normal get path."""
    __slots__ = ("ev", "payload", "error", "failover", "publish",
                 "_published", "actor_id")

    def __init__(self):
        self.ev = threading.Event()
        self.payload: Optional[bytes] = None   # serialization.pack(...)
        self.error: Optional[BaseException] = None
        self.failover = False
        self.actor_id: Optional[str] = None    # callee (wait-graph edge)
        # an escaped ref (serialized out of this process) must seal the
        # value driver-side so any reader anywhere can resolve it
        self.publish = False
        self._published = False


class _DirectChannel:
    """Caller side of one worker->worker direct-call connection
    (resolved once via the sys.actor_addr directory, then every call
    rides this socket with zero driver messages)."""

    def __init__(self, rt: "WorkerRuntime", actor_id: str,
                 worker_id: str, addr: str):
        self.rt = rt
        self.actor_id = actor_id
        self.worker_id = worker_id
        self.conn = connect_address(addr, timeout=5.0)
        self.dead = False
        self._lock = threading.Lock()
        self._rid = 0
        self._pending: Dict[int, tuple] = {}   # rid -> (spec, future)
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"dcall-{actor_id[-8:]}").start()

    def call(self, spec: TaskSpec, fut: _DirectFuture) -> bool:
        with self._lock:
            if self.dead:
                return False
            self._rid += 1
            rid = self._rid
            self._pending[rid] = (spec, fut)
        try:
            self.conn.send(("dcall", rid, spec))
        except ConnectionClosed as e:
            with self._lock:
                self._pending.pop(rid, None)
            self._fail(f"send failed: {e}")
            return False
        return True

    def _read_loop(self) -> None:
        while True:
            try:
                # raylint: disable=RT003 daemon reader; in-flight calls
                # settle via driver-path failover once the callee's
                # death is determined (SCHEDULING.md), so a half-open
                # channel parks only this thread, never a caller
                m = self.conn.recv()
            except ConnectionClosed as e:
                self._fail(f"connection lost: {e}")
                return
            if m[0] == "dresult":
                _, rid, ok, payload = m
                with self._lock:
                    entry = self._pending.pop(rid, None)
                if entry is None:
                    continue
                _spec, fut = entry
                if ok:
                    fut.payload = payload
                else:
                    fut.error = payload if isinstance(
                        payload, BaseException) else TaskError(str(payload))
                self.rt._direct_resolved(fut)
            elif m[0] == "dreject":
                # stale address (the actor moved / died): every pending
                # call fails over through the driver and the channel is
                # retired — the next call re-resolves the directory
                self._fail("callee rejected (stale address)")
                return

    def _fail(self, reason: str = "") -> None:
        with self._lock:
            if self.dead:
                return
            self.dead = True
            pending, self._pending = self._pending, {}
        if pending or reason:
            sys.stderr.write(
                f"[ray_tpu worker] direct channel to actor "
                f"{self.actor_id} failed ({reason}); "
                f"{len(pending)} in-flight calls fail over to the "
                f"driver path\n")
        self.rt._drop_direct_channel(self.actor_id, self)
        try:
            self.conn.close()
        except Exception:
            pass
        # in-flight direct calls FAIL OVER to the driver path: the
        # driver then applies its normal actor semantics (queue behind
        # a restart, or ActorDiedError with the death cause)
        for _rid, (spec, fut) in pending.items():
            fut.failover = True
            try:
                self.rt._batch.send(("submit", spec), urgent=True)
            except Exception:
                fut.failover = False
                fut.error = ActorDiedError(
                    f"direct call to actor {self.actor_id} lost its "
                    f"channel and the driver connection is gone")
            self.rt._direct_resolved(fut)


# How long a get() on an agent-placed result stays silent before telling
# the driver this worker is blocked (dwait CPU lend). Longer than the
# direct-call grace: short fan-outs must finish with ZERO driver frames
# (the two-level scheduling steady-state property), while anything slower
# still lends its CPU so capacity-tight gangs keep their liveness.
_AGENT_GRACE_S = 0.2


class _AgentFuture:
    """Local future for one task this worker submitted to its NODE AGENT
    (two-level scheduling, docs/SCHEDULING.md — the driver never hears
    about it). Resolves to a host-kind seal location in the node's
    shared arena. `failover` flips when the result must resolve through
    the driver instead: the agent forwarded the spec upward, or the
    agent plane died and the spec was resubmitted."""
    __slots__ = ("ev", "loc", "error", "failover", "publish",
                 "_published", "spec")

    def __init__(self, spec: TaskSpec):
        self.ev = threading.Event()
        self.loc = None                        # sealed ObjectLocation
        self.error: Optional[BaseException] = None
        self.failover = False
        self.publish = False
        self._published = False
        self.spec = spec                       # retained for failover


class _AgentPlane:
    """Worker side of the node agent's local dispatch plane (two-level
    scheduling, docs/SCHEDULING.md). One unix-socket connection to the
    agent that spawned this worker: the agent pushes bulk-lease tasks
    down (`aexec`) and this worker's own fan-outs go up (`asubmit`) for
    node-local placement — zero driver messages steady-state. On plane
    death every unresolved submission fails over to the driver path."""

    def __init__(self, loop: "WorkerLoop", addr: str):
        self.loop = loop
        self.rt = loop.rt
        self.conn = connect_address(addr)
        self.dead = False
        # completions coalesce like the worker->driver batcher does:
        # a pipelined backlog of sub-millisecond tasks acks in one
        # frame per window instead of one per task. urgent=True
        # flushes in order, so routing every verb through the batcher
        # keeps adone/asubmit ordering intact.
        self._batch = _MsgBatcher(
            self.conn,
            max_n=knobs.get_int("RAY_TPU_BATCH_FLUSH_N"),
            window=knobs.get_float("RAY_TPU_BATCH_FLUSH_S"),
            enabled=knobs.get_bool("RAY_TPU_BATCH"))
        self._batch.send(("aregister", loop.worker_id), urgent=True)
        threading.Thread(target=self._read_loop, daemon=True,
                         name="agent-plane").start()

    def _read_loop(self) -> None:
        rt = self.rt
        while True:
            try:
                # raylint: disable=RT003 node-local peer: agent death
                # closes the socket, and _fail() fails every unresolved
                # future over to the driver path
                m = self.conn.recv()
            except (ConnectionClosed, OSError):
                self._fail()
                return
            k = m[0]
            if k == "aexec":
                # one frame carries the worker's whole refill batch
                for spec, dep_locs, host_seal in m[1]:
                    spec._via_agent = True
                    spec._host_seal = bool(host_seal)
                    if dep_locs:
                        # pre-resolved dependency locations (node-local
                        # results): arg resolution reads them straight
                        # from the shared arena, no driver get_request
                        rt._agent_locs_update(dep_locs)
                    self.loop._task_q.put(("task", spec))
            elif k == "aresult":
                rt._agent_resolve(m[1], m[2], m[3])
            elif k == "aspill":
                rt._agent_spilled(m[1])

    def submit(self, spec: TaskSpec) -> List[ObjectRef]:
        rt = self.rt
        with rt._agent_lock:
            for oid in spec.return_ids:
                rt._register_agent_future(oid, _AgentFuture(spec))
            rt._agent_tasks[spec.task_id] = list(spec.return_ids)
        try:
            # urgent: the child's placement latency is on the parent's
            # critical path, and the ordered flush pushes any buffered
            # adone (a dep the child needs recorded) out first
            self._batch.send(("asubmit", [spec]), urgent=True)
        except (ConnectionClosed, OSError):
            self._fail()   # flips these futures to driver resubmission
        return [ObjectRef(oid) for oid in spec.return_ids]

    def task_done(self, tid: str, sealed, error) -> bool:
        """Route one agent-dispatched completion back to the agent.
        False when the plane is dead — the caller falls back to the
        driver connection so the result is not lost."""
        if self.dead:
            return False
        try:
            # flush NOW only when the local backlog drained — the
            # agent is waiting to refill; mid-backlog acks coalesce
            self._batch.send(("adone", tid, sealed, error),
                             urgent=self.loop._task_q.empty())
            return True
        except (ConnectionClosed, OSError):
            self._fail()
            return False

    def _fail(self) -> None:
        """Agent plane died: resubmit every unresolved agent-placed
        spec through the driver (at-least-once, like a direct-call
        channel death) and flip its futures to driver-path resolution."""
        rt = self.rt
        with rt._agent_lock:
            if self.dead:
                return
            self.dead = True
            pending = []
            for tid, oids in rt._agent_tasks.items():
                for oid in oids:
                    f = rt._agent_results.get(oid)
                    if f is not None and not f.ev.is_set():
                        pending.append((tid, oids))
                        break
        if pending:
            sys.stderr.write(
                f"[ray_tpu worker] agent dispatch plane lost; "
                f"{len(pending)} in-flight nested tasks fail over to "
                f"the driver path\n")
        for _tid, oids in pending:
            spec = None
            for oid in oids:
                f = rt._agent_results.get(oid)
                if f is not None and not f.ev.is_set():
                    f.failover = True
                    spec = spec or f.spec
            if spec is not None:
                try:
                    rt._batch.send(("submit", spec), urgent=True)
                except Exception:
                    err = TaskError(
                        "agent plane and driver connection both lost",
                        "", spec.name)
                    for oid in oids:
                        f = rt._agent_results.get(oid)
                        if f is not None and not f.ev.is_set():
                            f.failover = False
                            f.error = err
            for oid in oids:
                f = rt._agent_results.get(oid)
                if f is not None:
                    f.ev.set()
        with rt._direct_cv:
            rt._direct_cv.notify_all()


class WorkerRuntime:
    """The runtime visible to user code running inside this worker.

    Implements the same verbs as the driver runtime so `ray_tpu_torch.get/put/
    remote` work transparently in nested tasks.
    """

    is_driver = False

    # resolved direct-call results retained past this bound evict
    # oldest-first (their refs were never re-read); a late get of an
    # evicted one raises ObjectLostError naming the bound
    _DIRECT_RESULT_RETAIN = 8192

    def __init__(self, conn: Connection, worker_id: str, store: ShmStore):
        self.conn = conn
        self.worker_id = worker_id
        self.store = store
        self._replies: Dict[str, queue.Queue] = {}
        self._replies_lock = threading.Lock()
        # (rid, oid) -> bytearray for cross-node values streamed in
        # chunks ahead of the final get_reply (same socket => in order)
        self._value_chunks: Dict[tuple, bytearray] = {}
        self._req_counter = 0
        self._func_cache: Dict[str, Any] = {}
        self.current_task_id: Optional[str] = None
        self.current_actor_id: Optional[str] = None
        self.current_gpu_ids: list = []
        # this worker's actor began life via __ray_restore__ (surfaced
        # as RuntimeContext.was_current_actor_reconstructed)
        self.actor_restored = False
        self.job_id = knobs.get_str("RAY_TPU_JOB_ID")
        # outbound control-message batcher (WorkerLoop swaps in the
        # real one before the first task runs); the default passthrough
        # keeps early sends working
        self._batch = _MsgBatcher(conn, enabled=False)
        # WorkerLoop points this at its span buffer so fast-path
        # instrumentation (direct-call submits, DAG stages) can record
        # spans that ride the telemetry heartbeat — never the control
        # plane
        self._span_sink = None
        # ---- driver-bypass actor calls (docs/SCHEDULING.md) ----
        self._direct_enabled = knobs.get_bool("RAY_TPU_DIRECT_CALLS")
        self._direct_lock = threading.Lock()
        self._direct_chans: Dict[str, _DirectChannel] = {}
        self._direct_retry_after: Dict[str, float] = {}
        # oid -> _DirectFuture for calls this process fired direct;
        # insertion-ordered so resolution-retention can evict oldest
        self._direct_results: "collections.OrderedDict[str, _DirectFuture]" \
            = collections.OrderedDict()
        self._direct_evicted: set = set()
        self._direct_cv = threading.Condition()
        # threads inside force_driver_path() route actor calls through
        # the driver (rendezvous/polling patterns whose LIVENESS depends
        # on the scheduler seeing their blocking verbs — the driver path
        # lends the worker's CPU while it waits; util/collective.py)
        self._no_direct = threading.local()
        self.direct_calls = 0
        self.direct_fallbacks = 0
        # ---- agent-local dispatch (two-level scheduling) ----
        # set by WorkerLoop when a node agent spawned this worker
        self._agent_plane: Optional[_AgentPlane] = None
        self._agent_lock = threading.Lock()
        # oid -> _AgentFuture for fan-out tasks routed to the node agent
        self._agent_results: "collections.OrderedDict[str, _AgentFuture]" \
            = collections.OrderedDict()
        # task_id -> its return oids (error fan-in, failover resubmit)
        self._agent_tasks: "collections.OrderedDict[str, list]" \
            = collections.OrderedDict()
        self._agent_evicted: set = set()
        # oids known node-resolvable (agent-placed results, agent-stamped
        # dep locations): a fan-out whose ref args all live here may
        # route to the agent without a cross-connection ordering hazard
        # (the driver may not know these oids at all)
        self._agent_known: set = set()
        # oid -> host-kind location the agent stamped at dispatch
        self._agent_locs: dict = {}

    def force_driver_path(self):
        """Context manager: actor calls from this thread take the
        driver dispatch path even when a direct channel exists."""
        import contextlib  # noqa: PLC0415
        rt = self

        @contextlib.contextmanager
        def cm():
            prev = getattr(rt._no_direct, "on", False)
            rt._no_direct.on = True
            try:
                yield
            finally:
                rt._no_direct.on = prev
        return cm()

    # ---- request/reply over the driver connection -------------------------
    def _new_req(self) -> str:
        with self._replies_lock:
            self._req_counter += 1
            rid = f"{self.worker_id}:{self._req_counter}"
            q: queue.Queue = queue.Queue(maxsize=1)
            self._replies[rid] = q
        return rid

    def _take_reply(self, rid: str, timeout: Optional[float]) -> Any:
        q = self._replies[rid]
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            raise GetTimeoutError(f"request {rid} timed out") from None
        finally:
            with self._replies_lock:
                self._replies.pop(rid, None)

    def stash_value_chunk(self, rid: str, oid: str, off: int,
                          total: int, chunk: bytes) -> None:
        buf = self._value_chunks.get((rid, oid))
        if buf is None:
            buf = self._value_chunks[(rid, oid)] = bytearray(total)
        buf[off:off + len(chunk)] = chunk

    def take_staged_value(self, rid: str, oid: str) -> bytes:
        return bytes(self._value_chunks.pop((rid, oid)))

    def deliver_reply(self, rid: str, payload: Any) -> None:
        with self._replies_lock:
            q = self._replies.get(rid)
        if q is not None:
            q.put(payload)

    # ---- direct actor calls ----------------------------------------------
    def _direct_resolved(self, fut: _DirectFuture) -> None:
        """Channel-reader-side resolution: wake waiters and run the
        escape publication if this result's ref left the process."""
        fut.ev.set()
        with self._direct_cv:
            self._direct_cv.notify_all()
        if fut.publish and not fut.failover:
            for oid, f in list(self._direct_results.items()):
                if f is fut:
                    self._publish_direct(oid, fut)
                    break

    def _publish_direct(self, oid: str, fut: _DirectFuture) -> None:
        """Seal a direct-call result into the driver's object table: its
        ref escaped this process (was serialized into a spec / put /
        return value), so readers anywhere must be able to resolve it."""
        if fut._published or fut.failover:
            return
        fut._published = True
        try:
            # straight to the socket, NOT through the batcher: this can
            # run from inside a batch flush (ObjectRef.__reduce__ fires
            # while the flush pickles a buffered spec, under the
            # batcher's non-reentrant send lock — an urgent batched send
            # here would self-deadlock). Connection.send encodes outside
            # its socket lock, so the nested frame is safe and lands
            # BEFORE the spec that references the oid.
            if fut.error is not None:
                self.conn.send(("put_error", oid, fut.error))
            else:
                loc = self.store.put_packed(oid, fut.payload)
                self.conn.send(("put", oid, loc))
        except Exception:
            pass   # driver gone: nothing to publish to

    def on_ref_serialized(self, oid: str) -> None:
        """ObjectRef.__reduce__ hook: a ref leaving this process by
        serialization may reach readers that resolve through the
        driver — publish direct-call and agent-placed results so they
        can."""
        fut = self._direct_results.get(oid)
        if fut is not None and not fut.publish and not fut.failover:
            fut.publish = True
            if fut.ev.is_set():
                self._publish_direct(oid, fut)
            return
        af = self._agent_results.get(oid)
        if af is not None and not af.publish and not af.failover:
            af.publish = True
            if af.ev.is_set():
                self._publish_agent(oid, af)

    def _register_direct_future(self, oid: str, fut: _DirectFuture) -> None:
        self._direct_results[oid] = fut
        while len(self._direct_results) > self._DIRECT_RESULT_RETAIN:
            old_oid, old = next(iter(self._direct_results.items()))
            if not old.ev.is_set():
                break   # oldest still in flight: don't evict live calls
            del self._direct_results[old_oid]
            if old._published or old.failover:
                # the value lives driver-side (escaped-ref publication /
                # failover resubmit): later local gets resolve it over
                # the normal driver path — only a never-published local
                # result is actually lost
                continue
            self._direct_evicted.add(old_oid)
            while len(self._direct_evicted) > 4 * self._DIRECT_RESULT_RETAIN:
                self._direct_evicted.pop()

    # ---- agent-local dispatch (two-level scheduling) ----------------------
    def _register_agent_future(self, oid: str, fut: _AgentFuture) -> None:
        """Caller holds _agent_lock. Same oldest-first resolution
        retention as direct-call results; an evicted never-published
        result raises ObjectLostError on a late get."""
        self._agent_results[oid] = fut
        while len(self._agent_results) > self._DIRECT_RESULT_RETAIN:
            old_oid, old = next(iter(self._agent_results.items()))
            if not old.ev.is_set():
                break   # oldest still in flight: don't evict live tasks
            del self._agent_results[old_oid]
            self._agent_known.discard(old_oid)
            if old._published or old.failover:
                continue   # resolvable through the driver path
            self._agent_evicted.add(old_oid)
            while len(self._agent_evicted) > 4 * self._DIRECT_RESULT_RETAIN:
                self._agent_evicted.pop()
        while len(self._agent_tasks) > self._DIRECT_RESULT_RETAIN:
            old_tid, oids = next(iter(self._agent_tasks.items()))
            if any((f := self._agent_results.get(o)) is not None
                   and not f.ev.is_set() for o in oids):
                break
            del self._agent_tasks[old_tid]

    def _agent_locs_update(self, pairs) -> None:
        locs = self._agent_locs
        for oid, loc in pairs:
            locs[oid] = loc
            self._agent_known.add(oid)
        while len(locs) > 8192:
            # values still live in the node arena; a later get falls
            # back to the driver path
            del locs[next(iter(locs))]
        while len(self._agent_known) > 8 * 8192:
            self._agent_known.pop()

    def _agent_resolve(self, tid: str, sealed, error) -> None:
        """Agent-plane reader: one nested task this worker submitted
        completed on a sibling worker."""
        with self._agent_lock:
            oids = list(self._agent_tasks.get(tid, ()))
        err = None
        if error is not None:
            err = error if isinstance(error, BaseException) \
                else TaskError(str(error), "", tid)
        locs = dict(sealed or ())
        to_publish = []
        for oid in oids:
            fut = self._agent_results.get(oid)
            if fut is None or fut.ev.is_set():
                continue
            if err is not None:
                fut.error = err
            else:
                fut.loc = locs.get(oid)
                if fut.loc is None:
                    fut.error = TaskError(
                        f"agent-placed task sealed no location for {oid}",
                        "", tid)
                else:
                    self._agent_known.add(oid)
            fut.ev.set()
            if fut.publish:
                to_publish.append((oid, fut))
        with self._direct_cv:
            self._direct_cv.notify_all()
        for oid, fut in to_publish:
            self._publish_agent(oid, fut)

    def _agent_spilled(self, tids) -> None:
        """The agent forwarded these worker-submitted specs to the
        driver (deps not node-local, or no capacity in time): their
        results resolve through the driver path. No resubmit here —
        the agent already handed the spec up."""
        for tid in tids:
            for oid in self._agent_tasks.get(tid, ()):
                fut = self._agent_results.get(oid)
                if fut is not None and not fut.ev.is_set():
                    fut.failover = True
                    fut.ev.set()
        with self._direct_cv:
            self._direct_cv.notify_all()

    def _publish_agent(self, oid: str, fut: _AgentFuture) -> None:
        """Escape publication for an agent-placed result: its ref left
        this process, so readers that resolve through the driver must
        find it. The seal is host-kind (node arena / spill file), so
        the location itself is globally resolvable — no byte copy."""
        if fut._published or fut.failover:
            return
        fut._published = True
        try:
            # straight to the socket, NOT through the batcher — same
            # re-entrancy rule as _publish_direct
            if fut.error is not None:
                self.conn.send(("put_error", oid, fut.error))
            else:
                self.conn.send(("put", oid, fut.loc))
        except Exception:
            pass   # driver gone: nothing to publish to

    def _resolve_agent(self, oid: str, fut: _AgentFuture,
                       deadline: Optional[float]) -> Any:
        if not fut.ev.is_set():
            # silent grace first (the zero-driver-frame steady state),
            # then the same dwait CPU lend a blocked driver-path get
            # performs — capacity-tight gangs rely on it for liveness
            grace = _AGENT_GRACE_S if deadline is None \
                else max(0.0, min(_AGENT_GRACE_S,
                                  deadline - time.monotonic()))
            if not fut.ev.wait(grace):
                notified = False
                try:
                    self.conn.send(("dwait", True))
                    notified = True
                except Exception:
                    pass
                tok = waits_mod.park("object", oid, via="agent")
                try:
                    remaining = None if deadline is None \
                        else max(0.0, deadline - time.monotonic())
                    ok = fut.ev.wait(remaining)
                finally:
                    waits_mod.unpark(tok)
                    if notified:
                        try:
                            self.conn.send(("dwait", False))
                        except Exception:
                            pass
                if not ok:
                    raise GetTimeoutError(
                        f"get() timed out waiting for agent-placed "
                        f"task result {oid}")
        if fut.failover:
            remaining = None if deadline is None \
                else max(0.1, deadline - time.monotonic())
            return self._get_one_fresh(oid, remaining)
        if fut.error is not None:
            raise fut.error
        try:
            return self.store.get_value(fut.loc)
        except ObjectLostError:
            remaining = None if deadline is None \
                else max(0.1, deadline - time.monotonic())
            return self._get_one_fresh(oid, remaining)

    def _drop_direct_channel(self, actor_id: str,
                             ch: _DirectChannel) -> None:
        with self._direct_lock:
            if self._direct_chans.get(actor_id) is ch:
                del self._direct_chans[actor_id]

    def _direct_channel(self, actor_id: str) -> Optional[_DirectChannel]:
        with self._direct_lock:
            ch = self._direct_chans.get(actor_id)
            if ch is not None and not ch.dead:
                return ch
        if self._direct_retry_after.get(actor_id, 0) > time.monotonic():
            return None
        try:
            info = self.report_sync("sys.actor_addr", actor_id,
                                    timeout=10.0)
        except Exception:
            info = None
        if info == "pending":
            # callee still constructing (or restarting): this call falls
            # back, and the NEXT call retries the directory immediately.
            # No timed backoff here — driver-path calls run in ~1ms, so
            # even a 50ms pause let entire short bursts complete before
            # the channel ever got a chance to establish; one extra
            # report_sync per call, bounded by construction time, is
            # cheaper than condemning the burst to the fallback path.
            return None
        if not info:
            self._direct_retry_after[actor_id] = time.monotonic() + 1.0
            return None
        callee_wid, addr, _epoch = info
        try:
            ch = _DirectChannel(self, actor_id, callee_wid, addr)
        except Exception:
            self._direct_retry_after[actor_id] = time.monotonic() + 1.0
            return None
        with self._direct_lock:
            live = self._direct_chans.get(actor_id)
            if live is not None and not live.dead:
                try:
                    ch.conn.close()
                except Exception:
                    pass
                return live
            self._direct_chans[actor_id] = ch
        events_mod.emit(
            "task.dispatch.local",
            f"direct call channel to actor {actor_id} "
            f"(worker {callee_wid}) established; steady-state calls "
            f"bypass the driver",
            actor_id=actor_id, worker_id=self.worker_id)
        return ch

    def _try_direct_call(self, spec: TaskSpec) -> bool:
        ch = self._direct_channel(spec.actor_id)
        if ch is None:
            self.direct_fallbacks += 1
            try:
                mcat.get("ray_tpu_direct_call_fallbacks_total").inc(
                    tags={"reason": "no_address"})
            except Exception:
                pass
            return False
        oid = spec.return_ids[0]
        fut = _DirectFuture()
        fut.actor_id = spec.actor_id
        self._register_direct_future(oid, fut)
        if not ch.call(spec, fut):
            self._direct_results.pop(oid, None)
            self.direct_fallbacks += 1
            try:
                mcat.get("ray_tpu_direct_call_fallbacks_total").inc(
                    tags={"reason": "channel_died"})
            except Exception:
                pass
            return False
        self.direct_calls += 1
        try:
            mcat.get("ray_tpu_direct_actor_calls_total").inc()
        except Exception:
            pass
        # flight recorder: the SUBMIT span of a driver-bypass call is
        # recorded by the CALLER (the driver never sees the task); the
        # callee's exec span parents to spec.span_id as usual, so the
        # timeline stays a single tree with zero driver hops
        if self._span_sink is not None \
                and knobs.get_bool("RAY_TPU_FASTPATH_SPANS"):
            try:
                now = time.time()
                self._span_sink({
                    "trace_id": getattr(spec, "trace_id", "") or "",
                    "span_id": getattr(spec, "span_id", "") or "",
                    "parent_span_id":
                        getattr(spec, "parent_span_id", "") or "",
                    "task_id": spec.task_id,
                    "name": f"dcall:{spec.method_name}",
                    "cat": "dcall_submit",
                    "start": now, "end": now, "status": "ok",
                    "pid": os.getpid(), "worker_id": self.worker_id,
                    "node_id": knobs.get_raw("RAY_TPU_NODE_ID"),
                })
            except Exception:
                pass
        return True

    # ---- core verbs -------------------------------------------------------
    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        oids = [r.id for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        # device-resident fast path: objects THIS worker produced are
        # served from the in-process table — no driver round-trip, no
        # D2H, no deserialization (core/device_store.py)
        from . import device_store  # noqa: PLC0415
        local = {}
        direct: Dict[str, _DirectFuture] = {}
        agent: Dict[str, _AgentFuture] = {}
        for oid in oids:
            try:
                local[oid] = device_store.get(oid)
                continue
            except KeyError:
                pass
            fut = self._direct_results.get(oid)
            if fut is not None:
                direct[oid] = fut
                continue
            afut = self._agent_results.get(oid)
            if afut is not None:
                agent[oid] = afut
                continue
            aloc = self._agent_locs.get(oid)
            if aloc is not None:
                # agent-stamped dependency location: the value is in
                # this node's arena, no driver round-trip
                try:
                    local[oid] = self.store.get_value(aloc)
                    continue
                except Exception:
                    self._agent_locs.pop(oid, None)
            if oid in self._direct_evicted or oid in self._agent_evicted:
                raise ObjectLostError(
                    f"locally-owned result {oid} was evicted (held past "
                    f"the {self._DIRECT_RESULT_RETAIN}-entry retention "
                    f"bound without being read)")
        if len(local) == len(oids):
            return [local[oid] for oid in oids]
        remote_oids = [oid for oid in oids
                       if oid not in local and oid not in direct
                       and oid not in agent]
        results: Dict[str, tuple] = {}
        rid = None
        if remote_oids:
            self._batch.flush()   # a buffered put/submit may feed this
            rid = self._new_req()
            self.conn.send(("get_request", rid, remote_oids, timeout))
            tok = waits_mod.park("object", remote_oids[0],
                                 n=len(remote_oids))
            try:
                results = self._take_reply(rid, timeout)
            finally:
                waits_mod.unpark(tok)
        out = []
        for oid in oids:
            if oid in local:
                out.append(local[oid])
                continue
            if oid in direct:
                out.append(self._resolve_direct(oid, direct[oid],
                                                deadline))
                continue
            if oid in agent:
                out.append(self._resolve_agent(oid, agent[oid],
                                               deadline))
                continue
            kind, payload = results[oid]
            if kind == "error":
                raise payload if isinstance(payload, BaseException) else TaskError(str(payload))
            if kind == "value":
                # cross-node object: the driver shipped the packed bytes
                # (its node fetched them from the holder's store)
                out.append(serialization.unpack(payload))
            elif kind == "value_staged":
                # big cross-node object: bytes arrived ahead of the reply
                # as value_chunk frames
                out.append(serialization.unpack(
                    self.take_staged_value(rid, oid)))
            else:
                try:
                    out.append(self.store.get_value(payload))
                except ObjectLostError:
                    # The spiller (or arena LRU) dropped the segment after
                    # this loc was serialized but before we read it; a
                    # fresh request returns a spill-aware loc (or the
                    # re-hosted bytes). One retry closes the race.
                    out.append(self._get_one_fresh(oid, timeout))
        return out

    def _resolve_direct(self, oid: str, fut: _DirectFuture,
                        deadline: Optional[float]) -> Any:
        if not fut.ev.is_set():
            # short grace first: a round-trip-fast direct reply must not
            # cost driver messages (the zero-message property). Past it,
            # tell the driver we are BLOCKED so it lends this worker's
            # CPU and reclaims leased slots — exactly what a driver-path
            # get_request would have triggered (capacity-tight gang
            # workloads rely on that lend for liveness).
            grace = 0.005 if deadline is None \
                else max(0.0, min(0.005, deadline - time.monotonic()))
            if not fut.ev.wait(grace):
                notified = False
                try:
                    self.conn.send(("dwait", True))
                    notified = True
                except Exception:
                    pass
                # the target actor rides the record so the wait graph
                # can close cycles through calls the driver never saw
                tok = waits_mod.park("actor-call", oid,
                                     target_actor=fut.actor_id)
                try:
                    remaining = None if deadline is None \
                        else max(0.0, deadline - time.monotonic())
                    ok = fut.ev.wait(remaining)
                finally:
                    waits_mod.unpark(tok)
                    if notified:
                        try:
                            self.conn.send(("dwait", False))
                        except Exception:
                            pass
                if not ok:
                    raise GetTimeoutError(
                        f"get() timed out waiting for direct call "
                        f"result {oid}")
        if fut.failover:
            # the channel died mid-call and the spec was resubmitted
            # through the driver: resolve the oid the normal way
            remaining = None if deadline is None \
                else max(0.1, deadline - time.monotonic())
            return self._get_one_fresh(oid, remaining)
        if fut.error is not None:
            raise fut.error
        return serialization.unpack(fut.payload)

    def _get_one_fresh(self, oid: str, timeout: Optional[float],
                       _retried: bool = False) -> Any:
        t0 = time.monotonic()
        rid = self._new_req()
        self.conn.send(("get_request", rid, [oid], timeout))
        tok = waits_mod.park("object", oid, fresh=True)
        try:
            kind, payload = self._take_reply(rid, timeout)[oid]
        finally:
            waits_mod.unpark(tok)
        if kind == "error":
            raise payload if isinstance(payload, BaseException) \
                else TaskError(str(payload))
        if kind == "value":
            return serialization.unpack(payload)
        if kind == "value_staged":
            return serialization.unpack(self.take_staged_value(rid, oid))
        try:
            return self.store.get_value(payload)
        except ObjectLostError:
            if _retried:
                raise
            # segment gone without a spill copy: report the unreachable
            # location (the driver prunes it and reconstructs from
            # lineage when no live copy remains) and take ONE more
            # round-trip — on the REMAINING timeout budget, so
            # get(timeout=T) still bounds at ~T, not 2T
            self.conn.send(("object_unreachable", oid,
                            getattr(payload, "node_id", None)
                            or knobs.get_raw("RAY_TPU_NODE_ID"),
                            getattr(payload, "seal_seq", None)))
            remaining = None if timeout is None else max(
                0.1, timeout - (time.monotonic() - t0))
            return self._get_one_fresh(oid, remaining, _retried=True)

    def put(self, value: Any) -> ObjectRef:
        from . import device_store  # noqa: PLC0415
        oid = new_object_id()
        # torch tensors stay device-resident here; the driver pulls a
        # materialized copy only if a consumer elsewhere needs it
        loc = device_store.try_keep(self.store, self.worker_id, oid,
                                    value)
        self._batch.send(("put", oid, loc))
        return ObjectRef(oid)

    def _driver_wait(self, refs, num_returns, timeout):
        self._batch.flush()
        rid = self._new_req()
        self.conn.send(("wait_request", rid, [r.id for r in refs],
                        num_returns, timeout))
        tok = waits_mod.park("object", refs[0].id if refs else "",
                             op="wait", n=len(refs))
        try:
            ready_ids = set(self._take_reply(rid, None))
        finally:
            waits_mod.unpark(tok)
        ready = [r for r in refs if r.id in ready_ids]
        not_ready = [r for r in refs if r.id not in ready_ids]
        return ready, not_ready

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        direct = {r.id: f for r in refs
                  if (f := self._direct_results.get(r.id)) is not None
                  and not f.failover}
        # agent-placed futures duck-type the direct ones here (ev +
        # failover are all this loop reads), so they settle locally too
        for r in refs:
            if r.id not in direct:
                af = self._agent_results.get(r.id)
                if af is not None and not af.failover:
                    direct[r.id] = af
        if not direct:
            return self._driver_wait(refs, num_returns, timeout)
        # Mixed wait: direct-call futures settle locally (errored counts
        # as ready, like any settled object), driver-owned refs settle
        # through wait_request. The driver leg runs in bounded slices so
        # a direct completion is observed within ~0.2s.
        deadline = None if timeout is None \
            else time.monotonic() + (timeout or 0)
        others = [r for r in refs if r.id not in direct]
        ready_ids: set = set()
        # one park across the whole mixed-wait loop (the inner driver
        # slices are 0.2s — individually always younger than the ship
        # age, so only this outer record can represent a stuck wait())
        wtok = waits_mod.park("object", refs[0].id if refs else "",
                              op="wait", n=len(refs))
        try:
            return self._mixed_wait_loop(refs, direct, others,
                                         ready_ids, num_returns,
                                         deadline)
        finally:
            waits_mod.unpark(wtok)

    def _mixed_wait_loop(self, refs, direct, others, ready_ids,
                         num_returns, deadline):
        while True:
            # a channel death mid-wait flips futures to failover (the
            # spec was resubmitted through the driver): migrate those
            # refs to the driver leg or they would never settle here
            flipped = [oid for oid, f in direct.items() if f.failover]
            if flipped:
                for oid in flipped:
                    del direct[oid]
                others.extend(r for r in refs
                              if r.id in flipped and r.id not in ready_ids)
            ready_ids |= {oid for oid, f in direct.items()
                          if f.ev.is_set()}
            need = num_returns - len(ready_ids)
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if need <= 0 or (remaining is not None and remaining <= 0):
                break
            if others:
                slice_t = 0.2 if remaining is None \
                    else max(0.0, min(0.2, remaining))
                got, _ = self._driver_wait(
                    others, min(need, len(others)), slice_t)
                ready_ids |= {r.id for r in got}
                others = [r for r in others if r.id not in ready_ids]
            else:
                with self._direct_cv:
                    self._direct_cv.wait(
                        0.2 if remaining is None else min(0.2, remaining))
        ready = [r for r in refs if r.id in ready_ids]
        not_ready = [r for r in refs if r.id not in ready_ids]
        return ready, not_ready

    def submit(self, spec: TaskSpec) -> List[ObjectRef]:
        # Two-level scheduling (docs/SCHEDULING.md): a fan-out from a
        # worker goes to its OWN node agent for local placement when the
        # task is node-leaseable and every ref argument is known
        # node-resolvable — the dependency gate also prevents a put/
        # submit reorder across the two connections (the driver might
        # see the submit before the put that feeds it).
        ag = self._agent_plane
        if (ag is not None and not ag.dead
                and sched_mod.node_leaseable(spec)
                and all(oid in self._agent_known
                        for oid in spec.dep_object_ids)):
            return ag.submit(spec)
        self._batch.send(("submit", spec))
        return [ObjectRef(oid) for oid in spec.return_ids]

    def create_actor(self, acspec: ActorCreationSpec) -> None:
        self.conn.send(("submit_actor", acspec))

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        # Driver-bypass fast path: actor-to-actor (and any worker->
        # actor) unary calls resolve the callee's address once via the
        # GCS actor directory, then ride a direct worker->worker
        # connection — zero driver control messages steady-state. The
        # driver path stays as the instrumented fallback (streaming and
        # multi-return calls always use it).
        if (self._direct_enabled and spec.actor_id
                and not getattr(spec, "streaming", False)
                and len(spec.return_ids) == 1
                and not getattr(self._no_direct, "on", False)
                and self._try_direct_call(spec)):
            return [ObjectRef(spec.return_ids[0])]
        self._batch.send(("submit", spec))
        return [ObjectRef(oid) for oid in spec.return_ids]

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self._batch.flush()   # buffered calls must land before the kill
        self.conn.send(("kill_actor", actor_id, no_restart))

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        self._batch.flush()
        self.conn.send(("cancel", ref.id, force))

    def cancel_task(self, task_id: str, force: bool = False) -> None:
        self._batch.flush()
        self.conn.send(("cancel", task_id, force))

    def free(self, refs: List[ObjectRef]) -> None:
        """Drop objects from the store, as the driver's `free` does (a
        data exchange run inside an actor frees its pieces as it drains
        them; the reference's worker has no `free`)."""
        self._batch.flush()   # the puts that made them land first
        self.conn.send(("free", [r.id for r in refs]))

    def report(self, channel: str, payload: Any) -> None:
        """Out-of-band message to the driver (train session, metrics...)."""
        self.conn.send(("report", channel, payload))

    def report_sync(self, channel: str, payload: Any, timeout=None) -> Any:
        self._batch.flush()
        rid = self._new_req()
        self.conn.send(("report_sync", rid, channel, payload))
        return self._take_reply(rid, timeout)

    def gen_next(self, task_id: str, timeout=None):
        """Worker-side consumption of a streaming generator: ask the
        driver for the next item ref (blocks until one streams in)."""
        from .object_ref import ObjectRef  # noqa: PLC0415
        from ..exceptions import TaskError  # noqa: PLC0415
        self._batch.flush()
        rid = self._new_req()
        self.conn.send(("gen_next_request", rid, task_id))
        try:
            kind, payload = self._take_reply(rid, timeout)
        except GetTimeoutError:
            # Tell the driver to drop the parked waiter (and restore the
            # CPU it lent back) so a later item isn't popped into a
            # reply nobody consumes.
            self.conn.send(("gen_abandon", rid))
            raise
        if kind == "item":
            return ObjectRef(payload)
        if kind == "error":
            if isinstance(payload, BaseException):
                raise payload
            raise TaskError(str(payload))
        return None

    def get_resources(self) -> Dict[str, float]:
        return {}

    def shutdown(self) -> None:
        pass

    # ---- function cache ---------------------------------------------------
    def load_func(self, spec: TaskSpec):
        if spec.func_id and spec.func_id in self._func_cache:
            return self._func_cache[spec.func_id]
        fn = serialization.loads_call(spec.func_bytes)
        if spec.func_id:
            self._func_cache[spec.func_id] = fn
        return fn


def _check_spec_payload(spec) -> None:
    """Fail fast on a spec whose user payload could not be unpickled on
    THIS worker (protocol.py stamps `wire_error` instead of dropping
    the frame). Raising here routes the cause through the normal
    task-failure reporting — the alternative (a silently dropped exec
    frame) leaves the task RUNNING forever and its caller parked
    (observed: a multihost rank payload referencing a module only
    importable on the driver node)."""
    we = getattr(spec, "wire_error", None)
    if we:
        raise RuntimeError(
            f"task payload could not be deserialized on this worker: "
            f"{we} — is every module the payload references importable "
            "on this node (shared filesystem / PYTHONPATH / runtime_env "
            "py_modules)?")


def _resolve_args(rt: WorkerRuntime, args, kwargs):
    """Fetch top-level ObjectRef args (deps are ready by scheduling time)."""
    if not args and not kwargs:
        return args, kwargs
    refs = [a for a in list(args) + list(kwargs.values())
            if isinstance(a, ObjectRef)]
    if not refs:
        return args, kwargs
    vals = rt.get(refs)
    table = {r.id: v for r, v in zip(refs, vals)}
    new_args = tuple(table[a.id] if isinstance(a, ObjectRef) else a
                     for a in args)
    new_kwargs = {k: (table[v.id] if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
    return new_args, new_kwargs


class DirectCallServer:
    """Per-worker listener for driver-bypass actor calls. An incoming
    ("dcall", rid, spec) enqueues into the SAME execution lanes as
    driver dispatch (main loop / thread pools / async loop), so
    max_concurrency and concurrency groups hold; the reply carries the
    packed VALUE straight back — no store seal, no driver message."""

    def __init__(self, loop: "WorkerLoop", driver_address: str):
        import tempfile  # noqa: PLC0415
        self._loop = loop
        self._conns: List[Connection] = []
        if str(driver_address).startswith("tcp://"):
            # remote-node worker: peers on other hosts must reach us
            from .protocol import tcp_listener  # noqa: PLC0415
            from ..util.netutil import routable_ip  # noqa: PLC0415
            self._listener = tcp_listener("0.0.0.0", 0)
            port = self._listener.getsockname()[1]
            self.address = f"tcp://{routable_ip()}:{port}"
        else:
            from .protocol import unix_listener  # noqa: PLC0415
            # prefer the driver's log dir (cleaned up at driver
            # shutdown) over a per-worker tmpdir that os._exit leaks
            base = knobs.get_raw("RAY_TPU_LOG_DIR")
            if not base or not os.path.isdir(base):
                base = tempfile.mkdtemp(prefix="ray_tpu_dcall_")
            path = os.path.join(
                base, f"dcall-{loop.worker_id}-{os.getpid()}.sock")
            self._listener = unix_listener(path)
            self.address = path
        threading.Thread(target=self._accept, daemon=True,
                         name="dcall-accept").start()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = Connection(sock)
            self._conns.append(conn)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True, name="dcall-reader").start()

    def _reader(self, conn: Connection) -> None:
        while True:
            try:
                # raylint: disable=RT003 inbound direct-call conn: a dead
                # caller's socket closes (EOF) and its calls were already
                # failed over by the driver's death determination; a parked
                # reader costs one daemon thread
                m = conn.recv()
            except ConnectionClosed:
                return
            if m[0] != "dcall":
                continue
            _, rid, spec = m
            rt = self._loop.rt
            if (spec.actor_id != rt.current_actor_id
                    or self._loop._actor_instance is None):
                # stale directory entry (actor moved/died since the
                # caller resolved it): the caller fails over and
                # re-resolves — never execute under a wrong identity
                try:
                    conn.send(("dreject", rid))
                except ConnectionClosed:
                    return
                continue
            spec._direct_ch = (conn, rid)
            self._loop._task_q.put(("actor_task", spec))

    def close(self) -> None:
        try:
            self._listener.close()
        except Exception:
            pass
        for c in self._conns:
            try:
                c.close()
            except Exception:
                pass


class WorkerLoop:
    def __init__(self, socket_path: str, worker_id: str):
        # socket_path is a unix path for same-host workers or
        # "tcp://host:port" for workers spawned by a remote node agent.
        self.conn = connect_address(socket_path)
        self.store = make_store(
            capacity_bytes=knobs.get_int("RAY_TPU_STORE_BYTES"),
            is_owner=False)
        self.rt = WorkerRuntime(self.conn, worker_id, self.store)
        self.worker_id = worker_id
        self._task_q: "queue.Queue" = queue.Queue()
        self._shutdown = threading.Event()
        self._actor_instance: Any = None
        self._actor_spec: Optional[ActorCreationSpec] = None
        self._actor_pool: Optional[ThreadPoolExecutor] = None
        self._group_pools: Dict[str, ThreadPoolExecutor] = {}
        # CUDA_VISIBLE_DEVICES this process is bound to (_bind_gpu_ids)
        self._cuda_visible: Optional[str] = None
        self._async_loop = None
        self._async_sems: Dict[Optional[str], Any] = {}
        self._cancelled: set = set()
        # lease slots the driver reclaimed (blocked-head revoke): skip
        # silently when they surface in the queue. _queued_tasks mirrors
        # the ids sitting in _task_q so a revoke can tell "not started
        # yet" (fence it) from "already running/finished" (leave it to
        # the driver's revoked-pair guard) — fencing a started task
        # would leave a stale entry that silently swallows a future
        # re-dispatch of the same id to this worker (no task_done ever,
        # caller hangs)
        self._revoked: set = set()
        self._queued_tasks: set = set()
        # worker->driver control-message batcher: completions, seals
        # and nested submits coalesce into ("batch", ...) frames
        self._batch = _MsgBatcher(
            self.conn,
            max_n=knobs.get_int("RAY_TPU_BATCH_FLUSH_N"),
            window=knobs.get_float("RAY_TPU_BATCH_FLUSH_S"),
            enabled=knobs.get_bool("RAY_TPU_BATCH"))
        self.rt._batch = self._batch
        # agent-local dispatch plane (two-level scheduling): connect
        # BEFORE run() registers with the driver, so by the time the
        # driver sees this worker idle the agent can dispatch to it
        self._agent: Optional[_AgentPlane] = None
        agent_addr = knobs.get_raw("RAY_TPU_AGENT_ADDR")
        if agent_addr:
            try:
                self._agent = _AgentPlane(self, agent_addr)
                self.rt._agent_plane = self._agent
            except Exception:
                self._agent = None   # agent gone: driver path only
        # direct-call plane listener (RAY_TPU_DIRECT_CALLS=0 disables)
        self._direct_server = None
        if self.rt._direct_enabled:
            try:
                self._direct_server = DirectCallServer(self, socket_path)
            except Exception:
                self._direct_server = None
        # telemetry plane: metric deltas + execution spans ship to the
        # driver over the existing conn (report channels sys.metrics /
        # sys.spans) after each task and on a periodic heartbeat, so
        # the driver's /metrics exposes series recorded IN this process
        self._delta_exporter = metrics_mod.DeltaExporter()
        self._spans: List[dict] = []
        self._telemetry_lock = threading.Lock()
        self._last_flush = 0.0
        self._heartbeat_on = True   # set from env in run()
        self.rt._span_sink = self.record_span
        # always-on sampling profiler (off at hz=0; profile_ctl can
        # start/stop/snapshot it at runtime)
        from ..observability import sampling_profiler  # noqa: PLC0415
        self._profiler = sampling_profiler.SamplingProfiler(
            hz=knobs.get_float("RAY_TPU_PROFILE_HZ"))
        # __ray_save__ checkpoint shipping (actors that define the hook)
        self._ckpt_lock = threading.Lock()
        self._last_ckpt = 0.0
        # compiled-DAG plane (docs/DAG.md): built on first dag_install
        self._dag_ctx = None
        self.socket_path = socket_path

    def _dag(self):
        if self._dag_ctx is None:
            from .dag_runtime import WorkerDagContext  # noqa: PLC0415
            self._dag_ctx = WorkerDagContext(self)
        return self._dag_ctx

    # ---- main -------------------------------------------------------------
    def run(self) -> None:
        from . import runtime as runtime_mod  # noqa: PLC0415
        runtime_mod.set_runtime(self.rt)
        self.conn.send(("register", self.worker_id, os.getpid(),
                        self._direct_server.address
                        if self._direct_server else None))
        reader = threading.Thread(target=self._read_loop, daemon=True)
        reader.start()
        interval = knobs.get_float("RAY_TPU_METRICS_INTERVAL_S")
        self._heartbeat_on = interval > 0
        if interval > 0:
            threading.Thread(target=self._telemetry_loop,
                             args=(interval,), daemon=True,
                             name="worker-telemetry").start()
        while not self._shutdown.is_set():
            try:
                item = self._task_q.get(timeout=0.2)
            except queue.Empty:
                continue
            kind, payload = item
            if kind == "task":
                # un-queue BEFORE running so a concurrent revoke_tasks
                # classifies this id as started (program order makes
                # the discard visible before _run_task's fence check)
                self._queued_tasks.discard(payload.task_id)
                self._run_task(payload)
            elif kind == "create_actor":
                self._create_actor(payload)
            elif kind == "actor_task":
                self._dispatch_actor_task(payload)
        # graceful exit: ship whatever the batcher and the telemetry
        # buffers still hold — the final spans/events/metric deltas of
        # a completed job must not die with the process
        try:
            self._batch.flush()
        except Exception:
            pass
        self._flush_telemetry()
        try:
            self.conn.close()
        except Exception:
            pass

    def _read_loop(self) -> None:
        from .protocol import RECV_ERROR  # noqa: PLC0415
        while True:
            try:
                # raylint: disable=RT003 the worker's own driver conn: driver
                # process death closes it, and a silent driver HOST is the
                # node agent's RAY_TPU_DRIVER_SILENCE_S watchdog's job — it
                # terminates this worker when it rejoins
                msg = self.conn.recv()
            except ConnectionClosed:
                self._shutdown.set()
                os._exit(0)
            mtype = msg[0]
            if mtype == RECV_ERROR:
                sys.stderr.write(
                    f"[ray_tpu worker {self.worker_id}] dropped "
                    f"undeserializable message:\n{msg[1]}")
                continue
            if mtype == "exec_task":
                self._queued_tasks.add(msg[1].task_id)
                self._task_q.put(("task", msg[1]))
            elif mtype == "exec_task_many":
                # a multi-slot lease grant: the specs execute strictly
                # FIFO off this queue against the lease's resource slot
                for spec in msg[1]:
                    self._queued_tasks.add(spec.task_id)
                    self._task_q.put(("task", spec))
            elif mtype == "exec_actor_task_many":
                for spec in msg[1]:
                    self._task_q.put(("actor_task", spec))
            elif mtype == "revoke_tasks":
                # driver reclaimed unstarted lease slots (blocked head):
                # fence only ids still waiting in the local queue — an
                # id that already started (watchdog reclaim racing the
                # head's in-flight completion) must NOT be fenced, or
                # the stale entry would swallow a later re-dispatch of
                # the same task; its duplicate result is dropped by the
                # driver's revoked-pair guard instead
                self._revoked.update(
                    tid for tid in msg[1] if tid in self._queued_tasks)
            elif mtype == "create_actor":
                # (acspec, checkpoint|None) — the checkpoint is the
                # actor's latest __ray_save__ state around a restart
                self._task_q.put(("create_actor",
                                  (msg[1],
                                   msg[2] if len(msg) > 2 else None)))
            elif mtype == "exec_actor_task":
                self._task_q.put(("actor_task", msg[1]))
            elif mtype == "get_reply":
                self.rt.deliver_reply(msg[1], msg[2])
            elif mtype == "value_chunk":
                self.rt.stash_value_chunk(msg[1], msg[2], msg[3], msg[4],
                                          msg[5])
            elif mtype == "cancel":
                self._cancelled.add(msg[1])
            elif mtype == "materialize":
                self._materialize(msg[1])
            elif mtype == "drop_device":
                from . import device_store  # noqa: PLC0415
                device_store.drop(msg[1])
            elif mtype == "dag_install":
                # compile-time only; steady-state executions never
                # touch this socket (docs/DAG.md)
                self._dag().install(msg[1])
            elif mtype == "dag_start":
                self._dag().start(msg[1], msg[2])
            elif mtype == "dag_teardown":
                if self._dag_ctx is not None:
                    self._dag_ctx.teardown(msg[1])
            elif mtype == "profile_ctl":
                self._handle_profile_ctl(
                    msg[1], msg[2], msg[3] if len(msg) > 3 else None)
            elif mtype == "shutdown":
                if self._dag_ctx is not None:
                    self._dag_ctx.teardown_all()
                self._shutdown.set()

    # ---- telemetry --------------------------------------------------------
    def _telemetry_loop(self, interval: float) -> None:
        """Heartbeat shipping for long-running work (an actor hosting an
        LLM engine records tokens continuously with no task boundary)."""
        while not self._shutdown.is_set():
            time.sleep(interval)
            self._memory_gauges()
            self._flush_telemetry()

    def _memory_gauges(self) -> None:
        """Per-device HBM + host RSS gauges, refreshed per heartbeat
        (observability/profiler.py's memory accounting wired into the
        metrics plane; {} on backends without memory_stats)."""
        try:
            from ..observability import profiler  # noqa: PLC0415
            mcat.get("ray_tpu_worker_host_rss_bytes").set(
                profiler.host_rss_bytes())
            for dev, used in profiler.hbm_usage().items():
                mcat.get("ray_tpu_worker_hbm_used_bytes").set(
                    used, tags={"device": dev})
        except Exception:
            pass

    def _handle_profile_ctl(self, rid, action, arg) -> None:
        """On-demand profiler control (runs on the reader thread: every
        action is sub-millisecond and never blocks on user work)."""
        prof = self._profiler
        try:
            if action == "start":
                hz = float(arg) if arg else 100.0
                prof.set_hz(hz)
                events_mod.emit(
                    "worker.profile.start",
                    f"sampling profiler started at {hz:g} Hz",
                    worker_id=self.worker_id, hz=hz)
                payload = prof.status()
            elif action == "stop":
                prof.stop()
                events_mod.emit(
                    "worker.profile.stop", "sampling profiler stopped",
                    worker_id=self.worker_id)
                payload = prof.status()
            elif action == "snapshot":
                payload = prof.snapshot()
            elif action == "stack":
                # one-shot cluster stack dump (`ray_tpu stack`): walk
                # every thread's live frames with task attribution
                from ..observability import \
                    sampling_profiler as sp  # noqa: PLC0415
                payload = sp.dump_stacks()
                payload["worker_id"] = self.worker_id
            else:
                payload = prof.status()
        except Exception as e:  # noqa: BLE001
            payload = {"error": repr(e)}
        try:
            self.conn.send(("profile_reply", rid, payload))
        except Exception:
            pass   # driver gone; nothing to reply to

    def record_span(self, span: dict) -> None:
        """Buffer an externally-built span record (fast-path
        instrumentation: dcall submits, compiled-DAG stages) for the
        next telemetry flush — spans ride sys.spans on the heartbeat,
        never the control plane."""
        with self._telemetry_lock:
            self._spans.append(span)

    def _record_span(self, spec: TaskSpec, span_id: str, start: float,
                     end: float, status: str) -> None:
        entry = {
            "trace_id": getattr(spec, "trace_id", "") or "",
            "span_id": span_id,
            "parent_span_id": getattr(spec, "span_id", "") or "",
            "task_id": spec.task_id, "name": spec.name,
            "start": start, "end": end, "status": status,
            "pid": os.getpid(), "worker_id": self.worker_id,
            "node_id": knobs.get_raw("RAY_TPU_NODE_ID"),
        }
        lease = getattr(spec, "lease_id", "") or ""
        if lease:
            entry["lease_id"] = lease
        with self._telemetry_lock:
            self._spans.append(entry)

    def _flush_telemetry(self, min_interval: float = 0.0) -> None:
        """Ship buffered spans + registry deltas. Never raises — a
        telemetry failure must not fail user work. min_interval > 0
        throttles the registry walk (sub-millisecond task storms must
        not pay a full delta collect per task; the heartbeat thread
        ships whatever a throttled call left buffered)."""
        with self._telemetry_lock:
            now = time.monotonic()
            if min_interval and now - self._last_flush < min_interval:
                return
            self._last_flush = now
        # compiled-DAG stage spans sit in per-dag rings as bare tuples;
        # the expensive dict/derived-id conversion runs here, at flush
        # cadence, never on the per-seqno exec loop
        dag_spans: List[dict] = []
        if self._dag_ctx is not None:
            try:
                dag_spans = self._dag_ctx.drain_stage_spans()
            except Exception:
                dag_spans = []
        with self._telemetry_lock:
            spans, self._spans = self._spans, []
            if dag_spans:
                spans.extend(dag_spans)
            try:
                payload = self._delta_exporter.collect()
            except Exception:
                payload = None
        try:
            events = events_mod.drain()
        except Exception:
            events = None
        try:
            prof = self._profiler.collect_delta()
        except Exception:
            prof = None
        # wait-state plane: collect() returns None unless the set of
        # AGED waits changed — a healthy pipeline's micro-waits never
        # produce a sys.waits frame (the zero-steady-state-frames
        # property tests/test_waits.py counter-asserts)
        try:
            wts = waits_mod.collect()
        except Exception:
            wts = None
        try:
            if spans:
                self.conn.send(("report", "sys.spans", spans))
            if payload:
                self.conn.send(("report", "sys.metrics", payload))
            if events:
                self.conn.send(("report", "sys.events", events))
            if prof:
                self.conn.send(("report", "sys.profile", prof))
            if wts is not None:
                self.conn.send(("report", "sys.waits", wts))
        except Exception:  # ConnectionClosed included: driver is gone
            pass

    def _finish_task_telemetry(self, spec: TaskSpec, span_id: str,
                               start: float, status: str) -> None:
        end = time.time()
        try:
            mcat.get("ray_tpu_worker_task_run_s").observe(end - start)
            mcat.get("ray_tpu_worker_tasks_total").inc(
                tags={"status": status})
        except Exception:
            pass
        try:
            self._record_span(spec, span_id, start, end, status)
        except Exception:
            pass
        # throttle only when the heartbeat will sweep the leftovers
        self._flush_telemetry(
            min_interval=0.2 if self._heartbeat_on else 0.0)

    # ---- execution --------------------------------------------------------
    def _seal_returns(self, spec: TaskSpec, result: Any,
                      host: bool = False):
        """Pack return values; small ones ride inline in task_done.

        Values holding live torch tensors stay DEVICE-RESIDENT in this
        process (core/device_store.py): the sealed location is a device
        handle; same-worker consumers read the live value with no D2H,
        and the driver asks us to materialize only when a consumer
        elsewhere needs the bytes.

        `host=True` forces host-kind seals (shared arena / spill file):
        agent-placed nested tasks use it because their consumer is a
        SIBLING worker reading straight from the node arena — a device
        handle pinned in this process would be unreadable there without
        a driver materialize round-trip."""
        n = spec.num_returns
        values = (result,) if n == 1 else tuple(result)
        if n > 1 and len(values) != n:
            raise ValueError(
                f"task {spec.name} declared num_returns={n} but returned "
                f"{len(values)} values")
        sealed = []
        if host:
            from .spilling import put_value_or_spill  # noqa: PLC0415
            for oid, val in zip(spec.return_ids, values):
                sealed.append((oid, put_value_or_spill(
                    self.store, oid, val)))
            return sealed
        from . import device_store  # noqa: PLC0415
        for oid, val in zip(spec.return_ids, values):
            sealed.append((oid, device_store.try_keep(
                self.store, self.worker_id, oid, val)))
        return sealed

    def _materialize(self, oid: str) -> None:
        """Driver asked for a device-resident object's bytes (a consumer
        is elsewhere): serialize to the shm store and re-seal. Runs on
        the reader thread (Connection.send is locked; the shm arena is
        process-shared-mutex guarded), so a long-running task here can't
        stall a remote consumer."""
        from . import device_store  # noqa: PLC0415
        from .spilling import put_value_or_spill  # noqa: PLC0415
        val = device_store.peek(oid)
        if val is None:
            self.conn.send(("materialize_failed", oid,
                            "not resident on this worker"))
            return
        try:
            loc = put_value_or_spill(self.store, oid, val)
        except BaseException as e:  # noqa: BLE001
            self.conn.send(("materialize_failed", oid, repr(e)))
            return
        device_store.COUNTERS["materialized"] += 1
        # the host copy now serves every consumer (local ones included):
        # drop the device entry so HBM is reclaimed and the table never
        # pins long-dead values. A distinct message type (not "put")
        # lets the driver detect an object freed mid-materialize and
        # reclaim the fresh shm copy instead of resurrecting a ghost.
        device_store.drop(oid)
        self.conn.send(("materialized", oid, loc))

    # sealed payloads past this size flush their completion immediately:
    # the driver's watermark spiller must learn about big arena writes
    # NOW, not a batch later — leased tasks produce back-to-back with no
    # dispatch round-trip pacing them, and a lagging spiller lets the
    # arena evict unspilled segments under pressure
    _URGENT_SEAL_BYTES = 1 << 20

    def _task_done(self, task_id: str, sealed, error) -> None:
        """Completion message via the batcher: flush immediately when
        the local queue drained (no latency added to the last result of
        a batch) or the seal is big, else coalesce with the ones right
        behind."""
        big = any((getattr(loc, "size", 0) or 0) >= self._URGENT_SEAL_BYTES
                  for _oid, loc in sealed)
        self._batch.send(("task_done", task_id, sealed, error),
                         urgent=big or self._task_q.empty())
        if big:
            self._store_backpressure()

    def _complete_task(self, spec: TaskSpec, sealed, error) -> None:
        """Route a completion to the plane that dispatched the task:
        agent-placed tasks (two-level scheduling) report to the node
        agent, everything else to the driver. A dead agent plane falls
        back to the driver connection — driver-granted lease tasks are
        in its ledger, and its death handling fences any duplicate."""
        if getattr(spec, "_via_agent", False) and self._agent is not None \
                and self._agent.task_done(spec.task_id, sealed, error):
            return
        self._task_done(spec.task_id, sealed, error)

    def _store_backpressure(self, max_wait_s: float = 2.0) -> None:
        """Bounded wait for the driver's watermark spiller after a big
        seal. Pre-lease, production was paced by the dispatch round
        trip — the spiller ran between a task's seal and the next
        dispatch, so the arena never outran it. Leased/pipelined tasks
        produce back-to-back; without this, a burst of large returns
        can fill the arena and evict not-yet-spilled segments (data
        loss turned reconstruction churn). Only engages above the
        spill watermark, and gives up after max_wait_s so a stuck
        spiller degrades to the old racy behavior instead of stalling
        the worker."""
        cap = getattr(self.store, "capacity", 0) or 0
        if cap <= 0:
            return
        from .spilling import spill_threshold  # noqa: PLC0415
        limit = cap * spill_threshold()
        if self.store.used_bytes() <= limit:
            return
        deadline = time.monotonic() + max_wait_s
        while time.monotonic() < deadline \
                and self.store.used_bytes() > limit:
            time.sleep(0.005)

    def _bind_gpu_ids(self, ids) -> None:
        """Show this process only its granted cards, before the task runs
        or the actor is built: CUDA_VISIBLE_DEVICES = the cards the ids
        name (empty: no card). The ids index the node's own
        CUDA_VISIBLE_DEVICES where it set one. CUDA reads the variable
        once, at its first use in the process, so the first value binds
        the process for life; the driver never hands a bound worker
        other ids (runtime._bind_gpu_worker), and a mismatch here raises
        rather than run on the wrong card."""
        node = knobs.get_raw("RAY_TPU_NODE_VISIBLE_DEVICES")
        cards = node.split(",") if node else None
        value = ",".join(cards[int(i)] if cards else str(int(i))
                         for i in ids)
        if self._cuda_visible is None:
            os.environ["CUDA_VISIBLE_DEVICES"] = value
            self._cuda_visible = value
        elif value != self._cuda_visible:
            raise RuntimeError(
                f"worker {self.worker_id} runs with CUDA_VISIBLE_DEVICES="
                f"{self._cuda_visible!r} and cannot take GPU ids {value!r}")
        self.rt.current_gpu_ids = [int(i) for i in ids]

    def _run_task(self, spec: TaskSpec) -> None:
        if spec.task_id in self._revoked:
            # reclaimed lease slot: the driver already re-queued it
            self._revoked.discard(spec.task_id)
            return
        if spec.task_id in self._cancelled:
            self._complete_task(spec, [], "cancelled")
            return
        self.rt.current_task_id = spec.task_id
        logging_mod.mark_current_task(spec.task_id)
        t0 = time.time()
        exec_span = tracing.new_span_id()
        status = "ok"
        try:
            from . import runtime_env as renv_mod  # noqa: PLC0415
            # Dispatcher-assigned card indices (disjoint across concurrent
            # workloads; placement-group tasks get their bundle's ids)
            self._bind_gpu_ids(getattr(spec, "gpu_ids", []) or [])
            _check_spec_payload(spec)
            fn = self.rt.load_func(spec)
            args, kwargs = _resolve_args(self.rt, spec.args, spec.kwargs)
            # execution runs under this task's span so nested .remote()
            # submissions parent to it (cross-process trace tree)
            with renv_mod.applied(spec.runtime_env), \
                    tracing.active(getattr(spec, "trace_id", "") or "",
                                   exec_span):
                result = fn(*args, **kwargs)
                if getattr(spec, "streaming", False):
                    cancelled = self._stream_items(spec, result)
                    if cancelled:
                        status = "cancelled"
                    self._task_done(spec.task_id, [],
                                    "cancelled" if cancelled else None)
                    return
            sealed = self._seal_returns(
                spec, result, host=getattr(spec, "_host_seal", False))
            self._complete_task(spec, sealed, None)
        except BaseException as e:  # noqa: BLE001
            status = "error"
            err = TaskError(repr(e), traceback.format_exc(), spec.name)
            self._complete_task(spec, [], err)
        finally:
            self.rt.current_task_id = None
            logging_mod.mark_current_task(None)
            self._finish_task_telemetry(spec, exec_span, t0, status)

    def _create_actor(self, payload) -> None:
        acspec, ckpt = payload
        try:
            from . import runtime_env as renv_mod  # noqa: PLC0415
            # dedicated worker: the actor's runtime_env holds for its life
            renv_mod.apply_permanent(acspec.runtime_env)
            _check_spec_payload(acspec)
            self._bind_gpu_ids(getattr(acspec, "gpu_ids", []) or [])
            cls = serialization.loads_call(acspec.class_bytes)
            args, kwargs = _resolve_args(self.rt, acspec.args, acspec.kwargs)
            self._actor_instance = cls(*args, **kwargs)
            if ckpt is not None and hasattr(self._actor_instance,
                                            "__ray_restore__"):
                # restart of a checkpointing actor: the constructor ran
                # with the ORIGINAL args, then state resumes from the
                # last __ray_save__ snapshot instead of resetting
                self._actor_instance.__ray_restore__(
                    serialization.unpack(ckpt))
                self.rt.actor_restored = True
                events_mod.emit(
                    "actor.restore",
                    f"restored __ray_save__ checkpoint ({len(ckpt)} B)",
                    actor_id=acspec.actor_id, worker_id=self.worker_id)
            self._actor_spec = acspec
            self.rt.current_actor_id = acspec.actor_id
            groups = getattr(acspec, "concurrency_groups", None) or {}
            if acspec.max_concurrency > 1 or groups:
                self._actor_pool = ThreadPoolExecutor(
                    max_workers=max(1, acspec.max_concurrency),
                    thread_name_prefix="actor")
            # one executor lane per named group: a slow sync method in
            # one group can never occupy another group's threads (the
            # driver already gates dispatch per-group; the lanes keep
            # the isolation inside the process too)
            self._group_pools = {
                g: ThreadPoolExecutor(max_workers=n,
                                      thread_name_prefix=f"actor-{g}")
                for g, n in groups.items()}
            self.conn.send(("actor_created", acspec.actor_id, True, None))
        except BaseException as e:  # noqa: BLE001
            err = TaskError(repr(e), traceback.format_exc(),
                            f"{acspec.class_name}.__init__")
            self.conn.send(("actor_created", acspec.actor_id, False, err))

    def _dispatch_actor_task(self, spec: TaskSpec) -> None:
        import inspect  # noqa: PLC0415
        method = getattr(self._actor_instance, spec.method_name, None)
        fn = getattr(method, "__func__", method)
        if method is not None and inspect.isasyncgenfunction(fn):
            # async streaming method: iterate on the actor's event loop
            self._ensure_async_loop()
            import asyncio  # noqa: PLC0415
            asyncio.run_coroutine_threadsafe(
                self._run_actor_task_asyncgen(spec), self._async_loop)
        elif method is not None and inspect.iscoroutinefunction(fn):
            self._ensure_async_loop()
            import asyncio  # noqa: PLC0415
            asyncio.run_coroutine_threadsafe(
                self._run_actor_task_async(spec), self._async_loop)
        else:
            pool = self._group_pools.get(
                getattr(spec, "concurrency_group", None),
                self._actor_pool)
            if pool is not None:
                pool.submit(self._run_actor_task, spec)
            else:
                self._run_actor_task(spec)

    def _put_gen_item(self, spec: TaskSpec, item) -> None:
        """Seal one streamed item and announce it to the driver (the
        single definition of the gen_item protocol — sync and async
        generator paths both go through here)."""
        from .ids import new_object_id  # noqa: PLC0415
        from .spilling import put_value_or_spill  # noqa: PLC0415
        oid = new_object_id()
        loc = put_value_or_spill(self.store, oid, item)
        self._batch.send(("gen_item", spec.task_id, oid, loc))

    def _stream_items(self, spec: TaskSpec, iterable) -> bool:
        """Put each yielded item and announce it to the driver in order
        (streaming-generator tasks, num_returns="streaming"). Returns
        True if the task was cancelled mid-stream (the generator is
        closed and no further items are emitted)."""
        for item in iterable:
            if spec.task_id in self._cancelled:
                close = getattr(iterable, "close", None)
                if close:
                    close()
                return True
            self._put_gen_item(spec, item)
        return False

    def _maybe_checkpoint(self) -> None:
        """After a completed actor call: if the actor opted into the
        checkpoint contract (defines __ray_save__), serialize its state
        and ship it to the driver for the next restart's
        __ray_restore__. Throttled by checkpoint_interval_s (actor
        option, falling back to RAY_TPU_ACTOR_CHECKPOINT_INTERVAL_S;
        0 = after every completed call). Never fails user work."""
        inst = self._actor_instance
        save = getattr(inst, "__ray_save__", None)
        if inst is None or save is None:
            return
        interval = getattr(self._actor_spec, "checkpoint_interval_s",
                           None)
        if interval is None:
            interval = knobs.get_float(
                "RAY_TPU_ACTOR_CHECKPOINT_INTERVAL_S")
        try:
            # pack AND send under the lock: with max_concurrency > 1,
            # an older blob sent after a newer one would roll the
            # driver's retained state backwards
            with self._ckpt_lock:
                now = time.monotonic()
                if interval > 0 and now - self._last_ckpt < interval:
                    return
                blob = serialization.pack(save())
                self._last_ckpt = now
                # raylint: disable=RT001 deliberate pack+send
                # atomicity: _ckpt_lock serializes checkpoints
                # only — a blocking send delays at most the next
                # checkpoint, and Connection has its own send lock
                self.conn.send(("actor_ckpt", self.rt.current_actor_id,
                                blob))
            mcat.get("ray_tpu_actor_checkpoints_total").inc()
        except Exception:
            # a failing checkpoint must not fail the call that
            # triggered it; the actor just restarts from an older one
            pass

    def _actor_reply(self, spec: TaskSpec, result, error) -> None:
        """Route one actor-call completion: direct calls reply with the
        packed VALUE over the caller's channel (no store seal, no driver
        message); driver-dispatched calls seal returns and batch a
        task_done like before."""
        direct = getattr(spec, "_direct_ch", None)
        if direct is not None:
            conn, rid = direct
            try:
                if error is not None:
                    conn.send(("dresult", rid, False, error))
                else:
                    conn.send(("dresult", rid, True,
                               serialization.pack(result)))
            except Exception:  # noqa: BLE001
                pass   # caller gone: nobody is waiting for this value
            return
        if error is not None:
            self._task_done(spec.task_id, [], error)
        else:
            self._task_done(spec.task_id, self._seal_returns(spec, result),
                            None)

    def _run_actor_task(self, spec: TaskSpec) -> None:
        from ..exceptions import ActorExitRequest  # noqa: PLC0415
        if spec.task_id in self._cancelled:
            # pipelined dispatch: a cancel can land while the call is
            # still queued in this process — honor it like _run_task
            self._cancelled.discard(spec.task_id)
            self._task_done(spec.task_id, [], "cancelled")
            return
        t0 = time.time()
        exec_span = tracing.new_span_id()
        status = "ok"
        logging_mod.mark_current_task(spec.task_id)
        try:
            _check_spec_payload(spec)
            method = getattr(self._actor_instance, spec.method_name)
            args, kwargs = _resolve_args(self.rt, spec.args, spec.kwargs)
            with tracing.active(getattr(spec, "trace_id", "") or "",
                                exec_span):
                result = method(*args, **kwargs)
                if getattr(spec, "streaming", False):
                    cancelled = self._stream_items(spec, result)
                    if cancelled:
                        status = "cancelled"
                    self._task_done(spec.task_id, [],
                                    "cancelled" if cancelled else None)
                    self._maybe_checkpoint()
                    return
            self._actor_reply(spec, result, None)
            self._maybe_checkpoint()
        except ActorExitRequest:
            # graceful self-exit: this call returns None, then the actor
            # goes down for good (no restart)
            self._actor_reply(spec, None, None)
            self._batch.flush()
            self.conn.send(("actor_exit", self.rt.current_actor_id))
            # os._exit skips the finally block: ship this call's span
            # and any buffered telemetry NOW or it dies with the process
            self._finish_task_telemetry(spec, exec_span, t0, "ok")
            self._flush_telemetry()
            os._exit(0)  # works from threadpool threads too
        except BaseException as e:  # noqa: BLE001
            status = "error"
            err = TaskError(repr(e), traceback.format_exc(),
                            f"{type(self._actor_instance).__name__}."
                            f"{spec.method_name}")
            self._actor_reply(spec, None, err)
        finally:
            logging_mod.mark_current_task(None)
            self._finish_task_telemetry(spec, exec_span, t0, status)

    def _async_sem(self, group: Optional[str]):
        """Per-lane asyncio semaphore enforcing max_concurrency /
        concurrency-group limits IN the worker. With pipelined actor
        dispatch the driver intentionally sends past the limit (the
        extra slots just pre-stage specs), so the execution bound for
        async methods — which all share one event loop — must live
        here. Loop-thread only."""
        import asyncio  # noqa: PLC0415
        groups = getattr(self._actor_spec, "concurrency_groups",
                         None) or {}
        key = group if group in groups else None
        sem = self._async_sems.get(key)
        if sem is None:
            limit = groups.get(key) if key else max(
                1, getattr(self._actor_spec, "max_concurrency", 1))
            sem = self._async_sems[key] = asyncio.Semaphore(limit or 1)
        return sem

    async def _run_actor_task_asyncgen(self, spec: TaskSpec) -> None:
        """Streaming from an `async def ... yield` actor method. Requires
        num_returns=\"streaming\" on the call (enforced below — a plain
        call would otherwise try to seal an async_generator object)."""
        from ..exceptions import ActorExitRequest  # noqa: PLC0415
        t0 = time.time()
        exec_span = tracing.new_span_id()
        status = "ok"
        try:
            _check_spec_payload(spec)
            async with self._async_sem(
                    getattr(spec, "concurrency_group", None)):
                method = getattr(self._actor_instance, spec.method_name)
                args, kwargs = _resolve_args(self.rt, spec.args,
                                             spec.kwargs)
                agen = method(*args, **kwargs)
                if not getattr(spec, "streaming", False):
                    raise TypeError(
                        f"{spec.method_name} is an async generator; "
                        "call it with num_returns=\"streaming\"")
                cancelled = False
                async for item in agen:
                    if spec.task_id in self._cancelled:
                        cancelled = True
                        await agen.aclose()
                        break
                    self._put_gen_item(spec, item)
                if cancelled:
                    status = "cancelled"
                self._task_done(spec.task_id, [],
                                "cancelled" if cancelled else None)
                self._maybe_checkpoint()
        except ActorExitRequest:
            self._task_done(spec.task_id, [], None)
            self._batch.flush()
            self.conn.send(("actor_exit", self.rt.current_actor_id))
            # os._exit skips the finally block: ship this call's span
            self._finish_task_telemetry(spec, exec_span, t0, "ok")
            self._flush_telemetry()
            os._exit(0)
        except BaseException as e:  # noqa: BLE001
            status = "error"
            err = TaskError(repr(e), traceback.format_exc(),
                            f"asyncgen.{spec.method_name}")
            self._task_done(spec.task_id, [], err)
        finally:
            # no tracing.active here: interleaved coroutines share the
            # loop thread, so a thread-local context would leak between
            # requests — the span record alone keeps the timeline link
            self._finish_task_telemetry(spec, exec_span, t0, status)

    async def _run_actor_task_async(self, spec: TaskSpec) -> None:
        from ..exceptions import ActorExitRequest  # noqa: PLC0415
        if spec.task_id in self._cancelled:
            self._cancelled.discard(spec.task_id)
            self._task_done(spec.task_id, [], "cancelled")
            return
        t0 = time.time()
        exec_span = tracing.new_span_id()
        status = "ok"
        try:
            _check_spec_payload(spec)
            async with self._async_sem(
                    getattr(spec, "concurrency_group", None)):
                method = getattr(self._actor_instance, spec.method_name)
                args, kwargs = _resolve_args(self.rt, spec.args,
                                             spec.kwargs)
                result = await method(*args, **kwargs)
            self._actor_reply(spec, result, None)
            self._maybe_checkpoint()
        except ActorExitRequest:
            self._actor_reply(spec, None, None)
            self._batch.flush()
            self.conn.send(("actor_exit", self.rt.current_actor_id))
            # os._exit skips the finally block: ship this call's span
            self._finish_task_telemetry(spec, exec_span, t0, "ok")
            self._flush_telemetry()
            os._exit(0)
        except BaseException as e:  # noqa: BLE001
            status = "error"
            err = TaskError(repr(e), traceback.format_exc(),
                            f"async.{spec.method_name}")
            self._actor_reply(spec, None, err)
        finally:
            self._finish_task_telemetry(spec, exec_span, t0, status)

    def _ensure_async_loop(self):
        if self._async_loop is None:
            import asyncio  # noqa: PLC0415
            self._async_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._async_loop.run_forever,
                                 daemon=True, name="actor-asyncio")
            t.start()


def main() -> None:
    socket_path, worker_id = sys.argv[1], sys.argv[2]
    log_dir = knobs.get_raw("RAY_TPU_LOG_DIR")
    if log_dir:
        from .logging import redirect_process_output  # noqa: PLC0415
        redirect_process_output(
            os.path.join(log_dir, f"worker-{worker_id}.log"))
    try:
        loop = WorkerLoop(socket_path, worker_id)
    except (ConnectionRefusedError, FileNotFoundError):
        # Driver died between spawning us and our connect: exit quietly.
        sys.exit(0)
    loop.run()


if __name__ == "__main__":
    main()
