"""Driver runtime: single-controller scheduler + object directory.

Reference parity (collapsed into one process, by design):
  * raylet local scheduler  — src/ray/raylet/local_task_manager.cc
  * GCS server              — src/ray/gcs/gcs_server/
  * ownership/object dir    — src/ray/core_worker/reference_count.cc,
                              src/ray/object_manager/ownership_based_object_directory.cc
  * worker pool             — src/ray/raylet/worker_pool.cc

Concurrency model: every state mutation flows through one dispatcher thread
consuming an inbox queue (worker messages, API calls, timers). API threads
block on events; worker connections get one reader thread each. This is the
TPU-friendly single-controller analogue of the reference's distributed
raylet protocol — on a TPU pod, one driver per slice controls all hosts, and
the data plane (XLA collectives over ICI) never touches this control plane.
"""
from __future__ import annotations

import collections
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import resources as res_mod
from . import scheduling as sched_mod
from . import serialization
from .gcs import GCS, ActorEntry, TaskEntry, NodeEntry
from .ids import new_node_id, new_object_id
from .object_ref import ObjectRef
from .object_store import make_store
from .protocol import (Connection, ConnectionClosed, tcp_listener,
                       unix_listener)
from .task import TaskSpec, ActorCreationSpec
from ..util import knobs
from ..exceptions import (ActorDiedError, CompiledDagError, GetTimeoutError,
                          ObjectLostError, PlacementGroupError,
                          RuntimeNotInitializedError, TaskCancelledError,
                          TaskError, WorkerCrashedError)


_mcat_mod = None
_ev_mod = None


def _mcat():
    # lazy: ray_tpu_torch.util's __init__ imports modules that import THIS
    # module, so a top-level util import would be circular during
    # package init; cached after the first call (hot paths call this
    # several times per task — the importlib machinery is measurable)
    global _mcat_mod
    if _mcat_mod is None:
        from ..util import metrics_catalog  # noqa: PLC0415
        _mcat_mod = metrics_catalog
    return _mcat_mod


def _ev():
    # same lazy-import-then-cache rationale as _mcat
    global _ev_mod
    if _ev_mod is None:
        from ..util import events  # noqa: PLC0415
        _ev_mod = events
    return _ev_mod


_waits_mod = None


def _waits():
    # same lazy-import-then-cache rationale as _mcat
    global _waits_mod
    if _waits_mod is None:
        from ..util import waits  # noqa: PLC0415
        _waits_mod = waits
    return _waits_mod

_runtime: Optional[Any] = None
_runtime_lock = threading.Lock()


def get_runtime():
    if _runtime is None:
        raise RuntimeNotInitializedError(
            "ray_tpu_torch.init() must be called first")
    return _runtime


def set_runtime(rt) -> None:
    global _runtime
    _runtime = rt


def runtime_initialized() -> bool:
    return _runtime is not None


def _cpu_only(held: Dict[str, float]) -> Dict[str, float]:
    return {k: v for k, v in held.items() if k == "CPU"}


def _non_cpu(held: Dict[str, float]) -> Dict[str, float]:
    return {k: v for k, v in held.items() if k != "CPU"}


class WorkerState:
    __slots__ = ("worker_id", "conn", "proc", "pid", "state", "current_task",
                 "actor_id", "held_resources", "held_gpu_ids", "blocked",
                 "started_at", "purpose", "gpu_capable", "node_id",
                 "func_calls", "lease", "direct_addr", "last_progress",
                 "node_lease", "gpu_binding", "held_gpu_amount")

    def __init__(self, worker_id: str, proc: Optional[subprocess.Popen],
                 purpose=None, gpu_capable: bool = False,
                 node_id: Optional[str] = None):
        self.worker_id = worker_id
        self.proc = proc               # None for workers on remote nodes
        self.conn: Optional[Connection] = None
        self.pid: Optional[int] = None
        self.state = "starting"        # starting|idle|busy|actor|dead
        self.current_task: Optional[str] = None
        # task ids dispatched under this worker's current lease, in
        # execution order (head = the task actually running; the worker
        # executes its queue strictly FIFO). One-slot leases are the
        # legacy single-dispatch case.
        self.lease: collections.deque = collections.deque()
        # listener address for direct worker->worker actor calls
        # (registered at worker startup; None when the worker predates
        # the direct-call plane or failed to bind)
        self.direct_addr: Optional[str] = None
        # last lease grant or completion: the lease progress watchdog
        # reclaims unstarted slots when the head stalls without parking
        # in a driver-visible verb (gang tasks spinning in a user-space
        # rendezvous loop must not pin their peers behind them)
        self.last_progress = 0.0
        # id of the NODE-level bulk lease holding this worker (two-level
        # scheduling): the node agent, not the driver, fans tasks to it
        # while set; resources release at lease close, not per task
        self.node_lease: Optional[str] = None
        self.actor_id: Optional[str] = None
        self.held_resources: Dict[str, float] = {}
        self.held_gpu_ids: List[int] = []
        self.held_gpu_amount = 0.0     # the GPU request held_gpu_ids serve
        self.func_calls: Dict[str, int] = {}   # func_id -> executions
        self.blocked = False
        self.started_at = time.time()
        self.purpose = purpose         # None (general) | actor_id
        self.gpu_capable = gpu_capable
        self.node_id = node_id
        # the card ids this process's CUDA_VISIBLE_DEVICES is fixed to.
        # CUDA reads the variable once, at its first use in the process,
        # so a worker runs only tasks granted exactly these ids
        # (_bind_gpu_worker). A GPU-capable worker is unbound (None) until
        # its first task; any other worker was spawned seeing no card.
        self.gpu_binding: Optional[Tuple[int, ...]] = \
            None if gpu_capable else ()


class NodeState:
    """Per-node scheduling view: capacity, availability, topology labels,
    and (for remote nodes) the node-agent connection used to spawn
    workers and fetch objects. The driver's own host is node 0 with
    conn=None (reference parity: per-node resource views in
    gcs_node_manager.cc / node_manager.cc)."""
    __slots__ = ("node_id", "hostname", "total", "avail", "labels", "conn",
                 "alive", "free_gpu_ids", "gpu_shares", "last_heartbeat",
                 "heartbeat_missed", "incarnation", "restored",
                 "lease_capable")

    def __init__(self, node_id: str, hostname: str,
                 resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None,
                 conn: Optional[Connection] = None):
        self.node_id = node_id
        self.hostname = hostname
        self.total = dict(resources)
        self.avail = dict(resources)
        self.labels = dict(labels or {})
        self.conn = conn
        self.alive = True
        # liveness plumbing (event plane): agents ping periodically;
        # the reaper tick flags staleness as a node.heartbeat_miss
        # event before the socket-level death determination lands
        self.last_heartbeat = time.time()
        self.heartbeat_missed = False
        # bumped on rejoin; messages from older incarnations are fenced
        self.incarnation = 0
        # rebuilt from persisted state by a resumed driver and not yet
        # re-registered: the agent's reattach flips this back off
        self.restored = False
        # the agent advertised its local dispatch plane at registration
        # (two-level scheduling): only then may the driver grant this
        # node bulk leases
        self.lease_capable = False
        # Specific card indices handed to tasks/actors (get_gpu_ids):
        # whole-card holders see disjoint cards. A card held in shares
        # (fractional requests) leaves free_gpu_ids for gpu_shares, its
        # index -> the share in use, until the last share is returned.
        self.free_gpu_ids = list(range(int(resources.get("GPU", 0))))
        self.gpu_shares: Dict[int, float] = {}

    def gpu_room(self, amount: float) -> bool:
        """Whether some card(s) can take a GPU request of `amount`."""
        if amount >= 1:
            return len(self.free_gpu_ids) >= int(amount)
        return amount <= 0 or bool(self.free_gpu_ids) or any(
            used + amount <= 1 + 1e-9 for used in self.gpu_shares.values())

    def take_gpus(self, amount: float,
                  prefer: Optional[Tuple[int, ...]] = None
                  ) -> Optional[List[int]]:
        """Reserve card ids for a GPU request of `amount` (None when no
        card has room). A whole number takes that many free cards,
        `prefer`'s when they are all free; a share below 1 takes room on
        one card: `prefer`'s when it has room, else the fullest card with
        room (shares pack onto few cards), else a free card."""
        if amount <= 0:
            return []
        if amount >= 1:
            k = int(amount)
            if len(self.free_gpu_ids) < k:
                return None
            if (prefer is not None and len(prefer) == k
                    and set(prefer) <= set(self.free_gpu_ids)):
                ids = list(prefer)
            else:
                ids = self.free_gpu_ids[:k]
            self.free_gpu_ids = [i for i in self.free_gpu_ids
                                 if i not in ids]
            return ids
        room = [(used, i) for i, used in self.gpu_shares.items()
                if used + amount <= 1 + 1e-9]
        fits = {i for _, i in room} | set(self.free_gpu_ids)
        if prefer is not None and len(prefer) == 1 and prefer[0] in fits:
            i = prefer[0]
        elif room:
            i = max(room)[1]
        elif self.free_gpu_ids:
            i = self.free_gpu_ids[0]
        else:
            return None
        if i in self.free_gpu_ids:
            self.free_gpu_ids.remove(i)
        self.gpu_shares[i] = self.gpu_shares.get(i, 0.0) + amount
        return [i]

    def give_gpus(self, ids: List[int], amount: float) -> None:
        """Return what take_gpus(amount) reserved as `ids`: a share
        leaves its card, which rejoins the free ids with its last."""
        freed = list(ids)
        if 0 < amount < 1:
            freed = []
            for i in ids:
                left = self.gpu_shares.get(i, 0.0) - amount
                if left > 1e-9:
                    self.gpu_shares[i] = left
                else:
                    self.gpu_shares.pop(i, None)
                    freed.append(i)
        self.free_gpu_ids = sorted(set(self.free_gpu_ids) | set(freed))


class NodeLease:
    """Driver-side ledger of one NODE-level bulk lease (two-level
    scheduling, docs/SCHEDULING.md): a resource shape, the workers
    claimed for it (each holding one `need` worth of the node's
    resources until the lease closes), and the granted tasks still
    outstanding. Standing leases carry no driver tasks — they park
    capacity for a node's agent-local nested submissions and are
    released by the agent when idle (or reclaimed by the tick when
    driver work starves)."""

    __slots__ = ("lease_id", "node_id", "need", "need_key", "wids",
                 "tasks", "standing", "created_at", "last_activity")

    def __init__(self, lease_id: str, node_id: str,
                 need: Dict[str, float], wids: List[str],
                 standing: bool = False):
        self.lease_id = lease_id
        self.node_id = node_id
        self.need = dict(need)
        self.need_key = sched_mod.shape_key(need)
        self.wids = list(wids)
        self.tasks: Dict[str, TaskSpec] = {}   # outstanding ledger
        self.standing = standing
        self.created_at = time.time()
        # stamped at grant/extend/completion/spill: the tick watchdog
        # force-revokes a lease whose agent stops making progress
        self.last_activity = self.created_at


class GenStream:
    """Driver-side state of one streaming-generator task
    (num_returns="streaming"): item refs arrive as the remote generator
    yields; consumers pop them in order via gen_next (reference parity:
    ObjectRefGenerator / streaming generator tasks, _raylet.pyx)."""
    __slots__ = ("task_id", "items", "done", "error", "waiters",
                 "terminal_sent", "retained")

    def __init__(self, task_id: str):
        self.task_id = task_id
        self.items: collections.deque = collections.deque()   # sealed oids
        self.done = False
        self.error: Optional[BaseException] = None
        # each waiter: (cb, abandoned_flag_list); cb((kind, payload))
        self.waiters: collections.deque = collections.deque()
        # already enqueued on the retention-eviction deque
        self.retained = False
        # the done/error reply reached a consumer (GC precondition: the
        # real error object must be delivered before the stream drops to
        # the generic task-table fallback)
        self.terminal_sent = False


class Waiter:
    """A pending get/wait. Satisfied (and its callback fired) exactly once,
    from the dispatcher thread."""
    _ids = iter(range(1, 1 << 62))

    def __init__(self, oids: List[str], num_returns: Optional[int],
                 callback: Callable[[Dict[str, Tuple[str, Any]], List[str]], None],
                 needs_bytes: bool = True):
        self.waiter_id = next(Waiter._ids)
        self.oids = oids
        # settled ids accumulate here so each seal costs one membership
        # update, not a rescan of every oid (a 1000-ref get used to pay
        # O(N^2) _object_settled calls across its seals)
        self.settled: set = set()
        uniq = len(set(oids))
        self.num_returns = uniq if num_returns is None \
            else min(num_returns, uniq)
        self.callback = callback
        self.done = False
        # get-style waiters need the PAYLOAD (a device-resident object
        # must materialize first); wait-style waiters only need
        # readiness — a device loc counts as ready and must NOT trigger
        # a D2H materialization (that would also destroy the device-
        # locality scheduling the object exists for)
        self.needs_bytes = needs_bytes


class PlacementGroupState:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"         # PENDING|CREATED|INFEASIBLE|REMOVED
        self.ready_ref: Optional[str] = None
        # node_id per bundle, filled at admission by the strategy solver
        self.bundle_nodes: List[str] = []
        # chip indices reserved per bundle at admission (tasks scheduled
        # into a bundle report these from get_gpu_ids)
        self.bundle_gpu_ids: List[List[int]] = []
        self.created_at = time.time()


class DriverRuntime:
    is_driver = True
    # count backstop for the lineage table (the primary bound is
    # accumulated bytes, RAY_TPU_LINEAGE_BYTES — see _retain_lineage)
    _LINEAGE_RETAIN = 4096

    def __init__(self, *, num_cpus=None, num_gpus=None, resources=None,
                 object_store_memory=None, max_workers=None, namespace="default",
                 job_id=None, log_to_driver=True, listen=None,
                 state_dir=None, resume=False):
        self.namespace = namespace
        self.job_id = job_id or f"job-{os.getpid()}"
        self.gcs = GCS()
        self.node_id = new_node_id()
        # ---- control-plane persistence (core/persistence.py): with a
        # state dir, every GCS mutation WALs and resume=True rebuilds
        # the tables after a driver crash under a bumped incarnation
        from . import persistence as persist_mod  # noqa: PLC0415
        state_dir = state_dir or persist_mod.default_state_dir()
        self.state_dir = state_dir
        self.incarnation = 0
        self.resumed = False
        self._resume_rec = None
        self._persist = None
        if resume is True and not state_dir:
            # silently starting fresh here would re-run every
            # side-effecting task of a job that believes it resumed
            raise RuntimeError(
                "init(resume=True) requires a state dir: pass "
                "state_dir=... or set RAY_TPU_STATE_DIR "
                "(resume=\"auto\" starts fresh when there is none)")
        if state_dir and resume:
            rec = persist_mod.load(state_dir)
            if rec is None:
                if resume != "auto":
                    raise RuntimeError(
                        f"init(resume=True): no persisted driver state "
                        f"under {state_dir!r} (missing MANIFEST.json)")
            else:
                self._resume_rec = rec
                self.incarnation = rec.incarnation + 1
                self.resumed = True
                if rec.node_id:
                    # the driver node KEEPS its id across restarts
                    # (mirroring node agents, which keep theirs across
                    # rejoins and bump an incarnation): restored
                    # lineage specs' NodeAffinity pins, persisted
                    # ObjectLocations, and forensics all keep naming a
                    # node that still exists
                    self.node_id = rec.node_id
                if listen is None \
                        and not knobs.get_raw("RAY_TPU_LISTEN"):
                    # re-bind the crashed driver's control address so
                    # waiting node agents reattach to it
                    listen = rec.listen
        elif state_dir and persist_mod.wipe(state_dir):
            sys.stderr.write(
                f"[ray_tpu] fresh init(): cleared stale driver state "
                f"from {state_dir}\n")
        # Stamp this process's node id so ObjectLocations created by the
        # driver (and env-inheriting local workers) carry it.
        os.environ["RAY_TPU_NODE_ID"] = self.node_id
        node_res = res_mod.detect_node_resources(num_cpus, num_gpus)
        if resources:
            node_res.update(resources)
        labels: Dict[str, str] = {}   # no pod labels (resources.py)
        self.cluster_nodes: Dict[str, NodeState] = {
            self.node_id: NodeState(self.node_id, os.uname().nodename,
                                    node_res, labels=labels, conn=None)}
        self.gcs.nodes[self.node_id] = NodeEntry(
            node_id=self.node_id, hostname=os.uname().nodename,
            resources=dict(node_res), labels=labels)

        cap = object_store_memory \
            or knobs.get_int("RAY_TPU_STORE_BYTES")
        self.store = make_store(capacity_bytes=cap, is_owner=True)
        self.max_workers = max_workers \
            or knobs.get_int("RAY_TPU_MAX_WORKERS")

        self._tmpdir = tempfile.mkdtemp(prefix="ray_tpu_")
        from .spilling import SpillManager  # noqa: PLC0415
        self._spill_env_owned = "RAY_TPU_SPILL_DIR" not in os.environ
        spill_dir = knobs.get_raw("RAY_TPU_SPILL_DIR") or os.path.join(
            self._tmpdir, "spill")
        os.environ["RAY_TPU_SPILL_DIR"] = spill_dir  # workers inherit
        self._spill = SpillManager(self.store, spill_dir, self.node_id)
        self.socket_path = os.path.join(self._tmpdir, "driver.sock")
        self._listener = unix_listener(self.socket_path)
        # Multi-host: optional TCP listener for remote node agents and the
        # workers they spawn ("host:port", port 0 = ephemeral).
        listen = listen or knobs.get_raw("RAY_TPU_LISTEN")
        self._tcp_listener = None
        self.tcp_address: Optional[str] = None
        if listen:
            host, _, port = str(listen).rpartition(":")
            host = host or "127.0.0.1"
            self._tcp_listener = tcp_listener(host, int(port or 0))
            lh, lp = self._tcp_listener.getsockname()[:2]
            if lh in ("0.0.0.0", "::"):
                # Wildcard binds accept on every interface but the
                # advertised address must be routable from other hosts.
                from ..util.netutil import routable_ip  # noqa: PLC0415
                lh = routable_ip()
            self.tcp_address = f"tcp://{lh}:{lp}"
        self.log_dir = os.path.join(self._tmpdir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._log_streamer = None
        if log_to_driver:
            from .logging import LogStreamer  # noqa: PLC0415
            self._log_streamer = LogStreamer(self.log_dir)

        self.inbox: "queue.Queue" = queue.Queue()
        self.workers: Dict[str, WorkerState] = {}
        self.pending_tasks: collections.deque = collections.deque()
        self._spread_rr = 0   # rotating node index for SPREAD scheduling
        self._gen_streams: Dict[str, GenStream] = {}
        # rid -> (abandoned_flag, worker, blocked_here) for parked
        # worker-side generator waiters
        self._gen_worker_waiters: Dict[str, tuple] = {}
        # settled-but-unconsumed streams, oldest first (bounded retention)
        self._gen_settled: collections.deque = collections.deque()
        # settled streams still holding undrained items (larger bound)
        self._gen_undrained: collections.deque = collections.deque()
        # task_ids whose undrained items were evicted: late consumers
        # get an explicit ObjectLostError, not a silent "done".
        # deque bounds the memory; the set makes _gen_lookup's
        # membership check O(1) on the dispatcher thread.
        self._gen_evicted: collections.deque = collections.deque()
        self._gen_evicted_set: set = set()
        # batched-submission round-trips (compiled DAG test hook)
        self.submit_many_calls = 0
        # ---- decentralized batched dispatch (docs/SCHEDULING.md) ----
        # .remote() submits coalesce into api_submit_many frames under a
        # size + time flush window; dispatches grant multi-slot worker
        # leases; actor dispatch pipelines past max_concurrency (the
        # worker enforces the real execution bound). RAY_TPU_BATCH=0 is
        # the kill switch back to the legacy per-message paths.
        self._batch_enabled = knobs.get_bool("RAY_TPU_BATCH")
        self._flush_n = knobs.get_int("RAY_TPU_BATCH_FLUSH_N")
        self._flush_window = knobs.get_float("RAY_TPU_BATCH_FLUSH_S")
        self._lease_cap = knobs.get_int("RAY_TPU_LEASE_SLOTS")
        self._actor_pipeline = knobs.get_int("RAY_TPU_ACTOR_PIPELINE")
        if not self._batch_enabled:
            self._lease_cap = 1
            self._actor_pipeline = 0
        self._submit_buf: List[TaskSpec] = []
        self._submit_buf_lock = threading.Lock()
        self._submit_buf_event = threading.Event()
        # dispatch-plane telemetry (state API dispatch_summary / bench
        # messages-per-task): flushed submit batches, lease lifecycle,
        # frames and logical messages in each direction
        self.submit_batches = 0
        self.batched_submits = 0
        self.lease_grants = 0
        self.lease_revokes = 0
        self.dispatch_frames = 0
        self.dispatched_tasks = 0
        self.ctrl_frames = 0
        self.ctrl_msgs: collections.Counter = collections.Counter()
        # ---- two-level scheduling (docs/SCHEDULING.md) ----
        # NODE-level bulk leases: the driver hands a batch of compatible
        # queued tasks plus a set of the node's workers to its agent in
        # one frame; the agent fans them out locally and streams batched
        # completions back. RAY_TPU_NODE_LEASES=0 kills the path.
        self._node_leases_enabled = knobs.get_bool("RAY_TPU_NODE_LEASES")
        self._node_lease_slots = max(
            1, knobs.get_int("RAY_TPU_NODE_LEASE_SLOTS"))
        if not self._batch_enabled:
            self._node_leases_enabled = False
        self.node_leases: Dict[str, NodeLease] = {}
        self._nlease_counter = 0
        # node_id -> deadline (time.time); a node that just spilled
        # tasks back is skipped by the grant pass until this passes
        self._nlease_backoff: Dict[str, float] = {}
        self.node_lease_grants = 0
        self.node_lease_extends = 0
        self.node_lease_tasks = 0
        self.spillbacks = 0
        # compiled-DAG controllers by dag_id (docs/DAG.md); acquires
        # queue here until the dispatcher can pin every stage's worker
        self.compiled_dags: Dict[str, Any] = {}
        self._dag_acquires: List[dict] = []
        # (worker_id, task_id) pairs reclaimed from a blocked worker's
        # lease: a result that slips in anyway (revoke raced a user
        # thread) must be dropped, not double-sealed over the re-run
        self._revoked_set: set = set()
        self._revoked_q: collections.deque = collections.deque()
        self._kv_lock = threading.Lock()
        self.pending_actors: collections.deque = collections.deque()
        self.pending_restarts: collections.deque = collections.deque()
        self.actor_queues: Dict[str, collections.deque] = {}
        self.actor_max_conc: Dict[str, int] = {}
        # concurrency groups: per-actor {group: limit} and per
        # (actor_id, group|None) in-flight counts (None = the default
        # max_concurrency lane; this map is THE in-flight gate)
        self.actor_group_conc: Dict[str, Dict[str, int]] = {}
        self.actor_group_inflight: Dict[tuple, int] = {}
        self.waiters: Dict[int, Waiter] = {}
        self.object_waiters: Dict[str, List[int]] = {}
        self.report_handlers: Dict[str, Callable] = {}
        self.placement_groups: Dict[str, PlacementGroupState] = {}
        self._task_events: Dict[str, List[Tuple[float, str]]] = {}
        self._actor_create_specs: Dict[str, ActorCreationSpec] = {}
        self._respawnable_specs: Dict[str, TaskSpec] = {}
        # finished non-actor task specs for lineage reconstruction
        # (insertion-ordered; bounded by accumulated bytes AND count —
        # evicting a producer pins its surviving outputs as
        # non-reconstructable via ObjectEntry.lineage_evicted)
        self._lineage_specs: Dict[str, TaskSpec] = {}
        self._lineage_sizes: Dict[str, int] = {}
        self._lineage_bytes = 0
        self._lineage_cap = knobs.get_int("RAY_TPU_LINEAGE_BYTES")
        self._lineage_enabled = knobs.get_bool("RAY_TPU_LINEAGE")
        # how long a reader blocks for a reconstruction it triggered
        # before giving up on the object
        self._reconstruct_wait = knobs.get_float(
            "RAY_TPU_RECONSTRUCTION_WAIT_S")
        # latest __ray_save__ checkpoint per actor, handed back to the
        # replacement worker for __ray_restore__ around a restart
        self._actor_checkpoints: Dict[str, bytes] = {}
        # (node_id, conn id) pairs already reported as fenced, so a
        # chatty stale incarnation logs one node.fence, not thousands
        self._fenced_seen: set = set()
        # device-resident objects with an in-flight materialize request
        # (core/device_store.py); cleared when the holder's re-seal lands
        self._materializing: set = set()
        # pending-placement diagnostics: first-seen ts per task/actor id
        # and a warned set, so a workload stuck behind exhausted
        # resources surfaces a one-time stderr warning instead of
        # hanging silently (reference: raylet's pending-task warnings)
        self._pending_since: Dict[str, float] = {}
        self._pending_warned: set = set()
        self._wid_counter = 0
        self._shutdown = threading.Event()
        self._conn_by_wid: Dict[str, Connection] = {}
        # cross-node fetch plumbing: rid -> (Event, box)
        self._fetch_counter = 0
        self._fetch_lock = threading.Lock()
        self._fetch_events: Dict[int, Tuple[threading.Event, dict]] = {}

        # cluster metrics plane: remote processes ship delta snapshots
        # of their registries here (util/metrics.py); trace spans from
        # worker executions land in trace_spans for the timeline export
        from ..util.metrics import ClusterMetricsStore  # noqa: PLC0415
        self.cluster_metrics = ClusterMetricsStore()
        self.trace_spans: collections.deque = collections.deque(
            maxlen=8192)
        # deferred driver-side span producers (compiled-DAG controllers
        # buffer submit/result markers in bounded rings; see
        # drain_fastpath_spans)
        self._span_drains: List[Any] = []

        # cluster event plane (util/events.py): lifecycle events from
        # this process and every worker/node-agent merge here, indexed
        # by task/actor/object/node id for the state API, /api/events,
        # and post-mortem bundles
        from ..util.events import ClusterEventStore  # noqa: PLC0415
        self.cluster_events = ClusterEventStore()

        # cluster profile plane (observability/sampling_profiler.py):
        # workers ship folded-stack deltas over sys.profile on the same
        # telemetry heartbeat as metrics/spans; profile_ctl round-trips
        # (start/stop/snapshot) resolve through rid-keyed futures like
        # cross-node fetches
        from ..observability.sampling_profiler import \
            ClusterProfileStore  # noqa: PLC0415
        self.profile_store = ClusterProfileStore()
        self._profile_counter = 0
        self._profile_lock = threading.Lock()
        self._profile_replies: Dict[int, Tuple[threading.Event, dict]] = {}

        # cluster wait-state plane (util/waits.py): aged WaitRecord
        # snapshots from every worker/agent fold here; the hang
        # watchdog (observability/waitgraph.py) walks them together
        # with the driver's own wait table and GCS tables at
        # RAY_TPU_HANG_PROBE_S cadence
        from ..util.waits import ClusterWaitStore  # noqa: PLC0415
        self.cluster_waits = ClusterWaitStore()
        self._hang_monitor = None   # built lazily by _start_hang_watchdog
        self._node_hb_timeout = knobs.get_float(
            "RAY_TPU_NODE_HEARTBEAT_TIMEOUT_S")
        # heartbeat-DECLARED death: a node silent past this long is
        # declared dead without waiting for its socket to close (a
        # SIGSTOPped/preempted host can hold a socket open for minutes);
        # its object copies are pruned and reconstruction starts
        # immediately. The fenced agent rejoins under a new incarnation.
        self._node_death_timeout = knobs.get_float(
            "RAY_TPU_NODE_DEATH_TIMEOUT_S",
            default=2.0 * self._node_hb_timeout)

        # peer-to-peer object transfer plane (core/object_transfer.py):
        # the GCS object table is the location directory; this maps each
        # node to its data-plane listener so requesters pull object
        # bytes straight from the holder. The driver's own server covers
        # driver-node objects; relay over the control connections stays
        # only as an instrumented fallback (relay_bytes counter).
        self.transfer_addrs: Dict[str, str] = {}
        self._transfer_server = None
        self.relay_bytes = 0
        self._relay_lock = threading.Lock()
        if self._tcp_listener is not None:
            from .object_transfer import TransferServer  # noqa: PLC0415
            try:
                host = self.tcp_address[len("tcp://"):].rpartition(":")[0]
                # bind the SAME interface as the control plane: a
                # loopback-only driver must not expose a wider data plane
                self._transfer_server = TransferServer(
                    self.store, host=host or "0.0.0.0",
                    advertise_host=host or None,
                    spill_dirs=[spill_dir])
                self.transfer_addrs[self.node_id] = \
                    self._transfer_server.address
            except Exception:
                self._transfer_server = None

        self.report_handlers["sys.lookup_actor"] = self._sys_lookup_actor
        self.report_handlers["sys.kv"] = \
            lambda _wid, payload: self._kv_op(*payload)
        self.report_handlers["sys.metrics"] = self._on_worker_metrics
        self.report_handlers["sys.spans"] = self._on_worker_spans
        self.report_handlers["sys.events"] = self._on_worker_events
        self.report_handlers["sys.profile"] = self._on_worker_profile
        self.report_handlers["sys.waits"] = self._on_worker_waits
        # control-plane actors (the serve controller's autoscaler) need
        # the node table and placement-group ops; both live only in the
        # driver, so workers reach them over report_sync channels
        self.report_handlers["sys.cluster_view"] = self._sys_cluster_view
        self.report_handlers["sys.pg"] = self._sys_pg
        # GCS actor directory for driver-bypass actor calls: a caller
        # resolves the callee's direct-call address ONCE, then rides a
        # worker->worker connection (docs/SCHEDULING.md)
        self.report_handlers["sys.actor_addr"] = self._sys_actor_addr

        # restored remote-held objects parked until their node
        # reattaches: nid -> [(oid, loc), ...]; past the grace deadline
        # they go through lineage reconstruction instead
        self._reattach_pending: Dict[str, List[tuple]] = {}
        self._reattach_deadline = 0.0
        if state_dir:
            bound = None
            if self.tcp_address:
                bound = self.tcp_address[len("tcp://"):]
            self._persist = persist_mod.GCSPersistence(
                state_dir, incarnation=self.incarnation,
                job_id=self.job_id, node_id=self.node_id, listen=bound,
                resuming=self._resume_rec is not None)
        if self._resume_rec is not None:
            # single-threaded here (dispatcher not started yet): safe to
            # mutate every table directly
            self._restore_from(self._resume_rec)
            self._resume_rec = None
            # snapshot the RESTORED tables before anything else runs:
            # until this lands, the crashed life's manifest stays
            # authoritative (GCSPersistence deferred its swap), so a
            # second crash at ANY point resumes from intact state
            if self._persist is not None and \
                    not self._persist.snapshot(self._snapshot_tables):
                sys.stderr.write(
                    "[ray_tpu] WARNING: post-resume snapshot failed; "
                    "persistence is running degraded (the previous "
                    "life's state dir generation remains "
                    "authoritative)\n")

        # Backstop for drivers that exit without calling shutdown() (e.g.
        # a pytest process): workers self-exit on socket close, but the shm
        # arena needs an explicit owner-side unlink or it outlives us in
        # /dev/shm.
        import atexit
        atexit.register(self.shutdown)

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="rtpu-dispatch")
        self._dispatcher.start()
        self._acceptor = threading.Thread(
            target=self._accept_loop, args=(self._listener,),
            daemon=True, name="rtpu-accept")
        self._acceptor.start()
        if self._tcp_listener is not None:
            threading.Thread(target=self._accept_loop,
                             args=(self._tcp_listener,), daemon=True,
                             name="rtpu-accept-tcp").start()
        self._reaper = threading.Thread(
            target=self._reap_loop, daemon=True, name="rtpu-reaper")
        self._reaper.start()
        if self._batch_enabled:
            threading.Thread(target=self._submit_flush_loop, daemon=True,
                             name="rtpu-submit-flush").start()
        self._start_hang_watchdog()

    def _start_hang_watchdog(self) -> None:
        """The wait-graph watchdog: probe the cluster's wait records
        for deadlocks, stale waits, and stragglers every
        RAY_TPU_HANG_PROBE_S. Off when the wait plane is killed
        (RAY_TPU_WAITS=0) or the cadence is <= 0; the records
        themselves still flow for ad-hoc `ray_tpu stuck` queries."""
        from ..util import waits as waits_mod
        probe_s = knobs.get_float("RAY_TPU_HANG_PROBE_S")
        if not waits_mod.enabled() or probe_s <= 0:
            return
        from ..observability.waitgraph import HangMonitor
        self._hang_monitor = HangMonitor(self)

        def loop() -> None:
            while not self._shutdown.wait(probe_s):
                try:
                    self._hang_monitor.probe()
                except Exception:
                    pass    # a bad probe skips one tick, never kills
                    # the watchdog

        threading.Thread(target=loop, daemon=True,
                         name="rtpu-hang-watchdog").start()

    def hang_monitor(self):
        """The live HangMonitor (building it on demand so state-API
        callers can probe even when the watchdog thread is off)."""
        if self._hang_monitor is None:
            from ..observability.waitgraph import HangMonitor
            self._hang_monitor = HangMonitor(self)
        return self._hang_monitor

    # ================= driver restart / resume =================
    def _restore_from(self, rec) -> None:
        """Rebuild the control plane from a crashed driver's persisted
        state (core/persistence.py) and queue reconciliation:

        * remote nodes become reattach candidates (their agents rejoin
          through the incarnation fencing machinery; until then their
          objects park in _reattach_pending),
        * objects whose only payloads died with the old driver go
          through lineage reconstruction,
        * actors restart from their persisted __ray_save__ checkpoints
          (named / checkpointed / max_restarts>0 actors only — the
          serve controller rides this and re-deploys its targets),
        * everything else (in-flight tasks, streams, placement groups)
          is the resuming job's to resubmit.

        Runs in __init__ before any thread starts."""
        self._emit("driver.restart",
                   f"driver resumed as incarnation {self.incarnation} "
                   f"from {self.state_dir} "
                   f"({rec.replayed_records} WAL records replayed"
                   f"{', torn tail truncated' if rec.torn_tail else ''}"
                   f"{', clean shutdown' if rec.clean else ''})",
                   node_id=self.node_id,
                   incarnation=self.incarnation,
                   replayed_records=rec.replayed_records,
                   torn_tail=rec.torn_tail, clean=rec.clean)
        if self._persist is not None:
            self._persist.replayed_records = rec.replayed_records
            self._persist.torn_tail_recovered = rec.torn_tail
        old_driver_nid = rec.node_id
        if old_driver_nid and old_driver_nid != self.node_id:
            # only for state dirs written before node-id adoption: the
            # dead driver's id survives as a tombstone for forensics
            self.gcs.nodes.setdefault(old_driver_nid, NodeEntry(
                node_id=old_driver_nid, hostname="(dead driver)",
                resources={}, alive=False))

        # ---- nodes: alive-at-crash remote nodes await reattach
        for nid, info in rec.nodes.items():
            if nid == old_driver_nid:
                continue
            self.gcs.nodes[nid] = NodeEntry(
                node_id=nid, hostname=info.get("hostname", "?"),
                resources=dict(info.get("resources") or {}),
                labels=dict(info.get("labels") or {}),
                alive=False,
                incarnation=int(info.get("incarnation", 0)))
            if not info.get("alive", False):
                continue    # declared dead pre-crash: nothing to wait on
            ns = NodeState(nid, info.get("hostname", "?"),
                           dict(info.get("resources") or {}),
                           labels=info.get("labels"), conn=None)
            ns.alive = False
            ns.restored = True
            ns.incarnation = int(info.get("incarnation", 0))
            self.cluster_nodes[nid] = ns
        grace = knobs.get_float(
            "RAY_TPU_RESUME_REATTACH_GRACE_S",
            default=knobs.get_float("RAY_TPU_NODE_REJOIN_S"))
        self._reattach_deadline = time.time() + grace

        # ---- lineage + task table (reconstruction needs both)
        for task_id, spec in rec.lineage.items():
            self._lineage_specs[task_id] = spec
            cost = self._lineage_cost(spec)
            self._lineage_sizes[task_id] = cost
            self._lineage_bytes += cost
            self.gcs.tasks[task_id] = TaskEntry(
                task_id=task_id, name=spec.name, state="FINISHED",
                actor_id=spec.actor_id)

        # ---- objects: classify every persisted payload location
        lost: List[str] = []
        for oid, e in rec.objects.items():
            if e.state != "ready":
                continue
            servable, awaiting = [], []
            for loc in [e.loc, *e.copies]:
                if loc is None:
                    continue
                kind = getattr(loc, "kind", None)
                if kind == "inline":
                    servable.append(loc)
                    continue
                if kind == "device":
                    continue            # holder died with the driver
                nid = getattr(loc, "node_id", None) or old_driver_nid
                ns = self.cluster_nodes.get(nid)
                if ns is not None and getattr(ns, "restored", False):
                    awaiting.append(loc)
                    continue
                # driver-local (or dead-node) payload: the store died
                # with its process, but a spill copy on disk survives a
                # SIGKILL — re-home it onto the new driver node
                spath = getattr(loc, "spill_path", None) or (
                    loc.name if kind == "spill" else None)
                if spath and os.path.exists(spath):
                    loc.node_id = self.node_id
                    servable.append(loc)
            self.gcs.objects[oid] = e
            if servable:
                e.loc, e.copies = servable[0], servable[1:] + awaiting
            elif awaiting:
                # park until the holder reattaches; the reattach path
                # re-seals (fresh seal_seq), the grace expiry
                # reconstructs instead
                e.state, e.loc, e.copies = "pending", None, []
                nid = awaiting[0].node_id
                self._reattach_pending.setdefault(nid, []).append(
                    (oid, awaiting[0]))
            else:
                e.state, e.loc, e.copies = "pending", None, []
                lost.append(oid)

        # ---- actors: resume-eligible ones restart from checkpoints
        self.gcs.named_actors.update(rec.named_actors)
        self._actor_checkpoints.update(rec.checkpoints)
        for aid, ae in rec.actors.items():
            self.gcs.actors[aid] = ae
            if ae.state == "DEAD":
                continue    # a dead actor's name is not resurrected
            acspec = ae.create_spec
            pg_id = getattr(acspec, "placement_group_id", None) \
                if acspec is not None else None
            resumable = acspec is not None and pg_id is None and (
                bool(ae.name) or aid in rec.checkpoints
                or ae.max_restarts > 0)
            if not resumable:
                ae.state = "DEAD"
                ae.worker_id = None
                ae.death_cause = (
                    "placement groups are not persisted across a "
                    "driver restart" if pg_id is not None else
                    "driver restarted; actor is not resumable (no "
                    "name, no __ray_save__ checkpoint, max_restarts=0)")
                self._emit("actor.death", ae.death_cause, actor_id=aid,
                           class_name=ae.class_name)
                self._persist_actor_state(ae)
                continue
            ae.state = "RESTARTING"
            ae.worker_id = None
            self.actor_max_conc[aid] = acspec.max_concurrency
            self.actor_group_conc[aid] = dict(
                getattr(acspec, "concurrency_groups", None) or {})
            self.pending_restarts.append(aid)
            self._emit("actor.restart",
                       f"driver restart (incarnation "
                       f"{self.incarnation}); restarting"
                       + (" from persisted checkpoint"
                          if aid in rec.checkpoints else ""),
                       actor_id=aid, class_name=ae.class_name)
            self._persist_actor_state(ae)

        # ---- internal KV (job-level resume handles live here)
        self.gcs.kv.update(rec.kv)

        # lost objects reconstruct once the dispatcher starts (their
        # producer chains re-queue through _handle_lost_object)
        if lost:
            self.inbox.put(("resume_reconcile", lost))
        sys.stderr.write(
            f"[ray_tpu] driver resumed as incarnation "
            f"{self.incarnation}: {len(rec.objects)} objects "
            f"({len(lost)} lost with the old driver, "
            f"{sum(len(v) for v in self._reattach_pending.values())} "
            f"awaiting node reattach), {len(rec.actors)} actors "
            f"({len(self.pending_restarts)} restarting), "
            f"{len(rec.lineage)} lineage specs, "
            f"{rec.replayed_records} WAL records replayed\n")

    def _resume_reconcile(self, lost: List[str]) -> None:
        """Dispatcher-side half of resume: push every payload that died
        with the old driver through the loss machinery — lineage
        re-execution when the producer's spec survived, a clean
        ObjectLostError otherwise."""
        for oid in lost:
            e = self.gcs.objects.get(oid)
            if e is None or e.state != "pending":
                continue
            self._handle_lost_object(
                oid, e,
                cause="payload lived in the crashed driver's store")

    def _check_reattach_grace(self) -> None:
        """Give up on restored nodes that never reattached: their parked
        objects go through lineage reconstruction instead."""
        if not self._reattach_pending \
                or time.time() < self._reattach_deadline:
            return
        pend, self._reattach_pending = self._reattach_pending, {}
        for nid, items in pend.items():
            for oid, loc in items:
                e = self.gcs.objects.get(oid)
                if e is None or e.state != "pending":
                    continue
                self._handle_lost_object(
                    oid, e,
                    cause=f"holder node {nid} did not reattach within "
                          f"the resume grace window", node_id=nid)

    def _snapshot_tables(self) -> dict:
        """Build the snapshot payload (dispatcher thread: tables are
        consistent without locks; only kv is shared with API threads)."""
        nodes = {}
        for nid, ns in self.cluster_nodes.items():
            if nid == self.node_id:
                continue
            nodes[nid] = {"node_id": nid, "hostname": ns.hostname,
                          "resources": dict(ns.total),
                          "labels": dict(ns.labels),
                          "incarnation": ns.incarnation,
                          "alive": ns.alive}
        with self._kv_lock:
            kv = dict(self.gcs.kv)
        return {
            "objects": {oid: e for oid, e in self.gcs.objects.items()
                        if e.state == "ready"},
            "actors": dict(self.gcs.actors),
            "checkpoints": dict(self._actor_checkpoints),
            "named_actors": dict(self.gcs.named_actors),
            "nodes": nodes,
            "lineage": dict(self._lineage_specs),
            "kv": kv,
        }

    def _persist_actor_state(self, ae) -> None:
        if self._persist is not None:
            self._persist.actor_state(ae)

    def persistence_stats(self) -> Optional[dict]:
        """Persistence-health snapshot for the state API / CLI; None
        when no state dir is configured."""
        if self._persist is None:
            return None
        stats = self._persist.stats()
        stats["resumed"] = self.resumed
        stats["reattach_awaiting_objects"] = sum(
            len(v) for v in list(self._reattach_pending.values()))
        return stats

    # ================= threads =================
    def _accept_loop(self, listener):
        while not self._shutdown.is_set():
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            conn = Connection(sock)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: Connection):
        """One thread per inbound connection; the first message decides
        whether the peer is a worker ("register") or a remote node agent
        ("register_node")."""
        wid = None
        nid = None
        try:
            msg = conn.recv()
            if msg[0] == "register":
                wid = msg[1]
                self.inbox.put(("register", wid, conn, msg[2],
                                msg[3] if len(msg) > 3 else None))
                while True:
                    # raylint: disable=RT003 driver-side reader: worker
                    # process death closes the socket (EOF); host-level
                    # silence is the heartbeat monitor's job, which
                    # closes this conn on the node's death
                    # determination, unblocking the read
                    m = conn.recv()
                    self.inbox.put(("worker_msg", wid, m))
            elif msg[0] == "register_node":
                nid = msg[1]["node_id"]
                self.inbox.put(("register_node", msg[1], conn))
                while True:
                    # raylint: disable=RT003 heartbeat-declared node
                    # death closes this conn, so a silent peer unblocks
                    # the read within RAY_TPU_NODE_DEATH_TIMEOUT_S
                    m = conn.recv()
                    # the conn travels with the message so the dispatcher
                    # can fence traffic from a superseded incarnation
                    self.inbox.put(("node_msg", nid, m, conn))
            else:
                conn.close()
        except ConnectionClosed:
            if wid is not None:
                self.inbox.put(("worker_dead", wid))
            if nid is not None:
                self.inbox.put(("node_dead", nid, conn))

    def _reap_loop(self):
        while not self._shutdown.is_set():
            time.sleep(0.5)
            # Periodic tick: re-runs _schedule even with no worker events,
            # so time-based decisions (pg infeasibility grace) fire.
            self.inbox.put(("tick",))
            for w in list(self.workers.values()):
                if w.state != "starting":
                    continue
                if w.proc is not None and w.proc.poll() is not None:
                    self.inbox.put(("worker_dead", w.worker_id))
                elif w.proc is None and time.time() - w.started_at > 120:
                    # remote worker that never registered (agent-side
                    # spawn failure with no proc handle to poll)
                    self.inbox.put(("worker_dead", w.worker_id))

    def _dispatch_loop(self):
        while True:
            # raylint: disable=RT003 every control frame lands in this
            # inbox and the reap loop posts a tick each interval: the
            # blocking get is the dispatcher's idle state, never a park
            item = self.inbox.get()
            if item is None:
                return
            try:
                self._handle(item)
                self._schedule()
            except Exception:
                sys.stderr.write("ray_tpu dispatcher error:\n"
                                 + traceback.format_exc())

    # ================= event handling =================
    def _handle(self, item):
        kind = item[0]
        if kind == "tick":
            self._update_builtin_gauges()
            self._check_node_heartbeats()
            self._check_lease_watchdog()
            self._check_node_lease_watchdog()
            self._check_reattach_grace()
            if self._persist is not None and \
                    self._persist.maybe_snapshot(self._snapshot_tables):
                self._emit("gcs.snapshot",
                           node_id=self.node_id,
                           incarnation=self.incarnation,
                           **{k: v for k, v in
                              self._persist.stats().items()
                              if k in ("snapshots_taken",
                                       "wal_records")})
                try:
                    _mcat().get("ray_tpu_gcs_snapshots_total").inc()
                except Exception:
                    pass
            self.drain_local_events()
            return
        if kind == "resume_reconcile":
            self._resume_reconcile(item[1])
            return
        if kind == "wal":
            # API-thread mutations (internal KV) persist through here so
            # appends serialize with snapshot rotation
            if self._persist is not None:
                self._persist.append(item[1])
            return
        if kind == "final_snapshot":
            # shutdown(): the LAST snapshot must run on this thread —
            # the tables are only consistent here
            if self._persist is not None:
                self._persist.snapshot(self._snapshot_tables)
            item[1].set()
            return
        if kind == "register":
            _, wid, conn, pid = item[:4]
            w = self.workers.get(wid)
            if w is None:
                conn.close()
                return
            w.conn, w.pid = conn, pid
            if len(item) > 4:
                w.direct_addr = item[4]
            self._conn_by_wid[wid] = conn
            if w.purpose is not None:
                w.state = "actor"
                acspec = self._actor_create_specs.get(w.purpose)
                if acspec is not None:
                    w.actor_id = acspec.actor_id
                    # a restart hands back the latest __ray_save__
                    # checkpoint so the actor resumes instead of resetting
                    conn.send(("create_actor", acspec,
                               self._actor_checkpoints.get(
                                   acspec.actor_id)))
            else:
                w.state = "idle"
        elif kind == "worker_msg":
            _, wid, m = item
            self.ctrl_frames += 1
            self._handle_worker_msg(wid, m)
        elif kind == "worker_dead":
            self._on_worker_dead(item[1])
        elif kind == "register_node":
            self._on_register_node(item[1], item[2])
        elif kind == "node_msg":
            self.ctrl_frames += 1
            self._handle_node_msg(item[1], item[2],
                                  item[3] if len(item) > 3 else None)
        elif kind == "node_dead":
            self._on_node_dead(item[1],
                               conn=item[2] if len(item) > 2 else None)
        elif kind == "object_unreachable":
            self._on_object_unreachable(
                item[1], item[2], item[3] if len(item) > 3 else None)
        elif kind == "object_copied":
            e = self.gcs.objects.get(item[1])
            if e is not None and e.state == "ready":
                newloc = item[2]
                if newloc not in [e.loc, *e.copies]:
                    # copies belong to the CURRENT seal generation
                    try:
                        newloc.seal_seq = e.seal_seq
                    except Exception:
                        pass
                    self._emit("object.transfer", object_id=item[1],
                               node_id=newloc.node_id or self.node_id,
                               size=getattr(newloc, "size", None))
                    if (newloc.node_id or self.node_id) == self.node_id:
                        # driver-local re-host: promote it so driver-side
                        # readers hit local shm; the original stays a
                        # directory candidate and is freed alongside it
                        e.copies.append(e.loc)
                        e.loc = newloc
                    else:
                        # a peer pull landed a copy on another node:
                        # directory entry only (the primary stays put)
                        e.copies.append(newloc)
        elif kind == "api_submit":
            self._register_task(item[1])
        elif kind == "api_submit_many":
            # one inbox round-trip for a whole compiled-DAG level
            for spec in item[1]:
                self._register_task(spec)
        elif kind == "api_submit_actor":
            self._register_actor_creation(item[1])
        elif kind == "api_seal":
            _, oid, loc = item
            self._seal(oid, loc)
        elif kind == "api_waiter":
            self._add_waiter(item[1])
        elif kind == "api_gen_next":
            self._gen_request(item[1], item[2], item[3])
        elif kind == "waiter_timeout":
            self._fire_waiter(item[1], timed_out=True)
        elif kind == "api_cancel":
            self._cancel(item[1], item[2])
        elif kind == "api_cancel_obj":
            # Resolve object -> producing task here in the dispatcher, after
            # any preceding submit in the FIFO inbox has been processed.
            e = self.gcs.objects.get(item[1])
            if e is not None and e.owner_task:
                self._cancel(e.owner_task, item[2])
        elif kind == "api_kill_actor":
            self._kill_actor(item[1], item[2])
        elif kind == "api_free":
            self._free(item[1])
        elif kind == "api_create_pg":
            self._create_pg(item[1])
        elif kind == "api_remove_pg":
            self._remove_pg(item[1])
        elif kind == "api_dag_acquire":
            self._dag_acquires.append(item[1])
            self._process_dag_acquires()
        elif kind == "api_dag_release":
            self._dag_release(item[1], item[2], item[3])

    def _handle_worker_msg(self, wid: str, m):
        from .protocol import RECV_ERROR  # noqa: PLC0415
        w = self.workers.get(wid)
        mtype = m[0]
        if mtype == RECV_ERROR:
            sys.stderr.write(
                f"[ray_tpu driver] dropped undeserializable message from "
                f"{wid}:\n{m[1]}")
            return
        if mtype == "batch":
            # coalesced worker->driver frame: the inner messages are
            # ordinary control messages in their original send order
            for sub in m[1]:
                self._handle_worker_msg(wid, sub)
            return
        self.ctrl_msgs[mtype] += 1
        if w is not None and w.state == "dead" and mtype in (
                "task_done", "gen_item", "actor_created", "actor_exit",
                "put", "put_error", "materialized", "actor_ckpt",
                "object_unreachable"):
            # incarnation fence: a worker already declared dead (its node
            # was heartbeat-declared dead, or it was terminated) may still
            # be alive and sending — results from the fenced life must not
            # race the retried/reconstructed one
            return
        if mtype == "task_done":
            self._on_task_done(wid, m[1], m[2], m[3])
        elif mtype == "gen_item":
            self._on_gen_item(m[1], m[2], m[3])
        elif mtype == "gen_next_request":
            _, rid, task_id = m
            self._gen_next_for_worker(w, rid, task_id)
        elif mtype == "gen_abandon":
            self._gen_abandon_worker(m[1])
        elif mtype == "actor_created":
            self._on_actor_created(wid, m[1], m[2], m[3])
        elif mtype == "actor_exit":
            self._on_actor_exit(m[1])
        elif mtype == "put":
            self._seal(m[1], m[2])
        elif mtype == "materialized":
            oid, loc = m[1], m[2]
            self._materializing.discard(oid)
            if oid in self.gcs.objects:
                self._seal(oid, loc)
            else:
                # freed while the holder was serializing: reclaim the
                # fresh shm copy instead of resurrecting a ghost entry
                if loc.kind in ("shm", "native") and \
                        (loc.node_id or self.node_id) == self.node_id:
                    self.store.delete_segment(loc.name, loc.size)
        elif mtype == "materialize_failed":
            # The holder is ALIVE but the value won't serialize (e.g. an
            # unpicklable leaf next to the tensors). Reconstruction
            # would re-produce the same unserializable value forever —
            # surface the error to the waiters instead.
            e = self.gcs.objects.get(m[1])
            self._materializing.discard(m[1])
            if e is not None and e.state == "ready" \
                    and getattr(e.loc, "kind", None) == "device":
                self._fail_object(m[1], ObjectLostError(
                    f"device-resident object {m[1]} failed to "
                    f"materialize: {m[2]}"))
        elif mtype == "submit":
            self._register_task(m[1])
        elif mtype == "submit_many":
            # a worker-side fan-out coalesced into one frame
            for spec in m[1]:
                self._register_task(spec)
        elif mtype == "put_error":
            # a direct-call result escaped this cluster's caller (its
            # ref was serialized) but the call errored: fail the object
            # so driver-side readers see the error, not a hang
            self._fail_object(m[1], m[2])
        elif mtype == "submit_actor":
            self._register_actor_creation(m[1])
        elif mtype == "get_request":
            _, rid, oids, timeout = m
            self._worker_get(w, rid, oids, timeout)
        elif mtype == "wait_request":
            _, rid, oids, num_returns, timeout = m
            self._worker_wait(w, rid, oids, num_returns, timeout)
        elif mtype == "kill_actor":
            self._kill_actor(m[1], m[2])
        elif mtype == "actor_ckpt":
            self._on_actor_ckpt(wid, m[1], m[2])
        elif mtype == "dwait":
            # worker parked on a direct-call future past the grace
            # window: lend its CPU and reclaim leased slots, exactly
            # like a driver-path get_request would (symmetric unblock
            # on dwait False; actor workers never lend, as before)
            if w is not None and w.state == "busy":
                if m[1] and not w.blocked:
                    w.blocked = True
                    res_mod.release(self._wnode_avail(w),
                                    _cpu_only(w.held_resources))
                    if len(w.lease) > 1:
                        self._reclaim_lease(w)
                elif not m[1] and w.blocked:
                    w.blocked = False
                    res_mod.acquire(self._wnode_avail(w),
                                    _cpu_only(w.held_resources))
        elif mtype == "object_unreachable":
            self._on_object_unreachable(m[1], m[2],
                                        m[3] if len(m) > 3 else None)
        elif mtype == "free":
            self._free(m[1])
        elif mtype == "cancel":
            # Workers cancel by OBJECT id (mirroring ray.cancel(ref));
            # resolve to the producing task like the driver's
            # api_cancel_obj path. A task id (generator cancel) is also
            # accepted directly.
            e = self.gcs.objects.get(m[1])
            if e is not None and e.owner_task:
                self._cancel(e.owner_task, m[2])
            else:
                self._cancel(m[1], m[2])
        elif mtype == "dag_ready":
            ctl = self.compiled_dags.get(m[1])
            if ctl is not None:
                ctl.on_ready(m[2], m[3])
        elif mtype == "dag_error":
            ctl = self.compiled_dags.get(m[1])
            if ctl is not None:
                ctl.on_install_error(m[2], m[3])
        elif mtype == "dag_down":
            ctl = self.compiled_dags.get(m[1])
            if ctl is not None:
                ctl.on_down(m[2], m[3])
        elif mtype == "profile_reply":
            _, rid, payload = m
            with self._profile_lock:
                pair = self._profile_replies.get(rid)
            if pair is not None:
                pair[1]["payload"] = payload
                pair[0].set()
        elif mtype == "report":
            h = self.report_handlers.get(m[1])
            if h:
                try:
                    h(wid, m[2])
                except Exception:
                    traceback.print_exc()
        elif mtype == "report_sync":
            _, rid, channel, payload = m
            h = self.report_handlers.get(channel)
            result = None
            if h:
                try:
                    result = h(wid, payload)
                except Exception:
                    traceback.print_exc()
            if w and w.conn:
                w.conn.send(("get_reply", rid, result))

    # ---------------- nodes ----------------
    def _on_register_node(self, info: dict, conn: Connection) -> None:
        nid = info["node_id"]
        inc = int(info.get("incarnation", 0))
        prev = self.cluster_nodes.get(nid)
        if prev is not None and prev.alive and prev.conn is not None:
            if inc <= prev.incarnation:
                # duplicate/stale registration for a live node
                try:
                    conn.close()
                except Exception:
                    pass
                return
            # a NEWER incarnation arrived before the old socket's death
            # was determined: declare the old one dead first so its
            # workers, objects, and bundles fail over exactly once
            self._on_node_dead(nid)
        # the fence-report dedup is per (nid, conn) pair: reset on each
        # (re)registration so the set stays bounded and an id()-reused
        # future connection can still report once
        self._fenced_seen = {k for k in self._fenced_seen
                             if k[0] != nid}
        was_restored = prev is not None and getattr(prev, "restored",
                                                    False)
        ns = NodeState(nid, info.get("hostname", "?"), info["resources"],
                       labels=info.get("labels"), conn=conn)
        ns.incarnation = inc
        ns.lease_capable = bool(info.get("node_leases"))
        self.cluster_nodes[nid] = ns
        self.gcs.nodes[nid] = NodeEntry(
            node_id=nid, hostname=ns.hostname, resources=dict(ns.total),
            labels=dict(ns.labels), incarnation=inc)
        if info.get("transfer_address"):
            self.transfer_addrs[nid] = info["transfer_address"]
        if self._persist is not None:
            self._persist.node_register(
                {"node_id": nid, "hostname": ns.hostname,
                 "resources": dict(ns.total),
                 "labels": dict(ns.labels), "incarnation": inc})
        if was_restored:
            # reattach after a driver restart: the agent (and its store)
            # never died — every parked object it holds becomes ready
            # again under a fresh seal generation
            parked = self._reattach_pending.pop(nid, [])
            resealed = 0
            for oid, loc in parked:
                e = self.gcs.objects.get(oid)
                if e is not None and e.state == "pending":
                    self._seal(oid, loc)
                    resealed += 1
            self._emit("node.reattach",
                       f"node {nid} ({ns.hostname}) reattached to the "
                       f"restarted driver (incarnation {inc}); "
                       f"{resealed} restored objects ready again",
                       node_id=nid, objects_resealed=resealed,
                       driver_incarnation=self.incarnation)
        elif prev is not None:
            # elastic rejoin (preempted/stalled host back): queued work
            # may flow to it again; everything it held was failed over
            # at death determination and is NOT resurrected
            self._emit("node.rejoin",
                       f"node {nid} ({ns.hostname}) re-registered as "
                       f"incarnation {inc}; stale messages from the old "
                       "incarnation are fenced",
                       node_id=nid)
        else:
            self._emit("node.register", node_id=nid,
                       hostname=ns.hostname, resources=dict(ns.total))
        # the driver's own transfer address travels per-candidate in
        # pull_object/locations payloads, so the ack stays minimal
        conn.send(("node_registered", self.node_id, self.job_id,
                   self.incarnation))

    def _handle_node_msg(self, nid: str, m, conn=None) -> None:
        from .protocol import RECV_ERROR  # noqa: PLC0415
        ns = self.cluster_nodes.get(nid)
        if ns is not None and (not ns.alive or (
                conn is not None and ns.conn is not None
                and ns.conn is not conn)):
            # incarnation fence: traffic from a heartbeat-declared-dead
            # node, or over a connection a rejoin superseded, must not
            # heal liveness or mutate state. Closing the stale socket
            # prompts that agent to re-register under a new incarnation.
            key = (nid, id(conn))
            if key not in self._fenced_seen:
                self._fenced_seen.add(key)
                self._emit("node.fence",
                           f"dropping {m[0]!r} (and any further traffic) "
                           f"from a superseded incarnation of node {nid}",
                           node_id=nid)
            if conn is not None:
                try:
                    conn.close()
                except Exception:
                    pass
            return
        if ns is not None:
            # any traffic proves liveness; a flagged miss heals
            ns.last_heartbeat = time.time()
            ns.heartbeat_missed = False
        mtype = m[0]
        if mtype != "batch":
            # logical node-plane message accounting ("batch" recurses
            # into its parts): the two-level scheduling tests assert
            # driver-frame invariants over these deltas
            self.ctrl_msgs[mtype] += 1
        if mtype == "heartbeat":
            # ack so the AGENT can tell a silent-dead driver host from
            # an idle one (node.py's RAY_TPU_DRIVER_SILENCE_S watchdog;
            # a half-open TCP peer never errors a blocking recv) —
            # this is the agent-side mirror of heartbeat-declared death
            if conn is not None:
                try:
                    conn.send(("heartbeat_ack", m[1]))
                except Exception:
                    pass  # reader will determine the death
            return
        if mtype == "batch":
            # agent-side telemetry kinds coalesced into one frame
            for sub in m[1]:
                self._handle_node_msg(nid, sub, conn)
            return
        if mtype == RECV_ERROR:
            sys.stderr.write(f"[ray_tpu driver] dropped undeserializable "
                             f"message from node {nid}:\n{m[1]}")
        elif mtype == "fetched":
            _, rid, data, err = m
            with self._fetch_lock:
                pair = self._fetch_events.pop(rid, None)
            if pair is not None:
                ev, box = pair
                box["data"], box["err"] = data, err
                ev.set()
        elif mtype == "fetched_chunk":
            # large payloads stream in frames under the protocol cap
            _, rid, off, total, chunk = m
            with self._fetch_lock:
                pair = self._fetch_events.get(rid)
            if pair is None:
                return
            ev, box = pair
            buf = box.get("buf")
            if buf is None:
                buf = box["buf"] = bytearray(total)
                box["got"] = 0
            buf[off:off + len(chunk)] = chunk
            box["got"] += len(chunk)
            if box["got"] >= total:
                with self._fetch_lock:
                    self._fetch_events.pop(rid, None)
                box["data"], box["err"] = bytes(buf), None
                ev.set()
        elif mtype == "pulled":
            # a node agent finished (or failed) a peer pull we asked for
            _, rid, oid, newloc, err = m
            with self._fetch_lock:
                pair = self._fetch_events.pop(rid, None)
            if pair is not None:
                ev, box = pair
                box["loc"], box["err"] = newloc, err
                ev.set()
            elif newloc is not None:
                # the requester gave up waiting (timeout -> relay) but
                # the pull completed: register the copy anyway so the
                # directory serves it and the free path reclaims it
                self.inbox.put(("object_copied", oid, newloc))
        elif mtype == "locate":
            # agent-side PullManager re-resolving a stale directory
            # entry between retry rounds
            _, rid, oid = m
            ns = self.cluster_nodes.get(nid)
            if ns is not None and ns.conn is not None:
                try:
                    ns.conn.send(("locations", rid,
                                  self._object_candidates(oid)))
                except ConnectionClosed:
                    pass
        elif mtype == "metrics":
            # the node agent's own registry (store stats etc.) ships on
            # the node connection; workers ship on their own conns
            self.cluster_metrics.ingest(
                {"node_id": nid, "worker_id": "node-agent"}, m[1])
        elif mtype == "spans":
            # agent-side trace spans (per-pull transfer spans)
            for sp in m[1] or ():
                sp = dict(sp)
                sp.setdefault("worker_id", "node-agent")
                if not sp.get("node_id"):
                    sp["node_id"] = nid
                self.trace_spans.append(sp)
        elif mtype == "events":
            # agent-side lifecycle events (event plane delta batch)
            self.cluster_events.ingest(
                {"node_id": nid, "worker_id": "node-agent"}, m[1])
        elif mtype == "waits":
            # agent-side wait records (synthesized lease-queue heads)
            self.cluster_waits.ingest(
                f"agent:{nid}",
                {"node_id": nid, "worker_id": "node-agent"}, m[1])
        elif mtype == "worker_spawn_failed":
            sys.stderr.write(f"[ray_tpu driver] node {nid} failed to spawn "
                             f"worker {m[1]}: {m[2]}\n")
            self.inbox.put(("worker_dead", m[1]))
        elif mtype == "nlease_done":
            # batched completions off a node-level bulk lease
            for tid, wid, sealed, err in m[2]:
                self._on_nlease_done(m[1], tid, wid, sealed, err)
        elif mtype == "nlease_spill":
            self._on_nlease_spill(nid, m[1], m[2], m[3])
        elif mtype == "nlease_want":
            self._on_nlease_want(nid, m[1], m[2])
        elif mtype == "nlease_release":
            # the agent drained a standing lease and went idle: its
            # workers return to the pool
            self._close_node_lease(m[1], notify=False)
        elif mtype == "submit":
            # agent-forwarded nested spillover (deps not node-local or
            # no capacity arrived): enters the normal task queue
            self._register_task(m[1])

    def _on_node_dead(self, nid: str, conn=None) -> None:
        ns = self.cluster_nodes.get(nid)
        if ns is None or not ns.alive:
            return
        if conn is not None and ns.conn is not None and ns.conn is not conn:
            # socket-close of a SUPERSEDED incarnation: the rejoined
            # node stays alive
            return
        # determinism for forensics: the causal chain always reads
        # heartbeat-miss -> death, even when the socket close beat the
        # staleness check to the determination
        if not ns.heartbeat_missed:
            ns.heartbeat_missed = True
            self._emit("node.heartbeat_miss",
                       f"connection to node {nid} lost", node_id=nid)
        ns.alive = False
        entry = self.gcs.nodes.get(nid)
        if entry is not None:
            entry.alive = False
        if self._persist is not None:
            self._persist.node_death(nid)
        self._emit("node.death",
                   f"node {nid} ({ns.hostname}) declared dead; failing "
                   "over its workers, objects, and placement bundles",
                   node_id=nid)
        self.cluster_metrics.drop_source({"node_id": nid})
        # drop the agent's wait snapshot too — a dead agent's lease
        # queues are gone, and ghost waits would poison the waitgraph
        self.cluster_waits.drop_source(f"agent:{nid}")
        # location directory upkeep: the dead node serves no more pulls
        self.transfer_addrs.pop(nid, None)
        # Bulk node leases die with their agent. Unstarted slots
        # re-pend WITHOUT burning a retry, but up to one task per
        # leased worker may have been EXECUTING when the node died —
        # those (the oldest outstanding entries, by grant order)
        # follow normal worker-death retry accounting so a started
        # task can't silently re-run past its retry budget. (Conn is
        # gone, so no result can race this; a rejoining agent is a
        # fresh incarnation that dropped its lease state.) Close
        # zeroes held_resources BEFORE the worker-death loop so the
        # per-worker release below can't double-release.
        for lid, lease in list(self.node_leases.items()):
            if lease.node_id == nid:
                self._revoke_node_lease(
                    lid, reason="node_death",
                    charge=min(len(lease.wids), len(lease.tasks)))
                self._close_node_lease(lid, notify=False)
        # In-flight fetches against this node resolve via their timeout.
        for w in list(self.workers.values()):
            if w.node_id == nid and w.state != "dead":
                self._on_worker_dead(w.worker_id)
        # CREATED placement groups with a bundle on the dead node go back
        # to PENDING (the reference's RESCHEDULING): surviving-node
        # reservations are released and phase 0 re-solves against the
        # remaining topology. ready_ref stays sealed — holders simply see
        # their pg-bound work queue until capacity reappears (or the
        # infeasibility grace declares it impossible).
        for pg in self.placement_groups.values():
            if pg.state == "CREATED" and nid in pg.bundle_nodes:
                for i, (b, bn) in enumerate(zip(pg.bundles,
                                                pg.bundle_nodes)):
                    node = self.cluster_nodes.get(bn)
                    if bn != nid and node is not None and node.alive:
                        res_mod.release(node.avail, b)
                        ids = (pg.bundle_gpu_ids[i]
                               if i < len(pg.bundle_gpu_ids) else [])
                        node.give_gpus(ids, b.get("GPU", 0))
                pg.bundle_nodes = []
                pg.state = "PENDING"
                pg.created_at = time.time()
        self._reconstruct_lost_objects(nid)

    def _reconstruct_lost_objects(self, nid: str) -> None:
        """Lineage reconstruction (reference:
        core_worker/reference_count.cc + task resubmission): when a node
        dies — socket-close OR heartbeat-declared — every ready object
        whose payload lived there either fails over to a surviving copy,
        is re-created by re-running its producing task (kept in the
        bounded lineage log), or fails. Runs in the dispatcher BEFORE
        readers chase the stale location."""
        def alive(node_id) -> bool:
            n = self.cluster_nodes.get(node_id)
            return n is not None and n.alive

        for oid, e in list(self.gcs.objects.items()):
            if e.state != "ready":
                continue
            if getattr(e.loc, "kind", None) == "inline":
                continue  # payload rides in the location itself
            # location directory upkeep: copies on the dead node must
            # not be handed to pullers as candidates
            e.copies = [c for c in e.copies
                        if getattr(c, "node_id", None) != nid]
            loc_node = getattr(e.loc, "node_id", None)
            if loc_node != nid:
                continue
            survivors = [c for c in e.copies
                         if getattr(c, "node_id", None) is None
                         or alive(c.node_id)]
            if survivors:
                e.loc = survivors[0]
                e.copies = [c for c in survivors if c is not e.loc]
                continue
            self._handle_lost_object(
                oid, e, cause=f"only copy lived on dead node {nid}",
                node_id=nid)

    # ---------------- lineage / reconstruction ----------------
    @staticmethod
    def _max_reconstruction_depth() -> int:
        return knobs.get_int("RAY_TPU_MAX_RECONSTRUCTION_DEPTH")

    @staticmethod
    def _max_reconstructions() -> int:
        """Per-task cap on REPEAT re-executions (distinct from the
        recursion depth cap): a flapping node must not re-run the same
        producer forever while a reader blocks."""
        return knobs.get_int("RAY_TPU_MAX_RECONSTRUCTIONS")

    def _lineage_cost(self, spec) -> int:
        """Rough retained footprint of one lineage entry: func_bytes
        usually dominates; by-VALUE args are estimated by walking a few
        container levels (getsizeof alone counts a list's pointer
        array, not the gigabytes of ndarrays inside it). Args passed by
        ObjectRef cost nothing — the ref IS the lineage edge."""
        def est(a, depth=0):
            if isinstance(a, ObjectRef):
                return 64
            nb = getattr(a, "nbytes", None)
            if isinstance(nb, int):
                return nb
            if isinstance(a, (bytes, bytearray, memoryview, str)):
                return len(a)
            if depth < 3 and isinstance(a, (list, tuple, set)):
                return 64 + sum(est(x, depth + 1) for x in a)
            if depth < 3 and isinstance(a, dict):
                return 64 + sum(est(k, depth + 1) + est(v, depth + 1)
                                for k, v in a.items())
            try:
                return sys.getsizeof(a)
            except Exception:
                return 64
        n = len(spec.func_bytes or b"") + 256
        for a in list(spec.args) + list(spec.kwargs.values()):
            n += est(a)
        return n

    def _retain_lineage(self, task_id: str, spec) -> None:
        """Keep a finished task's spec so its outputs can name their
        recipe. Bounded by accumulated bytes (RAY_TPU_LINEAGE_BYTES) and
        entry count; evicting a producer pins its surviving outputs as
        non-reconstructable (the newest entry is always kept, even when
        alone over the cap)."""
        if not self._lineage_enabled:
            return
        cost = self._lineage_cost(spec)
        # move-to-end on re-retain (a reconstructed producer finishing
        # again): eviction pops oldest-INSERTED, and a hot re-executed
        # spec must not sit at the head of the line
        self._lineage_specs.pop(task_id, None)
        self._lineage_specs[task_id] = spec
        self._lineage_bytes += cost - self._lineage_sizes.get(task_id, 0)
        self._lineage_sizes[task_id] = cost
        if self._persist is not None:
            self._persist.lineage_retain(task_id, spec)
        # the spec is (back) in the table: un-pin outputs a concurrent
        # eviction may have flagged while this re-run was in flight
        for oid in spec.return_ids:
            e = self.gcs.objects.get(oid)
            if e is not None:
                e.lineage_evicted = False
        while len(self._lineage_specs) > 1 and (
                self._lineage_bytes > self._lineage_cap
                or len(self._lineage_specs) > self._LINEAGE_RETAIN):
            old_id = next(iter(self._lineage_specs))
            old = self._lineage_specs.pop(old_id)
            self._lineage_bytes -= self._lineage_sizes.pop(old_id, 0)
            if self._persist is not None:
                self._persist.lineage_evict(old_id)
            for ooid in old.return_ids:
                oe = self.gcs.objects.get(ooid)
                if oe is not None:
                    oe.lineage_evicted = True

    def _object_live(self, e) -> bool:
        """At least one recorded payload location is still servable
        (inline / alive node / alive holding worker)."""
        if e.state != "ready":
            return False
        for loc in [e.loc, *e.copies]:
            if loc is None:
                continue
            kind = getattr(loc, "kind", None)
            if kind == "inline":
                return True
            if kind == "device":
                w = self.workers.get(loc.name)
                if w is not None and w.state != "dead" \
                        and w.conn is not None:
                    return True
                continue
            nid = getattr(loc, "node_id", None) or self.node_id
            n = self.cluster_nodes.get(nid)
            if n is not None and n.alive:
                return True
        return False

    def _lost_object_error(self, oid: str, e, detail: str):
        """The user-facing error for a lost, non-reconstructable object.
        An object produced by a dead actor's task reports the ACTOR's
        death (with its death_cause), not a bare ObjectLostError — the
        two used to race on worker-death ordering."""
        te = self.gcs.tasks.get(e.owner_task) if e.owner_task else None
        aid = te.actor_id if te is not None else None
        if aid:
            ae = self.gcs.actors.get(aid)
            if ae is not None and ae.state in ("DEAD", "RESTARTING"):
                cause = ae.death_cause or "worker died"
                return ActorDiedError(
                    f"object {oid} was produced by actor {aid} "
                    f"({ae.class_name}), which died: {cause} [{detail}]")
        return ObjectLostError(f"object {oid} {detail}")

    def _handle_lost_object(self, oid: str, e, *, cause: str,
                            node_id=None) -> bool:
        """An object's last payload copy is gone: re-execute its
        producer from the lineage table when possible, else fail it.
        Returns True when a reconstruction is in flight."""
        why = self._reconstruct_object(oid, cause=cause, node_id=node_id)
        if why is None:
            return True
        detail = f"{cause}; {why}"
        self._emit("object.lost", detail, object_id=oid,
                   task_id=e.owner_task or None, node_id=node_id)
        self._fail_object(oid, self._lost_object_error(oid, e, detail))
        return False

    def _reconstruct_object(self, oid: str, *, depth: int = 0,
                            cause: str = "", node_id=None,
                            _seen=None) -> Optional[str]:
        """Queue a lineage re-execution of `oid`'s producing task — and,
        recursively, of any lost arguments up to
        RAY_TPU_MAX_RECONSTRUCTION_DEPTH. Returns None when a re-run is
        (now or already) in flight; otherwise a human-readable reason
        why the object cannot be reconstructed. Dispatcher-thread only;
        concurrent triggers dedupe on the entry/task state."""
        e = self.gcs.objects.get(oid)
        if e is None:
            return "object entry was freed"
        task_id = e.owner_task
        te = self.gcs.tasks.get(task_id) if task_id else None
        if e.state == "pending" and te is not None \
                and te.state in ("PENDING", "SCHEDULED", "RUNNING"):
            return None  # a concurrent reconstruction is already running
        if not self._lineage_enabled:
            return "lineage recording is disabled (RAY_TPU_LINEAGE=0)"
        if not task_id:
            return ("has no producing task (ray_tpu_torch.put / driver-created "
                    "objects are not reconstructable)")
        if getattr(e, "lineage_evicted", False):
            return ("its producing task's spec was evicted from the "
                    "lineage table (RAY_TPU_LINEAGE_BYTES cap)")
        spec = self._lineage_specs.get(task_id) \
            or self._respawnable_specs.get(task_id)
        if spec is None:
            return "its producing task's spec is not in the lineage table"
        if spec.actor_id is not None:
            return ("its producer was an actor method and is not "
                    "re-executable")
        if getattr(spec, "streaming", False):
            return ("its producer was a streaming generator (consumed "
                    "items cannot replay)")
        if getattr(spec, "reconstructions", 0) \
                >= self._max_reconstructions():
            return (f"its producer already re-executed "
                    f"{spec.reconstructions} times "
                    f"(RAY_TPU_MAX_RECONSTRUCTIONS cap)")
        _seen = _seen if _seen is not None else set()
        if task_id in _seen:
            return None  # this producer is already part of the chain
        _seen.add(task_id)
        maxd = self._max_reconstruction_depth()
        # lost ARGUMENTS first: every dep must be present or recoverable,
        # or the re-run would either hang pending or fail on an errored
        # dep — the recursion is what re-executes a whole producer chain
        for d in spec.dep_object_ids:
            de = self.gcs.objects.get(d)
            if de is None:
                return (f"argument {d} of {spec.name} was freed; cannot "
                        "re-execute")
            lost_dep = de.state == "error" and isinstance(
                de.error, ObjectLostError)
            if de.state == "error" and not lost_dep:
                return (f"argument {d} of {spec.name} failed to "
                        f"produce: {de.error!r}")
            if de.state == "pending" or (de.state == "ready"
                                         and self._object_live(de)):
                continue
            if depth + 1 > maxd:
                return (f"argument {d} of {spec.name} is lost and "
                        f"re-creating it would exceed "
                        f"RAY_TPU_MAX_RECONSTRUCTION_DEPTH={maxd}")
            why = self._reconstruct_object(
                d, depth=depth + 1,
                cause=f"lost argument of {spec.name}",
                node_id=node_id, _seen=_seen)
            if why is not None:
                return (f"argument {d} of {spec.name} is lost and not "
                        f"reconstructable: {why}")
        resubmit = te is None or te.state not in ("PENDING", "SCHEDULED",
                                                  "RUNNING")
        self._emit("object.lost",
                   f"{cause or 'payload lost'}; reconstructing via "
                   "recorded lineage",
                   severity="warning", object_id=oid, task_id=task_id,
                   node_id=node_id)
        # Reset ONLY this lost object — sibling returns with live
        # payloads keep serving reads; the re-run's seal refreshes them.
        e.state, e.loc, e.error, e.copies = "pending", None, None, []
        self._emit("object.reconstruct",
                   f"re-executing producer {spec.name} "
                   f"({'resubmitted' if resubmit else 'already queued'}"
                   f", depth {depth})",
                   object_id=oid, task_id=task_id, node_id=node_id,
                   name=spec.name, depth=depth)
        try:
            _mcat().get("ray_tpu_object_reconstructions_total").inc()
        except Exception:
            pass
        if resubmit:
            spec.reconstructions = getattr(spec, "reconstructions", 0) + 1
            if te is not None:
                te.state = "PENDING"
                te.finished_at = None
            self._respawnable_specs[task_id] = spec
            self.pending_tasks.append(spec)
            self._emit("task.retry",
                       f"lineage reconstruction of {oid}: "
                       f"{cause or 'payload lost'}",
                       task_id=task_id, object_id=oid, node_id=node_id,
                       name=spec.name)
            sys.stderr.write(
                f"[ray_tpu] reconstructing {spec.name} ({task_id}) for "
                f"lost object {oid}: {cause or 'payload lost'}\n")
        return None

    def _on_object_unreachable(self, oid: str, nid=None,
                               seq=None) -> None:
        """A reader exhausted the pull/relay paths against `oid`'s
        recorded locations (PullManager failover exhaustion, fetch
        timeout, holder gone): prune the copies it failed against and
        reconstruct unless a live candidate remains. Dispatcher only."""
        e = self.gcs.objects.get(oid)
        if e is None or e.state != "ready":
            return  # already reconstructing / freed / failed
        if seq is not None and seq != e.seal_seq:
            # the reader failed against an OLDER seal generation and a
            # reseal has landed since (e.g. a reconstruction that
            # finished while this report was in flight, possibly back
            # on the same rejoined node): don't prune the fresh copy —
            # the reader's retry will pick it up
            return
        if nid is not None:
            keep = [c for c in [e.loc, *e.copies]
                    if c is not None
                    and (getattr(c, "node_id", None)
                         or self.node_id) != nid]
        else:
            keep = [c for c in [e.loc, *e.copies] if c is not None]
        if keep:
            e.loc, e.copies = keep[0], keep[1:]
            if self._object_live(e):
                return  # a failover candidate remains; readers retry
        self._handle_lost_object(
            oid, e,
            cause="every recorded copy is unreachable"
                  + (f" (holder node {nid} did not serve the read)"
                     if nid else ""),
            node_id=nid)

    def _await_object(self, oid: str,
                      timeout: Optional[float] = 60.0):
        """Block until `oid` settles again; returns the waiter-style
        ("loc"|"error", payload) pair, or ("timeout", None). Helper/API
        threads only (never the dispatcher) — the shared wait behind
        _reload_one and the reconstruction retries in _worker_get."""
        ev = threading.Event()
        box: Dict[str, Any] = {}

        def cb(results, ready):
            box.update(results)
            ev.set()

        waiter = Waiter([oid], None, cb)
        self.inbox.put(("api_waiter", waiter))
        if not ev.wait(timeout):
            waiter.done = True
            return ("timeout", None)
        return box.get(oid, ("error", ObjectLostError(f"{oid} missing")))

    def _object_candidates(self, oid: str) -> List[Tuple[Any, Optional[str]]]:
        """Location-directory entries for one object: every live
        (location, holder transfer address) pair, primary first. Device
        locations are excluded — they materialize through the holder
        worker before any transfer. Dispatcher-thread only."""
        e = self.gcs.objects.get(oid)
        if e is None or e.state != "ready":
            return []
        out: List[Tuple[Any, Optional[str]]] = []
        for loc in [e.loc, *e.copies]:
            if loc is None or getattr(loc, "kind", None) == "device":
                continue
            nid = loc.node_id or self.node_id
            node = self.cluster_nodes.get(nid)
            if node is None or not node.alive:
                continue
            out.append((loc, self.transfer_addrs.get(nid)))
        return out

    def _count_relay(self, n: int) -> None:
        with self._relay_lock:   # helper threads relay concurrently
            self.relay_bytes += n
        try:
            _mcat().get("ray_tpu_transfer_relay_bytes_total").inc(n)
        except Exception:
            pass

    def _request_node_pull(self, requester_nid: str, oid: str,
                           candidates, timeout: float = 60.0):
        """Ask `requester_nid`'s agent to pull `oid` from a holder over
        the transfer plane; returns the fresh local ObjectLocation or
        None (caller falls back to the relay). Helper threads only."""
        ns = self.cluster_nodes.get(requester_nid)
        if ns is None or not ns.alive or ns.conn is None:
            return None
        if not any(addr for _loc, addr in candidates):
            return None  # no holder has a data-plane listener
        with self._fetch_lock:
            self._fetch_counter += 1
            rid = self._fetch_counter
            ev: threading.Event = threading.Event()
            box: dict = {}
            self._fetch_events[rid] = (ev, box)
        try:
            ns.conn.send(("pull_object", rid, oid, candidates))
        except ConnectionClosed:
            with self._fetch_lock:
                self._fetch_events.pop(rid, None)
            return None
        if not ev.wait(timeout=timeout):
            with self._fetch_lock:
                self._fetch_events.pop(rid, None)
            return None
        if box.get("err") is not None:
            return None
        return box.get("loc")

    def fetch_bytes(self, loc, oid: Optional[str] = None
                    ) -> "bytes | bytearray":
        """Pull a remote object's packed payload to this process. Peer
        path first: a direct TCP pull from the holder node's transfer
        server (driver sockets untouched); the control-connection relay
        through the holder's agent remains as the instrumented fallback.
        Called from API/helper threads (never the dispatcher — it blocks)."""
        addr = self.transfer_addrs.get(loc.node_id or "")
        if addr is not None:
            from . import object_transfer  # noqa: PLC0415
            t0 = time.time()
            try:
                data = object_transfer.pull_bytes(addr, oid or loc.name
                                                  or "?", loc)
            except Exception:  # fall back to relay (never swallow
                pass           # KeyboardInterrupt/SystemExit)
            else:
                try:
                    _mcat().get(
                        "ray_tpu_transfer_bytes_pulled_total").inc(
                        len(data))
                    _mcat().get("ray_tpu_transfer_pulls_total").inc(
                        tags={"result": "ok"})
                    _mcat().get(
                        "ray_tpu_transfer_pull_latency_s").observe(
                        time.time() - t0)
                except Exception:
                    pass
                return data
        ns = self.cluster_nodes.get(loc.node_id or "")
        if ns is None or not ns.alive or ns.conn is None:
            raise ObjectLostError(
                f"object payload lives on node {loc.node_id}, which is "
                "gone")
        with self._fetch_lock:
            self._fetch_counter += 1
            rid = self._fetch_counter
            ev: threading.Event = threading.Event()
            box: dict = {}
            self._fetch_events[rid] = (ev, box)
        try:
            ns.conn.send(("fetch_object", rid, loc))
        except ConnectionClosed:
            with self._fetch_lock:
                self._fetch_events.pop(rid, None)
            raise ObjectLostError(
                f"node {loc.node_id} connection lost during fetch") from None
        # Poll-wait so a holder death mid-fetch surfaces within ~a
        # second (the first send to a freshly-killed peer often lands in
        # the TCP buffer, so waiting the full budget would serialize a
        # dead node's timeout into every reader).
        deadline = time.time() + 60.0
        while not ev.wait(timeout=1.0):
            if not ns.alive:
                with self._fetch_lock:
                    self._fetch_events.pop(rid, None)
                raise ObjectLostError(
                    f"node {loc.node_id} died during fetch of "
                    f"{loc.name}")
            if time.time() > deadline:
                with self._fetch_lock:
                    self._fetch_events.pop(rid, None)
                raise ObjectLostError(
                    f"fetch of {loc.name} from node {loc.node_id} "
                    f"timed out")
        if box.get("err") is not None:
            err = box["err"]
            raise err if isinstance(err, BaseException) else \
                ObjectLostError(str(err))
        # these bytes crossed the driver's control connection: the peer
        # path was unavailable (no transfer server, or the pull failed)
        self._count_relay(len(box["data"]))
        return box["data"]

    def _load_location(self, loc) -> Any:
        """Materialize a value wherever its payload lives."""
        if loc.kind == "inline" or loc.node_id in (None, self.node_id):
            return self.store.get_value(loc)
        return serialization.unpack(self.fetch_bytes(loc))

    # ---------------- objects ----------------
    def _seal(self, oid: str, loc) -> None:
        e = self.gcs.seal_object(oid, loc)
        self._materializing.discard(oid)
        if self._persist is not None:
            self._persist.object_seal(e)
        self._emit("object.seal", object_id=oid, task_id=e.owner_task,
                   node_id=getattr(loc, "node_id", None) or self.node_id,
                   kind=getattr(loc, "kind", None),
                   size=getattr(loc, "size", None))
        self._spill.on_seal(oid, e.loc)
        self._notify_object(oid)

    # ---------------- streaming generators ----------------
    def _on_gen_item(self, task_id: str, oid: str, loc) -> None:
        self._seal(oid, loc)
        s = self._gen_streams.get(task_id)
        if s is None:
            return
        s.items.append(oid)
        self._gen_fire(s)

    # Fully-drained settled streams a consumer never took the terminal
    # reply for are kept for this many entries, then evicted
    # oldest-first (their item refs stay valid in the store;
    # _gen_lookup answers done/error from the task table). Settled
    # streams still HOLDING undrained items get a separate, larger
    # bound (_GEN_UNDRAINED_RETAIN): evicting one loses item refs, so
    # it happens only under sustained fire-and-forget abuse and
    # surfaces as an explicit ObjectLostError, never a silent "done".
    # Together they bound driver memory for fire-and-forget workloads.
    _GEN_SETTLED_RETAIN = 1024
    _GEN_UNDRAINED_RETAIN = 4096

    def _gen_settle(self, task_id: str, error=None) -> None:
        s = self._gen_streams.get(task_id)
        if s is None:
            return
        if error is None:
            s.done = True
        else:
            s.error = error
        self._gen_fire(s)
        if task_id not in self._gen_streams:     # drained+GC'd already
            return
        if s.items:
            self._gen_undrained.append(task_id)
            while len(self._gen_undrained) > self._GEN_UNDRAINED_RETAIN:
                old_id = self._gen_undrained.popleft()
                old = self._gen_streams.get(old_id)
                if old is None or not old.items:
                    continue  # drained in the meantime: retained deque
                              # (or the task table) already covers it
                self._gen_streams.pop(old_id, None)
                self._gen_evicted.append(old_id)
                self._gen_evicted_set.add(old_id)
                while len(self._gen_evicted) > self._GEN_UNDRAINED_RETAIN:
                    self._gen_evicted_set.discard(
                        self._gen_evicted.popleft())
        else:
            self._gen_retain(s)

    def _gen_retain(self, s: GenStream) -> None:
        """Enqueue a settled stream for retention-eviction — but ONLY
        once it holds no unconsumed item refs: evicting a stream with
        pending items would make _gen_lookup answer the task-table
        "done" fallback and silently lose them. Streams still holding
        items are re-enqueued by _gen_gc when their last item drains."""
        if s.items or s.retained:
            return
        s.retained = True
        self._gen_settled.append(s.task_id)
        while len(self._gen_settled) > self._GEN_SETTLED_RETAIN:
            old = self._gen_settled.popleft()
            self._gen_streams.pop(old, None)

    def _gen_reply(self, s: GenStream):
        """(kind, payload) if the stream can answer now, else None."""
        if s.items:
            return ("item", s.items.popleft())
        if s.error is not None:
            s.terminal_sent = True
            return ("error", s.error)
        if s.done:
            s.terminal_sent = True
            return ("done", None)
        return None

    def _gen_fire(self, s: GenStream) -> None:
        while s.waiters:
            head_cb, abandoned = s.waiters[0]
            if abandoned[0]:
                s.waiters.popleft()
                continue
            r = self._gen_reply(s)
            if r is None:
                break
            s.waiters.popleft()
            try:
                head_cb(r)
            except Exception:
                traceback.print_exc()
        self._gen_gc(s)

    def _gen_lookup(self, task_id: str):
        """(stream, None) for a live stream, else (None, terminal_reply).
        Finished streams are GC'd from _gen_streams; the task table keeps
        answering late/repeat consumers."""
        s = self._gen_streams.get(task_id)
        if s is not None:
            return s, None
        if task_id in self._gen_evicted_set:
            return None, ("error", ObjectLostError(
                f"streaming generator {task_id}: undrained item refs "
                f"were evicted (stream settled and was never consumed "
                f"past the retention bound)"))
        te = self.gcs.tasks.get(task_id)
        if te is None:
            return None, ("error", ValueError(
                f"no streaming generator for task {task_id}"))
        if te.state == "FINISHED":
            return None, ("done", None)
        if te.state == "CANCELLED":
            return None, ("error",
                          TaskCancelledError(f"task {task_id} cancelled"))
        return None, ("error", TaskError(
            f"streaming task {task_id} failed", "", te.name))

    def _gen_gc(self, s: GenStream) -> None:
        """Drop fully-drained settled streams (long-lived drivers submit
        unbounded numbers of generator tasks; _gen_lookup keeps answering
        from the task table afterwards)."""
        if s.terminal_sent and not s.items and not s.waiters:
            self._gen_streams.pop(s.task_id, None)
        elif (s.done or s.error is not None) and not s.items:
            # settled stream just fully drained its items (consumer has
            # not taken the terminal reply yet): now safe to bound
            self._gen_retain(s)

    def _gen_request(self, task_id: str, cb, abandoned) -> None:
        """Answer immediately if possible, else park the waiter."""
        s, terminal = self._gen_lookup(task_id)
        if s is None:
            cb(terminal)
            return
        r = self._gen_reply(s)
        if r is not None:
            cb(r)
            self._gen_gc(s)
            return
        s.waiters.append((cb, abandoned))

    def _gen_next_for_worker(self, w, rid: str, task_id: str) -> None:
        def send(result, w=w, rid=rid):
            if w is not None and w.conn is not None:
                try:
                    w.conn.send(("get_reply", rid, result))
                except ConnectionClosed:
                    pass

        s, terminal = self._gen_lookup(task_id)
        if s is None:
            send(terminal)
            return
        r = self._gen_reply(s)
        if r is not None:
            send(r)
            self._gen_gc(s)
            return
        # Must park: same blocked-worker protocol as _worker_get — while
        # a worker waits on the stream it lends its CPU back, else a
        # consumer task on a 1-CPU node deadlocks the generator feeding
        # it.
        blocked_here = (w is not None and w.state == "busy"
                        and not w.blocked)
        if blocked_here:
            w.blocked = True
            res_mod.release(self._wnode_avail(w),
                            _cpu_only(w.held_resources))
            self._reclaim_lease(w)

        def cb(result, w=w, rid=rid, blocked_here=blocked_here):
            self._gen_worker_waiters.pop(rid, None)
            if blocked_here and w is not None and w.blocked:
                w.blocked = False
                res_mod.acquire(self._wnode_avail(w),
                                _cpu_only(w.held_resources))
            send(result)

        abandoned = [False]
        self._gen_worker_waiters[rid] = (abandoned, w, blocked_here)
        s.waiters.append((cb, abandoned))

    def _gen_abandon_worker(self, rid: str) -> None:
        """A worker's gen_next timed out: mark its parked waiter so a
        later item is not popped into a reply nobody is waiting for, and
        restore the CPU the waiter had lent back. (If the reply already
        fired, the item was delivered to the timed-out rid and is lost —
        gen_next timeouts are inherently racy.)"""
        entry = self._gen_worker_waiters.pop(rid, None)
        if entry is None:
            return
        flag, w, blocked_here = entry
        flag[0] = True
        if blocked_here and w is not None and w.blocked \
                and w.state != "dead":
            w.blocked = False
            res_mod.acquire(self._wnode_avail(w),
                            _cpu_only(w.held_resources))

    def _fail_object(self, oid: str, err) -> None:
        self.gcs.fail_object(oid, err)
        self._notify_object(oid)

    def _notify_object(self, oid: str) -> None:
        for waiter_id in self.object_waiters.pop(oid, []):
            w = self.waiters.get(waiter_id)
            if w is None or w.done:
                continue
            if self._object_settled(oid, w.needs_bytes):
                w.settled.add(oid)
                if len(w.settled) >= w.num_returns:
                    self._fire_waiter(waiter_id, timed_out=False)
                    continue
            else:
                # still unsettled for this waiter — e.g. the seal
                # carried a DEVICE location and the bytes only land
                # with the holder's materialize re-seal: stay
                # subscribed or that re-seal would notify nobody
                self.object_waiters.setdefault(oid, []).append(
                    waiter_id)

    def _object_settled(self, oid: str, needs_bytes: bool = True) -> bool:
        e = self.gcs.objects.get(oid)
        if e is None:
            return False
        if (needs_bytes and e.state == "ready"
                and getattr(e.loc, "kind", None) == "device"):
            # the waiter needs BYTES but the value lives device-resident
            # in its producing worker (core/device_store.py): ask the
            # holder to materialize; the re-seal settles the waiter.
            # (Same-worker consumers never reach here — they hit the
            # worker-local table before sending a get_request.)
            self._request_materialize(oid, e)
            return False
        return e.state in ("ready", "error")

    def _request_materialize(self, oid: str, e) -> None:
        if oid in self._materializing:
            return
        w = self.workers.get(e.loc.name)
        if w is None or w.state == "dead" or w.conn is None:
            self._device_object_lost(oid, e)
            return
        self._materializing.add(oid)
        try:
            w.conn.send(("materialize", oid))
        except ConnectionClosed:
            # the holder is plainly dead even if its socket-close event
            # hasn't landed yet: run the FULL death handling (actor
            # death first, then device-object loss) so a dead actor's
            # objects fail with ActorDiedError, not ObjectLostError
            self._materializing.discard(oid)
            self._on_worker_dead(w.worker_id)

    def _device_object_lost(self, oid: str, e) -> None:
        """A device-resident object's holder is gone (or refused):
        re-run the producing task from the lineage log, or fail the
        object — the single-object analog of _reconstruct_lost_objects."""
        self._materializing.discard(oid)
        self._handle_lost_object(
            oid, e, cause="device-resident holder worker died")

    def _add_waiter(self, w: Waiter, timeout: Optional[float] = None):
        self.waiters[w.waiter_id] = w
        for oid in w.oids:
            if oid not in self.gcs.objects:
                self.gcs.add_pending_object(oid)
            if self._object_settled(oid, w.needs_bytes):
                w.settled.add(oid)
            else:
                self.object_waiters.setdefault(oid, []).append(w.waiter_id)
        if len(w.settled) >= w.num_returns:
            self._fire_waiter(w.waiter_id, timed_out=False)
        if not w.done and timeout is not None:
            t = threading.Timer(
                timeout, lambda: self.inbox.put(("waiter_timeout", w.waiter_id)))
            t.daemon = True
            t.start()

    def _fire_waiter(self, waiter_id: int, timed_out: bool):
        w = self.waiters.pop(waiter_id, None)
        if w is None or w.done:
            return
        w.done = True
        results: Dict[str, Tuple[str, Any]] = {}
        ready: List[str] = []
        for oid in w.oids:
            e = self.gcs.objects.get(oid)
            if e is None or e.state == "pending":
                continue
            if (w.needs_bytes and e.state == "ready"
                    and getattr(e.loc, "kind", None) == "device"):
                continue  # bytes not host-side yet (timed-out fire)
            ready.append(oid)
            if e.state == "ready":
                results[oid] = ("loc", e.loc)
            else:
                results[oid] = ("error", e.error)
        try:
            w.callback(results, ready)
        except Exception:
            traceback.print_exc()

    # ---------------- tasks ----------------
    def _register_task(self, spec: TaskSpec):
        te = TaskEntry(task_id=spec.task_id, name=spec.name,
                       actor_id=spec.actor_id, submitted_at=time.time(),
                       retries_left=spec.max_retries,
                       trace_id=getattr(spec, "trace_id", ""),
                       span_id=getattr(spec, "span_id", ""),
                       parent_span_id=getattr(spec, "parent_span_id", ""))
        self.gcs.tasks[spec.task_id] = te
        _mcat().get("ray_tpu_tasks_submitted_total").inc(tags={
            "kind": "actor_task" if spec.actor_id else "task"})
        self._emit("task.submit", task_id=spec.task_id,
                   actor_id=spec.actor_id, name=spec.name)
        for oid in spec.return_ids:
            self.gcs.add_pending_object(oid, owner_task=spec.task_id)
        if getattr(spec, "streaming", False):
            self._gen_streams[spec.task_id] = GenStream(spec.task_id)
        if spec.actor_id is not None:
            aentry = self.gcs.actors.get(spec.actor_id)
            if aentry is None or aentry.state == "DEAD":
                err = ActorDiedError(
                    f"actor {spec.actor_id} is dead"
                    + (f": {aentry.death_cause}" if aentry else ""))
                te.state = "FAILED"
                for oid in spec.return_ids:
                    self._fail_object(oid, err)
                self._gen_settle(spec.task_id, err)
                return
            self.actor_queues.setdefault(spec.actor_id,
                                         collections.deque()).append(spec)
        else:
            # a task a worker submitted re-queues like the driver's when
            # its lease slot is reclaimed or its worker dies (the
            # reference keeps only the driver's specs, so a reclaimed
            # nested task is fenced on its worker and never runs)
            self._respawnable_specs.setdefault(spec.task_id, spec)
            self.pending_tasks.append(spec)

    def _register_actor_creation(self, acspec: ActorCreationSpec):
        ae = ActorEntry(actor_id=acspec.actor_id, name=acspec.name,
                        namespace=acspec.namespace,
                        class_name=acspec.class_name,
                        resources=dict(acspec.resources),
                        max_restarts=acspec.max_restarts,
                        create_spec=acspec)
        self.gcs.actors[acspec.actor_id] = ae
        self._emit("actor.create", actor_id=acspec.actor_id,
                   class_name=acspec.class_name, name=acspec.name)
        if acspec.name:
            ok = self.gcs.register_named_actor(
                acspec.namespace, acspec.name, acspec.actor_id)
            if not ok:
                ae.state = "DEAD"
                ae.death_cause = f"name {acspec.name!r} already taken"
                self._emit("actor.death", ae.death_cause,
                           actor_id=acspec.actor_id,
                           class_name=acspec.class_name)
                if self._persist is not None:
                    self._persist.actor_create(ae)
                return
        if self._persist is not None:
            self._persist.actor_create(ae)
        self.actor_max_conc[acspec.actor_id] = acspec.max_concurrency
        self.actor_group_conc[acspec.actor_id] = dict(
            getattr(acspec, "concurrency_groups", None) or {})
        self.pending_actors.append(acspec)

    # ---------------- scheduling ----------------
    _PENDING_WARN_S = 10.0

    def _warn_if_stuck(self, key: str, what: str,
                       need: Dict[str, float]) -> None:
        """One-time stderr warning when a task/actor has been pending
        past _PENDING_WARN_S with nowhere to place it — exhausted CPU
        slots hang silently otherwise (a Gateway+controller+replica app
        on init(num_cpus=2) waits forever with zero feedback)."""
        now = time.time()
        first = self._pending_since.setdefault(key, now)
        if key in self._pending_warned \
                or now - first < self._PENDING_WARN_S:
            return
        self._pending_warned.add(key)
        self._emit("scheduler.backpressure",
                   f"{what} pending {now - first:.0f}s: requires "
                   f"{need or '{}'} with no feasible placement",
                   task_id=key if key.startswith("tsk-") else None,
                   actor_id=key if key.startswith("act-") else None)
        cap = {}
        avail = {}
        for ns in self.cluster_nodes.values():
            if not ns.alive:
                continue
            for r, v in ns.total.items():
                cap[r] = cap.get(r, 0) + v
            for r, v in ns.avail.items():
                avail[r] = avail.get(r, 0) + v
        sys.stderr.write(
            f"[ray_tpu] WARNING: {what} has been pending for "
            f"{now - first:.0f}s: requires {need or '{}'}, cluster "
            f"capacity {cap}, currently free {avail}. If demand exceeds "
            f"capacity it will wait forever — raise init(num_cpus=...) "
            f"or free resources.\n")

    def _deps_ready(self, dep_ids: List[str]) -> Optional[bool]:
        """True = all ready; False = still pending; None = a dep errored."""
        ok = True
        for oid in dep_ids:
            e = self.gcs.objects.get(oid)
            if e is None or e.state == "pending":
                ok = False
            elif e.state == "error":
                return None
        return ok

    def _alive_nodes(self) -> List[NodeState]:
        """Driver node first (locality), then remote nodes by id."""
        out = []
        drv = self.cluster_nodes.get(self.node_id)
        if drv is not None and drv.alive:
            out.append(drv)
        out.extend(sorted(
            (n for n in self.cluster_nodes.values()
             if n.alive and n.node_id != self.node_id),
            key=lambda n: n.node_id))
        return out

    def _solve_pg(self, pg: PlacementGroupState) -> Optional[List[str]]:
        """Assign each bundle a node per the strategy, against current
        availability. Returns node ids per bundle, None if not (yet)
        possible. Raises PlacementGroupError for STRICT_SPREAD that can
        never fit the alive topology (ref: gcs_placement_group_scheduler.cc
        strategy handling)."""
        nodes = self._alive_nodes()
        if not nodes:
            return None

        def fits_all_on(node: NodeState, bundles) -> bool:
            total: Dict[str, float] = {}
            for b in bundles:
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + v
            return res_mod.fits(node.avail, total)

        if pg.strategy in ("STRICT_PACK", "PACK"):
            for n in nodes:
                if fits_all_on(n, pg.bundles):
                    return [n.node_id] * len(pg.bundles)
            if pg.strategy == "STRICT_PACK":
                return None
            # PACK (non-strict): greedy first-fit across nodes
            scratch = {n.node_id: dict(n.avail) for n in nodes}
            assignment = []
            for b in pg.bundles:
                for n in nodes:
                    if res_mod.fits(scratch[n.node_id], b):
                        res_mod.acquire(scratch[n.node_id], b)
                        assignment.append(n.node_id)
                        break
                else:
                    return None
            return assignment
        if pg.strategy == "STRICT_SPREAD":
            if len(pg.bundles) > len(nodes):
                raise PlacementGroupError(
                    f"STRICT_SPREAD needs {len(pg.bundles)} distinct "
                    f"nodes; only {len(nodes)} alive")
            # greedy distinct-node matching (bundles are usually uniform)
            used: set = set()
            assignment = []
            for b in pg.bundles:
                for n in nodes:
                    if n.node_id not in used and res_mod.fits(n.avail, b):
                        used.add(n.node_id)
                        assignment.append(n.node_id)
                        break
                else:
                    return None
            return assignment
        # SPREAD (best-effort round-robin, reusing nodes when needed)
        scratch = {n.node_id: dict(n.avail) for n in nodes}
        assignment = []
        start = 0
        for b in pg.bundles:
            placed = False
            for j in range(len(nodes)):
                n = nodes[(start + j) % len(nodes)]
                if res_mod.fits(scratch[n.node_id], b):
                    res_mod.acquire(scratch[n.node_id], b)
                    assignment.append(n.node_id)
                    start = (start + j + 1) % len(nodes)
                    placed = True
                    break
            if not placed:
                return None
        return assignment

    def _pg_allowed_nodes(self, pg_id: Optional[str],
                          bundle_index: int) -> Optional[List[str]]:
        """Node ids a pg-bound task/actor may run on; None = pg not ready
        (requeue); empty list = unconstrained."""
        if pg_id is None:
            return []
        pg = self.placement_groups.get(pg_id)
        if pg is None or pg.state != "CREATED":
            return None
        if 0 <= bundle_index < len(pg.bundle_nodes):
            return [pg.bundle_nodes[bundle_index]]
        return list(dict.fromkeys(pg.bundle_nodes))

    def _schedule(self):
        # 0. pending placement groups admit as resources free up
        for pg in list(self.placement_groups.values()):
            if pg.state == "PENDING":
                try:
                    assignment = self._solve_pg(pg)
                except PlacementGroupError as e:
                    # Topology-infeasible *right now* — but nodes may
                    # still be joining (a STRICT_SPREAD created before
                    # remote agents register must not fail instantly).
                    # Only declare infeasibility after a grace window.
                    grace = knobs.get_float(
                        "RAY_TPU_PG_INFEASIBLE_GRACE_S")
                    if time.time() - pg.created_at < grace:
                        continue
                    pg.state = "INFEASIBLE"
                    self._fail_object(pg.ready_ref, e)
                    continue
                if assignment is None:
                    continue
                held = []
                for b, nid in zip(pg.bundles, assignment):
                    ids = self.cluster_nodes[nid].take_gpus(
                        b.get("GPU", 0))
                    if ids is None:
                        break
                    held.append(ids)
                if len(held) < len(pg.bundles):
                    # shares that fit the totals but no one card: wait
                    for b, nid, ids in zip(pg.bundles, assignment, held):
                        self.cluster_nodes[nid].give_gpus(
                            ids, b.get("GPU", 0))
                    continue
                for b, nid in zip(pg.bundles, assignment):
                    res_mod.acquire(self.cluster_nodes[nid].avail, b)
                pg.bundle_gpu_ids = held
                pg.bundle_nodes = assignment
                pg.state = "CREATED"
                self._seal(pg.ready_ref,
                           self.store.put_value(pg.ready_ref, True))

        # 0.5 compiled-DAG placements waiting on worker spawns
        if self._dag_acquires:
            self._process_dag_acquires()

        # 1. actor creations (dedicated worker each)
        still = collections.deque()
        while self.pending_actors:
            acspec = self.pending_actors.popleft()
            dr = self._deps_ready(acspec.dep_object_ids)
            if dr is None:
                ae = self.gcs.actors[acspec.actor_id]
                ae.state, ae.death_cause = "DEAD", "constructor arg errored"
                self._persist_actor_state(ae)
                continue
            if dr is False:
                still.append(acspec)
                continue
            allowed = self._pg_allowed_nodes(
                getattr(acspec, "placement_group_id", None),
                getattr(acspec, "bundle_index", -1))
            if allowed is None:
                still.append(acspec)
                continue
            need = {} if getattr(acspec, "placement_group_id", None) \
                else acspec.resources
            strat = getattr(acspec, "scheduling_strategy", None)
            hard = sched_mod.hard_affinity_node(strat)
            if hard is not None and not allowed:
                hn = self.cluster_nodes.get(hard)
                if hn is None or not hn.alive:
                    ae = self.gcs.actors[acspec.actor_id]
                    ae.state = "DEAD"
                    ae.death_cause = (f"NodeAffinity target node {hard!r} "
                                      "is dead or unknown")
                    self._persist_actor_state(ae)
                    continue
            tries, spread = sched_mod.strategy_plan(strat, allowed)
            node = None
            for att in tries:
                node = self._pick_node(need, att, spread=spread)
                if node is not None:
                    break
            if node is None:
                self._warn_if_stuck(
                    acspec.actor_id,
                    f"actor {acspec.class_name} ({acspec.actor_id})",
                    need)
                still.append(acspec)
                continue
            self._pending_since.pop(acspec.actor_id, None)
            res_mod.acquire(node.avail, need)
            self._actor_create_specs[acspec.actor_id] = acspec
            wid = self._spawn_worker(purpose=acspec.actor_id,
                                     node_id=node.node_id)
            w = self.workers[wid]
            w.held_resources = dict(need)
            if getattr(acspec, "placement_group_id", None) is not None:
                acspec.gpu_ids = self._pg_gpu_ids(
                    acspec.placement_group_id, acspec.bundle_index,
                    node.node_id)
            else:
                acspec.gpu_ids = self._take_gpu_ids(node, need, w)
            w.gpu_binding = tuple(acspec.gpu_ids)   # a fresh process
            w.actor_id = acspec.actor_id
        self.pending_actors = still

        # 1.5 actor restarts: same fit/pg rules as creation, but without
        # re-checking constructor deps (they were consumed at creation)
        still = collections.deque()
        while self.pending_restarts:
            aid = self.pending_restarts.popleft()
            ae = self.gcs.actors.get(aid)
            if ae is None or ae.state != "RESTARTING":
                continue
            acspec: ActorCreationSpec = ae.create_spec
            allowed = self._pg_allowed_nodes(
                getattr(acspec, "placement_group_id", None),
                getattr(acspec, "bundle_index", -1))
            if allowed is None:
                still.append(aid)
                continue
            need = {} if getattr(acspec, "placement_group_id", None) \
                else acspec.resources
            strat = getattr(acspec, "scheduling_strategy", None)
            hard = sched_mod.hard_affinity_node(strat)
            if hard is not None and not allowed:
                hn = self.cluster_nodes.get(hard)
                if hn is None or not hn.alive:
                    ae.state = "DEAD"
                    ae.death_cause = (f"NodeAffinity target node {hard!r} "
                                      "died; cannot restart pinned actor")
                    self._persist_actor_state(ae)
                    # queued method calls fail via the DEAD branch of the
                    # actor-task scheduling section below
                    continue
            tries, spread = sched_mod.strategy_plan(strat, allowed)
            node = None
            for att in tries:
                node = self._pick_node(need, att, spread=spread)
                if node is not None:
                    break
            if node is None:
                still.append(aid)
                continue
            res_mod.acquire(node.avail, need)
            self._actor_create_specs[aid] = acspec
            new_wid = self._spawn_worker(purpose=aid, node_id=node.node_id)
            nw = self.workers[new_wid]
            nw.held_resources = dict(need)
            if getattr(acspec, "placement_group_id", None) is not None:
                acspec.gpu_ids = self._pg_gpu_ids(
                    acspec.placement_group_id, acspec.bundle_index,
                    node.node_id)
            else:
                acspec.gpu_ids = self._take_gpu_ids(node, need, nw)
            nw.gpu_binding = tuple(acspec.gpu_ids)
            nw.actor_id = aid
        self.pending_restarts = still

        # 2. normal tasks
        # 2.0 two-level scheduling: the head run of same-shape
        # leaseable tasks goes to node agents in bulk; leftovers fall
        # through to per-worker placement below
        if self._node_leases_enabled:
            self._grant_node_leases()
        still = collections.deque()
        # CPU tasks may fall back onto idle GPU workers only when no GPU
        # task is waiting — otherwise a CPU backlog ahead of a GPU task
        # would repeatedly steal the one worker that can run it.
        gpu_demand = any(s.resources.get("GPU", 0) > 0
                         for s in self.pending_tasks)
        # Placement for an unconstrained task depends only on its
        # resource shape, so once one shape fails to place in this pass
        # every identical task behind it would fail the same way — skip
        # them (a 1k-task fan-out used to pay ~130 full placement
        # evaluations PER TASK across the passes of its drain).
        blocked_shapes: set = set()
        while self.pending_tasks:
            spec = self.pending_tasks.popleft()
            te = self.gcs.tasks[spec.task_id]
            if te.state == "CANCELLED":
                continue
            shape = None
            if spec.placement_group_id is None and (
                    spec.scheduling_strategy is None
                    or spec.scheduling_strategy == "DEFAULT"):
                shape = tuple(sorted(spec.resources.items()))
                if shape in blocked_shapes:
                    still.append(spec)
                    continue
            dr = self._deps_ready(spec.dep_object_ids)
            if dr is None:
                te.state = "FAILED"
                self._respawnable_specs.pop(spec.task_id, None)
                err = TaskError("upstream dependency failed", "", spec.name)
                for oid in spec.return_ids:
                    self._fail_object(oid, err)
                self._gen_settle(spec.task_id, err)
                continue
            if dr is False:
                still.append(spec)
                continue
            allowed = self._pg_allowed_nodes(spec.placement_group_id,
                                             spec.bundle_index)
            if allowed is None:
                still.append(spec)
                continue
            need = spec.resources if spec.placement_group_id is None else {}
            # a placement-group task runs on its bundle's cards, so it
            # needs a worker that may see them
            task_needs_gpu = (spec.resources.get("GPU", 0) > 0
                              or self._pg_holds_gpus(
                                  spec.placement_group_id,
                                  spec.bundle_index))
            hard = sched_mod.hard_affinity_node(spec.scheduling_strategy)
            if hard is not None and not allowed:
                hn = self.cluster_nodes.get(hard)
                if hn is None or not hn.alive:
                    te.state = "FAILED"
                    self._respawnable_specs.pop(spec.task_id, None)
                    err = TaskError(
                        f"NodeAffinity target node {hard!r} is dead or "
                        "unknown", "", spec.name)
                    for oid in spec.return_ids:
                        self._fail_object(oid, err)
                    continue
            tries, spread = sched_mod.strategy_plan(
                spec.scheduling_strategy, allowed)
            w = None
            if (not spread and hard is None
                    and spec.placement_group_id is None):
                # device-object locality: a task consuming a device-
                # resident dep runs on its holding worker when that
                # worker is free — the dep is then served from the
                # in-process table with zero D2H/serialization
                w = self._device_locality_worker(
                    spec, need, task_needs_gpu, allowed,
                    allow_gpu_fallback=not gpu_demand)
                if w is None:
                    # store-object locality (transfer-plane hint): prefer
                    # an idle worker on the node already holding the
                    # task's dep payloads — the arg fetch then becomes a
                    # local shm read instead of a peer pull. Soft: falls
                    # through to normal placement when no such worker is
                    # free (reference: locality-aware lease targeting).
                    for lnid in self._dep_locality_nodes(spec):
                        if allowed and lnid not in allowed:
                            continue
                        w = self._find_idle_worker(
                            needs_gpu=task_needs_gpu,
                            allow_gpu_fallback=not gpu_demand,
                            allowed_nodes=[lnid], need=need)
                        if w is not None:
                            break
            if w is None and spread:
                # SPREAD is node-first round-robin: assign the task a
                # target node once (sticky across scheduling passes —
                # re-rolling every pass would collapse onto whichever
                # node has warm workers) and insist on a worker THERE,
                # spawning one if allowed.
                target = getattr(spec, "_spread_target", None)
                tn = self.cluster_nodes.get(target) if target else None
                if tn is None or not tn.alive:
                    tn = self._pick_node(need, [], spread=True)
                    if tn is not None:
                        spec._spread_target = tn.node_id
                if tn is not None:
                    w = self._find_idle_worker(
                        needs_gpu=task_needs_gpu,
                        allow_gpu_fallback=not gpu_demand,
                        allowed_nodes=[tn.node_id], need=need)
                    if w is None:
                        if self._can_spawn(tn, needs_gpu=task_needs_gpu):
                            self._spawn_worker(purpose=None,
                                               gpu_capable=task_needs_gpu,
                                               node_id=tn.node_id)
                            still.append(spec)
                            continue
                        # target saturated and can't grow: best-effort
                        # spread — fall through and run anywhere rather
                        # than starve behind the pinned node
            if w is None:
                for att in tries:
                    w = self._find_idle_worker(
                        needs_gpu=task_needs_gpu,
                        allow_gpu_fallback=not gpu_demand,
                        allowed_nodes=att, need=need)
                    if w is not None:
                        break
            if w is None:
                for att in tries:
                    node = self._pick_node(need, att, spread=spread)
                    if node is not None and self._can_spawn(
                            node, needs_gpu=task_needs_gpu):
                        self._spawn_worker(purpose=None,
                                           gpu_capable=task_needs_gpu,
                                           node_id=node.node_id)
                        break
                else:
                    self._warn_if_stuck(spec.task_id,
                                        f"task {spec.name}", need)
                if shape is not None:
                    blocked_shapes.add(shape)
                still.append(spec)
                continue
            node = self.cluster_nodes[w.node_id]
            if spec.placement_group_id is not None:
                spec.gpu_ids = self._pg_gpu_ids(
                    spec.placement_group_id, spec.bundle_index, w.node_id)
            else:
                spec.gpu_ids = self._take_gpu_ids(node, need, w)
                if spec.gpu_ids is None:       # no card has the room
                    still.append(spec)
                    continue
            if not self._bind_gpu_worker(w, spec.gpu_ids):
                # this process already runs under other card ids: retire
                # it (a fresh worker takes the task next pass)
                self._return_gpu_ids(w)
                self._terminate_worker(w)
                still.append(spec)
                continue
            self._pending_since.pop(spec.task_id, None)
            # Lease fill (raylet-style, collapsed to the worker level):
            # grant this worker a bounded batch of compatible queued
            # tasks in ONE frame. The worker executes them strictly
            # FIFO against the single resource slot the lease holds;
            # results return in batched frames. Fill is capped so other
            # idle capacity still gets its share (a 2-CPU host splits a
            # fan-out across both workers, never serializes it onto
            # one), and reclaimed if the running head blocks in get().
            lease = [spec]
            if self._lease_cap > 1 and sched_mod.leaseable(spec):
                fill = self._lease_fill_count(need)
                while len(lease) < fill and self.pending_tasks:
                    cand = self.pending_tasks[0]
                    cte = self.gcs.tasks.get(cand.task_id)
                    if cte is not None and cte.state == "CANCELLED":
                        self.pending_tasks.popleft()
                        continue
                    if (not sched_mod.leaseable(cand)
                            or cand.resources != spec.resources
                            or self._deps_ready(cand.dep_object_ids)
                            is not True):
                        break   # contiguous prefix only: FIFO preserved
                    self.pending_tasks.popleft()
                    self._pending_since.pop(cand.task_id, None)
                    lease.append(cand)
            if len(lease) > 1:
                # Stamp the lease id onto every spec BEFORE the wire
                # send: the worker's exec spans carry it as a span
                # attribute, so the timeline can join a multi-task
                # grant back to the lease_grant span without any extra
                # frames (flight recorder, docs/OBSERVABILITY.md).
                lid = f"lease-{w.worker_id}-{self.lease_grants + 1}"
                for s in lease:
                    s.lease_id = lid
            try:
                if len(lease) == 1:
                    w.conn.send(("exec_task", spec))
                else:
                    w.conn.send(("exec_task_many", lease))
            except ConnectionClosed:
                # Worker socket just broke: its death event will arrive via
                # the reader thread; requeue the specs and keep scheduling.
                self._return_gpu_ids(w)
                w.state = "dying"
                still.extend(lease)
                continue
            self.dispatch_frames += 1
            self.dispatched_tasks += len(lease)
            if self._revoked_set:
                # a task reclaimed from this worker earlier may be
                # re-dispatched right back to it — its NEW result must
                # not be dropped by the stale-result guard
                for s in lease:
                    self._revoked_set.discard((w.worker_id, s.task_id))
            res_mod.acquire(node.avail, need)
            w.state = "busy"
            w.lease = collections.deque(s.task_id for s in lease)
            w.current_task = spec.task_id
            w.held_resources = dict(need)
            now = time.time()
            w.last_progress = now
            for s in lease:
                ste = self.gcs.tasks[s.task_id]
                ste.state, ste.worker_id, ste.started_at = (
                    "RUNNING", w.worker_id, now)
                if ste.submitted_at:
                    _mcat().get("ray_tpu_task_sched_latency_s").observe(
                        now - ste.submitted_at)
                self._emit("task.sched", task_id=s.task_id,
                           worker_id=w.worker_id, node_id=w.node_id,
                           name=s.name)
            if len(lease) > 1:
                self.lease_grants += 1
                self._emit("task.lease.grant",
                           f"granted worker {w.worker_id} a "
                           f"{len(lease)}-slot task lease",
                           worker_id=w.worker_id, node_id=w.node_id,
                           task_id=spec.task_id, slots=len(lease))
                if knobs.get_bool("RAY_TPU_FASTPATH_SPANS"):
                    # driver-local instant span: zero wire traffic,
                    # joined to the workers' exec spans by lease_id
                    self.trace_spans.append({
                        "trace_id": spec.trace_id,
                        "span_id": spec.lease_id,
                        "parent_span_id": spec.parent_span_id,
                        "task_id": spec.task_id,
                        "name": f"lease_grant:{len(lease)}",
                        "cat": "lease_grant",
                        "start": now, "end": now, "status": "ok",
                        "pid": os.getpid(), "worker_id": "driver",
                        "node_id": self.node_id,
                        "lease_id": spec.lease_id,
                        "slots": len(lease)})
                try:
                    _mcat().get("ray_tpu_lease_grants_total").inc()
                    _mcat().get("ray_tpu_dispatch_batch_size").observe(
                        len(lease))
                except Exception:
                    pass
        self.pending_tasks = still

        # 3. actor tasks
        for aid, q in list(self.actor_queues.items()):
            ae = self.gcs.actors.get(aid)
            if ae is None:
                continue
            if ae.state == "DEAD":
                while q:
                    spec = q.popleft()
                    err = ActorDiedError(f"actor {aid} died: {ae.death_cause}")
                    self.gcs.tasks[spec.task_id].state = "FAILED"
                    for oid in spec.return_ids:
                        self._fail_object(oid, err)
                    self._gen_settle(spec.task_id, err)
                continue
            if ae.state != "ALIVE":
                continue
            w = self._worker_for_actor(aid)
            if w is None or w.conn is None:
                continue
            maxc = self.actor_max_conc.get(aid, 1)
            group_limits = self.actor_group_conc.get(aid) or {}
            # Pipeline window: dispatch up to `pipeline` calls BEYOND
            # each lane's concurrency limit. Execution concurrency is
            # enforced in the worker (thread/group pools, async lane
            # semaphores), so the extra slots only pre-stage specs in
            # the worker's queue — one batched frame replaces a
            # dispatch round-trip per call.
            pipeline = self._actor_pipeline
            to_send: List[TaskSpec] = []

            def admit(spec, group) -> bool:
                """Validate one spec for this dispatch round. False =
                consumed without dispatch (dep-failed / cancelled)."""
                if self._deps_ready(spec.dep_object_ids) is None:
                    err = TaskError("upstream dependency failed", "",
                                    spec.name)
                    self.gcs.tasks[spec.task_id].state = "FAILED"
                    for oid in spec.return_ids:
                        self._fail_object(oid, err)
                    self._gen_settle(spec.task_id, err)
                    return False
                te = self.gcs.tasks[spec.task_id]
                if te.state == "CANCELLED":
                    return False
                self.actor_group_inflight[(aid, group)] = \
                    self.actor_group_inflight.get((aid, group), 0) + 1
                te.concurrency_group = group
                to_send.append(spec)
                return True

            if not group_limits:
                # fast path (no concurrency groups): strict-FIFO
                # popleft, O(1) per dispatch
                while q and self.actor_group_inflight.get(
                        (aid, None), 0) < maxc + pipeline:
                    dr = self._deps_ready(q[0].dep_object_ids)
                    if dr is False:
                        break
                    admit(q.popleft(), None)
            else:
                # Group-aware dispatch (reference: python/ray/actor.py
                # concurrency_groups): each named group has an
                # independent in-flight limit, so a saturated/
                # dep-blocked group is skipped while OTHER groups'
                # tasks behind it still run — a health-check method
                # never starves behind a long call. One rotation pass
                # of the deque (O(n), no remove scans); order WITHIN a
                # group stays strictly FIFO (blocked set).
                blocked: set = set()
                for _ in range(len(q)):
                    spec = q.popleft()
                    group = (spec.concurrency_group
                             if spec.concurrency_group in group_limits
                             else None)   # None = the default maxc lane
                    limit = (group_limits[group] if group else maxc) \
                        + pipeline
                    if (group in blocked
                            or self.actor_group_inflight.get(
                                (aid, group), 0) >= limit
                            or self._deps_ready(spec.dep_object_ids)
                            is False):
                        blocked.add(group)
                        q.append(spec)   # rotate to the back, order kept
                        continue
                    admit(spec, group)
            if not to_send:
                continue
            try:
                if len(to_send) == 1:
                    w.conn.send(("exec_actor_task", to_send[0]))
                else:
                    w.conn.send(("exec_actor_task_many", to_send))
            except ConnectionClosed:
                # conn died mid-dispatch: unwind the bookkeeping and put
                # the specs BACK so the actor-death path fails them with
                # ActorDiedError — dropping them here leaves their
                # return objects pending forever (observed as a flaky
                # get() timeout after actor_exit raced a method call)
                for spec in reversed(to_send):
                    te = self.gcs.tasks[spec.task_id]
                    gkey = (aid, te.concurrency_group)
                    self.actor_group_inflight[gkey] = max(
                        0, self.actor_group_inflight.get(gkey, 0) - 1)
                    q.appendleft(spec)
                continue
            self.dispatch_frames += 1
            self.dispatched_tasks += len(to_send)
            now = time.time()
            for spec in to_send:
                te = self.gcs.tasks[spec.task_id]
                te.state, te.worker_id, te.started_at = ("RUNNING",
                                                         w.worker_id,
                                                         now)
                if te.submitted_at:
                    _mcat().get("ray_tpu_task_sched_latency_s").observe(
                        now - te.submitted_at)
                self._emit("task.sched", task_id=spec.task_id,
                           worker_id=w.worker_id, node_id=w.node_id,
                           actor_id=aid, name=spec.name)
            if len(to_send) > 1:
                try:
                    _mcat().get("ray_tpu_dispatch_batch_size").observe(
                        len(to_send))
                except Exception:
                    pass

    def _pg_holds_gpus(self, pg_id: Optional[str],
                       bundle_index: int) -> bool:
        """True when the group reserved card ids for this bundle (any
        bundle for bundle_index -1)."""
        pg = self.placement_groups.get(pg_id) if pg_id else None
        if pg is None:
            return False
        if 0 <= bundle_index < len(pg.bundle_gpu_ids):
            return bool(pg.bundle_gpu_ids[bundle_index])
        return any(pg.bundle_gpu_ids)

    def _pg_gpu_ids(self, pg_id: Optional[str], bundle_index: int,
                    node_id: str) -> List[int]:
        """Chip indices a placement-group task may use: its bundle's
        reserved ids (bundle pinned), else every id the group reserved on
        the task's node. These release with the GROUP, not the task."""
        pg = self.placement_groups.get(pg_id) if pg_id else None
        if pg is None or pg.state != "CREATED":
            return []
        if 0 <= bundle_index < len(pg.bundle_gpu_ids):
            return list(pg.bundle_gpu_ids[bundle_index])
        out: List[int] = []
        for nid, ids in zip(pg.bundle_nodes, pg.bundle_gpu_ids):
            if nid == node_id:
                out.extend(ids)
        return sorted(set(out))

    def _take_gpu_ids(self, node: NodeState, need: Dict[str, float],
                      w: WorkerState) -> Optional[List[int]]:
        """Reserve specific card indices for `need`'s GPU request on the
        worker (NodeState.take_gpus: whole cards, or a share of one),
        the ids it is bound to when they have room; returned via
        _return_gpu_ids when the resources release. None when no card
        has room."""
        amount = need.get("GPU", 0)
        ids = node.take_gpus(amount, w.gpu_binding)
        if ids is not None:
            w.held_gpu_ids, w.held_gpu_amount = ids, amount
        return ids

    @staticmethod
    def _bind_gpu_worker(w: WorkerState, ids: List[int]) -> bool:
        """True when `w` may run work granted `ids`: an unbound worker
        binds to them, a bound one only takes its own ids again."""
        if w.gpu_binding is None:
            w.gpu_binding = tuple(ids)
        return w.gpu_binding == tuple(ids)

    def _return_gpu_ids(self, w: WorkerState) -> None:
        if not w.held_gpu_ids:
            return
        node = self.cluster_nodes.get(w.node_id or self.node_id)
        if node is not None and node.alive:
            node.give_gpus(w.held_gpu_ids, w.held_gpu_amount)
        w.held_gpu_ids, w.held_gpu_amount = [], 0.0

    # ---------------- worker leases ----------------
    def _lease_fill_count(self, need: Dict[str, float]) -> int:
        """How many queued tasks one lease grant may take: bounded by
        RAY_TPU_LEASE_SLOTS and by the queue's fair share of the
        cluster's parallelism for this resource shape — a 2-CPU host
        splits a fan-out across both workers instead of serializing it
        onto whichever was found first."""
        remaining = len(self.pending_tasks) + 1
        par = 0
        for n in self._alive_nodes():
            cap = None
            for r, v in need.items():
                if v <= 0:
                    continue
                c = int(n.total.get(r, 0.0) // v)
                cap = c if cap is None else min(cap, c)
            if cap is None:
                cap = int(n.total.get("CPU", 1)) or 1
            par += cap
        par = max(1, par)
        return max(1, min(self._lease_cap, -(-remaining // par)))

    def _check_lease_watchdog(self) -> None:
        """Reaper-tick backstop: a leased head that stalls WITHOUT
        parking in a driver-visible verb (a gang task spinning in a
        user-space rendezvous poll, a long compute) keeps its unstarted
        slots pinned — the blocked-head reclaim never fires because the
        driver never hears a get/wait. Past RAY_TPU_LEASE_HEAD_S of no
        completions, reclaim the followers; long tasks don't benefit
        from batching anyway, and gang peers stuck behind the head get
        to run elsewhere (pre-lease, one-task-per-dispatch gave them
        separate workers unconditionally)."""
        if self._lease_cap <= 1:
            return
        stall = knobs.get_float("RAY_TPU_LEASE_HEAD_S")
        if stall <= 0:
            return
        now = time.time()
        for w in self.workers.values():
            if (w.state == "busy" and len(w.lease) > 1
                    and not w.blocked
                    and now - w.last_progress > stall):
                self._reclaim_lease(w)

    def _revoked_add(self, wid: str, tid: str) -> None:
        self._revoked_set.add((wid, tid))
        self._revoked_q.append((wid, tid))
        while len(self._revoked_q) > 4096:
            self._revoked_set.discard(self._revoked_q.popleft())

    def _reclaim_lease(self, w: WorkerState) -> None:
        """A leased worker's running head blocked in get()/gen_next:
        slots behind it would wait on the head (or deadlock, if the
        head waits on one of them) — re-queue them for other workers
        and fence this worker with revoke_tasks. The revoke frame is
        sent BEFORE the blocking verb's reply, so on the FIFO
        connection the worker sees it before its main thread can
        resume; a result that slips through anyway (user-thread get)
        is dropped via _revoked_set."""
        if len(w.lease) <= 1:
            return
        head = w.lease.popleft()
        revoked = list(w.lease)
        w.lease = collections.deque([head])
        w.current_task = head
        for tid in revoked:
            self._revoked_add(w.worker_id, tid)
            te = self.gcs.tasks.get(tid)
            spec = self._respawnable_specs.get(tid)
            if te is not None and te.state == "RUNNING" \
                    and spec is not None:
                te.state, te.worker_id = "PENDING", None
                self.pending_tasks.append(spec)
        self.lease_revokes += 1
        self._emit("task.lease.revoke",
                   f"worker {w.worker_id} blocked in get(); "
                   f"{len(revoked)} unstarted lease slots re-queued",
                   worker_id=w.worker_id, node_id=w.node_id,
                   task_id=head, slots=len(revoked) + 1)
        try:
            _mcat().get("ray_tpu_lease_revokes_total").inc(
                tags={"reason": "worker_blocked"})
        except Exception:
            pass
        try:
            w.conn.send(("revoke_tasks", revoked))
        except (ConnectionClosed, AttributeError):
            # dying worker: the slots are already re-queued above and no
            # longer in w.lease, so the death path won't double-queue;
            # a zombie's stray results are dropped via _revoked_set
            pass

    # ---------------- node leases (two-level scheduling) ----------------
    def _grant_node_leases(self) -> None:
        """Phase-2 preamble (docs/SCHEDULING.md, two-level scheduling):
        hand the head run of same-shape leaseable tasks to node AGENTS
        in bulk — one frame per node carrying a worker set plus a task
        batch — instead of per-worker lease grants. The agent fans the
        batch across its local workers and streams completions back;
        the driver only sees the ledger shrink. Tasks the agent can't
        place spill back (nlease_spill) and re-enter this queue."""
        self._settle_node_leases()
        if not self.pending_tasks:
            return
        # agent-free cluster: don't pay the take/re-pend sweep of the
        # whole head run on every pass — there is nobody to grant to
        if not self.node_leases and not any(
                ns.conn is not None and ns.lease_capable and ns.alive
                for ns in self.cluster_nodes.values()):
            return
        head = self.pending_tasks[0]
        if not sched_mod.node_leaseable(head):
            return
        te = self.gcs.tasks.get(head.task_id)
        if te is not None and te.state == "CANCELLED":
            return
        if self._deps_ready(head.dep_object_ids) is not True:
            return
        shape = sched_mod.shape_key(head.resources)
        take: collections.deque = collections.deque()
        while self.pending_tasks:
            spec = self.pending_tasks[0]
            te = self.gcs.tasks.get(spec.task_id)
            if te is not None and te.state == "CANCELLED":
                self.pending_tasks.popleft()
                continue
            if (not sched_mod.node_leaseable(spec)
                    or sched_mod.shape_key(spec.resources) != shape
                    or self._deps_ready(spec.dep_object_ids) is not True):
                break
            take.append(self.pending_tasks.popleft())
        if not take:
            return
        try:
            now = time.time()
            # extend open same-shape leases first: a hot lease refills
            # without worker churn (the agent keeps its slots warm)
            for lease in list(self.node_leases.values()):
                if not take:
                    break
                ns = self.cluster_nodes.get(lease.node_id)
                if (lease.need_key != shape or ns is None
                        or not ns.alive or ns.conn is None):
                    continue
                # only workers that can actually make progress count
                # toward refill capacity — extending onto a lease whose
                # workers are all parked in get() would ping-pong the
                # batch through spillback forever
                active = 0
                for wid in lease.wids:
                    w = self.workers.get(wid)
                    if (w is not None and w.state != "dead"
                            and not w.blocked):
                        active += 1
                cap = (active * self._node_lease_slots
                       - len(lease.tasks))
                if cap <= 0:
                    continue
                specs = [take.popleft()
                         for _ in range(min(cap, len(take)))]
                if not self._send_node_lease(ns, lease, specs,
                                             extend=True):
                    take.extendleft(reversed(specs))
            # new grants on agent-capable remote nodes with idle workers
            for ns in self._alive_nodes():
                if not take:
                    break
                if (ns.conn is None or not ns.lease_capable
                        or self._nlease_backoff.get(ns.node_id, 0.0)
                        > now):
                    continue
                need = dict(head.resources)
                wids: List[str] = []
                for w in self.workers.values():
                    if (w.node_id != ns.node_id or w.state != "idle"
                            or w.conn is None or w.gpu_capable
                            or w.purpose is not None):
                        continue
                    if not res_mod.fits(ns.avail, need):
                        break
                    res_mod.acquire(ns.avail, need)
                    wids.append(w.worker_id)
                    if (len(wids) * self._node_lease_slots
                            >= len(take)):
                        break
                if not wids:
                    continue
                lease = self._new_node_lease(ns, need, wids,
                                             standing=False)
                n = min(len(wids) * self._node_lease_slots, len(take))
                specs = [take.popleft() for _ in range(n)]
                if not self._send_node_lease(ns, lease, specs,
                                             extend=False):
                    take.extendleft(reversed(specs))
        finally:
            # whatever didn't fit stays at the queue head for the
            # per-worker path below, order preserved
            self.pending_tasks.extendleft(reversed(take))

    def _settle_node_leases(self) -> None:
        """Close drained non-standing leases whose shape no longer
        matches the queue head — their workers return to the pool
        instead of idling reserved for a shape that's gone."""
        if not self.node_leases:
            return
        head_shape = None
        if self.pending_tasks:
            head = self.pending_tasks[0]
            if sched_mod.node_leaseable(head):
                head_shape = sched_mod.shape_key(head.resources)
        for lid, lease in list(self.node_leases.items()):
            if (not lease.standing and not lease.tasks
                    and lease.need_key != head_shape):
                self._close_node_lease(lid, notify=True)

    def _new_node_lease(self, ns: NodeState, need: Dict[str, float],
                        wids: List[str], standing: bool) -> NodeLease:
        """Record a lease and mark its workers busy-for-the-lease: each
        holds one `need` of the node's resources (acquired by the
        caller) until the lease closes or the worker dies. w.lease
        stays empty — the driver doesn't know which task runs where;
        the agent owns per-worker assignment."""
        self._nlease_counter += 1
        lid = f"nlease-{ns.node_id[-6:]}-{self._nlease_counter}"
        lease = NodeLease(lid, ns.node_id, need, wids, standing)
        self.node_leases[lid] = lease
        now = time.time()
        for wid in wids:
            w = self.workers.get(wid)
            if w is None:
                continue
            w.state = "busy"
            w.node_lease = lid
            w.current_task = None
            w.lease = collections.deque()
            w.held_resources = dict(need)
            w.last_progress = now
        return lease

    def _send_node_lease(self, ns: NodeState, lease: NodeLease,
                         specs: List[TaskSpec], extend: bool) -> bool:
        """One wire frame carrying a whole batch. False = conn died;
        the caller re-queues `specs` (a fresh lease is also torn down —
        its node is about to be declared dead)."""
        lid = lease.lease_id
        for s in specs:
            s.lease_id = lid
        try:
            if extend:
                ns.conn.send(("nlease_extend", lid, specs))
            else:
                ns.conn.send(("nlease_grant", lid, dict(lease.need),
                              list(lease.wids), specs, lease.standing))
        except ConnectionClosed:
            if not extend:
                self._close_node_lease(lid, notify=False)
            return False
        now = time.time()
        lease.last_activity = now
        for s in specs:
            lease.tasks[s.task_id] = s
            te = self.gcs.tasks[s.task_id]
            # worker_id stays None until completion: the agent decides
            # placement; death/cancel paths key off the lease ledger
            te.state, te.worker_id, te.started_at = "RUNNING", None, now
            if te.submitted_at:
                _mcat().get("ray_tpu_task_sched_latency_s").observe(
                    now - te.submitted_at)
            self._emit("task.sched", task_id=s.task_id,
                       node_id=ns.node_id, name=s.name)
            self._pending_since.pop(s.task_id, None)
        self.dispatch_frames += 1
        self.dispatched_tasks += len(specs)
        self.node_lease_tasks += len(specs)
        if extend:
            self.node_lease_extends += 1
        else:
            self.node_lease_grants += 1
            self._emit("task.lease.node_grant",
                       f"granted node lease {lid} to {ns.node_id}: "
                       f"{len(lease.wids)} workers, {len(specs)} tasks"
                       + (" (standing)" if lease.standing else ""),
                       node_id=ns.node_id, lease_id=lid,
                       slots=len(specs), workers=len(lease.wids))
            try:
                _mcat().get("ray_tpu_node_lease_grants_total").inc()
            except Exception:
                pass
        if specs:
            try:
                _mcat().get("ray_tpu_agent_dispatch_batch_size").observe(
                    len(specs))
            except Exception:
                pass
        return True

    def _close_node_lease(self, lid: str, notify: bool) -> None:
        """Release the lease's worker claims. Outstanding ledger tasks
        (if any) are the caller's problem — revoke first when they must
        re-queue."""
        lease = self.node_leases.pop(lid, None)
        if lease is None:
            return
        for wid in lease.wids:
            w = self.workers.get(wid)
            if w is None or w.state == "dead" or w.node_lease != lid:
                continue
            if w.blocked:
                # CPU already lent back while parked in a driver verb:
                # only the non-CPU remainder is still held (mirrors
                # _on_worker_dead / _on_task_done)
                res_mod.release(self._wnode_avail(w),
                                _non_cpu(w.held_resources))
            else:
                res_mod.release(self._wnode_avail(w), w.held_resources)
            w.held_resources = {}
            w.node_lease = None
            w.state, w.current_task, w.blocked = "idle", None, False
        if notify:
            ns = self.cluster_nodes.get(lease.node_id)
            if ns is not None and ns.alive and ns.conn is not None:
                try:
                    ns.conn.send(("nlease_close", lid))
                except ConnectionClosed:
                    pass

    def _revoke_node_lease(self, lid: str, reason: str,
                           fence: bool = False,
                           charge: int = 0) -> None:
        """Re-pend every outstanding ledger task WITHOUT burning a
        retry — a revoked bulk lease means zero lost tasks, exactly
        like a revoked per-worker lease (docs/FAULT_TOLERANCE.md). With
        fence=True, late results from a zombie agent are dropped via
        the (lease_id, task_id) revocation set. With charge=N, the N
        OLDEST outstanding entries (grant order — the ones that can
        have reached a worker's FIFO head and started executing)
        follow normal worker-death retry accounting instead: burn a
        retry, or FAIL when none remain. The driver can't see agent-
        local worker assignment, so this is the same conservative
        bound the per-worker path applies to its lease head."""
        lease = self.node_leases.get(lid)
        if lease is None or not lease.tasks:
            return
        n = 0
        charged = 0
        for tid, spec in list(lease.tasks.items()):
            lease.tasks.pop(tid, None)
            if fence:
                self._revoked_add(lid, tid)
            te = self.gcs.tasks.get(tid)
            if te is None or te.state != "RUNNING":
                continue
            if charged < charge:
                charged += 1
                # Streaming tasks never retry: already-consumed items
                # would replay and duplicate the stream.
                streaming = getattr(spec, "streaming", False)
                if not streaming and te.retries_left > 0:
                    te.retries_left -= 1
                    te.state, te.worker_id = "PENDING", None
                    spec.lease_id = ""
                    self.pending_tasks.append(spec)
                    self._emit("task.retry",
                               f"node lease {lid} revoked ({reason}) "
                               f"while {te.name} may have started; "
                               "resubmitting",
                               task_id=tid, node_id=lease.node_id,
                               name=te.name,
                               retries_left=te.retries_left)
                else:
                    te.state = "FAILED"
                    err = WorkerCrashedError(
                        f"node {lease.node_id} died while running "
                        f"{te.name}")
                    self._emit("task.fail", str(err), task_id=tid,
                               node_id=lease.node_id, name=te.name)
                    for oid in self._return_ids_of(tid):
                        self._fail_object(oid, err)
                    self._gen_settle(tid, err)
                continue
            te.state, te.worker_id = "PENDING", None
            spec.lease_id = ""
            self.pending_tasks.append(spec)
            n += 1
        self.lease_revokes += 1
        self._emit("task.lease.revoke",
                   f"node lease {lid} revoked ({reason}); {n} granted "
                   "tasks re-queued without burning a retry"
                   + (f", {charged} possibly-started slots charged"
                      if charged else ""),
                   node_id=lease.node_id, lease_id=lid, slots=n,
                   reason=reason)
        try:
            _mcat().get("ray_tpu_lease_revokes_total").inc(
                tags={"reason": reason})
        except Exception:
            pass

    def _check_node_lease_watchdog(self) -> None:
        """Reaper-tick backstop for the agent plane: (a) standing
        leases parked on capacity the driver now needs are reclaimed
        when driver-visible work starves; (b) a lease whose agent stops
        making progress entirely (wedged process that still heartbeats)
        is force-revoked with fencing."""
        if not self.node_leases:
            return
        now = time.time()
        spill_s = knobs.get_float("RAY_TPU_NODE_LEASE_SPILL_S")
        idle_s = knobs.get_float("RAY_TPU_NODE_LEASE_IDLE_S")
        starving = any(now - t > 1.0
                       for t in self._pending_since.values())
        for lid, lease in list(self.node_leases.items()):
            if not lease.tasks:
                # drained: reclaim when queued work can't place, or
                # when a standing lease outlives the agent's own idle
                # release by a wide margin (lost nlease_release frame)
                if starving or (lease.standing and now
                                - lease.last_activity
                                > max(10.0, 5 * idle_s)):
                    self._close_node_lease(lid, notify=True)
                continue
            if now - lease.last_activity > max(10.0, 4 * spill_s):
                self._revoke_node_lease(lid, "agent_stalled",
                                        fence=True)
                self._close_node_lease(lid, notify=True)

    def _on_nlease_done(self, lid: str, tid: str, wid: str, sealed,
                        error) -> None:
        lease = self.node_leases.get(lid)
        if (lid, tid) in self._revoked_set:
            # force-revoked lease whose agent finished the task anyway:
            # it was already re-queued — drop this result
            self._revoked_set.discard((lid, tid))
            if lease is not None:
                lease.tasks.pop(tid, None)
            return
        if lease is not None:
            # pop BEFORE the state guard: cancelled/stale tasks must
            # still drain the ledger or the lease never closes
            lease.tasks.pop(tid, None)
            lease.last_activity = time.time()
        te = self.gcs.tasks.get(tid)
        if te is None or te.state != "RUNNING":
            return
        te.worker_id = wid
        w = self.workers.get(wid)
        if w is not None:
            w.last_progress = time.time()
        # release_worker=False: the worker stays claimed by the lease
        # (the agent immediately refills it); resources release at
        # lease close or worker death
        self._on_task_done(wid, tid, sealed, error,
                           release_worker=False)

    def _on_nlease_spill(self, nid: str, lid: str, entries,
                         reason: str) -> None:
        """Agent couldn't place (or lost) granted tasks: re-queue them
        here. started=False (never began executing) re-pends free;
        started=True (its worker died mid-run) burns a retry — same
        at-least-once contract as the per-worker death path."""
        lease = self.node_leases.get(lid)
        n = 0
        for tid, started in entries:
            spec = None
            if lease is not None:
                spec = lease.tasks.pop(tid, None)
            if spec is None:
                spec = self._respawnable_specs.get(tid)
            te = self.gcs.tasks.get(tid)
            if te is None or te.state != "RUNNING" or spec is None:
                continue
            if started:
                if te.retries_left <= 0:
                    te.state = "FAILED"
                    err = WorkerCrashedError(
                        f"worker died while running {te.name} under "
                        f"node lease {lid}")
                    self._emit("task.fail", str(err), task_id=tid,
                               node_id=nid, name=te.name)
                    for oid in self._return_ids_of(tid):
                        self._fail_object(oid, err)
                    self._gen_settle(tid, err)
                    continue
                te.retries_left -= 1
            te.state, te.worker_id = "PENDING", None
            spec.lease_id = ""
            self.pending_tasks.append(spec)
            n += 1
        if lease is not None:
            lease.last_activity = time.time()
        if n:
            self.spillbacks += n
            # brief grant backoff: the node just told us it can't
            # place this shape — don't re-grant into the same wall
            self._nlease_backoff[nid] = time.time() + 1.0
            self._emit("task.spillback",
                       f"node {nid} spilled {n} tasks back "
                       f"({reason}); re-queued",
                       node_id=nid, lease_id=lid, slots=n,
                       reason=reason)
            try:
                _mcat().get("ray_tpu_spillbacks_total").inc(
                    n, tags={"reason": reason})
            except Exception:
                pass

    def _on_nlease_want(self, nid: str, need: Dict[str, float],
                        count: int) -> None:
        """Agent asks for standing capacity to place nested
        submissions locally. Granted only from workers the driver's
        own queue doesn't need — driver work always wins."""
        if not self._node_leases_enabled:
            return
        ns = self.cluster_nodes.get(nid)
        if ns is None or not ns.alive or ns.conn is None:
            return
        now = time.time()
        if any(now - t > 1.0 for t in self._pending_since.values()):
            return   # driver-visible work is starving: refuse
        need = dict(need)
        wids: List[str] = []
        for w in self.workers.values():
            if len(wids) >= max(1, int(count)):
                break
            if (w.node_id != nid or w.state != "idle"
                    or w.conn is None or w.gpu_capable
                    or w.purpose is not None):
                continue
            if not res_mod.fits(ns.avail, need):
                break
            res_mod.acquire(ns.avail, need)
            wids.append(w.worker_id)
        if not wids:
            return
        lease = self._new_node_lease(ns, need, wids, standing=True)
        self._send_node_lease(ns, lease, [], extend=False)

    def _wnode_avail(self, w: WorkerState) -> Dict[str, float]:
        """The avail dict of the worker's node (a throwaway dict if the
        node is gone — releases to dead nodes must not corrupt others)."""
        node = self.cluster_nodes.get(w.node_id or self.node_id)
        if node is None or not node.alive:
            return {}
        return node.avail

    def _pick_node(self, need: Dict[str, float], allowed: List[str],
                   spread: bool = False) -> Optional[NodeState]:
        """First alive node (driver-first) where `need` fits; `allowed`
        non-empty restricts to those node ids (placement groups /
        affinity). spread=True round-robins across the fitting nodes
        instead of driver-first."""
        candidates = [n for n in self._alive_nodes()
                      if (not allowed or n.node_id in allowed)
                      and res_mod.fits(n.avail, need)
                      and n.gpu_room(need.get("GPU", 0))]
        if not candidates:
            return None
        if spread:
            # Round-robin across fitting nodes (reference SPREAD
            # semantics): load-based choice degenerates for sub-second
            # tasks, which always observe every node idle.
            self._spread_rr += 1
            return candidates[self._spread_rr % len(candidates)]
        return candidates[0]

    def _dep_locality_nodes(self, spec) -> List[str]:
        """Nodes holding this task's dep payloads, largest byte total
        first — only deps big enough that moving them would cost more
        than an off-node placement (> inline threshold) count."""
        from .object_store import INLINE_MAX  # noqa: PLC0415
        sizes: Dict[str, int] = {}
        for oid in spec.dep_object_ids:
            e = self.gcs.objects.get(oid)
            if e is None or e.state != "ready":
                continue
            for loc in [e.loc, *e.copies]:
                if loc is None or getattr(loc, "kind", None) in (
                        "inline", "device"):
                    continue
                nid = loc.node_id or self.node_id
                sizes[nid] = sizes.get(nid, 0) + int(
                    getattr(loc, "size", 0) or 0)
        big = {n: s for n, s in sizes.items() if s > INLINE_MAX}
        return sorted(big, key=big.get, reverse=True)

    def _device_locality_worker(self, spec, need, needs_gpu: bool,
                                allowed_nodes,
                                allow_gpu_fallback: bool = True
                                ) -> "Optional[WorkerState]":
        """The idle worker holding this task's device-resident deps, if
        eligible — else None (normal placement takes over; the dep then
        materializes through the shm store on first remote read)."""
        holder = None
        for oid in spec.dep_object_ids:
            e = self.gcs.objects.get(oid)
            if (e is not None and e.state == "ready"
                    and getattr(e.loc, "kind", None) == "device"):
                holder = e.loc.name
                break
        if holder is None:
            return None
        w = self.workers.get(holder)
        if w is None or w.state != "idle" or w.conn is None:
            return None
        if allowed_nodes and w.node_id not in allowed_nodes:
            return None
        node = self.cluster_nodes.get(w.node_id)
        if node is None or not node.alive:
            return None
        if need and not (res_mod.fits(node.avail, need)
                         and node.gpu_room(need.get("GPU", 0))):
            return None
        if needs_gpu and not w.gpu_capable:
            return None
        if (not needs_gpu and w.gpu_capable
                and (not allow_gpu_fallback or w.gpu_binding != ())):
            # queued GPU demand reserves GPU-capable workers — locality
            # must not let a CPU consumer starve them, nor fix an
            # unbound one to no card (same rule as _find_idle_worker's
            # allow_gpu_fallback)
            return None
        return w

    def _find_idle_worker(self, needs_gpu: bool = False,
                          allow_gpu_fallback: bool = True,
                          allowed_nodes: Optional[List[str]] = None,
                          need: Optional[Dict[str, float]] = None
                          ) -> Optional[WorkerState]:
        # Prefer an exact capability match; a CPU task may fall back to an
        # idle TPU-capable worker (running plain Python there is harmless)
        # so capacity is never stranded — unless the caller knows TPU
        # demand is queued. A TPU task never runs on a worker without the
        # device. The worker's node must also fit `need`.
        fallback = None
        for w in self.workers.values():
            if w.state != "idle" or w.conn is None:
                continue
            if allowed_nodes and w.node_id not in allowed_nodes:
                continue
            node = self.cluster_nodes.get(w.node_id)
            if node is None or not node.alive:
                continue
            if need and not (res_mod.fits(node.avail, need)
                             and node.gpu_room(need.get("GPU", 0))):
                continue
            if w.gpu_capable == needs_gpu:
                return w
            # a CPU task falls back only onto a GPU-capable worker that
            # already runs without a card: running it elsewhere would fix
            # an unbound worker's CUDA_VISIBLE_DEVICES to none
            if (not needs_gpu and w.gpu_capable and allow_gpu_fallback
                    and w.gpu_binding == ()):
                fallback = w
        return fallback

    def _can_spawn(self, node: NodeState, needs_gpu: bool = False) -> bool:
        # max_workers (bounded by the node's CPU capacity for general
        # workers) is a per-node hard ceiling — it applies even when no
        # starting/idle worker of the needed kind exists, otherwise
        # sustained load with all workers busy would spawn one more worker
        # per scheduling pass.
        on_node = [w for w in self.workers.values()
                   if w.node_id == node.node_id]
        # Blocked workers lent their CPU back (parked in get()/gen_next)
        # — they don't count against the cap, or a consumer task holding
        # the node's only CPU slot could never get a producer spawned.
        general_alive = len([w for w in on_node
                             if w.state != "dead" and w.purpose is None
                             and not w.blocked])
        cpu_cap = int(node.total.get("CPU", 1)) or 1
        under_cap = general_alive < min(self.max_workers, cpu_cap)
        ready = sum(1 for w in on_node
                    if w.state in ("starting", "idle")
                    and w.gpu_capable == needs_gpu)
        if ready == 0:
            # Demand with no ready worker of this kind: spawn if under the
            # cap, or if the cap is consumed entirely by the other
            # capability kind and none of this kind is alive (a TPU task
            # must always be able to get at least one TPU worker).
            alive_kind = sum(1 for w in on_node
                             if w.state != "dead" and w.purpose is None
                             and w.gpu_capable == needs_gpu)
            return under_cap or alive_kind == 0
        return under_cap

    def _spawn_worker(self, purpose, gpu_capable: bool = False,
                      node_id: Optional[str] = None) -> str:
        self._wid_counter += 1
        wid = f"w{self._wid_counter:04d}"
        node_id = node_id or self.node_id
        node = self.cluster_nodes[node_id]
        acspec = self._actor_create_specs.get(purpose) if purpose else None
        if acspec is not None and acspec.resources.get("GPU", 0) > 0:
            gpu_capable = True
        self._emit("worker.start", worker_id=wid, node_id=node_id,
                   actor_id=purpose, gpu_capable=bool(gpu_capable))
        if node.conn is not None:
            # remote node: its agent spawns the worker, which connects
            # straight back to our TCP listener
            node.conn.send(("spawn_worker", wid, bool(gpu_capable),
                            self.job_id))
            self.workers[wid] = WorkerState(wid, None, purpose=purpose,
                                            gpu_capable=gpu_capable,
                                            node_id=node_id)
            return wid
        env = dict(os.environ)
        env["RAY_TPU_JOB_ID"] = self.job_id
        env["RAY_TPU_NODE_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "")
        env["RAY_TPU_LOG_DIR"] = self.log_dir
        env.setdefault("PYTHONPATH", "")
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        # Propagate the driver's full sys.path so by-reference pickles of
        # driver-side modules (test files, user scripts next to the driver)
        # resolve in workers — the single-host analogue of the reference's
        # runtime_env working_dir shipping (python/ray/runtime_env).
        driver_paths = [p for p in sys.path
                        if p and os.path.isdir(p) and p != repo_root]
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root, *driver_paths,
             *[p for p in env["PYTHONPATH"].split(os.pathsep) if p]])
        # A worker sees no card unless it may hold GPU resources; a
        # GPU-capable worker narrows CUDA_VISIBLE_DEVICES to its granted
        # ids before its first task or its actor (worker.py
        # _bind_gpu_ids).
        if not gpu_capable:
            env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker",
             self.socket_path, wid],
            env=env, cwd=os.getcwd())
        self.workers[wid] = WorkerState(wid, proc, purpose=purpose,
                                        gpu_capable=gpu_capable,
                                        node_id=node_id)
        return wid

    def _worker_for_actor(self, aid: str) -> Optional[WorkerState]:
        for w in self.workers.values():
            if w.actor_id == aid and w.state == "actor":
                return w
        return None

    # ---------------- compiled-DAG placement (docs/DAG.md) -----------
    def _process_dag_acquires(self):
        rest = []
        for acq in self._dag_acquires:
            if not self._try_place_dag(acq):
                if time.time() > acq["deadline"]:
                    acq["reply"].put({"error": (
                        "placement timed out: not enough idle workers "
                        "for the compiled-DAG stages")})
                else:
                    rest.append(acq)
        self._dag_acquires = rest

    def _dag_pick_worker(self, pref_node: str,
                         need: Dict[str, float],
                         used: set) -> Optional[WorkerState]:
        # dependency-local first, then any node; plain CPU workers
        # before idle TPU-capable ones (same fallback rule as tasks)
        best = None
        for w in self.workers.values():
            if (w.state != "idle" or w.conn is None or w.purpose
                    or w.worker_id in used or w.gpu_binding != ()):
                continue
            node = self.cluster_nodes.get(w.node_id)
            if node is None or not node.alive:
                continue
            if need and not res_mod.fits(node.avail, need):
                continue
            score = (w.node_id == pref_node, not w.gpu_capable)
            if best is None or score > best[0]:
                best = (score, w)
        return best[1] if best else None

    def _try_place_dag(self, acq: dict) -> bool:
        """True when the acquire resolved (placement committed or a
        terminal error was replied); False keeps it queued."""
        placement: Dict[Any, dict] = {}
        node_of: Dict[Any, str] = {}
        used: set = set()
        spawn_nodes: List[str] = []
        for r in acq["reqs"]:
            sid = r["sid"]
            if r["kind"] == "method":
                aid = r["actor_id"]
                ae = self.gcs.actors.get(aid)
                if ae is None or ae.state == "DEAD":
                    acq["reply"].put({"error": f"actor:{aid}:dead"})
                    return True
                w = self._worker_for_actor(aid)
                if w is None or ae.state != "ALIVE" or w.conn is None:
                    return False     # still starting: retry next pass
                placement[sid] = {"wid": w.worker_id,
                                  "node_id": w.node_id, "conn": w.conn,
                                  "pinned": False}
                node_of[sid] = w.node_id
            else:
                pref = sched_mod.compiled_stage_node(
                    r.get("deps") or (), node_of, self.node_id)
                need = {"CPU": float(r.get("num_cpus") or 1)}
                w = self._dag_pick_worker(pref, need, used)
                if w is None:
                    spawn_nodes.append(pref)
                    continue
                used.add(w.worker_id)
                placement[sid] = {"wid": w.worker_id,
                                  "node_id": w.node_id, "conn": w.conn,
                                  "pinned": True, "need": need}
                node_of[sid] = w.node_id
        if spawn_nodes:
            for nid in spawn_nodes:
                node = self.cluster_nodes.get(nid)
                if node is None or not node.alive:
                    node = self.cluster_nodes[self.node_id]
                starting = sum(
                    1 for w in self.workers.values()
                    if w.node_id == node.node_id
                    and w.state == "starting" and w.purpose is None)
                # one outstanding spawn per node per pass: registration
                # re-triggers _schedule, which retries this acquire
                if starting == 0 and self._can_spawn(node):
                    self._spawn_worker(None, node_id=node.node_id)
            return False
        # every stage has a worker: commit atomically
        for sid, p in placement.items():
            if not p["pinned"]:
                continue
            w = self.workers[p["wid"]]
            w.state = "dag"
            w.current_task = f"dag:{acq['dag_id']}"
            need = p.pop("need")
            res_mod.acquire(self._wnode_avail(w), need)
            w.held_resources = dict(need)
        acq["reply"].put({"placement": placement})
        return True

    def _dag_release(self, dag_id: str, wids: List[str], info: dict):
        for wid in wids:
            w = self.workers.get(wid)
            if w is None or w.state != "dag":
                continue
            res_mod.release(self._wnode_avail(w), w.held_resources)
            w.held_resources = {}
            w.state = "idle"
            w.current_task = None
        self._emit("dag.channel.close", dag_id=dag_id,
                   channels=int(info.get("channels", 0)))
        self._emit("dag.teardown", dag_id=dag_id,
                   reason=str(info.get("reason", "")),
                   workers=len(wids))

    # ---------------- completions ----------------
    def _on_task_done(self, wid: str, task_id: str, sealed, error,
                      release_worker: bool = True):
        te = self.gcs.tasks.get(task_id)
        w = self.workers.get(wid)
        if (wid, task_id) in self._revoked_set:
            # reclaimed lease slot that executed anyway (the revoke
            # raced a user thread in the worker): the task was already
            # re-queued elsewhere — drop this result
            self._revoked_set.discard((wid, task_id))
            return
        if te is None:
            return
        spec_returns = []
        if error is None:
            te.state = "FINISHED"
            for oid, loc in sealed:
                self._seal(oid, loc)
                spec_returns.append(oid)
            self._gen_settle(task_id)
        elif error == "cancelled":
            te.state = "CANCELLED"
            err = TaskCancelledError(f"task {task_id} cancelled")
            for oid in self._return_ids_of(task_id):
                self._fail_object(oid, err)
            self._gen_settle(task_id, err)
        else:
            te.state = "FAILED"
            for oid in self._return_ids_of(task_id):
                self._fail_object(oid, error)
            self._gen_settle(task_id, error)
        te.finished_at = time.time()
        _mcat().get("ray_tpu_tasks_finished_total").inc(
            tags={"state": te.state})
        if te.started_at:
            _mcat().get("ray_tpu_task_run_s").observe(
                te.finished_at - te.started_at)
        if te.state == "FINISHED":
            self._emit("task.finish", task_id=task_id, worker_id=wid,
                       actor_id=te.actor_id, name=te.name,
                       duration_s=round(
                           te.finished_at - te.started_at, 6)
                       if te.started_at else None)
        elif te.state == "CANCELLED":
            self._emit("task.cancel", task_id=task_id, worker_id=wid,
                       actor_id=te.actor_id, name=te.name)
        else:
            self._emit("task.fail", repr(error)[:500], task_id=task_id,
                       worker_id=wid, actor_id=te.actor_id,
                       name=te.name)
        spec = self._respawnable_specs.pop(task_id, None)
        if spec is not None and error is None and spec.actor_id is None:
            # retain for lineage reconstruction of this task's outputs
            # (byte- and count-bounded: oldest lineage drops first)
            self._retain_lineage(task_id, spec)
        if te.actor_id is not None:
            gkey = (te.actor_id, getattr(te, "concurrency_group", None))
            self.actor_group_inflight[gkey] = max(
                0, self.actor_group_inflight.get(gkey, 0) - 1)
        elif w is not None and release_worker:
            w.last_progress = time.time()
            if task_id in w.lease:
                try:
                    w.lease.remove(task_id)
                except ValueError:
                    pass
            if w.state == "busy" and w.lease:
                # more leased slots queued behind this one: the worker
                # keeps its resource slot and runs the next task
                w.current_task = w.lease[0]
                return
            if w.blocked:
                # its CPU was already lent while parked (dwait/get) and
                # the symmetric unblock never arrived: release only the
                # non-CPU remainder (mirrors _on_worker_dead)
                res_mod.release(self._wnode_avail(w),
                                _non_cpu(w.held_resources))
            else:
                res_mod.release(self._wnode_avail(w), w.held_resources)
            self._return_gpu_ids(w)
            w.held_resources = {}
            w.state, w.current_task, w.blocked = "idle", None, False
            if spec is not None and getattr(spec, "max_calls", 0) > 0:
                # worker recycling (@remote(max_calls=N)): retire the
                # process once it has run this function N times — the
                # escape hatch for leaky native libraries
                w.func_calls[spec.func_id] = \
                    w.func_calls.get(spec.func_id, 0) + 1
                if w.func_calls[spec.func_id] >= spec.max_calls:
                    self._terminate_worker(w)

    def _return_ids_of(self, task_id: str) -> List[str]:
        return [oid for oid, e in self.gcs.objects.items()
                if e.owner_task == task_id]

    def _on_actor_created(self, wid: str, actor_id: str, ok: bool, err):
        ae = self.gcs.actors.get(actor_id)
        if ae is None:
            return
        if ok:
            ae.state, ae.worker_id = "ALIVE", wid
            self._persist_actor_state(ae)
            self._emit("actor.alive", actor_id=actor_id, worker_id=wid,
                       class_name=ae.class_name)
        else:
            ae.state, ae.death_cause = "DEAD", repr(err)
            self._persist_actor_state(ae)
            self._actor_checkpoints.pop(actor_id, None)
            self._emit("actor.death",
                       f"constructor failed: {repr(err)[:400]}",
                       actor_id=actor_id, worker_id=wid,
                       class_name=ae.class_name)
            w = self.workers.get(wid)
            if w is not None:
                res_mod.release(self._wnode_avail(w), w.held_resources)
                self._return_gpu_ids(w)
                w.held_resources = {}
                self._terminate_worker(w)
            # propagate the constructor error to queued method calls
            for spec in self.actor_queues.get(actor_id, []):
                self.gcs.tasks[spec.task_id].state = "FAILED"
                for oid in spec.return_ids:
                    self._fail_object(oid, err)
                self._gen_settle(spec.task_id, err)
            self.actor_queues.pop(actor_id, None)

    def _on_worker_dead(self, wid: str):
        w = self.workers.get(wid)
        if w is None or w.state == "dead":
            return
        w.state = "dead"
        # a compiled-DAG participant died: fail that pipeline's
        # in-flight executions (typed CompiledDagError) and tear its
        # channels down; the next execute() re-compiles transparently
        for ctl in list(self.compiled_dags.values()):
            try:
                ctl.on_worker_dead(wid)
            except Exception:
                traceback.print_exc()
        # a dead worker's gauge series would otherwise report its last
        # "current state" forever (counters/histograms stay: history)
        self.cluster_metrics.drop_source({"worker_id": wid})
        # ghost waits from a dead process must not poison the wait
        # graph (its waits died with it; the CAUSES live elsewhere)
        self.cluster_waits.drop_source(wid)
        if w.node_lease is not None:
            # node-leased worker: the AGENT owns its task assignment —
            # it spills the in-flight task back (nlease_spill,
            # started=True) and redistributes the rest, so the driver
            # neither retries nor fails anything here (the lease
            # watchdog backstops a wedged agent). Just drop the claim.
            lease = self.node_leases.get(w.node_lease)
            if lease is not None:
                try:
                    lease.wids.remove(wid)
                except ValueError:
                    pass
            w.node_lease = None
        if w.blocked:
            # Blocked workers already returned their CPU when they entered
            # get() — release only the non-CPU remainder they still hold.
            res_mod.release(self._wnode_avail(w),
                            _non_cpu(w.held_resources))
        else:
            res_mod.release(self._wnode_avail(w), w.held_resources)
        self._return_gpu_ids(w)
        w.held_resources = {}
        w.blocked = False
        self._conn_by_wid.pop(wid, None)
        self._emit("worker.death", task_id=w.current_task,
                   actor_id=w.actor_id, worker_id=wid,
                   node_id=w.node_id)
        # running / leased normal tasks -> retry or fail. Only the
        # lease HEAD can have started (the worker executes its lease
        # strictly FIFO), so slots behind it re-queue without burning a
        # retry — a revoked lease must mean zero lost tasks even at
        # max_retries=0.
        leased = list(w.lease) if w.lease else (
            [w.current_task] if w.current_task else [])
        w.lease = collections.deque()
        if len(leased) > 1:
            self.lease_revokes += 1
            self._emit("task.lease.revoke",
                       f"worker {wid} died holding a {len(leased)}-slot "
                       f"lease; unstarted slots re-queue without "
                       f"burning a retry",
                       worker_id=wid, node_id=w.node_id,
                       task_id=leased[0], slots=len(leased))
            try:
                _mcat().get("ray_tpu_lease_revokes_total").inc(
                    tags={"reason": "worker_death"})
            except Exception:
                pass
        for idx, tid in enumerate(leased):
            te = self.gcs.tasks.get(tid)
            if te is None or te.state != "RUNNING":
                continue
            spec = self._respawnable_specs.get(tid)
            # Streaming tasks never retry: already-consumed items
            # would replay and duplicate the stream.
            streaming = spec is not None and getattr(spec, "streaming",
                                                     False)
            if spec is not None and not streaming and (
                    idx > 0 or te.retries_left > 0):
                if idx == 0:
                    te.retries_left -= 1
                te.state = "PENDING"
                te.worker_id = None
                self.pending_tasks.append(spec)
                self._emit("task.retry",
                           (f"worker {wid} died while running "
                            f"{te.name}; resubmitting") if idx == 0 else
                           (f"lease on dead worker {wid} revoked before "
                            f"{te.name} started; resubmitting"),
                           task_id=tid, worker_id=wid,
                           node_id=w.node_id, name=te.name,
                           retries_left=te.retries_left)
            else:
                te.state = "FAILED"
                err = WorkerCrashedError(
                    f"worker {wid} died while running {te.name}")
                self._emit("task.fail", str(err),
                           task_id=tid, worker_id=wid,
                           node_id=w.node_id, name=te.name)
                for oid in self._return_ids_of(tid):
                    self._fail_object(oid, err)
                self._gen_settle(tid, err)
        # actor hosted here -> restart or mark dead FIRST: sealed
        # objects this worker still held (device-resident returns) must
        # fail with the actor's death_cause, not a bare ObjectLostError
        # — the two paths used to race on ordering
        if w.actor_id:
            self._on_actor_worker_dead(w.actor_id, wid)
        # device-resident objects held by this worker are gone:
        # reconstruct from lineage or fail (mirrors node-death handling)
        for oid, e in list(self.gcs.objects.items()):
            if (e.state == "ready"
                    and getattr(e.loc, "kind", None) == "device"
                    and e.loc.name == wid):
                self._device_object_lost(oid, e)

    def _fail_inflight_actor_tasks(self, aid: str, cause: str) -> None:
        err = ActorDiedError(f"actor {aid} {cause}")
        for task_id, te in self.gcs.tasks.items():
            if te.actor_id == aid and te.state == "RUNNING":
                te.state = "FAILED"
                for oid in self._return_ids_of(task_id):
                    self._fail_object(oid, err)
                self._gen_settle(task_id, err)
        for key in [k for k in self.actor_group_inflight if k[0] == aid]:
            self.actor_group_inflight[key] = 0

    def _drain_actor_queue(self, aid: str, cause: str) -> None:
        err = ActorDiedError(f"actor {aid} {cause}")
        for spec in self.actor_queues.get(aid, []):
            self.gcs.tasks[spec.task_id].state = "FAILED"
            for oid in spec.return_ids:
                self._fail_object(oid, err)
            self._gen_settle(spec.task_id, err)
        self.actor_queues.pop(aid, None)

    def _on_actor_exit(self, aid: str) -> None:
        """Graceful self-exit (ray_tpu_torch.actor_exit()): DEAD before the
        socket-close event so no restart happens; any OTHER in-flight or
        queued calls fail like a death (the exiting call itself already
        completed)."""
        ae = self.gcs.actors.get(aid)
        if ae is None or ae.state == "DEAD":
            return
        ae.state = "DEAD"
        ae.death_cause = "actor_exit() called"
        self._persist_actor_state(ae)
        self._actor_checkpoints.pop(aid, None)
        self._emit("actor.death", ae.death_cause, actor_id=aid,
                   class_name=ae.class_name)
        self._fail_inflight_actor_tasks(aid, "exited via actor_exit()")
        self._drain_actor_queue(aid, "exited via actor_exit()")

    def _on_actor_ckpt(self, wid: str, aid: str, blob) -> None:
        """Latest __ray_save__ state from the actor's worker; handed to
        the replacement worker's __ray_restore__ around a restart."""
        ae = self.gcs.actors.get(aid)
        if ae is None or ae.state == "DEAD" or blob is None:
            return
        self._actor_checkpoints[aid] = blob
        if self._persist is not None:
            self._persist.actor_ckpt(aid, blob)
        self._emit("actor.checkpoint", actor_id=aid, worker_id=wid,
                   size=len(blob))

    def _on_actor_worker_dead(self, aid: str, wid: str):
        ae = self.gcs.actors.get(aid)
        if ae is None or ae.state == "DEAD":
            return
        self._fail_inflight_actor_tasks(aid, "worker died")
        if ae.num_restarts < ae.max_restarts:
            ae.num_restarts += 1
            ae.state = "RESTARTING"
            self._persist_actor_state(ae)
            self._emit("actor.restart",
                       f"worker {wid} died; restart "
                       f"{ae.num_restarts}/{ae.max_restarts}",
                       actor_id=aid, worker_id=wid,
                       class_name=ae.class_name)
            # Restart placement goes through the scheduler (phase 1.5):
            # spawning here unconditionally could land the actor on a
            # node that lacks its resources (or violate its placement
            # group) and drive that node's avail negative.
            self.pending_restarts.append(aid)
            # _on_actor_created flips state back to ALIVE on success.
        else:
            ae.state = "DEAD"
            ae.death_cause = ae.death_cause or f"worker {wid} died"
            self._persist_actor_state(ae)
            self._actor_checkpoints.pop(aid, None)
            self._emit("actor.death", ae.death_cause, actor_id=aid,
                       worker_id=wid, class_name=ae.class_name)
            self._drain_actor_queue(aid, "died")

    # ---------------- worker-side blocking verbs ----------------
    def _worker_get(self, w: Optional[WorkerState], rid, oids, timeout):
        def cb(results, ready, w=w, rid=rid, oids=oids):
            full = {}
            for oid in oids:
                full[oid] = results.get(
                    oid, ("error", ObjectLostError(f"{oid} unavailable")))
            # Cross-node payloads can't be read from the requester's
            # shm. Peer path (core/object_transfer.py): the requester's
            # node agent pulls the bytes STRAIGHT from the holder's
            # transfer server and re-hosts them in its own arena — the
            # reply then carries a local location and the driver's
            # sockets never see the payload. The location directory is
            # consulted first (a copy may already live on the
            # requester's node), and the old driver relay remains the
            # instrumented fallback. Pulls block on other nodes, so they
            # run on a helper thread — never the dispatcher.
            wnode = w.node_id if w is not None else self.node_id
            cross = [oid for oid, (kind, p) in full.items()
                     if kind == "loc" and p.kind != "inline"
                     and (p.node_id or self.node_id) != wnode]
            # candidates snapshot on the dispatcher thread (GCS tables
            # are dispatcher-owned); the helper thread only reads it
            cand = {oid: self._object_candidates(oid) for oid in cross}

            def serve_one(oid, loc, cands, w=w, rid=rid, wnode=wnode):
                """Move one cross-node payload to the requester; returns
                the reply tuple. Raises (notably ObjectLostError) on an
                unreachable holder — the caller then triggers lineage
                reconstruction and retries with the fresh location."""
                chunk_sz = knobs.get_int("RAY_TPU_FETCH_CHUNK")
                if getattr(loc, "kind", None) == "inline" or \
                        (loc.node_id or self.node_id) == wnode:
                    return ("loc", loc)  # reconstructed copy came local
                # 0. directory: a copy already on the requester's node
                # serves as a plain local read
                local = next(
                    (c for c, _a in cands
                     if (c.node_id or self.node_id) == wnode), None)
                if local is not None:
                    return ("loc", local)
                if wnode != self.node_id:
                    # 1. peer path: requester's agent pulls direct from
                    # the holder
                    newloc = self._request_node_pull(wnode, oid, cands)
                    if newloc is not None:
                        self.inbox.put(("object_copied", oid, newloc))
                        return ("loc", newloc)
                # 2. relay fallback (also the driver-node requester
                # path, where fetch_bytes itself pulls peer-direct from
                # the holder's server)
                if (loc.node_id or self.node_id) == self.node_id:
                    data = self.store.get_bytes(loc)
                else:
                    data = self.fetch_bytes(loc, oid=oid)
                    try:
                        newloc = self.store.put_packed(oid, data)
                    except Exception:
                        newloc = None
                    if newloc is not None:
                        self.inbox.put(("object_copied", oid, newloc))
                        if wnode == self.node_id:
                            return ("loc", newloc)
                if (w is not None and w.conn is not None
                        and len(data) > chunk_sz):
                    for off in range(0, len(data), chunk_sz):
                        w.conn.send(("value_chunk", rid, oid, off,
                                     len(data),
                                     data[off:off + chunk_sz]))
                    if wnode != self.node_id:
                        self._count_relay(len(data))
                    return ("value_staged", len(data))
                if wnode != self.node_id:
                    # payload leaves over the worker's control
                    # connection: driver relay
                    self._count_relay(len(data))
                return ("value", data)

            def finish(full=full, cross=cross, w=w, rid=rid, wnode=wnode,
                       cand=cand):
                # First pass: serve what's reachable; report EVERY lost
                # object up front so the dispatcher reconstructs them
                # concurrently (a serial report-and-wait would make the
                # wall clock the SUM of the reconstructions, not the
                # max).
                retry: List[str] = []
                for oid in cross:
                    _, loc = full[oid]
                    try:
                        full[oid] = serve_one(oid, loc,
                                              cand.get(oid, []))
                    except ObjectLostError:
                        # every recorded copy failed us: the dispatcher
                        # prunes the bad copies and re-executes the
                        # producer from lineage
                        self.inbox.put((
                            "object_unreachable", oid,
                            getattr(loc, "node_id", None)
                            or self.node_id,
                            getattr(loc, "seal_seq", None)))
                        retry.append(oid)
                    except BaseException as e:  # noqa: BLE001
                        full[oid] = ("error", e)
                # Second pass: wait for the re-seals (overlapping — the
                # first await covers the others' reconstruction time)
                # and serve each ONCE more.
                for oid in retry:
                    kind2, payload2 = self._await_object(
                        oid, timeout=self._reconstruct_wait)
                    if kind2 == "timeout":
                        full[oid] = ("error", ObjectLostError(
                            f"object {oid} did not reconstruct within "
                            f"{self._reconstruct_wait}s"))
                        continue
                    if kind2 != "loc":
                        full[oid] = ("error", payload2)
                        continue
                    # fresh location; rebuild ONE candidate with its
                    # holder's transfer address so the peer path (not
                    # the driver relay) still serves the reconstructed
                    # payload
                    loc = payload2
                    addr = self.transfer_addrs.get(
                        getattr(loc, "node_id", None) or self.node_id)
                    try:
                        full[oid] = serve_one(
                            oid, loc, [(loc, addr)] if addr else [])
                    except BaseException as e:  # noqa: BLE001
                        full[oid] = ("error", e)
                if w is not None and w.conn is not None:
                    try:
                        w.conn.send(("get_reply", rid, full))
                    except ConnectionClosed:
                        pass

            if cross:
                threading.Thread(target=finish, daemon=True).start()
            else:
                finish()
            if w is not None and w.blocked:
                w.blocked = False
                res_mod.acquire(self._wnode_avail(w),
                                _cpu_only(w.held_resources))
        waiter = Waiter(oids, None, cb)
        if w is not None and w.state == "busy" and not w.blocked:
            # Worker blocks in user get(): release its CPU so other tasks
            # can run (reference: raylet "blocked worker" CPU release,
            # src/ray/raylet/node_manager.cc HandleTaskBlocked). TPU chips
            # stay held — the blocked process still owns the device and
            # its HBM; lending the chip out would double-book it.
            w.blocked = True
            res_mod.release(self._wnode_avail(w),
                            _cpu_only(w.held_resources))
        self._add_waiter(waiter, timeout=timeout)
        if w is not None and w.blocked and not waiter.done \
                and len(w.lease) > 1:
            # The get actually PARKED (args-already-ready gets — every
            # leased task resolving its arg refs — fire synchronously
            # above and never reach here): leased slots behind the
            # blocked head would wait on it, or deadlock if the head
            # waits on one of THEM via a nested ref — pull them back
            # for other workers. Still ordered before the eventual
            # get_reply, so the worker is fenced first.
            self._reclaim_lease(w)

    def _worker_wait(self, w, rid, oids, num_returns, timeout):
        def cb(results, ready, w=w, rid=rid):
            if w is not None and w.conn is not None:
                try:
                    w.conn.send(("get_reply", rid, ready))
                except ConnectionClosed:
                    pass
        waiter = Waiter(oids, num_returns, cb, needs_bytes=False)
        self._add_waiter(waiter, timeout=timeout)
        if not waiter.done and w is not None and w.state == "busy" \
                and len(w.lease) > 1:
            # a lease head parked in wait() pins its unstarted slots
            # exactly like a parked get() — and can deadlock the same
            # way if it waits on one of them via a nested ref
            self._reclaim_lease(w)

    # ---------------- control ----------------
    def _cancel(self, task_id: str, force: bool):
        te = self.gcs.tasks.get(task_id)
        if te is None or te.state in ("FINISHED", "FAILED", "CANCELLED"):
            return
        if te.state in ("PENDING", "SCHEDULED"):
            te.state = "CANCELLED"
            self._respawnable_specs.pop(task_id, None)
            self._emit("task.cancel", "cancelled before dispatch",
                       task_id=task_id, name=te.name)
            err = TaskCancelledError(f"task {task_id} cancelled")
            for oid in self._return_ids_of(task_id):
                self._fail_object(oid, err)
            self._gen_settle(task_id, err)
        elif te.state == "RUNNING" and te.worker_id is None and any(
                task_id in nl.tasks for nl in self.node_leases.values()):
            # node-leased and not yet (knowably) started: the driver
            # doesn't know which worker — if any — holds it. Mark it
            # terminal and settle its objects now; _on_nlease_done
            # drains the agent's eventual result via the ledger pop +
            # state guard, so nothing double-settles.
            te.state = "CANCELLED"
            self._respawnable_specs.pop(task_id, None)
            self._emit("task.cancel", "cancelled while node-leased",
                       task_id=task_id, name=te.name)
            err = TaskCancelledError(f"task {task_id} cancelled")
            for oid in self._return_ids_of(task_id):
                self._fail_object(oid, err)
            self._gen_settle(task_id, err)
        elif te.state == "RUNNING":
            w = self.workers.get(te.worker_id or "")
            if w and w.conn:
                try:
                    w.conn.send(("cancel", task_id))
                except ConnectionClosed:
                    pass
            if force and w is not None and te.actor_id is None:
                # Mark terminal first so the death handler neither retries
                # nor double-fails this task.
                te.state = "CANCELLED"
                self._respawnable_specs.pop(task_id, None)
                err = TaskCancelledError(f"task {task_id} cancelled (force)")
                for oid in self._return_ids_of(task_id):
                    self._fail_object(oid, err)
                self._gen_settle(task_id, err)
                w.current_task = None
                self._terminate_worker(w)

    def _kill_actor(self, actor_id: str, no_restart: bool):
        ae = self.gcs.actors.get(actor_id)
        if ae is None or ae.state == "DEAD":
            return
        if no_restart:
            ae.max_restarts = ae.num_restarts  # block further restarts
            ae.death_cause = "killed via ray_tpu_torch.kill"
        w = self._worker_for_actor(actor_id)
        if w is not None:
            # The death handler (run inline by _terminate_worker) fails
            # in-flight tasks and either restarts the actor or marks it DEAD,
            # honoring the remaining restart budget.
            self._terminate_worker(w)
        else:
            ae.state = "DEAD"
            ae.death_cause = ae.death_cause or "killed before start"
            self._persist_actor_state(ae)
            self._emit("actor.death", ae.death_cause,
                       actor_id=actor_id, class_name=ae.class_name)
            for spec in self.actor_queues.pop(actor_id, []):
                self.gcs.tasks[spec.task_id].state = "FAILED"
                err = ActorDiedError(f"actor {actor_id} was killed")
                for oid in spec.return_ids:
                    self._fail_object(oid, err)

    def _terminate_worker(self, w: WorkerState):
        """Forcefully stop a worker process and run its death cleanup inline.

        The reader thread will also post a worker_dead event when the socket
        drops; _on_worker_dead dedupes on state == "dead"."""
        try:
            if w.conn:
                w.conn.close()
        except Exception:
            pass
        try:
            w.proc.terminate()
        except Exception:
            pass
        self._on_worker_dead(w.worker_id)

    def _free(self, oids: List[str]):
        for oid in oids:
            e = self.gcs.objects.pop(oid, None)
            if e is None or e.loc is None:
                continue
            if self._persist is not None:
                self._persist.object_free(oid)
            self._emit("object.free", object_id=oid,
                       task_id=e.owner_task)
            for loc in [e.loc, *e.copies]:
                if loc.kind == "device":
                    holder = self.workers.get(loc.name)
                    if holder is not None and holder.conn is not None:
                        try:
                            holder.conn.send(("drop_device", oid))
                        except ConnectionClosed:
                            pass
                    continue
                holder = loc.node_id or self.node_id
                if holder == self.node_id:
                    if loc.kind in ("shm", "native"):
                        self.store.delete_segment(loc.name, loc.size)
                else:
                    ns = self.cluster_nodes.get(holder)
                    if ns is not None and ns.alive and ns.conn is not None:
                        try:
                            ns.conn.send(("free_object", loc))
                        except ConnectionClosed:
                            pass
                self._spill.on_free(loc, oid)

    def _create_pg(self, pg: PlacementGroupState):
        # Registration only; admission happens in _schedule phase 0.
        self.placement_groups[pg.pg_id] = pg

    def _remove_pg(self, pg_id: str):
        pg = self.placement_groups.pop(pg_id, None)
        if pg is not None and pg.state == "CREATED":
            for i, (b, nid) in enumerate(zip(pg.bundles, pg.bundle_nodes)):
                node = self.cluster_nodes.get(nid)
                if node is not None and node.alive:
                    res_mod.release(node.avail, b)
                    ids = (pg.bundle_gpu_ids[i]
                           if i < len(pg.bundle_gpu_ids) else [])
                    node.give_gpus(ids, b.get("GPU", 0))

    # ================= public API (called from any thread) =================
    def submit(self, spec: TaskSpec) -> List[ObjectRef]:
        """Register one task. Submits coalesce into api_submit_many
        batches under a size (RAY_TPU_BATCH_FLUSH_N) + time
        (RAY_TPU_BATCH_FLUSH_S) flush window, so a `[f.remote() for ...]`
        fan-out costs the dispatcher one inbox frame per batch — and one
        scheduling pass per batch — instead of one per call. Verbs whose
        semantics depend on a prior submit having landed (get/cancel/
        gen_next/...) flush first; otherwise the pending-object
        machinery tolerates the ≤1ms reorder."""
        self._respawnable_specs[spec.task_id] = spec
        if not self._batch_enabled:
            self.inbox.put(("api_submit", spec))
            return [ObjectRef(oid) for oid in spec.return_ids]
        with self._submit_buf_lock:
            self._submit_buf.append(spec)
            n = len(self._submit_buf)
        if n >= self._flush_n:
            self._flush_submits()
        else:
            self._submit_buf_event.set()
        return [ObjectRef(oid) for oid in spec.return_ids]

    def _flush_submits(self) -> None:
        with self._submit_buf_lock:
            if not self._submit_buf:
                return
            buf, self._submit_buf = self._submit_buf, []
        self.inbox.put(("api_submit_many", buf))
        self.submit_batches += 1
        self.batched_submits += len(buf)
        try:
            _mcat().get("ray_tpu_submit_batch_size").observe(len(buf))
        except Exception:
            pass

    def _submit_flush_loop(self) -> None:
        """Time bound of the flush window: a solo .remote() with no
        follow-up verb still lands within ~RAY_TPU_BATCH_FLUSH_S."""
        while not self._shutdown.is_set():
            if not self._submit_buf_event.wait(timeout=0.5):
                continue
            self._submit_buf_event.clear()
            if self._flush_window > 0:
                time.sleep(self._flush_window)
            self._flush_submits()

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        return self.submit(spec)

    def submit_many(self, specs: List[TaskSpec]) -> List[List[ObjectRef]]:
        """Submit a batch of (task or actor-method) specs in ONE
        dispatcher round-trip — compiled DAG levels come through here
        (SURVEY C16: batched submissions; vs one inbox message per
        .remote() call)."""
        self._flush_submits()   # keep inter-batch submission order
        specs = list(specs)
        for spec in specs:
            self._respawnable_specs[spec.task_id] = spec
        self.inbox.put(("api_submit_many", specs))
        self.submit_many_calls += 1
        return [[ObjectRef(oid) for oid in s.return_ids] for s in specs]

    def gen_next(self, task_id: str,
                 timeout: Optional[float] = None) -> Optional[ObjectRef]:
        """Next item ref of a streaming-generator task; None when the
        stream is exhausted; raises the task's error if it failed."""
        ev = threading.Event()
        box: Dict[str, Any] = {}
        abandoned = [False]

        def cb(result):
            box["r"] = result
            ev.set()

        self._flush_submits()   # the stream's submit may still be buffered
        self.inbox.put(("api_gen_next", task_id, cb, abandoned))
        if not ev.wait(timeout):
            abandoned[0] = True
            raise GetTimeoutError(
                f"generator next() timed out after {timeout}s")
        kind, payload = box["r"]
        if kind == "item":
            return ObjectRef(payload)
        if kind == "error":
            if isinstance(payload, BaseException):
                raise payload
            raise TaskError(str(payload))
        return None

    def create_actor(self, acspec: ActorCreationSpec) -> None:
        self.inbox.put(("api_submit_actor", acspec))

    def put(self, value: Any) -> ObjectRef:
        from .spilling import put_value_or_spill  # noqa: PLC0415
        oid = new_object_id()
        loc = put_value_or_spill(self.store, oid, value)
        # Register for spilling NOW (not at dispatch): a burst of puts
        # must not evict an object the dispatcher hasn't sealed yet.
        self._spill.on_seal(oid, loc)
        self.inbox.put(("api_seal", oid, loc))
        return ObjectRef(oid)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        oids = [r.id for r in refs]
        ev = threading.Event()
        box: Dict[str, Any] = {}

        def cb(results, ready):
            box.update(results)
            ev.set()

        self._flush_submits()   # no flush-window latency on submit->get
        waiter = Waiter(oids, None, cb)
        self.inbox.put(("api_waiter", waiter))
        wtok = _waits().park("object", oids[0] if oids else "",
                             waiter="driver", n=len(oids))
        try:
            settled = ev.wait(timeout)
        finally:
            _waits().unpark(wtok)
        if not settled:
            waiter.done = True
            raise GetTimeoutError(
                f"get() timed out after {timeout}s on {len(oids)} objects")
        out = []
        for oid in oids:
            kind, payload = box.get(oid, ("error",
                                          ObjectLostError(f"{oid} missing")))
            if kind == "error":
                if isinstance(payload, BaseException):
                    raise payload
                raise TaskError(str(payload))
            try:
                out.append(self._load_location(payload))
            except ObjectLostError:
                # the holder died between the waiter firing and the
                # read: report the unreachable copy (the dispatcher
                # prunes it and re-executes the producer from lineage
                # when no live copy remains), then one fresh round-trip
                # picks up the reconstructed/re-hosted copy — mirrors
                # the worker-side _get_one_fresh retry
                self.inbox.put(("object_unreachable", oid,
                                getattr(payload, "node_id", None)
                                or self.node_id,
                                getattr(payload, "seal_seq", None)))
                out.append(self._reload_one(oid, timeout))
        return out

    def _reload_one(self, oid: str, timeout: Optional[float]) -> Any:
        """Single-object re-resolve after a stale-location read failed;
        lineage reconstruction resets the entry to pending, so a fresh
        waiter round-trip (_await_object) blocks until the re-run
        reseals it."""
        kind, payload = self._await_object(oid, timeout=timeout)
        if kind == "timeout":
            raise GetTimeoutError(
                f"get() timed out re-resolving lost object {oid}")
        if kind == "error":
            if isinstance(payload, BaseException):
                raise payload
            raise TaskError(str(payload))
        return self._load_location(payload)

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        ev = threading.Event()
        box: Dict[str, Any] = {"ready": []}

        def cb(results, ready):
            box["ready"] = ready
            ev.set()

        self._flush_submits()
        waiter = Waiter([r.id for r in refs], num_returns, cb,
                        needs_bytes=False)
        self.inbox.put(("api_waiter", waiter))
        # emulate timeout by a timer event so the dispatcher fires partial
        if timeout is not None:
            t = threading.Timer(timeout, lambda: self.inbox.put(
                ("waiter_timeout", waiter.waiter_id)))
            t.daemon = True
            t.start()
        wtok = _waits().park("object", refs[0].id if refs else "",
                             waiter="driver", op="wait", n=len(refs))
        try:
            ev.wait(None if timeout is None else timeout + 1.0)
        finally:
            _waits().unpark(wtok)
        ready_ids = set(box["ready"])
        ready = [r for r in refs if r.id in ready_ids]
        not_ready = [r for r in refs if r.id not in ready_ids]
        return ready, not_ready

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self._flush_submits()   # queued calls must land before the kill
        self.inbox.put(("api_kill_actor", actor_id, no_restart))

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        # cancel resolves object -> producing task in the dispatcher:
        # the submit that created the object must be in the inbox first
        self._flush_submits()
        self.inbox.put(("api_cancel_obj", ref.id, force))

    def cancel_task(self, task_id: str, force: bool = False) -> None:
        """Cancel by task id (streaming-generator handles)."""
        self._flush_submits()
        self.inbox.put(("api_cancel", task_id, force))

    def free(self, refs: List[ObjectRef]) -> None:
        self._flush_submits()
        self.inbox.put(("api_free", [r.id for r in refs]))

    def report(self, channel: str, payload: Any) -> None:
        h = self.report_handlers.get(channel)
        if h:
            h("driver", payload)

    def register_report_handler(self, channel: str, fn: Callable) -> None:
        self.report_handlers[channel] = fn

    def _kv_op(self, op: str, *args):
        """Internal KV (ray_tpu_torch.experimental.internal_kv). Locked: driver
        API threads call this directly while the dispatcher serves worker
        sys.kv requests, and iteration (list/del-by-prefix) plus put's
        check-then-set are not atomic under the GIL."""
        with self._kv_lock:
            kv = self.gcs.kv
            if op == "put":
                key, value, overwrite = args
                existed = key in kv
                if overwrite or not existed:
                    kv[key] = value
                    if self._persist is not None:
                        # WAL via the dispatcher: an API-thread append
                        # racing a snapshot rotation could land in the
                        # WAL generation being deleted and vanish
                        # raylint: disable=RT001 self.inbox is an
                        # unbounded queue.Queue; put never blocks
                        self.inbox.put(
                            ("wal", ("kvput", key, value)))
                return existed
            if op == "get":
                return kv.get(args[0])
            if op == "exists":
                return args[0] in kv
            if op == "del":
                key, by_prefix = args
                if self._persist is not None:
                    # raylint: disable=RT001 self.inbox is an
                    # unbounded queue.Queue; put never blocks
                    self.inbox.put(
                        ("wal", ("kvdel", key, by_prefix)))
                if by_prefix:
                    doomed = [k for k in kv if k.startswith(key)]
                    for k in doomed:
                        del kv[k]
                    return len(doomed)
                return 1 if kv.pop(key, None) is not None else 0
            if op == "list":
                # args[0] is the namespaced prefix "ns\x00p"; return the
                # un-namespaced key names, reference-style (bytes)
                return [k.split("\x00", 1)[1].encode() for k in kv
                        if k.startswith(args[0])]
            raise ValueError(f"unknown kv op {op!r}")

    def _on_worker_metrics(self, wid: str, payload) -> None:
        w = self.workers.get(wid)
        node = (w.node_id if w is not None and w.node_id else None) \
            or self.node_id
        self.cluster_metrics.ingest(
            {"node_id": node, "worker_id": wid}, payload)

    def drain_fastpath_spans(self) -> None:
        """Flush deferred driver-side span rings (compiled-DAG submit
        and result markers) into trace_spans. Runs when worker spans
        are ingested and when the timeline is exported, so readers see
        the complete parented tree without the execute() hot path ever
        paying dict-build or id-derivation costs."""
        for fn in list(self._span_drains):
            try:
                fn()
            except Exception:
                pass

    def _on_worker_spans(self, wid: str, payload) -> None:
        self.drain_fastpath_spans()
        w = self.workers.get(wid)
        node = (w.node_id if w is not None and w.node_id else None) \
            or self.node_id
        for sp in payload or ():
            sp = dict(sp)
            if not sp.get("worker_id"):
                sp["worker_id"] = wid
            if not sp.get("node_id"):
                sp["node_id"] = node
            self.trace_spans.append(sp)

    def _on_worker_profile(self, wid: str, payload) -> None:
        self.profile_store.ingest(wid, payload)

    def _on_worker_waits(self, wid: str, payload) -> None:
        w = self.workers.get(wid)
        node = (w.node_id if w is not None and w.node_id else None) \
            or self.node_id
        self.cluster_waits.ingest(
            wid, {"node_id": node, "worker_id": wid}, payload)

    def profile_ctl(self, worker_id: str, action: str,
                    arg: Any = None, timeout: float = 5.0) -> dict:
        """Drive one worker's sampling profiler over the control plane:
        action in {"start", "stop", "snapshot", "status"} (arg = hz for
        start). Blocks for the worker's reply (sub-ms handler on its
        reader thread) and returns the reply payload."""
        conn = self._conn_by_wid.get(worker_id)
        w = self.workers.get(worker_id)
        if conn is None or w is None or w.state == "dead":
            raise ValueError(f"no live worker {worker_id!r}")
        ev = threading.Event()
        box: dict = {}
        with self._profile_lock:
            self._profile_counter += 1
            rid = self._profile_counter
            self._profile_replies[rid] = (ev, box)
        try:
            conn.send(("profile_ctl", rid, action, arg))
            if not ev.wait(timeout):
                raise TimeoutError(
                    f"profile_ctl({action}) to {worker_id} timed out "
                    f"after {timeout}s")
        finally:
            with self._profile_lock:
                self._profile_replies.pop(rid, None)
        return box.get("payload", {})

    # ---------------- event plane ----------------
    def _emit(self, event_type: str, message: str = "", **fields) -> None:
        """Driver-side lifecycle event into the process-local buffer
        (drained into cluster_events on the tick / on query). Never
        raises — a telemetry failure must not break scheduling."""
        try:
            _ev().emit(event_type, message, **fields)
        except Exception:
            pass

    def _on_worker_events(self, wid: str, payload) -> None:
        w = self.workers.get(wid)
        node = (w.node_id if w is not None and w.node_id else None) \
            or self.node_id
        self.cluster_events.ingest(
            {"node_id": node, "worker_id": wid}, payload or ())

    def drain_local_events(self) -> None:
        """Move this process's buffered events into the cluster store.
        Called from the dispatcher tick and lazily by queries (so a
        just-emitted driver-side event is visible immediately)."""
        batch = _ev().drain()
        if batch:
            self.cluster_events.ingest(
                {"node_id": self.node_id, "worker_id": "driver"}, batch)

    def _check_node_heartbeats(self) -> None:
        """Flag remote nodes whose agent stopped pinging: the
        node.heartbeat_miss event precedes the socket-level death
        determination (reference: gcs health-check manager)."""
        if self._node_hb_timeout <= 0:
            return
        now = time.time()
        for ns in list(self.cluster_nodes.values()):
            if ns.conn is None or not ns.alive:
                continue
            stale = now - ns.last_heartbeat
            if not ns.heartbeat_missed and stale > self._node_hb_timeout:
                ns.heartbeat_missed = True
                self._emit(
                    "node.heartbeat_miss",
                    f"no heartbeat from node {ns.node_id} for "
                    f"{stale:.1f}s",
                    node_id=ns.node_id)
            if 0 < self._node_death_timeout < stale:
                # heartbeat-DECLARED death: don't wait for the socket to
                # close — prune the node's object copies and start
                # lineage reconstruction now. Closing the conn fences a
                # stalled-but-alive agent and prompts it to rejoin under
                # a new incarnation.
                conn = ns.conn
                self._on_node_dead(ns.node_id)
                try:
                    conn.close()
                except Exception:
                    pass

    def _update_builtin_gauges(self) -> None:
        """Periodic (reaper-tick) refresh of the driver-side pool/store
        gauges; failures must never take down the dispatcher."""
        try:
            by_state: Dict[str, int] = {}
            for w in self.workers.values():
                by_state[w.state] = by_state.get(w.state, 0) + 1
            g = _mcat().get("ray_tpu_workers")
            for state in ("starting", "idle", "busy", "actor", "dead"):
                g.set(float(by_state.get(state, 0)),
                      tags={"state": state})
            _mcat().get("ray_tpu_pending_tasks").set(
                float(len(self.pending_tasks)))
            _mcat().get("ray_tpu_object_store_used_bytes").set(
                float(self.store.used_bytes()))
            cap = getattr(self.store, "capacity", None)
            if cap:
                _mcat().get("ray_tpu_object_store_capacity_bytes").set(
                    float(cap))
            nobj = getattr(self.store, "num_objects", None)
            if callable(nobj):
                _mcat().get("ray_tpu_object_store_objects").set(
                    float(nobj()))
            if self._persist is not None:
                _mcat().get("ray_tpu_driver_incarnation").set(
                    float(self.incarnation))
                _mcat().get("ray_tpu_wal_records").set(
                    float(self._persist.records_appended))
                _mcat().get("ray_tpu_wal_bytes").set(
                    float(self._persist.wal_bytes))
        except Exception:
            pass

    def _sys_lookup_actor(self, _wid, payload) -> Optional[tuple]:
        """Built-in report_sync channel backing get_actor() from workers."""
        ns, name = payload
        if ns is None:
            ns = self.namespace
        aid = self.gcs.lookup_named_actor(ns, name)
        if aid is None:
            return None
        ae = self.gcs.actors[aid]
        return (aid, ae.class_name,
                getattr(ae.create_spec, "method_opts", {}) or {})

    def _sys_actor_addr(self, _wid, actor_id):
        """GCS actor directory (report_sync): the callee's direct-call
        address for driver-bypass actor calls. One lookup per
        (caller, actor) pair steady-state. None = never reachable
        direct (dead, or its worker runs no direct server — the caller
        backs off for a while); "pending" = constructing/restarting
        (the caller retries almost immediately, so the first calls of a
        fresh actor don't condemn a whole burst to the driver path)."""
        ae = self.gcs.actors.get(actor_id)
        if ae is None or ae.state == "DEAD":
            return None
        if ae.state != "ALIVE" or not ae.worker_id:
            return "pending"
        w = self.workers.get(ae.worker_id)
        if w is None or w.state == "dead":
            return "pending"   # death determination/restart in flight
        if not w.direct_addr:
            return None        # worker has no direct-call listener
        return (ae.worker_id, w.direct_addr, ae.num_restarts)

    def dispatch_stats(self) -> Dict[str, Any]:
        """Dispatch-plane counters for the state API / CLI / bench:
        submit batching, lease lifecycle, frame and logical-message
        counts (messages-per-task is the control-plane amplification
        the batching exists to kill)."""
        from .protocol import wire_enabled  # noqa: PLC0415
        return {
            "batching_enabled": self._batch_enabled,
            "binary_wire_enabled": wire_enabled(),
            "flush_max_tasks": self._flush_n,
            "flush_window_s": self._flush_window,
            "lease_slots": self._lease_cap,
            "actor_pipeline": self._actor_pipeline,
            "submit_many_calls": self.submit_many_calls,
            "submit_batches": self.submit_batches,
            "batched_submits": self.batched_submits,
            "avg_submit_batch": round(
                self.batched_submits / self.submit_batches, 2)
            if self.submit_batches else None,
            "lease_grants": self.lease_grants,
            "lease_revokes": self.lease_revokes,
            "node_leases_enabled": self._node_leases_enabled,
            "node_lease_slots": self._node_lease_slots,
            "node_lease_grants": self.node_lease_grants,
            "node_lease_extends": self.node_lease_extends,
            "node_lease_tasks": self.node_lease_tasks,
            "node_leases_open": len(self.node_leases),
            "spillbacks": self.spillbacks,
            "dispatch_frames": self.dispatch_frames,
            "dispatched_tasks": self.dispatched_tasks,
            "ctrl_frames_in": self.ctrl_frames,
            "ctrl_msgs_in": dict(self.ctrl_msgs),
        }

    def _sys_cluster_view(self, _wid, _payload) -> List[Dict]:
        """report_sync channel: live node capacity views for worker-side
        schedulers (the serve autoscaler's bin-pack feasibility)."""
        views = []
        for ns in list(self.cluster_nodes.values()):
            if not ns.alive:
                continue
            views.append({"id": ns.node_id, "total": dict(ns.total),
                          "avail": dict(ns.avail),
                          "labels": dict(getattr(ns, "labels", {}) or {}),
                          "is_driver": ns.node_id == self.node_id})
        return views

    def _sys_pg(self, _wid, payload):
        """report_sync channel: placement-group create/remove/table from
        worker processes (actors only get `.pg_id` back — bundle node
        resolution happens at scheduling time like every other pg)."""
        op = payload[0]
        if op == "create":
            _, bundles, strategy, name = payload
            pg = self.placement_group(bundles, strategy, name)
            return {"pg_id": pg.pg_id}
        if op == "remove":
            self.remove_placement_group(payload[1])
            return True
        if op == "table":
            return {pg.pg_id: {"name": pg.name, "strategy": pg.strategy,
                               "state": pg.state,
                               "bundles": list(pg.bundles)}
                    for pg in list(self.placement_groups.values())}
        raise ValueError(f"unknown sys.pg op {op!r}")

    def placement_group(self, bundles, strategy="PACK", name="") -> "PlacementGroupState":
        from .ids import new_placement_group_id  # noqa: PLC0415
        pg = PlacementGroupState(new_placement_group_id(), bundles, strategy,
                                 name)
        pg.ready_ref = new_object_id()
        self.gcs.add_pending_object(pg.ready_ref)
        self.inbox.put(("api_create_pg", pg))
        return pg

    def remove_placement_group(self, pg_id: str) -> None:
        self.inbox.put(("api_remove_pg", pg_id))

    # ---------------- compiled DAGs (docs/DAG.md) ----------------
    def dag_acquire(self, dag_id: str, reqs: List[dict],
                    timeout: float) -> Dict[Any, dict]:
        """Pin one worker per compiled-DAG stage (dependency-local).
        Blocks the calling API thread; placement itself happens on the
        dispatcher. Raises CompiledDagError when placement fails."""
        reply: "queue.Queue" = queue.Queue()
        self.inbox.put(("api_dag_acquire", {
            "dag_id": dag_id, "reqs": reqs, "reply": reply,
            "deadline": time.time() + timeout}))
        try:
            res = reply.get(timeout=timeout + 5.0)
        except queue.Empty:
            raise CompiledDagError("compiled-DAG placement timed out",
                                   cause="dispatcher unresponsive") \
                from None
        if "error" in res:
            raise CompiledDagError("compiled-DAG placement failed",
                                   cause=res["error"])
        return res["placement"]

    def dag_release(self, dag_id: str, wids: List[str],
                    channels: int = 0, reason: str = "") -> None:
        self.inbox.put(("api_dag_release", dag_id, list(wids),
                        {"channels": channels, "reason": reason}))

    def get_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self.cluster_nodes.values():
            if n.alive:
                for k, v in n.total.items():
                    total[k] = total.get(k, 0.0) + v
        return total

    def available_resources(self) -> Dict[str, float]:
        avail: Dict[str, float] = {}
        for n in self.cluster_nodes.values():
            if n.alive:
                for k, v in n.avail.items():
                    avail[k] = avail.get(k, 0.0) + v
        return avail

    def actor_state(self, actor_id: str) -> Optional[str]:
        ae = self.gcs.actors.get(actor_id)
        return ae.state if ae else None

    def wait_actor_alive(self, actor_id: str, timeout: float = 60.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            ae = self.gcs.actors.get(actor_id)
            if ae is not None and ae.state == "ALIVE":
                return
            if ae is not None and ae.state == "DEAD":
                raise ActorDiedError(
                    f"actor failed to start: {ae.death_cause}")
            time.sleep(0.005)
        raise GetTimeoutError(f"actor {actor_id} not alive in {timeout}s")

    # ---------------- shutdown ----------------
    def shutdown(self) -> None:
        if self._shutdown.is_set():
            return
        self._flush_submits()
        for ctl in list(self.compiled_dags.values()):
            try:
                ctl.close()
            except Exception:
                pass
        self._shutdown.set()
        self._submit_buf_event.set()   # unblock the flush loop
        if self._persist is not None:
            # final snapshot BEFORE teardown: it must capture the live
            # cluster (ALIVE actors, sealed objects), not the storm of
            # worker/actor deaths the shutdown itself is about to
            # cause — and it must run ON the dispatcher thread, where
            # the tables are consistent. close() then stops further
            # WAL appends, so those teardown deaths never reach the
            # persisted state and a planned restart resumes the job as
            # it last ran.
            done = threading.Event()
            self.inbox.put(("final_snapshot", done))
            snapped = done.wait(timeout=5.0)
            # dispatcher wedged/dead: degrade to a caller-side snapshot
            # attempt (snapshot() tolerates a racing mutation by
            # failing closed) rather than skipping the final state
            self._persist.close(
                None if snapped else self._snapshot_tables)
        for n in list(self.cluster_nodes.values()):
            if n.conn is not None:
                try:
                    n.conn.send(("shutdown",))
                except Exception:
                    pass
        for w in list(self.workers.values()):
            try:
                if w.conn:
                    w.conn.send(("shutdown",))
            except Exception:
                pass
        time.sleep(0.05)
        for w in list(self.workers.values()):
            try:
                w.proc.terminate()
            except Exception:
                pass
        deadline = time.time() + 2.0
        for w in list(self.workers.values()):
            try:
                w.proc.wait(timeout=max(0.01, deadline - time.time()))
            except Exception:
                try:
                    w.proc.kill()
                except Exception:
                    pass
        try:
            self._listener.close()
        except Exception:
            pass
        if self._tcp_listener is not None:
            try:
                self._tcp_listener.close()
            except Exception:
                pass
        if self._transfer_server is not None:
            try:
                self._transfer_server.close()
            except Exception:
                pass
        if self._log_streamer is not None:
            self._log_streamer.stop()
        self.inbox.put(None)
        self.store.shutdown()
        # Undo env we set so a later init() in this process gets a fresh
        # spill dir / node id instead of this runtime's dead paths.
        if self._spill_env_owned:
            os.environ.pop("RAY_TPU_SPILL_DIR", None)
        if knobs.get_raw("RAY_TPU_NODE_ID") == self.node_id:
            os.environ.pop("RAY_TPU_NODE_ID", None)
        import shutil
        shutil.rmtree(self._tmpdir, ignore_errors=True)
        global _runtime
        with _runtime_lock:
            if _runtime is self:
                _runtime = None
