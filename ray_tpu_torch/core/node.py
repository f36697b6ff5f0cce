"""Node agent: joins a host to a running driver over TCP.

Reference parity: src/ray/raylet/node_manager.cc (node registration,
worker leasing) + src/ray/gcs/gcs_server/gcs_node_manager.cc (node table)
— collapsed to the single-controller model: the agent owns this host's
shared-memory object store and spawns workers on the driver's request;
the workers connect straight back to the driver's TCP listener, so the
driver keeps one scheduler for the whole cluster ("multi-host pods are a
transport, not a rewrite").

Run on each additional host:
    python -m ray_tpu_torch.core.node tcp://<driver-host>:<port> \
        [--num-cpus N] [--num-gpus N] [--store-bytes B]

The driver side opens the TCP listener via
`ray_tpu_torch.init(listen="0.0.0.0:6380")` (or RAY_TPU_LISTEN) and exposes the
bound address as `runtime.tcp_address`.
"""
from __future__ import annotations

import argparse
import collections
import os
import select
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, Optional

from . import resources as res_mod
from .ids import new_node_id
from .object_store import make_store
from .protocol import (Connection, ConnectionClosed, connect_address,
                       unix_listener)
from ..util import knobs

# Cross-node payloads stream in frames well under protocol.MAX_MSG so one
# huge object can never poison the connection with an oversized frame.
FETCH_CHUNK = knobs.get_int("RAY_TPU_FETCH_CHUNK")

# Host-resolvable location kinds: any worker on this node can read them
# out of the shared arena (or a spill file), so they are safe to hand to
# a sibling worker as pre-resolved dependency locations.
_HOST_KINDS = ("shm", "native", "inline", "spill")


class _AgentLease:
    """Agent-side half of one node-level bulk lease (two-level
    scheduling, docs/SCHEDULING.md): a resource shape, the local workers
    the driver assigned to it, and a FIFO of tasks to fan across them.
    Queue entries are `[spec, owner_conn_or_None, enqueue_time]` — owner
    None means the driver granted the task (completions stream back as
    `nlease_done`); a live owner conn means a local worker submitted it
    (`asubmit`) and gets the result directly (`aresult`)."""

    __slots__ = ("lid", "need", "wids", "queue", "standing",
                 "last_activity")

    def __init__(self, lid: str, need: dict, wids: set, standing: bool):
        self.lid = lid
        self.need = need
        self.wids = wids
        self.queue: collections.deque = collections.deque()
        self.standing = standing
        self.last_activity = time.monotonic()


class NodeAgent:
    def __init__(self, driver_address: str, *, num_cpus=None, num_gpus=None,
                 resources=None, store_bytes: Optional[int] = None,
                 node_id: Optional[str] = None):
        self.driver_address = driver_address
        # A pre-chosen id lets a launcher (core/autoscaler.py providers)
        # correlate "the process I started" with "the node that joined".
        self.node_id = node_id or new_node_id()
        # This host's store is its own arena: drop any inherited owner env
        # (tests run agents on the driver's host) and stamp our node id so
        # every ObjectLocation written here names this node.
        os.environ.pop("RAY_TPU_ARENA_NAME", None)
        os.environ["RAY_TPU_NODE_ID"] = self.node_id
        cap = store_bytes \
            or knobs.get_int("RAY_TPU_STORE_BYTES", default=2 << 30)
        self.store = make_store(capacity_bytes=cap, is_owner=True)

        node_res = res_mod.detect_node_resources(num_cpus, num_gpus)
        if resources:
            node_res.update(resources)
        self.resources = node_res
        self.labels = {}   # no pod labels on GPU hosts (resources.py)
        node_type = knobs.get_raw("RAY_TPU_NODE_TYPE")
        if node_type:
            self.labels["node-type"] = node_type

        self._tmpdir = tempfile.mkdtemp(prefix="ray_tpu_node_")
        self.log_dir = os.path.join(self._tmpdir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        # This node's workers spill put-overflow here (core/spilling.py;
        # the driver-side watermark spiller only covers the driver node).
        # Overrides any env inherited from a same-host driver in tests.
        spill_dir = os.path.join(self._tmpdir, "spill")
        os.environ["RAY_TPU_SPILL_DIR"] = spill_dir
        self.workers: Dict[str, subprocess.Popen] = {}
        self.job_id = "job-default"
        # Fetches run on threads (a multi-GB read must not head-of-line
        # block spawns/frees), bounded so they can't starve the loop.
        self._fetch_sem = threading.Semaphore(4)

        # ---- two-level scheduling: agent-local dispatch plane ----------
        # The driver grants this agent bulk leases (batches of compatible
        # tasks plus a set of local workers); the agent fans them across
        # those workers over a node-local unix socket and refills slots
        # as completions arrive, without driver round trips. Workers also
        # submit their own fan-outs here (`asubmit`) for dependency-local
        # placement. docs/SCHEDULING.md "Two-level scheduling".
        self._nlease_enabled = knobs.get_bool("RAY_TPU_NODE_LEASES")
        self._sched_lock = threading.RLock()
        self._aworkers: Dict[str, Connection] = {}     # wid -> worker conn
        # wid -> deque of (lease_id_or_"", spec, owner_conn_or_None):
        # tasks in flight per worker, FIFO. Depth >1 pipelines the
        # aexec/adone round trip so a worker never idles between
        # sub-millisecond tasks; only the head can have started (the
        # worker executes its backlog strictly in order), which is what
        # the spill accounting relies on.
        self._winflight: Dict[str, collections.deque] = {}
        self._leases: Dict[str, _AgentLease] = {}
        # worker-submitted tasks waiting for lease capacity of their shape
        self._nested_q: collections.deque = collections.deque()
        self._want_last: Dict[tuple, float] = {}
        # host-kind seal locations of recent local results, for stamping
        # pre-resolved dependency locations onto sibling dispatches
        self._oid_locs: collections.OrderedDict = collections.OrderedDict()
        self._agent_listener = None
        self.agent_addr = ""
        self._done_batch = None
        if self._nlease_enabled:
            self._start_agent_plane()

        # Peer-to-peer transfer plane (core/object_transfer.py): this
        # host serves its sealed objects directly to peer nodes, and
        # pulls remote objects into its own arena on the driver's
        # request ("pull_object") — object bytes stop transiting the
        # driver's control connections. Spans per pull buffer here and
        # ship with the metrics heartbeat.
        self._spans: list = []
        self._spans_lock = threading.Lock()
        from .object_transfer import (PullManager,  # noqa: PLC0415
                                      TransferServer)
        self.transfer_server = TransferServer(
            self.store, spill_dirs=[spill_dir])
        self.pull_manager = PullManager(
            self.store, node_id=self.node_id, locate=self._locate,
            span_sink=self._span_sink)
        # locate round-trips: rid -> (Event, box)
        self._locate_lock = threading.Lock()
        self._locate_counter = 0
        self._locate_events: Dict[int, tuple] = {}

        # Bumped on every re-registration after a lost driver connection
        # (network blip, or the driver fenced us after a heartbeat-
        # declared death): the driver fences traffic from older
        # incarnations, so a stalled-then-recovered agent can't corrupt
        # the failover that already happened.
        self.incarnation = 0
        # last acked driver incarnation (bumps when a SIGKILLed driver
        # resumes and this agent reattaches to it)
        self.driver_incarnation = 0
        self.conn = connect_address(driver_address)
        self.conn.send(("register_node", self._register_info()))
        if self._nlease_enabled:
            # Lease completions coalesce into ("batch", ...) frames on
            # the node connection, same codec + cadence discipline as the
            # worker->driver batcher (a fan-out of sub-millisecond tasks
            # costs one frame per batch, not one per completion).
            from .worker import _MsgBatcher  # noqa: PLC0415
            self._done_batch = _MsgBatcher(
                self.conn,
                max_n=knobs.get_int("RAY_TPU_BATCH_FLUSH_N"),
                window=knobs.get_float("RAY_TPU_BATCH_FLUSH_S"),
                enabled=knobs.get_bool("RAY_TPU_BATCH"))
            threading.Thread(target=self._spill_loop, daemon=True,
                             name="node-lease-spill").start()
        # Metrics plane: this agent's registry (node-local store stats,
        # any user metrics recorded here) ships delta snapshots on the
        # node connection; the driver merges them tagged with node_id.
        self._metrics_interval = knobs.get_float(
            "RAY_TPU_METRICS_INTERVAL_S")
        if self._metrics_interval > 0:
            threading.Thread(target=self._metrics_loop, daemon=True,
                             name="node-metrics").start()
        # Liveness pings for the driver's event plane: a stalled (not
        # just disconnected) agent surfaces as node.heartbeat_miss
        # before the socket-level death determination.
        self._heartbeat_interval = knobs.get_float(
            "RAY_TPU_NODE_HEARTBEAT_S")
        if self._heartbeat_interval > 0:
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="node-heartbeat").start()
        # Agent-side mirror of the driver's heartbeat-declared death:
        # the driver acks every heartbeat, so a healthy connection is
        # never silent longer than the heartbeat interval. Total
        # silence past RAY_TPU_DRIVER_SILENCE_S means the driver HOST
        # is gone without a FIN/RST (preemption, partition) — recv()
        # would park until the ~15min TCP retransmit timeout and this
        # host's capacity would stay lost long after the driver
        # restarts. run() treats that as a lost connection and rejoins.
        self._silence_timeout = knobs.get_float("RAY_TPU_DRIVER_SILENCE_S")
        self._last_driver_traffic = time.monotonic()
        # True while run() is parked inside conn.recv(): with the
        # select() gate that only happens when at least a frame HEADER
        # arrived, so a long park here means the driver died mid-frame
        # — the heartbeat loop then closes the conn to unblock the
        # read (the same cross-thread unblock idiom the driver's death
        # determination uses). A socket-level settimeout would be
        # simpler but caps every sendall on this SHARED conn too, and
        # the fetch path streams 64MB frames over it.
        self._in_recv = False

    def _register_info(self) -> dict:
        return {
            "node_id": self.node_id,
            "hostname": os.uname().nodename,
            "resources": dict(self.resources),
            "labels": dict(self.labels),
            "transfer_address": self.transfer_server.address,
            "incarnation": self.incarnation,
            "pid": os.getpid(),
            # capability flag: the driver only grants node-level bulk
            # leases to agents that actually run the local dispatch plane
            "node_leases": self._nlease_enabled,
        }

    def _heartbeat_loop(self) -> None:
        while True:
            time.sleep(self._heartbeat_interval)
            try:
                self.conn.send(("heartbeat", time.time()))
            except (ConnectionClosed, OSError):
                # driver connection down: run() is either reconnecting
                # (self.conn gets swapped) or exiting (daemon thread
                # dies with the process) — keep ticking either way
                continue
            except Exception:
                pass
            # mid-frame silence watchdog: run()'s select() gate cannot
            # fire while recv() is parked on a partial frame
            if (self._silence_timeout > 0 and self._in_recv
                    and time.monotonic() - self._last_driver_traffic
                    > self._silence_timeout):
                from ..util import events as events_mod  # noqa: PLC0415
                events_mod.emit_safe(
                    "sched.hang.suspected",
                    f"driver silent > {self._silence_timeout:.0f}s "
                    "mid-frame (recv parked on a partial frame); "
                    "closing the connection to enter the rejoin loop",
                    node_id=self.node_id, kind="driver_silence",
                    mid_frame=True)
                try:
                    self.conn.close()   # recv raises; run() rejoins
                except Exception:
                    pass

    def _metrics_loop(self) -> None:
        from ..util.metrics import DeltaExporter  # noqa: PLC0415
        from ..util import metrics_catalog as mcat  # noqa: PLC0415
        from ..util import events as events_mod  # noqa: PLC0415
        from ..util import waits as waits_mod  # noqa: PLC0415
        exporter = DeltaExporter()
        # Collected-but-unsent messages: collect()/drain() are
        # DESTRUCTIVE reads, so a send failure during the rejoin window
        # must re-queue them (bounded) rather than drop a blip's worth
        # of deltas and lifecycle events on the floor.
        pending: list = []
        while True:
            time.sleep(self._metrics_interval)
            try:
                mcat.get("ray_tpu_object_store_used_bytes").set(
                    float(self.store.used_bytes()))
                cap = getattr(self.store, "capacity", None)
                if cap:
                    mcat.get(
                        "ray_tpu_object_store_capacity_bytes").set(
                        float(cap))
                payload = exporter.collect()
                if payload:
                    pending.append(("metrics", payload))
                with self._spans_lock:
                    spans, self._spans = self._spans, []
                if spans:
                    pending.append(("spans", spans))
                # event-plane delta batch (anything code on this agent
                # emitted — memory pressure, engine/data events)
                evs = events_mod.drain()
                if evs:
                    pending.append(("events", evs))
                # wait-state plane: lease queues are data structures,
                # not parked threads — re-synthesize the queue heads
                # as lease-slot waits each tick, then ship the aged
                # delta (None steady-state, like the workers)
                try:
                    self._synth_lease_waits(waits_mod)
                    wts = waits_mod.collect()
                    if wts is not None:
                        pending.append(("waits", wts))
                except Exception:  # noqa: BLE001
                    pass
                # one coalesced frame per interval (compact binary
                # codec), not one frame per telemetry kind; a single
                # leftover skips the envelope
                if len(pending) > 1:
                    self.conn.send(("batch", list(pending)))
                    del pending[:]
                elif pending:
                    self.conn.send(pending[0])
                    pending.pop(0)
            except (ConnectionClosed, OSError):
                # reconnecting (or exiting) — see heartbeat loop; keep
                # the backlog bounded while the driver is away
                del pending[:-64]
                continue
            except Exception:
                pass  # telemetry must never kill the agent

    def _synth_lease_waits(self, waits_mod) -> None:
        """Each lease FIFO's parked HEAD (and the nested queue's) is a
        blocking edge: the head task waits on a local worker slot. The
        tail behind it is context, not separate edges — one record per
        queue keeps the table bounded by lease count."""
        if not waits_mod.enabled():
            return
        recs = []
        with self._sched_lock:
            for lease in self._leases.values():
                if not lease.queue:
                    continue
                spec, _owner, ts = lease.queue[0]
                recs.append(("lease-slot", lease.lid, ts,
                             {"task": getattr(spec, "task_id", ""),
                              "name": getattr(spec, "name", ""),
                              "queued": len(lease.queue)}))
            if self._nested_q:
                spec, _owner, ts = self._nested_q[0]
                recs.append(("lease-slot", "nested", ts,
                             {"task": getattr(spec, "task_id", ""),
                              "name": getattr(spec, "name", ""),
                              "queued": len(self._nested_q)}))
        waits_mod.table().replace_synth("agent:", recs)

    # ---- transfer plane ---------------------------------------------------
    def _span_sink(self, span: dict) -> None:
        with self._spans_lock:
            self._spans.append(span)

    def _locate(self, oid: str):
        """Ask the driver for fresh location-directory candidates (the
        PullManager's between-rounds re-resolve). Returns the candidate
        list, or None on timeout/disconnect."""
        with self._locate_lock:
            self._locate_counter += 1
            rid = self._locate_counter
            ev = threading.Event()
            box: dict = {}
            self._locate_events[rid] = (ev, box)
        try:
            self.conn.send(("locate", rid, oid))
        except ConnectionClosed:
            with self._locate_lock:
                self._locate_events.pop(rid, None)
            return None
        if not ev.wait(timeout=10.0):
            with self._locate_lock:
                self._locate_events.pop(rid, None)
            return None
        return box.get("candidates")

    def _serve_pull(self, rid, oid: str, candidates) -> None:
        """Run one driver-requested pull on a thread and report the
        local location back (or the failure, so the driver can fall
        back to its relay path). Bounded by the same semaphore as
        fetches — each pull buffers a whole object, so unbounded
        concurrency would be an unbounded memory spike."""
        with self._fetch_sem:
            try:
                loc = self.pull_manager.pull(oid, candidates)
                self.conn.send(("pulled", rid, oid, loc, None))
            except ConnectionClosed:
                pass
            except BaseException as e:  # noqa: BLE001
                try:
                    self.conn.send(("pulled", rid, oid, None, repr(e)))
                except ConnectionClosed:
                    pass

    # ---- command loop -----------------------------------------------------
    def _await_driver_traffic(self) -> bool:
        """Bounded wait for inbound driver frames. True when the
        connection is readable (or the watchdog is disabled); False
        when total driver silence exceeded RAY_TPU_DRIVER_SILENCE_S —
        the half-open-peer case a blocking recv() can never notice."""
        if self._silence_timeout <= 0 or self._heartbeat_interval <= 0:
            return True   # no acks flowing -> silence proves nothing
        while True:
            try:
                readable, _, _ = select.select(
                    [self.conn.sock], [], [], 1.0)
            except (OSError, ValueError):
                return True   # socket dying: let recv() raise the cause
            if readable:
                return True
            silent = time.monotonic() - self._last_driver_traffic
            if silent > self._silence_timeout:
                return False

    def run(self) -> None:
        try:
            while True:
                try:
                    if not self._await_driver_traffic():
                        print(f"ray_tpu node {self.node_id}: driver "
                              f"silent > {self._silence_timeout:.0f}s "
                              "(no frames or heartbeat acks); treating "
                              "the connection as dead", flush=True)
                        from ..util import \
                            events as events_mod  # noqa: PLC0415
                        events_mod.emit_safe(
                            "sched.hang.suspected",
                            f"driver silent > "
                            f"{self._silence_timeout:.0f}s (no frames "
                            "or heartbeat acks); treating the "
                            "connection as dead and rejoining",
                            node_id=self.node_id,
                            kind="driver_silence")
                        try:
                            self.conn.close()
                        except Exception:
                            pass
                        raise ConnectionClosed("driver silence timeout")
                    self._in_recv = True
                    try:
                        # raylint: disable=RT003 bounded two ways: recv
                        # only runs after _await_driver_traffic saw
                        # readability, and a mid-frame park is closed
                        # out by the heartbeat loop's
                        # RAY_TPU_DRIVER_SILENCE_S watchdog (_in_recv)
                        m = self.conn.recv()
                    finally:
                        self._in_recv = False
                    self._last_driver_traffic = time.monotonic()
                    self._handle(m)
                except ConnectionClosed:
                    # Driver connection lost — noticed at recv OR at a
                    # send inside a handler (e.g. worker_spawn_failed):
                    # a preempted/stalled host (or a network blip) tries
                    # to REJOIN under a new incarnation instead of dying
                    # — the driver already failed our work over;
                    # rejoining just puts this host's capacity back in
                    # the pool.
                    if not self._reconnect():
                        return
                    continue
                if m[0] == "shutdown":
                    break
        finally:
            self._cleanup()

    def _reconnect(self) -> bool:
        """Re-register with the driver under a new incarnation, within
        the RAY_TPU_NODE_REJOIN_S window (0 disables). Old workers are
        terminated first: the driver marked them dead at our death
        determination, and a zombie from the fenced incarnation must
        not double-execute anything."""
        window = knobs.get_float("RAY_TPU_NODE_REJOIN_S")
        if window <= 0:
            return False
        for proc in self.workers.values():
            try:
                proc.terminate()
            except Exception:
                pass
        self.workers.clear()
        # Old bulk leases die with the old incarnation: the driver's
        # death determination already re-pended their ledgers (fenced),
        # and the workers they named were just terminated.
        self._clear_lease_state()
        deadline = time.time() + window
        delay = 0.2
        while time.time() < deadline:
            try:
                conn = connect_address(self.driver_address)
                self.incarnation += 1
                conn.send(("register_node", self._register_info()))
            except Exception:
                time.sleep(min(delay,
                               max(0.05, deadline - time.time())))
                delay = min(delay * 2, 2.0)
                continue
            self.conn = conn
            if self._done_batch is not None:
                self._done_batch.conn = conn
            self._last_driver_traffic = time.monotonic()
            print(f"ray_tpu node {self.node_id} rejoined "
                  f"{self.driver_address} as incarnation "
                  f"{self.incarnation}", flush=True)
            return True
        return False

    def _handle(self, m) -> None:
        mtype = m[0]
        if mtype == "node_registered":
            self.job_id = m[2]
            # a restarted driver acks with a bumped incarnation: this
            # host's capacity (and its surviving object store) is now
            # reattached to the resumed control plane
            inc = m[3] if len(m) > 3 else 0
            if inc and inc != self.driver_incarnation:
                print(f"ray_tpu node {self.node_id} reattached to "
                      f"driver incarnation {inc}", flush=True)
                # the resumed driver rebuilt its lease ledger from
                # scratch; anything granted by the old incarnation is
                # fenced there, so holding it here would only double-run
                self._clear_lease_state()
            self.driver_incarnation = inc
        elif mtype == "heartbeat_ack":
            pass  # run() already stamped _last_driver_traffic
        elif mtype == "pull_object":
            _, rid, oid, candidates = m
            threading.Thread(target=self._serve_pull,
                             args=(rid, oid, candidates),
                             daemon=True).start()
        elif mtype == "locations":
            _, rid, candidates = m
            with self._locate_lock:
                pair = self._locate_events.pop(rid, None)
            if pair is not None:
                ev, box = pair
                box["candidates"] = candidates
                ev.set()
        elif mtype == "spawn_worker":
            _, wid, gpu_capable, job_id = m
            self.job_id = job_id
            try:
                self._spawn(wid, gpu_capable)
            except BaseException as e:  # noqa: BLE001
                self.conn.send(("worker_spawn_failed", wid, repr(e)))
        elif mtype == "fetch_object":
            _, rid, loc = m
            threading.Thread(target=self._serve_fetch, args=(rid, loc),
                             daemon=True).start()
        elif mtype == "free_object":
            _, loc = m
            try:
                if loc.kind in ("shm", "native"):
                    self.store.delete_segment(loc.name, loc.size)
                if loc.spill_path and os.path.exists(loc.spill_path):
                    os.remove(loc.spill_path)
                elif loc.kind == "spill" and os.path.exists(loc.name):
                    os.remove(loc.name)
            except Exception:
                traceback.print_exc()
        elif mtype == "nlease_grant":
            _, lid, need, wids, specs, standing = m
            self._on_nlease_grant(lid, need, wids, specs, standing)
        elif mtype == "nlease_extend":
            self._on_nlease_extend(m[1], m[2])
        elif mtype == "nlease_close":
            self._on_nlease_close(m[1])
        elif mtype == "shutdown":
            pass  # run() breaks and cleans up

    def _serve_fetch(self, rid, loc) -> None:
        """Read from the local store (arena or spill file) and stream the
        payload back in chunks. Connection.send is thread-safe, so
        concurrent fetches interleave at frame granularity."""
        with self._fetch_sem:
            try:
                data = self.store.get_bytes(loc)
            except BaseException as e:  # noqa: BLE001
                try:
                    self.conn.send(("fetched", rid, None, e))
                except ConnectionClosed:
                    pass
                return
            try:
                total = len(data)
                if total <= FETCH_CHUNK:
                    self.conn.send(("fetched", rid, data, None))
                    return
                for off in range(0, total, FETCH_CHUNK):
                    self.conn.send(("fetched_chunk", rid, off, total,
                                    data[off:off + FETCH_CHUNK]))
            except ConnectionClosed:
                pass

    def _spawn(self, wid: str, gpu_capable: bool) -> None:
        env = dict(os.environ)
        env["RAY_TPU_JOB_ID"] = self.job_id
        env["RAY_TPU_LOG_DIR"] = self.log_dir
        env["RAY_TPU_NODE_ID"] = self.node_id
        env["RAY_TPU_NODE_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "")
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        agent_paths = [p for p in sys.path
                       if p and os.path.isdir(p) and p != repo_root]
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root, *agent_paths,
             *[p for p in env.get("PYTHONPATH", "").split(os.pathsep)
               if p]])
        if self.agent_addr:
            # workers join the agent-local dispatch plane (two-level
            # scheduling) before they register with the driver
            env["RAY_TPU_AGENT_ADDR"] = self.agent_addr
        if not gpu_capable:
            # a worker that may not use the card sees none
            env["CUDA_VISIBLE_DEVICES"] = ""
        self.workers[wid] = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker",
             self.driver_address, wid],
            env=env, cwd=os.getcwd())

    # ---- agent-local dispatch plane (two-level scheduling) ----------------
    def _start_agent_plane(self) -> None:
        path = os.path.join(self._tmpdir, "agent.sock")
        self._agent_listener = unix_listener(path)
        self.agent_addr = path
        threading.Thread(target=self._agent_accept, daemon=True,
                         name="agent-accept").start()

    def _agent_accept(self) -> None:
        while True:
            try:
                sock, _ = self._agent_listener.accept()
            except OSError:
                return   # listener closed: agent shutting down
            conn = Connection(sock)
            threading.Thread(target=self._agent_reader, args=(conn,),
                             daemon=True, name="agent-wreader").start()

    def _agent_reader(self, conn: Connection) -> None:
        """One thread per local worker connection: registration,
        completions, and nested submissions."""
        wid = None
        try:
            while True:
                # raylint: disable=RT003 bounded by worker lifetime: the
                # peer is a local worker process on a unix socket; its
                # exit closes the socket and ends this loop
                m = conn.recv()
                k = m[0]
                if k == "aregister":
                    wid = m[1]
                    with self._sched_lock:
                        self._aworkers[wid] = conn
                    self._pump()
                elif k == "adone":
                    self._on_adone(wid, m[1], m[2], m[3])
                elif k == "asubmit":
                    for spec in m[1]:
                        self._on_asubmit(spec, conn)
                elif k == "batch":
                    # worker-side completion batcher: unwrap in order,
                    # refill once at the end — per-item pumps would
                    # fragment the next aexec refill into tiny frames
                    for bm in m[1]:
                        if bm[0] == "adone":
                            self._on_adone(wid, bm[1], bm[2], bm[3],
                                           pump=False)
                        elif bm[0] == "aregister":
                            wid = bm[1]
                            with self._sched_lock:
                                self._aworkers[wid] = conn
                        elif bm[0] == "asubmit":
                            for spec in bm[1]:
                                self._on_asubmit(spec, conn)
                    self._pump()
        except (ConnectionClosed, OSError):
            pass
        finally:
            if wid is not None:
                self._on_aworker_lost(wid, conn)

    def _clear_lease_state(self) -> None:
        with self._sched_lock:
            self._leases.clear()
            self._winflight.clear()
            self._nested_q.clear()

    def _oid_record(self, oid, loc) -> None:
        with self._sched_lock:
            self._oid_locs[oid] = loc
            self._oid_locs.move_to_end(oid)
            while len(self._oid_locs) > 8192:
                self._oid_locs.popitem(last=False)

    def _lease_for(self, resources) -> Optional[_AgentLease]:
        """An open lease of exactly this resource shape with queue
        capacity left AND a free worker, or None. The free-worker
        requirement matters for nested submissions: queueing a child
        behind the lease's only worker when that worker is its blocked
        PARENT would self-deadlock until the spill timer bails it out
        — park it instead and ask for standing capacity (_pump absorbs
        parked tasks the moment a matching worker frees up). Caller
        holds _sched_lock."""
        key = tuple(sorted(resources.items()))
        slots = max(1, knobs.get_int("RAY_TPU_NODE_LEASE_SLOTS"))
        for lease in self._leases.values():
            if (tuple(sorted(lease.need.items())) == key and lease.wids
                    and len(lease.queue) < len(lease.wids) * slots
                    and any(w in self._aworkers
                            and not self._winflight.get(w)
                            for w in lease.wids)):
                return lease
        return None

    def _maybe_want(self, resources) -> None:
        """Ask the driver for standing-lease capacity of this shape, at
        most once a second per shape. Caller holds _sched_lock (only the
        throttle table; the send is safe on the thread-safe conn)."""
        key = tuple(sorted(resources.items()))
        now = time.monotonic()
        if now - self._want_last.get(key, 0.0) < 1.0:
            return
        self._want_last[key] = now
        try:
            self.conn.send(("nlease_want", dict(resources),
                            max(1, len(self._nested_q))))
        except (ConnectionClosed, OSError):
            pass

    def _forward_to_driver(self, spec, owner) -> None:
        """Spill one worker-submitted task up to the driver queue (deps
        not node-local, or no capacity arrived in time) and tell the
        owner to resolve its result through the driver instead."""
        try:
            self.conn.send(("submit", spec))
        except (ConnectionClosed, OSError):
            return  # driver gone: the rejoin/death path owns recovery
        if owner is not None:
            try:
                owner.send(("aspill", [spec.task_id]))
            except (ConnectionClosed, OSError):
                pass  # owner died; its job's failure handling covers it

    def _on_asubmit(self, spec, owner: Connection) -> None:
        """A local worker submitted a fan-out task. Place it locally when
        every dependency is node-resolvable and a shape-matching lease
        has capacity; otherwise park it (asking the driver for a standing
        lease) and let the spill timer forward it if none arrives."""
        dep_locs = []
        with self._sched_lock:
            for oid in getattr(spec, "dep_object_ids", None) or ():
                loc = self._oid_locs.get(oid)
                if loc is None:
                    dep_locs = None
                    break
                dep_locs.append((oid, loc))
        if dep_locs is None:
            self._forward_to_driver(spec, owner)
            return
        # attached out-of-band at dispatch (the compact spec codec
        # carries pure fields only)
        spec._dep_locs = dep_locs or None
        now = time.monotonic()
        with self._sched_lock:
            lease = self._lease_for(spec.resources)
            if lease is not None:
                lease.queue.append([spec, owner, now])
                lease.last_activity = now
            else:
                self._nested_q.append([spec, owner, now])
                self._maybe_want(spec.resources)
        self._pump()

    def _pump(self) -> None:
        """Fan queued lease tasks across registered workers, keeping up
        to RAY_TPU_NODE_LEASE_DEPTH tasks in flight per worker. Depth
        >1 pipelines the aexec/adone round trip (the worker executes
        its backlog FIFO, so sub-millisecond tasks never leave it idle
        waiting for the next frame). Parked nested tasks are absorbed
        only by a fully-idle worker: queueing a child behind its own
        blocked parent would self-deadlock until the spill timer bails
        it out. Assignment happens under the lock; the sends happen
        outside it."""
        depth = max(1, knobs.get_int("RAY_TPU_NODE_LEASE_DEPTH"))
        dispatch = []
        with self._sched_lock:
            for lease in list(self._leases.values()):
                key = None
                for w in list(lease.wids):
                    conn = self._aworkers.get(w)
                    if conn is None:
                        continue
                    q = self._winflight.setdefault(
                        w, collections.deque())
                    while len(q) < depth:
                        if lease.queue:
                            spec, owner, _t0 = lease.queue.popleft()
                        elif not q:
                            # fully idle: absorb a parked nested task
                            # of this lease's shape (it missed
                            # _lease_for when every worker was
                            # momentarily busy)
                            if key is None:
                                key = tuple(sorted(lease.need.items()))
                            entry = None
                            for e in self._nested_q:
                                if tuple(sorted(
                                        e[0].resources.items())) == key:
                                    entry = e
                                    break
                            if entry is None:
                                break
                            self._nested_q.remove(entry)
                            spec, owner, _t0 = entry
                        else:
                            break
                        q.append((lease.lid, spec, owner))
                        lease.last_activity = time.monotonic()
                        dispatch.append((w, conn, spec, owner))
        # one aexec frame per worker per pump round: a refill of
        # `depth` sub-millisecond tasks costs one syscall + wakeup,
        # not one per task (the 1-core contention profile is frame-
        # dominated, see BENCH_CORE multi_agent_scaling)
        by_worker: Dict[str, list] = {}
        conns = {}
        for w, conn, spec, owner in dispatch:
            conns[w] = conn
            by_worker.setdefault(w, []).append(
                (spec, getattr(spec, "_dep_locs", None),
                 owner is not None))
        for w, batch in by_worker.items():
            try:
                conns[w].send(("aexec", batch))
            except (ConnectionClosed, OSError):
                self._on_aworker_lost(w, conns[w])

    def _on_adone(self, wid, tid, sealed, error,
                  pump: bool = True) -> None:
        with self._sched_lock:
            entry = None
            q = self._winflight.get(wid)
            if q:
                # completions arrive in dispatch order (the worker
                # executes its backlog FIFO) — but a revoked/raced
                # frame can skip, so match by task id
                if q[0][1].task_id == tid:
                    entry = q.popleft()
                else:
                    for e in q:
                        if e[1].task_id == tid:
                            entry = e
                            q.remove(e)
                            break
        if entry is None:
            return
        lid, spec, owner = entry
        # host-kind seals are readable by every worker on this node:
        # remember them so a sibling fan-out task depending on this
        # result dispatches with pre-resolved locations
        for oid, loc in sealed or ():
            if getattr(loc, "kind", None) in _HOST_KINDS:
                self._oid_record(oid, loc)
        if owner is not None:
            try:
                owner.send(("aresult", tid, sealed, error))
            except (ConnectionClosed, OSError):
                pass  # owner died; nothing upstream waits on this
        else:
            with self._sched_lock:
                lease = self._leases.get(lid)
                # flush NOW only when this lease has truly drained
                # (no queued work and no pipelined backlog on any of
                # its workers) — the driver may be waiting on the last
                # ack to extend or settle. Mid-stream completions ride
                # the batch window so acks coalesce.
                urgent = lease is None or (
                    not lease.queue
                    and not any(e[0] == lid
                                for q in self._winflight.values()
                                for e in q))
            try:
                self._done_batch.send(
                    ("nlease_done", lid, [(tid, wid, sealed, error)]),
                    urgent=urgent)
            except (ConnectionClosed, OSError):
                pass  # rejoin path re-pends the ledger driver-side
        if pump:
            self._pump()

    def _on_aworker_lost(self, wid, conn: Connection) -> None:
        """A local worker's agent connection died (process exit or
        crash). Its in-flight task HAD started: driver-granted tasks
        spill back with started=True (the driver applies its normal
        worker-death retry accounting); nested tasks forward to the
        driver for re-execution (at-least-once, like a direct-call
        channel death)."""
        with self._sched_lock:
            if self._aworkers.get(wid) is conn:
                del self._aworkers[wid]
            entries = self._winflight.pop(wid, None) or ()
            for lease in self._leases.values():
                lease.wids.discard(wid)
        # only the head of the worker's FIFO backlog can have started;
        # the pipelined tasks behind it re-queue without burning a retry
        spills: Dict[str, list] = {}
        for i, (lid, spec, owner) in enumerate(entries):
            if owner is None:
                spills.setdefault(lid, []).append(
                    (spec.task_id, i == 0))
            else:
                self._forward_to_driver(spec, owner)
        for lid, batch in spills.items():
            try:
                self.conn.send(("nlease_spill", lid, batch,
                                "worker_death"))
            except (ConnectionClosed, OSError):
                pass
        self._pump()

    def _on_nlease_grant(self, lid, need, wids, specs, standing) -> None:
        now = time.monotonic()
        with self._sched_lock:
            lease = _AgentLease(lid, dict(need), set(wids),
                                bool(standing))
            for spec in specs:
                lease.queue.append([spec, None, now])
            self._leases[lid] = lease
            # parked nested tasks of this shape ride the new capacity
            key = tuple(sorted(lease.need.items()))
            keep: collections.deque = collections.deque()
            for entry in self._nested_q:
                if tuple(sorted(entry[0].resources.items())) == key:
                    lease.queue.append(entry)
                else:
                    keep.append(entry)
            self._nested_q = keep
        self._pump()

    def _on_nlease_extend(self, lid, specs) -> None:
        now = time.monotonic()
        unknown = False
        with self._sched_lock:
            lease = self._leases.get(lid)
            if lease is None:
                unknown = True
            else:
                lease.last_activity = now
                for spec in specs:
                    lease.queue.append([spec, None, now])
        if unknown:
            # closed/fenced lease: hand the batch straight back unstarted
            try:
                self.conn.send(("nlease_spill", lid,
                                [(s.task_id, False) for s in specs],
                                "unknown_lease"))
            except (ConnectionClosed, OSError):
                pass
            return
        self._pump()

    def _on_nlease_close(self, lid) -> None:
        with self._sched_lock:
            lease = self._leases.pop(lid, None)
            if lease is not None:
                for entry in lease.queue:
                    # nested tasks go back to the wait queue; any
                    # driver-owned leftovers were already re-pended
                    # driver-side before the close
                    if entry[1] is not None:
                        self._nested_q.append(entry)
        self._pump()

    def _spill_loop(self) -> None:
        """Ages out unplaceable queued tasks: lease entries that no free
        worker picked up within RAY_TPU_NODE_LEASE_SPILL_S spill back to
        the driver, parked nested tasks forward to it, and drained
        standing leases release after RAY_TPU_NODE_LEASE_IDLE_S."""
        spill_s = knobs.get_float("RAY_TPU_NODE_LEASE_SPILL_S")
        idle_s = knobs.get_float("RAY_TPU_NODE_LEASE_IDLE_S")
        tick = max(0.05, min(0.5, (spill_s or 1.0) / 4))
        while True:
            time.sleep(tick)
            try:
                self._spill_pass(spill_s, idle_s)
            except Exception:
                pass  # the timer must never die

    def _spill_pass(self, spill_s: float, idle_s: float) -> None:
        now = time.monotonic()
        spills = []     # (lid, [(tid, False)])
        forwards = []   # (spec, owner)
        releases = []
        with self._sched_lock:
            for lid, lease in list(self._leases.items()):
                if spill_s > 0 and lease.queue:
                    free = any(w in self._aworkers
                               and not self._winflight.get(w)
                               for w in lease.wids)
                    if not free:
                        aged = []
                        keep: collections.deque = collections.deque()
                        for entry in lease.queue:
                            spec, owner, t0 = entry
                            if now - t0 > spill_s:
                                if owner is None:
                                    aged.append(spec.task_id)
                                else:
                                    forwards.append((spec, owner))
                            else:
                                keep.append(entry)
                        lease.queue = keep
                        if aged:
                            spills.append(
                                (lid, [(t, False) for t in aged]))
                if (lease.standing and idle_s > 0 and not lease.queue
                        and now - lease.last_activity > idle_s
                        and not any(e[0] == lid
                                    for q in self._winflight.values()
                                    for e in q)):
                    releases.append(lid)
                    del self._leases[lid]
            if spill_s > 0:
                keep = collections.deque()
                for entry in self._nested_q:
                    spec, owner, t0 = entry
                    if now - t0 > spill_s:
                        forwards.append((spec, owner))
                    else:
                        keep.append(entry)
                self._nested_q = keep
        for lid, entries in spills:
            try:
                self.conn.send(
                    ("nlease_spill", lid, entries, "placement_timeout"))
            except (ConnectionClosed, OSError):
                pass
        for spec, owner in forwards:
            self._forward_to_driver(spec, owner)
        for lid in releases:
            try:
                self.conn.send(("nlease_release", lid))
            except (ConnectionClosed, OSError):
                pass

    def _cleanup(self) -> None:
        if self._agent_listener is not None:
            try:
                self._agent_listener.close()
            except Exception:
                pass
        try:
            self.transfer_server.close()
        except Exception:
            pass
        for proc in self.workers.values():
            try:
                proc.terminate()
            except Exception:
                pass
        deadline = time.time() + 2.0
        for proc in self.workers.values():
            try:
                proc.wait(timeout=max(0.01, deadline - time.time()))
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
        try:
            self.store.shutdown()
        except Exception:
            traceback.print_exc()
        import shutil
        shutil.rmtree(self._tmpdir, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="ray_tpu node agent: join this host to a driver")
    ap.add_argument("driver_address",
                    help="tcp://<driver-host>:<port> of ray_tpu_torch.init("
                         "listen=...)")
    ap.add_argument("--num-cpus", type=int, default=None)
    ap.add_argument("--num-gpus", type=int, default=None)
    ap.add_argument("--store-bytes", type=int, default=None)
    ap.add_argument("--resources", type=str, default=None,
                    help='extra custom resources as JSON, e.g. '
                         '\'{"my_res": 2}\'')
    ap.add_argument("--node-id", type=str, default=None)
    args = ap.parse_args()
    import json
    extra = json.loads(args.resources) if args.resources else None
    agent = NodeAgent(args.driver_address, num_cpus=args.num_cpus,
                      num_gpus=args.num_gpus, resources=extra,
                      store_bytes=args.store_bytes, node_id=args.node_id)
    print(f"ray_tpu node {agent.node_id} joined {args.driver_address}",
          flush=True)
    agent.run()


if __name__ == "__main__":
    main()
