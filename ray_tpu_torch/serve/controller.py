"""Serve controller actor: reconciles deployment state (counterpart of
ray_tpu/serve/controller.py).

Reference parity: python/ray/serve/_private/controller.py +
deployment_state.py (target-state reconciliation, health checks, rolling
updates) and autoscaling_state.py (metrics-driven replica counts). One
controller actor per cluster; a background thread runs the reconcile loop
so control-plane progress never depends on incoming calls.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from .config import DeploymentConfig, ReplicaInfo

CONTROLLER_NAME = "_SERVE_CONTROLLER"
_LOOP_PERIOD_S = 0.25
# how often each RUNNING replica is polled for autoscale metrics when
# the deployment sets no autoscaling_config (victim selection for
# least-busy scale-down still wants a load sample)
_METRICS_PERIOD_S = 0.5
# sticky session/prefix bindings remembered per deployment for the
# state API / dashboard router table
_BINDINGS_CAP = 1024


def _env_float(name: str, default: float) -> float:
    """Env knob with a per-deployment-config fallback: the serve FT
    knobs (RAY_TPU_SERVE_HEALTH_PERIOD_S/_TIMEOUT_S/_THRESHOLD) apply
    cluster-wide when set; otherwise each deployment's config wins."""
    from ..util import knobs
    return knobs.get_float(name, default=default)


def _emit_serve_event(etype: str, message: str = "", **attrs) -> None:
    """Serve-plane lifecycle event; ships via the worker telemetry
    channel like every other event. Never fails control-plane work."""
    from ..util import events as events_mod
    events_mod.emit_safe(etype, message, **attrs)


class _DeploymentState:
    def __init__(self, app_name: str, name: str, callable_bytes: bytes,
                 init_args, init_kwargs, config: DeploymentConfig,
                 version: str, route_prefix: Optional[str],
                 is_ingress: bool, is_asgi: bool = False):
        self.app_name = app_name
        self.name = name
        self.callable_bytes = callable_bytes
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.config = config
        self.version = version
        self.route_prefix = route_prefix
        self.is_ingress = is_ingress
        self.is_asgi = is_asgi
        self.replicas: List[ReplicaInfo] = []
        self.target_num: int = self._initial_target()
        self._replica_seq = 0
        self._last_metrics: Dict[str, float] = {}
        self._ongoing_history: List[tuple] = []  # (ts, total_ongoing)
        self._last_scale_ts = 0.0
        # shared prompt prefixes registered against this deployment
        # (serve.register_prefix): rows {"key", "prefix"}. Pushed to
        # the affinity ring owner at registration and to every replica
        # that starts afterwards, so warmth survives replacement.
        self.registered_prefixes: List[dict] = []
        # placement-group bundles reserved by a scale-up, consumed one
        # per _start_replica: [(pg_id, bundle_index), ...]
        self._pending_pg_bundles: List[tuple] = []
        # sticky-routing bindings reported by handles (router table)
        self.bindings: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.binding_counts: Dict[str, int] = {}
        self._start_failures = 0  # consecutive replica-init failures
        # replica ids killed for unhealthiness/death whose replacement
        # hasn't started yet: _start_replica pops one per start and
        # emits serve.replica.replaced linking old -> new
        self._pending_replacements: List[str] = []
        self.status = "UPDATING"
        self.message = ""

    def _initial_target(self) -> int:
        ac = self.config.autoscaling_config
        if ac is not None:
            return ac.initial_replicas if ac.initial_replicas is not None \
                else ac.min_replicas
        return self.config.num_replicas

    def next_replica_id(self) -> str:
        self._replica_seq += 1
        return f"{self.app_name}#{self.name}#{self._replica_seq}"


class ServeController:
    """Actor. Owns all deployment state; creates/destroys replica actors."""

    def __init__(self, http_options: Optional[dict] = None):
        from .autoscaler import ServeAutoscaler
        self._deployments: Dict[str, _DeploymentState] = {}  # key: app/name
        self._apps: Dict[str, List[str]] = {}  # app -> deployment keys
        # deployment states removed from _deployments that still have
        # STOPPING replicas draining; the control loop finishes them
        self._stopping_states: List[_DeploymentState] = []
        self._autoscaler = ServeAutoscaler()
        # placement-group refcounts: pg removed when its last replica is
        # gone (pg_id -> live replica count); removals queue here and
        # the control loop drains them OUTSIDE the lock (the removal is
        # a driver round trip)
        self._pg_refs: Dict[str, int] = {}
        self._pgs_to_remove: List[str] = []
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        self._http_options = http_options or {}
        self._loop_thread = threading.Thread(
            target=self._control_loop, daemon=True, name="serve-controller")
        self._loop_thread.start()

    # ---- API called by serve.api ------------------------------------------
    def deploy_application(self, app_name: str,
                           deployments: List[dict]) -> None:
        """Set target state for an app. Idempotent; changed versions roll."""
        with self._lock:
            keys = []
            for d in deployments:
                key = f"{app_name}/{d['name']}"
                keys.append(key)
                cfg = DeploymentConfig(**d["config"])
                existing = self._deployments.get(key)
                if existing is None:
                    self._deployments[key] = _DeploymentState(
                        app_name, d["name"], d["callable_bytes"],
                        d["init_args"], d["init_kwargs"], cfg, d["version"],
                        d.get("route_prefix"), d.get("is_ingress", False),
                        d.get("is_asgi", False))
                else:
                    existing.callable_bytes = d["callable_bytes"]
                    existing.init_args = d["init_args"]
                    existing.init_kwargs = d["init_kwargs"]
                    existing.config = cfg
                    existing.route_prefix = d.get("route_prefix")
                    existing.is_ingress = d.get("is_ingress", False)
                    existing.is_asgi = d.get("is_asgi", False)
                    if existing.version != d["version"]:
                        existing.version = d["version"]
                        existing.status = "UPDATING"
                    existing._start_failures = 0  # redeploy resets backoff
                    if existing.config.autoscaling_config is None:
                        existing.target_num = cfg.num_replicas
            # drop deployments removed from the app
            for key in list(self._apps.get(app_name, [])):
                if key not in keys:
                    self._stop_deployment(key)
            self._apps[app_name] = keys

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            for key in self._apps.pop(app_name, []):
                self._stop_deployment(key)

    def list_applications(self) -> Dict[str, List[str]]:
        with self._lock:
            return {a: [k.split("/", 1)[1] for k in keys]
                    for a, keys in self._apps.items()}

    def get_replicas(self, app_name: str, deployment_name: str) -> List[Any]:
        """Routing table for handles: [(replica_id, actor_handle), ...]."""
        with self._lock:
            st = self._deployments.get(f"{app_name}/{deployment_name}")
            if st is None:
                return []
            return [(r.replica_id, r.actor_handle) for r in st.replicas
                    if r.state == "RUNNING"]

    def get_deployment_info(self, app_name: str,
                            deployment_name: str) -> Optional[dict]:
        with self._lock:
            st = self._deployments.get(f"{app_name}/{deployment_name}")
            if st is None:
                return None
            return {"name": st.name, "app": st.app_name,
                    "version": st.version, "status": st.status,
                    "message": st.message,
                    "target_num_replicas": st.target_num,
                    "num_running": sum(1 for r in st.replicas
                                       if r.state == "RUNNING"),
                    "route_prefix": st.route_prefix,
                    "is_ingress": st.is_ingress,
                    "max_ongoing_requests":
                        st.config.max_ongoing_requests,
                    "max_queued_requests":
                        st.config.max_queued_requests,
                    "registered_prefixes":
                        [dict(row) for row in st.registered_prefixes]}

    # ---- scale-out router surface -----------------------------------------
    def register_prefix(self, app_name: str, deployment_name: str,
                        prefix, key: Optional[str] = None) -> str:
        """Register a shared prompt prefix against a deployment.

        The prefix is pushed (via the deployment callable's
        `register_prefix` method, e.g. LLMServer's) to the replica that
        owns `key` on the affinity hash ring — the SAME deterministic
        ring every handle routes prefix-keyed requests with, so traffic
        lands on the warm replica without coordination — and to every
        replica that starts later (replacements, scale-ups), so warmth
        survives replica death. Returns the affinity key."""
        from .router import prefix_key, ring_order
        if key is None:
            key = prefix_key(prefix)
        row = {"key": key, "prefix": prefix}
        with self._lock:
            st = self._deployments.get(f"{app_name}/{deployment_name}")
            if st is None:
                raise KeyError(
                    f"no deployment {app_name}/{deployment_name}")
            if any(r["key"] == key for r in st.registered_prefixes):
                return key               # idempotent
            st.registered_prefixes.append(row)
            running = [(r.replica_id, r.actor_handle)
                       for r in st.replicas if r.state == "RUNNING"]
        order = ring_order(key, [rid for rid, _h in running])
        if order:
            target = dict(running)[order[0]]
            try:
                # fire-and-forget: a failed push only costs the first
                # request a cold prefill (the replica registers lazily
                # through its own register_prefix handler)
                target.handle_request.remote(
                    "register_prefix", (dict(row),), {})
            except Exception:  # noqa: BLE001
                pass
        return key

    def note_session_binding(self, app_name: str, deployment_name: str,
                             key: str, replica_id: str,
                             outcome: str) -> None:
        """Handles report sticky-binding transitions here (best-effort)
        so the router table is centrally introspectable — and so a
        registered prefix FOLLOWS its key: when a key re-binds (its
        warm replica died or was diverted), the prefix is pushed to the
        new home, which re-warms it for every request after the first.
        Replacement replicas get prefixes eagerly in _check_started;
        this covers keys remapped onto pre-existing replicas."""
        push = None
        with self._lock:
            st = self._deployments.get(f"{app_name}/{deployment_name}")
            if st is None:
                return
            st.bindings[key] = {"replica_id": replica_id,
                                "outcome": outcome, "ts": time.time()}
            st.bindings.move_to_end(key)
            while len(st.bindings) > _BINDINGS_CAP:
                st.bindings.popitem(last=False)
            st.binding_counts[outcome] = \
                st.binding_counts.get(outcome, 0) + 1
            row = next((p for p in st.registered_prefixes
                        if p["key"] == key), None)
            if row is not None:
                handle = next((r.actor_handle for r in st.replicas
                               if r.replica_id == replica_id
                               and r.state == "RUNNING"), None)
                if handle is not None:
                    push = (handle, dict(row))
        if push is not None:
            try:
                # idempotent replica-side (keyed); a lost push costs
                # cold prefills until the next binding transition
                push[0].handle_request.remote(
                    "register_prefix", (push[1],), {})
            except Exception:  # noqa: BLE001
                pass

    def get_router_table(self) -> Dict[str, Any]:
        """Per-deployment routing view: RUNNING replica ids (the hash
        ring membership), registered prefixes, and the recent sticky
        bindings handles reported."""
        from .router import ring_order
        with self._lock:
            out = {}
            for dep_key, st in self._deployments.items():
                running = [r.replica_id for r in st.replicas
                           if r.state == "RUNNING"]
                out[dep_key] = {
                    "replicas": running,
                    "registered_prefixes": [
                        {"key": row["key"],
                         "owner": (ring_order(row["key"], running) or
                                   [None])[0]}
                        for row in st.registered_prefixes],
                    "bindings": {k: dict(v)
                                 for k, v in st.bindings.items()},
                    "binding_transitions": dict(st.binding_counts),
                }
            return out

    def get_autoscaler_status(self) -> Dict[str, Any]:
        """Autoscaler targets + the recent decision log (scale_up /
        scale_down rows with reasons and placement annotations)."""
        with self._lock:
            per = {}
            for dep_key, st in self._deployments.items():
                ac = st.config.autoscaling_config
                per[dep_key] = {
                    "target_num_replicas": st.target_num,
                    "num_running": sum(1 for r in st.replicas
                                       if r.state == "RUNNING"),
                    "autoscaling": None if ac is None else {
                        "min_replicas": ac.min_replicas,
                        "max_replicas": ac.max_replicas,
                        "target_ongoing_requests":
                            ac.target_ongoing_requests,
                        "ttft_slo_ms": ac.ttft_slo_ms,
                        "tpot_slo_ms": ac.tpot_slo_ms,
                        "target_queue_depth": ac.target_queue_depth},
                }
            return {"deployments": per,
                    "decisions": self._autoscaler.snapshot()}

    def get_app_status(self, app_name: str) -> dict:
        with self._lock:
            keys = self._apps.get(app_name, [])
            deps = {}
            overall = "RUNNING"  # reference ApplicationStatus: RUNNING=ok
            for key in keys:
                st = self._deployments[key]
                deps[st.name] = {"status": st.status,
                                 "replicas": len([r for r in st.replicas
                                                  if r.state == "RUNNING"]),
                                 "target": st.target_num}
                if st.status == "DEPLOY_FAILED":
                    overall = "DEPLOY_FAILED"
                elif st.status != "HEALTHY" and overall == "RUNNING":
                    overall = "DEPLOYING"
            return {"app": app_name, "status": overall,
                    "deployments": deps}

    def get_http_config(self) -> dict:
        return dict(self._http_options)

    def get_routes(self) -> Dict[str, tuple]:
        """route_prefix -> (app_name, ingress name, is_asgi)."""
        with self._lock:
            routes = {}
            for key, st in self._deployments.items():
                if st.is_ingress and st.route_prefix is not None:
                    routes[st.route_prefix] = (st.app_name, st.name,
                                               st.is_asgi)
            return routes

    def get_ingress_targets(self) -> Dict[str, str]:
        """app_name -> ingress deployment name, INCLUDING apps with
        route_prefix=None (apps with no HTTP prefix are still
        addressable by application name)."""
        with self._lock:
            return {st.app_name: st.name
                    for st in self._deployments.values()
                    if st.is_ingress}

    def list_replicas(self, app_name: str,
                      deployment_name: str) -> List[dict]:
        """Full replica-state snapshot (all states, health counters) —
        chaos tooling and tests introspect through this."""
        with self._lock:
            st = self._deployments.get(f"{app_name}/{deployment_name}")
            if st is None:
                return []
            return [{"replica_id": r.replica_id, "state": r.state,
                     "version": r.version,
                     "health_failures": r.health_failures,
                     "actor_id": getattr(r.actor_handle, "actor_id",
                                         None)}
                    for r in st.replicas]

    def graceful_shutdown(self) -> None:
        with self._lock:
            # the drain wait must honor the LONGEST configured
            # per-deployment graceful_shutdown_timeout_s (snapshot
            # before delete_application moves states to _stopping)
            max_drain = max(
                (st.config.graceful_shutdown_timeout_s
                 for st in self._deployments.values()), default=0.0)
            for app in list(self._apps):
                self.delete_application(app)
        # let the control loop finish draining STOPPING replicas before
        # tearing the loop down (bounded: drains are themselves bounded
        # by each deployment's graceful_shutdown_timeout_s)
        deadline = time.time() + max_drain + 2.0
        while time.time() < deadline:
            with self._lock:
                if not self._stopping_states:
                    break
            time.sleep(0.05)
        self._shutdown.set()

    def ping(self) -> bool:
        return True

    # ---- driver-restart persistence ---------------------------------------
    # The controller is a NAMED actor, so a resumed driver
    # (init(resume=True), core/persistence.py) restarts it and hands
    # back the last checkpoint: __ray_save__ captures the deployment
    # TARGETS (code, config, version, routes — not live replica
    # handles), __ray_restore__ re-deploys them and the reconcile loop
    # starts fresh replicas, so traffic resumes after a driver crash.
    def __ray_save__(self) -> dict:
        with self._lock:
            apps = {}
            for app, keys in self._apps.items():
                rows = []
                for key in keys:
                    st = self._deployments.get(key)
                    if st is None:
                        continue
                    rows.append({
                        "name": st.name,
                        "callable_bytes": st.callable_bytes,
                        "init_args": st.init_args,
                        "init_kwargs": st.init_kwargs,
                        "config": st.config.to_dict(),
                        "version": st.version,
                        "route_prefix": st.route_prefix,
                        "is_ingress": st.is_ingress,
                        "is_asgi": st.is_asgi,
                        "registered_prefixes":
                            [dict(p) for p in st.registered_prefixes],
                    })
                apps[app] = rows
            return {"apps": apps,
                    "http_options": dict(self._http_options)}

    def __ray_restore__(self, saved: dict) -> None:
        self._http_options = saved.get("http_options") \
            or self._http_options
        for app, deployments in (saved.get("apps") or {}).items():
            if deployments:
                self.deploy_application(app, deployments)
                # restore registered prefixes: replicas started by the
                # redeploy get them pushed on the _check_started path
                with self._lock:
                    for d in deployments:
                        st = self._deployments.get(f"{app}/{d['name']}")
                        if st is not None:
                            st.registered_prefixes = [
                                dict(p) for p in
                                (d.get("registered_prefixes") or [])]

    # ---- reconcile loop ---------------------------------------------------
    def _control_loop(self) -> None:
        import ray_tpu_torch as rt
        while not self._shutdown.is_set():
            try:
                with self._lock:
                    keys = list(self._deployments.keys())
                for key in keys:
                    # metric collection blocks on replicas -> outside lock
                    self._collect_autoscale_metrics(rt, key)
                    # autoscale decisions do driver round trips
                    # (feasibility, pg reserve) -> phased locking inside
                    self._autoscale_step(key)
                    self._reconcile(rt, key)
                self._drain_pg_removals()
                # deployments deleted mid-drain: their STOPPING replicas
                # still need the drain poll until done/timeout
                with self._lock:
                    for st in list(self._stopping_states):
                        self._check_draining(rt, st)
                        if not any(r.state == "STOPPING"
                                   for r in st.replicas):
                            self._stopping_states.remove(st)
            except Exception:  # noqa: BLE001  control loop must survive
                import traceback
                traceback.print_exc()
            self._shutdown.wait(_LOOP_PERIOD_S)

    _MAX_START_FAILURES = 3

    def _reconcile(self, rt, key: str) -> None:
        with self._lock:
            # re-check under lock: the app may have been deleted between
            # the loop's snapshot and now (else we'd resurrect replicas
            # onto an orphaned state object).
            st = self._deployments.get(key)
            if st is None:
                return
            self._check_started(rt, st)
            self._probe_health(rt, st)
            self._check_draining(rt, st)
            running = [r for r in st.replicas if r.state == "RUNNING"]
            starting = [r for r in st.replicas if r.state == "STARTING"]
            # version rollout: replace at most one stale replica per tick,
            # only when we're at/above target so capacity never dips.
            stale = [r for r in running if r.version != st.version]
            if stale and len(running) + len(starting) >= st.target_num:
                self._stop_replica(rt, st, stale[0])
            live = [r for r in st.replicas
                    if r.state in ("RUNNING", "STARTING")]
            if len(live) >= st.target_num and st._pending_replacements:
                # no deficit: the unhealthy kill was absorbed (e.g. a
                # concurrent scale-down) and no replacement will start
                # — drop the pending link so a LATER unrelated start
                # (autoscale-up) isn't mislabeled serve.replica.replaced
                st._pending_replacements.clear()
            if len(live) < st.target_num:
                if st._start_failures < self._MAX_START_FAILURES:
                    for _ in range(st.target_num - len(live)):
                        self._start_replica(rt, st)
                # else: stay DEPLOY_FAILED until a redeploy resets backoff
            elif len(live) > st.target_num:
                # prefer stopping stale versions, then the replica with
                # the FEWEST in-flight requests (live autoscale sample)
                # — draining a busy replica while an idle peer survives
                # wastes the drain window and fails more streams over
                extras = sorted(
                    live, key=lambda r: (r.version == st.version,
                                         self._replica_load(r),
                                         r.replica_id))
                for r in extras[:len(live) - st.target_num]:
                    self._stop_replica(rt, st, r)
            current = [r for r in st.replicas if r.state == "RUNNING"]
            if (len(current) >= st.target_num
                    and all(r.version == st.version for r in current)):
                st.status = "HEALTHY"
            st.replicas = [r for r in st.replicas if r.state != "DEAD"]

    def _start_replica(self, rt, st: _DeploymentState) -> None:
        from .autoscaler import PlacementGroupRef
        from .replica import Replica
        rid = st.next_replica_id()
        opts = dict(st.config.ray_actor_options)
        opts.setdefault("max_concurrency", st.config.max_ongoing_requests + 8)
        pg_id = None
        if st._pending_pg_bundles:
            # consume one reserved bundle from the latest scale-up batch
            pg_id, bundle_index = st._pending_pg_bundles.pop(0)
            opts["placement_group"] = PlacementGroupRef(pg_id)
            opts["bundle_index"] = bundle_index
        handle = rt.remote(Replica).options(**opts).remote(
            st.name, rid, st.callable_bytes, st.init_args, st.init_kwargs,
            user_config=st.config.user_config,
            max_ongoing_requests=st.config.max_ongoing_requests)
        info = ReplicaInfo(replica_id=rid, deployment_name=st.name,
                           app_name=st.app_name, version=st.version,
                           actor_handle=handle, state="STARTING",
                           start_ref=handle.ready.remote(), pg_id=pg_id)
        if pg_id:
            self._pg_refs[pg_id] = self._pg_refs.get(pg_id, 0) + 1
        st.replicas.append(info)
        if st._pending_replacements:
            old = st._pending_replacements.pop(0)
            _emit_serve_event(
                "serve.replica.replaced",
                f"replacement {rid} started for {old}",
                actor_id=getattr(handle, "actor_id", None),
                deployment=st.name, app=st.app_name,
                replaces=old, replica_id=rid)

    def _check_started(self, rt, st: _DeploymentState) -> None:
        for r in st.replicas:
            if r.state != "STARTING":
                continue
            ready, _ = rt.wait([r.start_ref], timeout=0)
            if ready:
                try:
                    rt.get(r.start_ref)
                    r.state = "RUNNING"
                    st._start_failures = 0
                    # propagate registered prefixes: every replica that
                    # starts after a register_prefix() call pre-warms
                    # them, so affinity survives replacement/scale-up
                    for row in st.registered_prefixes:
                        try:
                            r.actor_handle.handle_request.remote(
                                "register_prefix", (dict(row),), {})
                        except Exception:  # noqa: BLE001  lazy re-warm
                            pass
                except Exception as e:  # noqa: BLE001  init failed
                    r.state = "DEAD"
                    st._start_failures += 1
                    st.status = "DEPLOY_FAILED"
                    st.message = repr(e)
                    # a failed init never reaches _kill_replica, so its
                    # pg reservation must be released here or it leaks
                    self._release_pg(r.pg_id)
                    r.pg_id = None

    def _stop_replica(self, rt, st: _DeploymentState,
                      r: ReplicaInfo, graceful: bool = True) -> None:
        """Graceful: flip the replica to STOPPING — it stops admitting
        (prepare_for_shutdown sets its draining flag; routing drops it
        because get_replicas only returns RUNNING) and the drain poll
        kills it once its ongoing count (streams included) hits zero or
        graceful_shutdown_timeout_s passes. Non-graceful (unhealthy /
        never-started): immediate kill."""
        if graceful and r.state == "RUNNING":
            r.state = "STOPPING"
            r.draining_since = time.time()
            try:
                r.drain_ref = r.actor_handle.prepare_for_shutdown.remote()
            except Exception:  # noqa: BLE001  already dead
                self._kill_replica(rt, r)
            return
        self._kill_replica(rt, r)

    def _kill_replica(self, rt, r: ReplicaInfo) -> None:
        r.state = "DEAD"
        try:
            rt.kill(r.actor_handle)
        except Exception:  # noqa: BLE001
            pass
        self._release_pg(r.pg_id)
        r.pg_id = None

    def _check_draining(self, rt, st: _DeploymentState) -> None:
        """Drive STOPPING replicas to DEAD: poll the ongoing-request
        count (never blocking) and kill at zero or at the graceful
        timeout. Lock held; wait(timeout=0) only."""
        now = time.time()
        for r in st.replicas:
            if r.state != "STOPPING":
                continue
            timed_out = (now - r.draining_since
                         > st.config.graceful_shutdown_timeout_s)
            done = False
            if r.drain_ref is not None:
                ready, _ = rt.wait([r.drain_ref], timeout=0)
                if ready:
                    ref, r.drain_ref = r.drain_ref, None
                    try:
                        done = rt.get(ref) <= 0
                    except Exception:  # noqa: BLE001  replica died
                        done = True
            elif not timed_out:
                try:
                    # prepare_for_shutdown doubles as the drain poll
                    # (idempotent; counts handlers + undrained streams,
                    # unlike the autoscaler's get_queue_len)
                    r.drain_ref = \
                        r.actor_handle.prepare_for_shutdown.remote()
                except Exception:  # noqa: BLE001  replica died
                    done = True
            if done or timed_out:
                self._kill_replica(rt, r)
                _emit_serve_event(
                    "serve.replica.drain",
                    f"drain {'timed out' if timed_out and not done else 'completed'}"
                    f" after {now - r.draining_since:.2f}s",
                    actor_id=getattr(r.actor_handle, "actor_id", None),
                    deployment=st.name, app=st.app_name,
                    replica_id=r.replica_id,
                    timed_out=bool(timed_out and not done))

    # ---- active health probes ---------------------------------------------
    def _probe_health(self, rt, st: _DeploymentState) -> None:
        """Periodically probe RUNNING replicas via their health_check
        actor method; RAY_TPU_SERVE_HEALTH_THRESHOLD consecutive
        failures (error, wedged cause, timeout, or actor death) mark
        the replica unhealthy: it is killed and the reconcile pass
        below starts a replacement. Lock held; never blocks (probe
        results are collected with wait(timeout=0))."""
        period = _env_float("RAY_TPU_SERVE_HEALTH_PERIOD_S",
                            st.config.health_check_period_s)
        if period <= 0:
            return
        timeout = _env_float("RAY_TPU_SERVE_HEALTH_TIMEOUT_S",
                             st.config.health_check_timeout_s)
        threshold = max(1, int(_env_float(
            "RAY_TPU_SERVE_HEALTH_THRESHOLD",
            st.config.health_check_failure_threshold)))
        now = time.time()
        for r in list(st.replicas):
            if r.state != "RUNNING":
                continue
            if r.health_ref is not None:
                ready, _ = rt.wait([r.health_ref], timeout=0)
                if ready:
                    ref, r.health_ref = r.health_ref, None
                    try:
                        rt.get(ref)
                        r.health_failures = 0
                    except Exception as e:  # noqa: BLE001
                        self._health_failure(rt, st, r, e, threshold)
                elif now - r.last_probe_ts > timeout:
                    r.health_ref = None
                    self._health_failure(
                        rt, st, r,
                        TimeoutError(f"health probe timed out after "
                                     f"{timeout}s"), threshold)
            if (r.state == "RUNNING" and r.health_ref is None
                    and now - r.last_probe_ts >= period):
                r.last_probe_ts = now
                try:
                    r.health_ref = r.actor_handle.health_check.remote()
                except Exception as e:  # noqa: BLE001
                    self._health_failure(rt, st, r, e, threshold)

    def _health_failure(self, rt, st: _DeploymentState,
                        r: ReplicaInfo, exc: BaseException,
                        threshold: int) -> None:
        from ..exceptions import ActorDiedError
        from ..util import events as events_mod
        r.health_failures += 1
        events_mod.emit_safe(
            counter="ray_tpu_serve_health_probe_failures_total",
            counter_tags={"deployment": st.name})
        # actor death is unambiguous — no flake to tolerate, escalate
        # on the first observation instead of waiting out the threshold
        if (r.health_failures < threshold
                and not isinstance(exc, ActorDiedError)):
            return
        cause = repr(exc)
        if "EngineWedgedError" in cause:
            cause = f"wedged: {cause}"
        _emit_serve_event(
            "serve.replica.unhealthy",
            f"{r.replica_id} failed {r.health_failures} consecutive "
            f"health probes: {cause[:300]}",
            actor_id=getattr(r.actor_handle, "actor_id", None),
            deployment=st.name, app=st.app_name,
            replica_id=r.replica_id, cause=cause[:300],
            failures=r.health_failures)
        st._pending_replacements.append(r.replica_id)
        self._kill_replica(rt, r)

    def _stop_deployment(self, key: str) -> None:
        import ray_tpu_torch as rt
        st = self._deployments.pop(key, None)
        if st is None:
            return
        # pg bundles reserved by a scale-up whose replicas never
        # started: nothing will consume them now — queue the empty pgs
        # for removal or their reserved capacity leaks forever
        if st._pending_pg_bundles:
            stale = {pg for pg, _i in st._pending_pg_bundles}
            st._pending_pg_bundles.clear()
            for pg in stale:
                if self._pg_refs.get(pg, 0) <= 0:
                    self._pg_refs.pop(pg, None)
                    self._pgs_to_remove.append(pg)
        for r in st.replicas:
            self._stop_replica(rt, st, r,
                               graceful=r.state == "RUNNING")
        if any(r.state == "STOPPING" for r in st.replicas):
            self._stopping_states.append(st)

    def _collect_autoscale_metrics(self, rt, key: str) -> None:
        """Harvest + re-dispatch per-replica autoscale metric probes,
        never blocking: outstanding refs are collected with
        wait(timeout=0) and a new probe is dispatched once the previous
        answered and the sampling period elapsed. Runs for EVERY
        deployment (least-busy scale-down victim selection wants a load
        sample) — only autoscaling ones keep the windowed history.

        Settling the probe refs happens OUTSIDE the controller lock:
        wait/get are worker->driver socket round trips even for a
        ready ref, and holding the lock across them stalls every
        handle's routing-table RPC whenever the dispatcher is busy —
        the stall this controller's _autoscale_step also phase-locks
        against. Only the control loop
        settles probe refs, so the unlocked window cannot race another
        settler."""
        with self._lock:
            st = self._deployments.get(key)
            if st is None:
                return
            pending = [(r, r.metrics_ref) for r in st.replicas
                       if r.state == "RUNNING"
                       and r.metrics_ref is not None]
        settled: Dict[int, Optional[dict]] = {}
        for r, ref in pending:
            ready, _ = rt.wait([ref], timeout=0)
            if not ready:
                continue
            try:
                settled[id(r)] = rt.get(ref)
            except Exception:  # noqa: BLE001  dying replica
                settled[id(r)] = None
        with self._lock:
            st = self._deployments.get(key)
            if st is None:
                return
            ac = st.config.autoscaling_config
            now = time.time()
            period = (ac.metrics_interval_s if ac is not None
                      else _METRICS_PERIOD_S)
            total_ongoing = 0.0
            engine_agg: Dict[str, list] = {}
            have_sample = False
            for r in st.replicas:
                if r.state != "RUNNING":
                    continue
                if r.metrics_ref is not None and id(r) in settled:
                    r.metrics_ref = None
                    m = settled[id(r)]
                    if m is not None:
                        r.last_metrics = m
                if (r.metrics_ref is None
                        and now - r.metrics_dispatch_ts >= period):
                    r.metrics_dispatch_ts = now
                    try:
                        r.metrics_ref = \
                            r.actor_handle.get_autoscale_metrics.remote()
                    except Exception:  # noqa: BLE001  dying replica
                        pass
                m = r.last_metrics
                if m is None:
                    continue
                have_sample = True
                load = float(m.get("ongoing", 0)) + float(
                    m.get("streams", 0))
                eng = m.get("engine") or {}
                load += float(eng.get("queue_depth", 0) or 0)
                total_ongoing += load
                for k in ("queue_depth", "kv_util", "ttft_p50_ms",
                          "tpot_ms"):
                    v = eng.get(k)
                    if v is not None:
                        engine_agg.setdefault(k, []).append(float(v))
            if ac is None or not have_sample:
                return
            st._ongoing_history.append((now, total_ongoing))
            cutoff = now - ac.look_back_period_s
            st._ongoing_history = [(t, v) for t, v in st._ongoing_history
                                   if t >= cutoff]
            # engine SLO signals: queue depth sums across replicas, the
            # latency/utilization signals take the worst replica
            st._last_metrics = {
                "queue_depth": sum(engine_agg.get("queue_depth", [])),
            }
            for k in ("kv_util", "ttft_p50_ms", "tpot_ms"):
                if engine_agg.get(k):
                    st._last_metrics[k] = max(engine_agg[k])

    @staticmethod
    def _replica_load(r: ReplicaInfo) -> float:
        m = r.last_metrics or {}
        return (float(m.get("ongoing", 0)) + float(m.get("streams", 0)))

    def _autoscale_step(self, key: str) -> None:
        """Feed the metric window into the deployment's autoscaler
        policy (serve/autoscaler.py -> core/autoscaler.py) and apply
        the returned target: scale-up reserves placement-group bundles
        when configured, scale-down lets _reconcile drain the
        least-busy replicas.

        Three phases so the controller lock is NEVER held across a
        driver round trip (feasibility view, pg create — each a
        report_sync with a seconds-scale timeout; pinning the lock
        would stall every handle's routing-table RPC during the exact
        load spike that triggered the scale-up): decide under the
        lock, do driver I/O unlocked, re-validate and apply under the
        lock."""
        # ---- phase 1 (lock): decide ----
        with self._lock:
            st = self._deployments.get(key)
            if st is None:
                return
            ac = st.config.autoscaling_config
            if ac is None or not st._ongoing_history:
                return
            running = [r for r in st.replicas if r.state == "RUNNING"]
            if not running:
                return
            now = time.time()
            avg = (sum(v for _, v in st._ongoing_history)
                   / max(len(st._ongoing_history), 1))
            policy = self._autoscaler.policy_for(key, ac)
            busy = {r.replica_id: self._replica_load(r) for r in running}
            target, reason = policy.decide(
                now, st.target_num, avg, engine=st._last_metrics,
                per_replica_busy=busy)
            try:
                from ..util import metrics_catalog as mcat
                mcat.get("ray_tpu_serve_autoscaler_target_replicas").set(
                    float(target), tags={"deployment": st.name})
            except Exception:  # noqa: BLE001
                pass
            if target == st.target_num:
                return
            old_target = st.target_num
            direction = ("scale_up" if target > old_target
                         else "scale_down")
            if direction == "scale_down" and st._pending_pg_bundles:
                # bundles reserved by a scale-up that never started its
                # replicas: drop them so a LATER unrelated start isn't
                # pinned to a stale reservation; empty pgs queue for
                # removal (drained outside the lock)
                stale = {pg for pg, _i in st._pending_pg_bundles}
                st._pending_pg_bundles.clear()
                for pg in stale:
                    if self._pg_refs.get(pg, 0) <= 0:
                        self._pg_refs.pop(pg, None)
                        self._pgs_to_remove.append(pg)
            opts = st.config.ray_actor_options
            resources = dict(opts.get("resources") or {})
            resources.setdefault("CPU", opts.get("num_cpus", 1) or 1)
            # a replica's card is part of its demand (the reference drops
            # it): feasible_now counts free GPUs, and a placement-group
            # bundle reserves one
            if opts.get("num_gpus"):
                resources["GPU"] = float(opts["num_gpus"])
            pg_strategy = st.config.placement_group_strategy
            dep_name, app_name = st.name, st.app_name

        # ---- phase 2 (no lock): driver round trips ----
        feasible = None
        pg = None
        if direction == "scale_up":
            from .autoscaler import create_placement_group
            deficit = target - old_target
            feasible = self._autoscaler.feasible_now(resources, deficit)
            if pg_strategy:
                pg = create_placement_group(
                    [dict(resources) for _ in range(deficit)],
                    strategy=pg_strategy,
                    name=f"serve-{app_name}-{dep_name}-{int(time.time())}")

        # ---- phase 3 (lock): re-validate and apply ----
        aborted = False
        with self._lock:
            st = self._deployments.get(key)
            if st is None or st.target_num != old_target:
                # deleted or retargeted (redeploy) while unlocked:
                # drop this decision; an unconsumed reservation frees
                aborted = True
                if pg is not None:
                    self._pgs_to_remove.append(pg.pg_id)
            else:
                if pg is not None:
                    self._pg_refs.setdefault(pg.pg_id, 0)
                    st._pending_pg_bundles.extend(
                        (pg.pg_id, i) for i in range(deficit))
                self._autoscaler.record(
                    key=key, deployment=dep_name, app=app_name,
                    direction=direction, from_num=old_target,
                    to_num=target, reason=reason, feasible=feasible,
                    pg_id=pg.pg_id if pg is not None else None)
                st.target_num = target
                st._last_scale_ts = now
        if not aborted:
            _emit_serve_event(
                f"serve.autoscaler.{direction}",
                f"{key}: {old_target} -> {target} ({reason})",
                counter="ray_tpu_serve_autoscaler_scale_events_total",
                counter_tags={"deployment": dep_name,
                              "direction": direction},
                deployment=dep_name, app=app_name,
                from_replicas=old_target, to_replicas=target,
                reason=reason[:200], feasible_now=feasible,
                placement_group=pg.pg_id if pg is not None else None)

    def _release_pg(self, pg_id: Optional[str]) -> None:
        """Drop one replica's claim; the last claim queues the pg for
        removal. Lock-safe: the actual driver RPC happens when the
        control loop drains _pgs_to_remove outside the lock."""
        if not pg_id:
            return
        n = self._pg_refs.get(pg_id)
        if n is None:
            return
        n -= 1
        if n <= 0:
            self._pg_refs.pop(pg_id, None)
            self._pgs_to_remove.append(pg_id)
        else:
            self._pg_refs[pg_id] = n

    def _drain_pg_removals(self) -> None:
        """Remove released placement groups; control loop, no lock."""
        from .autoscaler import remove_placement_group
        while True:
            with self._lock:
                if not self._pgs_to_remove:
                    return
                pg_id = self._pgs_to_remove.pop(0)
            remove_placement_group(pg_id)
