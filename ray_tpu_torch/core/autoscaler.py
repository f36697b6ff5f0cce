"""Autoscaler: demand-driven node/slice count policy.

Reference counterpart: python/ray/autoscaler (resource-demand scheduler
+ node launcher). In-image scope (SURVEY.md §2.1 C19): the POLICY —
bin-pack pending demands onto node types, respect min/max and
upscaling_speed, downscale idle nodes after a timeout — with no cloud
provisioner; on a TPU pod the "node type" is a slice shape (e.g. a
v5e-8 host with 8 chips).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NodeType:
    name: str
    resources: Dict[str, float]        # e.g. {"CPU": 8, "GPU": 8}
    min_workers: int = 0
    max_workers: int = 10


@dataclasses.dataclass
class AutoscalerConfig:
    node_types: List[NodeType]
    upscaling_speed: float = 1.0       # new nodes per existing node per round
    idle_timeout_s: float = 300.0


def upscale_step(have: int, want: int, upscaling_speed: float) -> int:
    """Launches allowed this round: at most upscaling_speed * existing
    nodes (floor 1, so a cold pool can still start). Shared by the
    node-scaling plan() below and the serve replica autoscaler, which
    models replicas as nodes of a per-deployment NodeType."""
    if want <= 0:
        return 0
    return min(want, max(1, int(upscaling_speed * max(1, have))))


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items())


def _subtract(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class Autoscaler:
    """Pure policy object: feed it demands + current nodes, get a plan."""

    def __init__(self, config: AutoscalerConfig):
        self.config = config
        self._idle_since: Dict[str, float] = {}

    def bin_pack(self, demands: List[Dict[str, float]],
                 nodes_avail: List[Tuple[str, Dict[str, float]]]
                 ) -> Tuple[List[Dict[str, float]], Dict[str, int]]:
        """First-fit-decreasing pack of demands onto existing capacity,
        then onto fresh nodes. Returns (unmet_after_plan, new_nodes)."""
        avail = [dict(r) for _, r in nodes_avail]
        unmet: List[Dict[str, float]] = []
        for d in sorted(demands, key=lambda d: -sum(d.values())):
            for a in avail:
                if _fits(a, d):
                    _subtract(a, d)
                    break
            else:
                unmet.append(d)
        new_nodes: Dict[str, int] = {}
        virtual: List[Dict[str, float]] = []
        still: List[Dict[str, float]] = []
        for d in unmet:
            for a in virtual:
                if _fits(a, d):
                    _subtract(a, d)
                    break
            else:
                nt = self._best_node_type(d)
                if nt is None:
                    still.append(d)       # infeasible on any node type
                    continue
                new_nodes[nt.name] = new_nodes.get(nt.name, 0) + 1
                fresh = dict(nt.resources)
                _subtract(fresh, d)
                virtual.append(fresh)
        return still, new_nodes

    def _best_node_type(self, demand: Dict[str, float]) -> Optional[NodeType]:
        feasible = [nt for nt in self.config.node_types
                    if _fits(dict(nt.resources), demand)]
        if not feasible:
            return None
        # smallest node that fits: cheapest marginal capacity
        return min(feasible, key=lambda nt: sum(nt.resources.values()))

    def plan(self, *, demands: List[Dict[str, float]],
             nodes: List[Dict],            # {id, type, avail, used}
             now: Optional[float] = None) -> Dict:
        """One reconcile round: scale-up for unmet demand, scale-down idle.

        nodes entries: {"id": str, "type": str, "avail": {res: qty},
        "used": {res: qty}}.
        """
        now = time.time() if now is None else now
        cfg = self.config
        counts: Dict[str, int] = {}
        for n in nodes:
            counts[n["type"]] = counts.get(n["type"], 0) + 1

        infeasible, wanted = self.bin_pack(
            demands, [(n["id"], n["avail"]) for n in nodes])

        # clamp to max_workers and upscaling_speed
        launches: Dict[str, int] = {}
        for nt in cfg.node_types:
            want = wanted.get(nt.name, 0)
            have = counts.get(nt.name, 0)
            room = max(0, nt.max_workers - have)
            launches[nt.name] = min(
                upscale_step(have, want, cfg.upscaling_speed), room)
            # honor min_workers even with zero demand
            if have + launches[nt.name] < nt.min_workers:
                launches[nt.name] = min(nt.min_workers - have, room)
        launches = {k: v for k, v in launches.items() if v > 0}

        # idle tracking + downscale candidates
        terminate: List[str] = []
        by_type = {nt.name: nt for nt in cfg.node_types}
        for n in nodes:
            busy = any(v > 0 for v in n.get("used", {}).values())
            if busy:
                self._idle_since.pop(n["id"], None)
                continue
            first_idle = self._idle_since.setdefault(n["id"], now)
            nt = by_type.get(n["type"])
            floor = nt.min_workers if nt else 0
            if (now - first_idle >= cfg.idle_timeout_s
                    and counts.get(n["type"], 0) - sum(
                        1 for t in terminate
                        if any(m["id"] == t and m["type"] == n["type"]
                               for m in nodes)) > floor):
                terminate.append(n["id"])
        return {"launch": launches, "terminate": terminate,
                "infeasible": infeasible}


def demands_from_runtime(rt) -> List[Dict[str, float]]:
    """Extract pending resource demands from a live DriverRuntime."""
    demands = []
    for spec in list(rt.pending_tasks):
        if spec.resources:
            demands.append(dict(spec.resources))
    for acspec in list(rt.pending_actors):
        if acspec.resources:
            demands.append(dict(acspec.resources))
    return demands


# ---------------------------------------------------------------------------
# Live autoscaling: a provider that actually launches/terminates node
# agents, and a reconcile loop driving the policy against a DriverRuntime.
# Reference counterpart: python/ray/autoscaler/_private/autoscaler.py
# (StandardAutoscaler) + node_launcher.py; cloud provisioners are out of
# scope — LocalNodeProvider stands in by spawning agent subprocesses,
# which is also exactly how a TPU-pod deployment adds a host.
# ---------------------------------------------------------------------------

class NodeProvider:
    """Launch/terminate nodes of a NodeType. Implementations map a
    provider-side handle to the runtime node id (they pre-choose it)."""

    def launch(self, node_type: NodeType) -> str:
        raise NotImplementedError

    def terminate(self, node_id: str) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class LocalNodeProvider(NodeProvider):
    """Spawns `python -m ray_tpu_torch.core.node` subprocesses against the
    driver's TCP address, pre-assigning each node id so the autoscaler
    can track its launches through the GCS node table."""

    def __init__(self, driver_address: str):
        import subprocess  # noqa: PLC0415
        self._subprocess = subprocess
        self.driver_address = driver_address
        self.procs: Dict[str, "object"] = {}

    def launch(self, node_type: NodeType) -> str:
        import json as _json  # noqa: PLC0415
        import os  # noqa: PLC0415
        import sys  # noqa: PLC0415
        from .ids import new_node_id  # noqa: PLC0415
        node_id = new_node_id()
        res = dict(node_type.resources)
        cpus = int(res.pop("CPU", 1))
        gpus = int(res.pop("GPU", 0))
        env = dict(os.environ)
        env["RAY_TPU_NODE_TYPE"] = node_type.name
        if gpus:
            env["RAY_TPU_GPUS"] = str(gpus)
        else:
            # CPU-only node types see no card; GPU node types keep
            # CUDA_VISIBLE_DEVICES (their gpu_capable workers must see
            # the cards).
            env["CUDA_VISIBLE_DEVICES"] = ""
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node",
               self.driver_address, "--num-cpus", str(cpus),
               "--node-id", node_id]
        if gpus:
            cmd += ["--num-gpus", str(gpus)]
        if res:
            cmd += ["--resources", _json.dumps(res)]
        self.procs[node_id] = self._subprocess.Popen(cmd, env=env)
        return node_id

    def terminate(self, node_id: str) -> None:
        proc = self.procs.pop(node_id, None)
        if proc is not None:
            try:
                proc.terminate()
            except Exception:
                pass
            import threading  # noqa: PLC0415

            def reap(proc=proc):
                try:
                    proc.wait(timeout=5)
                except Exception:
                    try:
                        proc.kill()
                        proc.wait(timeout=5)
                    except Exception:
                        pass
            threading.Thread(target=reap, daemon=True).start()

    def alive(self, node_id: str) -> bool:
        """True while the launched agent process is running (poll() also
        reaps exited children so they never zombie)."""
        proc = self.procs.get(node_id)
        if proc is None:
            return False
        if proc.poll() is not None:
            self.procs.pop(node_id, None)
            return False
        return True

    def shutdown(self) -> None:
        for nid in list(self.procs):
            self.terminate(nid)


class StandardAutoscaler:
    """Reconcile loop: pending demand -> policy plan -> provider actions.

    Scales the cluster while the runtime schedules onto whatever nodes
    exist; the driver node itself is never terminated."""

    def __init__(self, rt, config: AutoscalerConfig,
                 provider: NodeProvider, *, interval_s: float = 2.0):
        import threading  # noqa: PLC0415
        self.rt = rt
        self.policy = Autoscaler(config)
        self.provider = provider
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._launched: Dict[str, str] = {}   # node_id -> type name
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-autoscaler")
        self._thread.start()

    def _node_views(self) -> List[Dict]:
        views = []
        for ns in list(self.rt.cluster_nodes.values()):
            if not ns.alive or ns.node_id == self.rt.node_id:
                continue  # the driver host is not scalable inventory
            ntype = (self._launched.get(ns.node_id)
                     or ns.labels.get("node-type", "unknown"))
            used = {k: ns.total.get(k, 0.0) - ns.avail.get(k, 0.0)
                    for k in ns.total}
            views.append({"id": ns.node_id, "type": ntype,
                          "avail": dict(ns.avail),
                          "used": {k: v for k, v in used.items()
                                   if v > 1e-9}})
        return views

    def reconcile_once(self) -> Dict:
        demands = demands_from_runtime(self.rt)
        # A launch whose process died before registering is evicted so
        # the next tick relaunches for its demand (otherwise it would be
        # phantom in-flight capacity forever).
        alive = getattr(self.provider, "alive", None)
        if alive is not None:
            for nid in list(self._launched):
                if nid not in self.rt.cluster_nodes and not alive(nid):
                    self._launched.pop(nid, None)
        # launches still registering count as capacity-in-flight: without
        # this, every tick would relaunch for the same unmet demand.
        pending_types = [t for nid, t in self._launched.items()
                         if nid not in self.rt.cluster_nodes]
        by_name = {nt.name: nt for nt in self.policy.config.node_types}
        views = self._node_views()
        for i, tname in enumerate(pending_types):
            nt = by_name.get(tname)
            if nt is not None:
                views.append({"id": f"__pending_{i}", "type": tname,
                              "avail": dict(nt.resources),
                              "used": {"CPU": 1e-6}})  # never idle-reaped
        plan = self.policy.plan(demands=demands, nodes=views)
        for tname, count in plan["launch"].items():
            nt = by_name[tname]
            for _ in range(count):
                nid = self.provider.launch(nt)
                self._launched[nid] = tname
        for nid in plan["terminate"]:
            if nid.startswith("__pending_"):
                continue
            self.provider.terminate(nid)
            self._launched.pop(nid, None)
        return plan

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.reconcile_once()
            except Exception:
                import traceback  # noqa: PLC0415
                traceback.print_exc()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
