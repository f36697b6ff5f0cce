"""SLO-driven replica autoscaling for the serve plane (counterpart of
ray_tpu/serve/autoscaler.py).

Reference counterpart: python/ray/serve/_private/autoscaling_state.py
(metrics-driven replica targets) — but the scaling *policy* is
`core/autoscaler.py`'s: each replica is modeled as one node of a
per-deployment NodeType, so min/max replicas, the upscaling_speed step
clamp, and idle-timeout downscale all come from the same
first-fit-decreasing bin-pack policy that scales cluster hosts.

The controller feeds each deployment's live engine metrics — in-flight
requests, engine queue depth, TTFT/TPOT, KV-page utilization — into a
`DeploymentAutoscaler`, which returns a new replica target plus the
reason. Hysteresis lives here: upscale needs the breach to persist for
`upscale_delay_s`, downscale needs `downscale_delay_s` of slack, and a
change in either direction opens a cooldown before the opposite one,
so a sawtooth load cannot flap the replica set.

Placement: scale-ups can reserve a placement group (one bundle per new
replica, deployment-configurable strategy, multi-host capable) through
the driver's `sys.pg` channel; the bin-packed cluster view comes from
`sys.cluster_view`. Both work from the controller actor's worker
process — the tables themselves live only in the driver.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core.autoscaler import Autoscaler, AutoscalerConfig, NodeType
from .config import AutoscalingConfig

_SLOT = "__replica_slot__"


# ---------------------------------------------------------------------------
# Driver-table access from the controller's worker process
# ---------------------------------------------------------------------------

def cluster_view() -> List[Dict[str, Any]]:
    """[{id, total, avail, labels, is_driver}] for live nodes — direct
    when running in the driver, via the sys.cluster_view report channel
    from a worker (the controller actor)."""
    from ..core.runtime import get_runtime
    rt = get_runtime()
    if hasattr(rt, "cluster_nodes"):          # driver process
        views = []
        for ns in list(rt.cluster_nodes.values()):
            if not ns.alive:
                continue
            views.append({"id": ns.node_id, "total": dict(ns.total),
                          "avail": dict(ns.avail),
                          "labels": dict(getattr(ns, "labels", {}) or {}),
                          "is_driver": ns.node_id == rt.node_id})
        return views
    try:
        return rt.report_sync("sys.cluster_view", None, timeout=5.0) or []
    except Exception:  # noqa: BLE001  view is advisory, never fatal
        return []


class PlacementGroupRef:
    """Worker-safe stand-in for a PlacementGroup: actor options only
    read `.pg_id` off the object they are given."""

    def __init__(self, pg_id: str):
        self.pg_id = pg_id

    def __repr__(self):
        return f"PlacementGroupRef({self.pg_id})"


def create_placement_group(bundles: List[Dict[str, float]],
                           strategy: str = "SPREAD",
                           name: str = "") -> Optional[PlacementGroupRef]:
    """Reserve bundles for a scale-up batch; driver-direct or via the
    sys.pg channel from a worker. Returns None when the driver is not
    reachable (callers then place without a reservation)."""
    from ..core.runtime import get_runtime
    rt = get_runtime()
    try:
        if hasattr(rt, "cluster_nodes"):
            state = rt.placement_group(bundles, strategy, name)
            return PlacementGroupRef(state.pg_id)
        out = rt.report_sync("sys.pg", ("create", bundles, strategy, name),
                             timeout=5.0)
        return PlacementGroupRef(out["pg_id"]) if out else None
    except Exception:  # noqa: BLE001
        return None


def remove_placement_group(pg_id: str) -> None:
    from ..core.runtime import get_runtime
    rt = get_runtime()
    try:
        if hasattr(rt, "cluster_nodes"):
            rt.remove_placement_group(pg_id)
        else:
            rt.report_sync("sys.pg", ("remove", pg_id), timeout=5.0)
    except Exception:  # noqa: BLE001
        pass


# ---------------------------------------------------------------------------
# Per-deployment policy
# ---------------------------------------------------------------------------

class DeploymentAutoscaler:
    """Turns a metric window into a replica target, with hysteresis.

    The desired count starts from the reference load formula
    (`AutoscalingConfig.desired_replicas` over average in-flight +
    engine queue depth), then SLO terms can only *raise* it: engine
    queue depth per replica above `target_queue_depth`, TTFT p50 above
    `ttft_slo_ms`, TPOT above `tpot_slo_ms`, or KV-page utilization
    above `kv_util_target` each ask for one more replica. The step
    toward the target is clamped by `core/autoscaler.py` — replicas are
    nodes of a synthetic NodeType whose min/max/upscaling_speed mirror
    the deployment's AutoscalingConfig.
    """

    def __init__(self, key: str, cfg: AutoscalingConfig):
        self.key = key
        self.cfg = cfg
        self._policy = Autoscaler(AutoscalerConfig(
            node_types=[NodeType(key, {_SLOT: 1.0},
                                 min_workers=cfg.min_replicas,
                                 max_workers=cfg.max_replicas)],
            upscaling_speed=cfg.upscaling_speed,
            idle_timeout_s=cfg.downscale_delay_s))
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_change_ts = 0.0

    # -- desired count before hysteresis/step clamps ------------------------
    def _raw_desired(self, current: int, avg_load: float,
                     engine: Dict[str, float]) -> Tuple[int, str]:
        cfg = self.cfg
        desired = cfg.desired_replicas(avg_load, current)
        reason = (f"load {avg_load:.2f} vs target "
                  f"{cfg.target_ongoing_requests}/replica")
        bumps = []
        per = max(current, 1)
        q = engine.get("queue_depth", 0.0) / per
        if cfg.target_queue_depth is not None and \
                q > cfg.target_queue_depth:
            bumps.append(f"engine queue {q:.1f}/replica")
        ttft = engine.get("ttft_p50_ms")
        if cfg.ttft_slo_ms is not None and ttft is not None \
                and ttft > cfg.ttft_slo_ms:
            bumps.append(f"ttft p50 {ttft:.0f}ms > slo {cfg.ttft_slo_ms}")
        tpot = engine.get("tpot_ms")
        if cfg.tpot_slo_ms is not None and tpot is not None \
                and tpot > cfg.tpot_slo_ms:
            bumps.append(f"tpot {tpot:.1f}ms > slo {cfg.tpot_slo_ms}")
        kv = engine.get("kv_util")
        if cfg.kv_util_target is not None and kv is not None \
                and kv > cfg.kv_util_target:
            bumps.append(f"kv util {kv:.2f} > {cfg.kv_util_target}")
        if bumps:
            desired = max(desired, current + 1)
            reason = "; ".join(bumps)
        desired = int(min(max(desired, cfg.min_replicas),
                          cfg.max_replicas))
        return desired, reason

    def decide(self, now: float, current: int, avg_load: float,
               engine: Optional[Dict[str, float]] = None,
               per_replica_busy: Optional[Dict[str, float]] = None
               ) -> Tuple[int, str]:
        """(new_target, reason). new_target == current means hold.

        `per_replica_busy` maps replica_id -> in-flight count; it feeds
        the core policy's idle tracking so a replica only counts toward
        idle-timeout downscale once it has been empty for
        downscale_delay_s (and the load formula must agree).
        """
        cfg = self.cfg
        engine = engine or {}
        desired, reason = self._raw_desired(current, avg_load, engine)

        if desired > current:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since < cfg.upscale_delay_s
                    or now - self._last_change_ts < cfg.upscale_delay_s):
                return current, "upscale pending delay"
            # step clamp through the core policy: one synthetic demand
            # per missing replica, one synthetic busy node per current
            # replica; plan() applies max_workers AND upscaling_speed
            nodes = [{"id": rid, "type": self.key, "avail": {_SLOT: 0.0},
                      "used": {_SLOT: 1.0}}
                     for rid in (per_replica_busy or
                                 {f"r{i}": 1.0 for i in range(current)})]
            plan = self._policy.plan(
                demands=[{_SLOT: 1.0}] * (desired - current),
                nodes=nodes, now=now)
            step = plan["launch"].get(self.key, 0)
            if step <= 0:
                return current, "upscale clamped to zero"
            self._above_since = None
            self._last_change_ts = now
            return current + step, reason

        if desired < current:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if (now - self._below_since < cfg.downscale_delay_s
                    or now - self._last_change_ts < cfg.downscale_delay_s):
                return current, "downscale pending delay"
            self._below_since = None
            self._last_change_ts = now
            return desired, reason

        self._above_since = self._below_since = None
        return current, "steady"


# ---------------------------------------------------------------------------
# Controller-side coordinator
# ---------------------------------------------------------------------------

class ServeAutoscaler:
    """One per controller: per-deployment policies, a bounded decision
    log (surfaced by the state API / `/api/serve/autoscaler` / CLI),
    and bin-packed placement annotations for scale-ups."""

    _LOG_CAP = 256

    def __init__(self):
        self._by_key: Dict[str, DeploymentAutoscaler] = {}
        self.decisions: "collections.deque" = collections.deque(
            maxlen=self._LOG_CAP)

    def policy_for(self, key: str,
                   cfg: AutoscalingConfig) -> DeploymentAutoscaler:
        pol = self._by_key.get(key)
        if pol is None or pol.cfg is not cfg:
            pol = DeploymentAutoscaler(key, cfg)
            self._by_key[key] = pol
        return pol

    def feasible_now(self, resources: Dict[str, float],
                     count: int) -> int:
        """How many of `count` replicas (each needing `resources`) fit
        on the cluster's free capacity right now — first-fit-decreasing
        bin-pack over the live node views. Advisory: an infeasible
        replica still becomes a pending actor, which is exactly the
        demand signal the cluster-level StandardAutoscaler launches
        nodes for."""
        if count <= 0:
            return 0
        need = dict(resources) or {"CPU": 1.0}
        policy = Autoscaler(AutoscalerConfig(node_types=[]))
        unmet, _launch = policy.bin_pack(
            [dict(need)] * count,
            [(v["id"], dict(v["avail"])) for v in cluster_view()])
        return count - len(unmet)

    def record(self, *, key: str, deployment: str, app: str,
               direction: str, from_num: int, to_num: int, reason: str,
               feasible: Optional[int] = None,
               pg_id: Optional[str] = None) -> Dict[str, Any]:
        row = {"ts": time.time(), "key": key, "deployment": deployment,
               "app": app, "direction": direction, "from": from_num,
               "to": to_num, "reason": reason}
        if feasible is not None:
            row["feasible_now"] = feasible
        if pg_id:
            row["placement_group"] = pg_id
        self.decisions.append(row)
        return row

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self.decisions)


__all__ = ["DeploymentAutoscaler", "ServeAutoscaler", "cluster_view",
           "create_placement_group", "remove_placement_group",
           "PlacementGroupRef"]
