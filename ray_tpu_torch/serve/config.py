"""Serve configuration dataclasses (counterpart of
ray_tpu/serve/config.py).

Reference parity: python/ray/serve/config.py (AutoscalingConfig,
HTTPOptions) and python/ray/serve/schema.py (deployment options). Kept
pydantic-free: plain dataclasses with validation in __post_init__.
"""
from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-depth-driven autoscaling policy (reference:
    serve/config.py::AutoscalingConfig + autoscaling_policy.py)."""
    min_replicas: int = 1
    initial_replicas: Optional[int] = None
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    metrics_interval_s: float = 0.5
    look_back_period_s: float = 5.0
    upscaling_factor: float = 1.0
    downscaling_factor: float = 1.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    # step clamp fed into core/autoscaler.py's policy: at most
    # max(1, int(upscaling_speed * current)) new replicas per decision
    upscaling_speed: float = 1.0
    # SLO terms (serve/autoscaler.py): each may only RAISE the desired
    # count computed from the load formula above. None disables a term.
    target_queue_depth: Optional[float] = None   # engine queue / replica
    ttft_slo_ms: Optional[float] = None
    tpot_slo_ms: Optional[float] = None
    kv_util_target: Optional[float] = 0.9        # KV pages in use / pool

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(self.min_replicas, 1):
            raise ValueError("max_replicas must be >= min_replicas and >= 1")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        """The reference formula: replicas scaled by load/target ratio."""
        if current == 0:
            return max(self.min_replicas, 1) if total_ongoing > 0 else \
                self.min_replicas
        per_replica = total_ongoing / current
        ratio = per_replica / self.target_ongoing_requests
        if ratio > 1.0:
            desired = current * (1 + (ratio - 1) * self.upscaling_factor)
            import math
            desired = math.ceil(desired)
        elif ratio < 1.0:
            desired = current * (1 - (1 - ratio) * self.downscaling_factor)
            import math
            desired = math.floor(desired) if desired >= self.min_replicas \
                else self.min_replicas
        else:
            desired = current
        return int(min(max(desired, self.min_replicas), self.max_replicas))


@dataclass
class DeploymentConfig:
    """Resolved per-deployment options (reference: serve/schema.py
    DeploymentSchema + serve/api.py::deployment kwargs)."""
    num_replicas: int = 1
    max_ongoing_requests: int = 5
    max_queued_requests: int = -1  # -1 == unbounded
    user_config: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    graceful_shutdown_timeout_s: float = 5.0
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 5.0
    health_check_failure_threshold: int = 3
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    # when set (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD), autoscale-ups
    # reserve a placement group with one bundle per new replica before
    # starting them (multi-host capable placement)
    placement_group_strategy: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.autoscaling_config, dict):
            self.autoscaling_config = AutoscalingConfig(
                **self.autoscaling_config)
        if self.num_replicas is not None and self.num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if self.placement_group_strategy is not None:
            from ..util.placement_group import VALID_STRATEGIES
            if self.placement_group_strategy not in VALID_STRATEGIES:
                raise ValueError(
                    f"placement_group_strategy must be one of "
                    f"{VALID_STRATEGIES}")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def default_request_timeout_s() -> float:
    """Per-request budget when the client supplies no deadline (the
    HTTP X-Serve-Timeout-S header)."""
    from ..util import knobs
    return knobs.get_float("RAY_TPU_SERVE_REQUEST_TIMEOUT_S")


@dataclass
class HTTPOptions:
    """Reference: serve/config.py::HTTPOptions (host/port/root_path)."""
    host: str = "127.0.0.1"
    port: int = 8000
    root_path: str = ""


@dataclass
class ReplicaInfo:
    """Controller-side record of one running replica."""
    replica_id: str
    deployment_name: str
    app_name: str
    version: str
    actor_handle: Any = None
    state: str = "STARTING"  # STARTING | RUNNING | STOPPING | DEAD
    start_ref: Any = None    # ObjectRef of the readiness probe
    # active health probing (controller reconcile loop)
    health_ref: Any = None       # outstanding health_check ObjectRef
    last_probe_ts: float = 0.0   # when the last probe was dispatched
    health_failures: int = 0     # consecutive probe failures
    # graceful drain (rolling update / scale-down / shutdown)
    draining_since: float = 0.0  # 0 = not draining
    drain_ref: Any = None        # outstanding ongoing-count ObjectRef
    # live autoscale metrics (controller reconcile loop; non-blocking)
    metrics_ref: Any = None      # outstanding get_autoscale_metrics ref
    metrics_dispatch_ts: float = 0.0
    last_metrics: Optional[Dict[str, Any]] = None
    # placement-group reservation this replica was started into
    pg_id: Optional[str] = None
