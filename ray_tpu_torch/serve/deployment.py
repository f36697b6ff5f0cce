"""Deployment & Application graph objects (counterpart of
ray_tpu/serve/deployment.py).

Reference parity: python/ray/serve/deployment.py (Deployment, .bind,
.options) + serve/dag.py (the bound-application graph). `.bind()` captures
init args — which may themselves be bound sub-deployments; `serve.run`
walks the graph, deploys every node, and wires DeploymentHandles in place
of the bound children (reference: _private/build_app.py).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Tuple

from ..core import serialization
from .config import AutoscalingConfig, DeploymentConfig


class Application:
    """A deployment bound with its init args (possibly nested apps)."""

    def __init__(self, deployment: "Deployment", args: Tuple, kwargs: Dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs

    @property
    def deployment(self) -> "Deployment":
        return self._deployment


class Deployment:
    def __init__(self, target, name: str,
                 config: Optional[DeploymentConfig] = None,
                 version: Optional[str] = None,
                 route_prefix: Optional[str] = "/"):
        self._target = target
        self._name = name
        self._config = config or DeploymentConfig()
        self._version = version
        self._route_prefix = route_prefix
        self._target_bytes: Optional[bytes] = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def config(self) -> DeploymentConfig:
        return self._config

    @property
    def route_prefix(self) -> Optional[str]:
        return self._route_prefix

    @property
    def is_asgi(self) -> bool:
        """True when the callable was wrapped by serve.ingress(app) —
        the HTTP proxy then ships raw requests instead of JSON bodies."""
        from .asgi import ASGI_ATTR  # noqa: PLC0415
        return bool(getattr(self._target, ASGI_ATTR, False))

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[Any] = None,
                max_ongoing_requests: Optional[int] = None,
                max_queued_requests: Optional[int] = None,
                user_config: Optional[dict] = None,
                autoscaling_config: Optional[Any] = None,
                version: Optional[str] = None,
                route_prefix: Optional[str] = "__unset__",
                health_check_period_s: Optional[float] = None,
                health_check_timeout_s: Optional[float] = None,
                health_check_failure_threshold: Optional[int] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                ray_actor_options: Optional[dict] = None,
                placement_group_strategy: Optional[str] = "__unset__",
                ) -> "Deployment":
        cfg = DeploymentConfig(**self._config.to_dict())
        if num_replicas == "auto":
            if autoscaling_config is None:
                autoscaling_config = AutoscalingConfig(
                    min_replicas=1, max_replicas=100,
                    target_ongoing_requests=2.0)
            num_replicas = None
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if user_config is not None:
            cfg.user_config = user_config
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                autoscaling_config if isinstance(
                    autoscaling_config, AutoscalingConfig)
                else AutoscalingConfig(**autoscaling_config))
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if health_check_timeout_s is not None:
            cfg.health_check_timeout_s = health_check_timeout_s
        if health_check_failure_threshold is not None:
            cfg.health_check_failure_threshold = \
                health_check_failure_threshold
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if placement_group_strategy != "__unset__":
            cfg.placement_group_strategy = placement_group_strategy
        return Deployment(
            self._target, name or self._name, cfg,
            version if version is not None else self._version,
            self._route_prefix if route_prefix == "__unset__"
            else route_prefix)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    # ---- controller payload ----------------------------------------------
    def callable_bytes(self) -> bytes:
        if self._target_bytes is None:
            self._target_bytes = serialization.dumps_call(self._target)
        return self._target_bytes

    def version_hash(self) -> str:
        """Code+config identity; a change triggers rolling replacement
        (reference: serve/_private/version.py::DeploymentVersion)."""
        h = hashlib.sha1()
        h.update(self.callable_bytes())
        h.update(repr(sorted((self._config.user_config or {}).items()))
                 .encode())
        if self._version:
            h.update(self._version.encode())
        return h.hexdigest()[:16]


def deployment_decorator(target=None, *, name: Optional[str] = None,
                         num_replicas=None, max_ongoing_requests=None,
                         max_queued_requests=None, user_config=None,
                         autoscaling_config=None, version=None,
                         route_prefix="/", health_check_period_s=None,
                         health_check_timeout_s=None,
                         health_check_failure_threshold=None,
                         graceful_shutdown_timeout_s=None,
                         ray_actor_options=None,
                         placement_group_strategy="__unset__", **_compat):
    """@serve.deployment — wraps a class or function into a Deployment."""

    def wrap(t):
        d = Deployment(t, name or t.__name__, route_prefix=route_prefix)
        return d.options(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            user_config=user_config, autoscaling_config=autoscaling_config,
            version=version,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            health_check_failure_threshold=health_check_failure_threshold,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=ray_actor_options,
            placement_group_strategy=placement_group_strategy)

    if target is not None:  # bare @serve.deployment
        return wrap(target)
    return wrap
