"""serve.run / shutdown / status — the user-facing control API
(counterpart of ray_tpu/serve/api.py).

Reference parity: python/ray/serve/api.py (run, delete, status,
get_deployment_handle, get_app_handle) + _private/api.py (controller
bootstrap). The application graph from `.bind()` is flattened here:
nested Applications in init args are deployed too and replaced with
DeploymentHandles before the args ship to replicas.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .config import HTTPOptions
from .controller import CONTROLLER_NAME, ServeController
from .deployment import Application, Deployment
from .handle import DeploymentHandle

_DEFAULT_APP = "default"


def _get_or_start_controller(http_options: Optional[HTTPOptions] = None):
    import ray_tpu_torch
    ray_tpu_torch.init()
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001  not started yet
        opts = http_options or HTTPOptions()
        # checkpoint_interval_s throttles the controller's __ray_save__
        # (deployment-target persistence for driver restart): without
        # it every routing-table RPC would ship a checkpoint blob
        ctrl = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, max_concurrency=16,
            checkpoint_interval_s=0.5).remote(
            {"host": opts.host, "port": opts.port,
             "root_path": opts.root_path})
        ray_tpu_torch.get(ctrl.ping.remote())
        return ctrl


def start(http_options: Optional[HTTPOptions] = None, **_kw):
    """Explicitly start the serve instance (reference: serve.start)."""
    return _get_or_start_controller(http_options)


def _flatten_app(app: Application, app_name: str,
                 out: Dict[str, dict], is_ingress: bool) -> DeploymentHandle:
    """DFS the bound graph; returns the handle standing in for `app`."""
    d = app.deployment

    def convert(v):
        if isinstance(v, Application):
            return _flatten_app(v, app_name, out, is_ingress=False)
        return v

    args = tuple(convert(a) for a in app._args)
    kwargs = {k: convert(v) for k, v in app._kwargs.items()}
    if d.name in out:
        prev = out[d.name]
        if (prev["version"] != d.version_hash()
                or prev["init_args"] != args
                or prev["init_kwargs"] != kwargs):
            raise ValueError(
                f"two deployments named {d.name!r} with different code or "
                f"init args in one app; use .options(name=...) to "
                f"disambiguate")
    else:
        out[d.name] = {
            "name": d.name,
            "callable_bytes": d.callable_bytes(),
            "init_args": args,
            "init_kwargs": kwargs,
            "config": d.config.to_dict(),
            "version": d.version_hash(),
            "route_prefix": d.route_prefix if is_ingress else None,
            "is_ingress": is_ingress,
            "is_asgi": d.is_asgi,
        }
    return DeploymentHandle(d.name, app_name)


_ROUTE_UNSET = object()


def run(target: Application, *, name: str = _DEFAULT_APP,
        route_prefix=_ROUTE_UNSET, blocking: bool = False,
        _local_testing_mode: bool = False,
        wait_for_ready_timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress.

    route_prefix overrides the ingress deployment's own prefix only when
    passed explicitly — apps built with a baked-in prefix (e.g.
    build_openai_deployment's "/v1") keep it by default.
    """
    import ray_tpu_torch
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"serve.run expects an Application (from .bind()); "
                        f"got {type(target)}")
    if route_prefix is not _ROUTE_UNSET and route_prefix is not None:
        ingress_d = target.deployment
        if ingress_d.route_prefix != route_prefix:
            target = Application(
                ingress_d.options(route_prefix=route_prefix),
                target._args, target._kwargs)
    ctrl = _get_or_start_controller()
    deployments: Dict[str, dict] = {}
    ingress_handle = _flatten_app(target, name, deployments, is_ingress=True)
    ray_tpu_torch.get(ctrl.deploy_application.remote(
        name, list(deployments.values())))
    _wait_healthy(ctrl, name, wait_for_ready_timeout_s)
    if blocking:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return ingress_handle


def _wait_healthy(ctrl, app_name: str, timeout_s: float):
    import ray_tpu_torch
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        status = ray_tpu_torch.get(ctrl.get_app_status.remote(app_name))
        if status["status"] == "RUNNING" or (
                status["deployments"]
                and all(d["replicas"] >= d["target"] and d["target"] > 0
                        for d in status["deployments"].values())):
            return
        if status["status"] == "DEPLOY_FAILED":
            raise RuntimeError(f"deploy failed: {status}")
        time.sleep(0.05)
    raise TimeoutError(
        f"app {app_name!r} not healthy after {timeout_s}s")


def status() -> Dict[str, Any]:
    import ray_tpu_torch
    ctrl = _get_or_start_controller()
    apps = ray_tpu_torch.get(ctrl.list_applications.remote())
    return {"applications": {
        a: ray_tpu_torch.get(ctrl.get_app_status.remote(a)) for a in apps}}


def delete(name: str, _blocking: bool = True):
    import ray_tpu_torch
    ctrl = _get_or_start_controller()
    ray_tpu_torch.get(ctrl.delete_application.remote(name))


def get_app_handle(name: str = _DEFAULT_APP) -> DeploymentHandle:
    import ray_tpu_torch
    ctrl = _get_or_start_controller()
    routes = ray_tpu_torch.get(ctrl.get_routes.remote())
    for _prefix, target in routes.items():
        if target[0] == name:
            return DeploymentHandle(target[1], target[0])
    apps = ray_tpu_torch.get(ctrl.list_applications.remote())
    if name in apps and apps[name]:
        return DeploymentHandle(apps[name][0], name)
    raise KeyError(f"no application named {name!r}")


def get_deployment_handle(deployment_name: str,
                          app_name: str = _DEFAULT_APP) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def register_prefix(prefix, *, key: Optional[str] = None,
                    app_name: str = _DEFAULT_APP,
                    deployment_name: Optional[str] = None) -> str:
    """Register a shared prompt prefix (e.g. a system prompt) against a
    deployment for warm-KV affinity routing.

    The controller pre-fills it on the replica that owns the returned
    affinity key on the routing hash ring, and on every replica started
    later (replacements / scale-ups). Requests whose prompt starts with
    the prefix are then sticky-routed to the warm replica by every
    handle and proxy (serve/router.py). The deployment's callable must
    expose a `register_prefix` method (LLMServer does). Returns the
    affinity key."""
    import ray_tpu_torch
    ctrl = _get_or_start_controller()
    if deployment_name is None:
        ingress = ray_tpu_torch.get(ctrl.get_ingress_targets.remote())
        deployment_name = ingress.get(app_name)
        if deployment_name is None:
            raise KeyError(f"no application named {app_name!r}")
    return ray_tpu_torch.get(ctrl.register_prefix.remote(
        app_name, deployment_name, prefix, key))


def shutdown():
    """Tear down all serve apps and the controller."""
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        return
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001
        return
    try:
        # generous bound: graceful_shutdown itself waits up to the
        # longest per-deployment graceful_shutdown_timeout_s for
        # in-flight work to drain (returns immediately when idle)
        ray_tpu_torch.get(ctrl.graceful_shutdown.remote(), timeout=30)
    except Exception:  # noqa: BLE001
        pass
    try:
        # kill must run even when the drain wait timed out above — a
        # surviving named controller with a stopped reconcile loop
        # would be silently reused by the next serve.run()
        ray_tpu_torch.kill(ctrl)
    except Exception:  # noqa: BLE001
        pass
