"""Ingress-proxy plumbing (counterpart of ray_tpu/serve/_proxy_util.py):
the controller-polling route refresh and the get-or-create-named-actor
pattern of the HTTP proxy.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

from .handle import DeploymentHandle


def refresh_routes_forever(fetch: Callable, apply: Callable,
                           period_s: float = 0.5) -> None:
    """Poll the controller forever. fetch(ctrl) returns an ObjectRef of
    the raw route table; apply(raw) runs ONLY when the table changed —
    steady state does no handle rebuilding (each DeploymentHandle keeps
    its replica cache + load-tracker state between refreshes)."""
    import ray_tpu_torch
    from .controller import CONTROLLER_NAME
    last = None
    while True:
        try:
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            raw = ray_tpu_torch.get(fetch(ctrl))
            if raw != last:
                apply(raw)
                last = raw
        except Exception:  # noqa: BLE001  controller not up yet
            pass
        time.sleep(period_s)


def rebuild_handles(old: Dict[str, DeploymentHandle],
                    wanted: Dict[str, tuple]
                    ) -> Dict[str, DeploymentHandle]:
    """wanted: key -> (app_name, deployment_name[, extra...]). Reuses
    existing handles whose target is unchanged; builds fresh ones only
    for added/retargeted keys."""
    new = {}
    for key, target in wanted.items():
        app, dep = target[0], target[1]
        cur = old.get(key)
        if (cur is not None and cur._deployment == dep
                and cur._app == app):
            new[key] = cur
        else:
            new[key] = DeploymentHandle(dep, app)
    return new


def get_or_create_proxy(name: str, cls, host: str, port: int,
                        max_concurrency: int = 8):
    """Fetch the named proxy actor or create it; returns
    (handle, bound_port)."""
    import ray_tpu_torch
    try:
        proxy = ray_tpu_torch.get_actor(name)
    except Exception:  # noqa: BLE001
        proxy = ray_tpu_torch.remote(cls).options(
            name=name, max_concurrency=max_concurrency).remote(host, port)
    return proxy, ray_tpu_torch.get(proxy.ready.remote())


__all__ = ["refresh_routes_forever", "rebuild_handles",
           "get_or_create_proxy"]
