"""Deterministic serve-plane fault injection (counterpart of
ray_tpu/serve/chaos.py).

Fault-tolerance tests and recovery-time measurements need to break a
CHOSEN replica at a CHOSEN moment — not wait for entropy. This module is the
one sanctioned way to do that: every helper targets one replica of one
deployment through the controller's routing table, so a test reads as
"kill replica 0 mid-stream; assert the failover chain".

Fault modes (see Replica.chaos for the replica-side halves):

- ``kill_replica``     — hard-kill the replica actor (preemption /
  OOM-kill stand-in); in-flight calls raise ActorDiedError.
- ``crash_replica``    — the replica process os._exit()s itself
  (segfault stand-in; exercises the same death path from inside).
- ``wedge_replica``    — stall the hosted LLM engine's loop thread so
  the REAL watchdog declares it wedged (hung device call stand-in).
- ``hang_health``      — health probes block until the controller's
  probe timeout fires.
- ``fail_health``      — health probes raise (generic sickness).
- ``delay_replica``    — every request sleeps first (slow replica).
- ``reset``            — clear injected delay/health modes.

All helpers are no-ops on deployments they can't find — chaos should
fail tests through ASSERTIONS, not through tooling errors.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple


def _controller():
    import ray_tpu_torch
    from .controller import CONTROLLER_NAME
    return ray_tpu_torch.get_actor(CONTROLLER_NAME)


def list_replicas(app_name: str, deployment_name: str) -> List[dict]:
    """Controller-side replica snapshots (all states, health counters)."""
    import ray_tpu_torch
    return ray_tpu_torch.get(_controller().list_replicas.remote(
        app_name, deployment_name))


def running_replicas(app_name: str,
                     deployment_name: str) -> List[Tuple[str, Any]]:
    """[(replica_id, actor_handle)] for RUNNING replicas."""
    import ray_tpu_torch
    return ray_tpu_torch.get(_controller().get_replicas.remote(
        app_name, deployment_name))


def _pick(app_name: str, deployment_name: str,
          replica_id: Optional[str], index: int) -> Tuple[str, Any]:
    reps = running_replicas(app_name, deployment_name)
    if not reps:
        raise LookupError(
            f"no RUNNING replicas for {app_name}/{deployment_name}")
    if replica_id is not None:
        for rid, handle in reps:
            if rid == replica_id:
                return rid, handle
        raise LookupError(f"replica {replica_id!r} not RUNNING")
    return reps[index % len(reps)]


def kill_replica(app_name: str = "default",
                 deployment_name: str = "", *,
                 replica_id: Optional[str] = None,
                 index: int = 0) -> str:
    """Hard-kill one RUNNING replica actor (external preemption).
    Returns the killed replica id; in-flight requests on it raise
    ActorDiedError and fail over."""
    import ray_tpu_torch
    rid, handle = _pick(app_name, deployment_name, replica_id, index)
    ray_tpu_torch.kill(handle)
    return rid


def crash_replica(app_name: str = "default",
                  deployment_name: str = "", *,
                  replica_id: Optional[str] = None,
                  index: int = 0) -> str:
    """The replica process exits itself (os._exit) — same death path as
    a segfault, observed from inside rather than via ray_tpu_torch.kill."""
    rid, handle = _pick(app_name, deployment_name, replica_id, index)
    handle.chaos.remote("die")   # never completes; the process is gone
    return rid


def wedge_replica(app_name: str = "default",
                  deployment_name: str = "", *,
                  seconds: float = 3600.0,
                  replica_id: Optional[str] = None,
                  index: int = 0) -> str:
    """Stall the replica's LLM engine loop for `seconds` so the real
    watchdog path fires (llm_engine.wedged -> health fail `wedged` ->
    replacement). Only valid on replicas hosting an engine."""
    import ray_tpu_torch
    rid, handle = _pick(app_name, deployment_name, replica_id, index)
    ray_tpu_torch.get(handle.chaos.remote("wedge", seconds))
    return rid


def hang_health(app_name: str = "default", deployment_name: str = "", *,
                replica_id: Optional[str] = None, index: int = 0) -> str:
    """Health probes on the chosen replica block until the controller's
    probe timeout (RAY_TPU_SERVE_HEALTH_TIMEOUT_S) declares failure."""
    import ray_tpu_torch
    rid, handle = _pick(app_name, deployment_name, replica_id, index)
    ray_tpu_torch.get(handle.chaos.remote("health_hang"))
    return rid


def fail_health(app_name: str = "default", deployment_name: str = "", *,
                replica_id: Optional[str] = None, index: int = 0) -> str:
    """Health probes on the chosen replica raise immediately."""
    import ray_tpu_torch
    rid, handle = _pick(app_name, deployment_name, replica_id, index)
    ray_tpu_torch.get(handle.chaos.remote("health_fail"))
    return rid


def delay_replica(app_name: str = "default",
                  deployment_name: str = "", *, seconds: float,
                  replica_id: Optional[str] = None,
                  index: int = 0) -> str:
    """Every request admitted by the chosen replica sleeps `seconds`
    before running (slow-replica / deadline-pressure scenarios)."""
    import ray_tpu_torch
    rid, handle = _pick(app_name, deployment_name, replica_id, index)
    ray_tpu_torch.get(handle.chaos.remote("delay", seconds))
    return rid


def reset(app_name: str = "default", deployment_name: str = "") -> None:
    """Clear injected delay/health chaos on every RUNNING replica."""
    import ray_tpu_torch
    for _rid, handle in running_replicas(app_name, deployment_name):
        try:
            ray_tpu_torch.get(handle.chaos.remote("reset"))
        except Exception:  # noqa: BLE001
            pass


def wait_for_replacement(app_name: str, deployment_name: str,
                         dead_replica_id: str,
                         timeout_s: float = 30.0) -> List[str]:
    """Block until the controller runs a replacement RUNNING replica
    that is not `dead_replica_id`; returns the RUNNING ids."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        ids = [rid for rid, _h in running_replicas(
            app_name, deployment_name)]
        if ids and dead_replica_id not in ids:
            return ids
        time.sleep(0.05)
    raise TimeoutError(
        f"no replacement for {dead_replica_id} after {timeout_s}s")


__all__ = ["list_replicas", "running_replicas", "kill_replica",
           "crash_replica", "wedge_replica", "hang_health",
           "fail_health", "delay_replica", "reset",
           "wait_for_replacement"]
