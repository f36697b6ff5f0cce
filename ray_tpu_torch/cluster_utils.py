"""Local multi-node test clusters (reference: ray.cluster_utils.Cluster).

Spins up a driver with a TCP listener plus N node agents as local
subprocesses — the same path real multi-host deployments use
(`python -m ray_tpu_torch.core.node`), so tests and demos exercise true
cross-node scheduling and object transfer on one machine.

The head's `init` counts the host's cards, as any driver does. Every
agent is started with an explicit `--num-gpus` (default 0): an agent left
to count would count the same host's cards again, and a one-card host
would report a card per agent.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional


class Cluster:
    def __init__(self, *, initialize_head: bool = True, head_cpus: int = 4,
                 connect: bool = True, **_compat):
        self._agents: List[subprocess.Popen] = []
        self._rt = None
        if initialize_head:
            import ray_tpu_torch
            self._rt = ray_tpu_torch.init(num_cpus=head_cpus,
                                          listen="127.0.0.1:0")

    @property
    def address(self) -> Optional[str]:
        return getattr(self._rt, "tcp_address", None)

    def add_node(self, *, num_cpus: int = 2, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 env: Optional[Dict[str, str]] = None,
                 wait: bool = True, timeout: float = 30.0):
        """Start one node agent joined to the head; returns its node id
        once registered (wait=True)."""
        if self._rt is None:
            raise RuntimeError("cluster has no head (initialize_head=False)")
        before = set(self._rt.cluster_nodes)
        agent_env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        agent_env["PYTHONPATH"] = os.pathsep.join(
            [repo, *agent_env.get("PYTHONPATH", "").split(os.pathsep)])
        agent_env.update(env or {})
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node", self.address,
               "--num-cpus", str(num_cpus), "--num-gpus", str(num_gpus)]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        proc = subprocess.Popen(cmd, env=agent_env, cwd=repo)
        self._agents.append(proc)
        if not wait:
            return None
        deadline = time.time() + timeout
        while time.time() < deadline:
            new = set(self._rt.cluster_nodes) - before
            if new:
                return next(iter(new))
            if proc.poll() is not None:
                raise RuntimeError(
                    f"node agent exited rc={proc.returncode}")
            time.sleep(0.05)
        raise TimeoutError("node agent failed to register")

    def shutdown(self):
        import ray_tpu_torch
        ray_tpu_torch.shutdown()
        for p in self._agents:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        self._agents.clear()
        self._rt = None

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


__all__ = ["Cluster"]
