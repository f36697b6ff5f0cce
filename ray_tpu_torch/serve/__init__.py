"""ray_tpu_torch.serve — model serving of the port (counterpart of
ray_tpu/serve/).

Control plane: a controller actor reconciles replica actors per
deployment (health checks, autoscaling, rolling updates). Data plane:
client-side power-of-two-choices routing straight to replica actors, a
stdlib HTTP ingress, @batch coalescing, @multiplexed model caches, and
the continuous-batching LLM engine on the GPU (serve.llm), whose
`build_llm_deployment` and `build_openai_deployment` give each replica
one card.
"""
from __future__ import annotations

import importlib

from ..exceptions import (DeadlineExceededError, EngineWedgedError,
                          NoCapacityError, ReplicaDrainingError,
                          StreamInterruptedError)
from .api import (run, start, status, delete, shutdown, get_app_handle,
                  get_deployment_handle, register_prefix)
from .asgi import ingress
from .batching import batch
from .config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from .context import get_request_deadline, remaining_budget
from .deployment import Application, Deployment, deployment_decorator
from .handle import (BackPressureError, DeploymentHandle,
                     DeploymentResponse, DeploymentResponseGenerator)
from .multiplex import get_multiplexed_model_id, multiplexed

deployment = deployment_decorator


def __getattr__(name):
    if name in ("llm", "chaos", "router", "autoscaler"):
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'ray_tpu_torch.serve' has no attribute {name!r}")


__all__ = [
    "run", "start", "status", "delete", "shutdown", "get_app_handle",
    "get_deployment_handle", "ingress", "batch", "AutoscalingConfig",
    "DeploymentConfig", "HTTPOptions", "Application", "Deployment",
    "deployment", "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", "BackPressureError",
    "NoCapacityError", "DeadlineExceededError", "EngineWedgedError",
    "ReplicaDrainingError", "StreamInterruptedError",
    "get_request_deadline", "remaining_budget",
    "get_multiplexed_model_id", "multiplexed", "llm", "chaos",
    "register_prefix", "router", "autoscaler",
]
