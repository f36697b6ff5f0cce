"""Observability of the port (counterpart of ray_tpu/observability/):
so far the device profiler. The timeline, dashboard and cluster state
views need the runtime and wait for a later slice."""
from . import profiler

__all__ = ["profiler"]
