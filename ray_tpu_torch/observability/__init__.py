"""Observability of the port (counterpart of ray_tpu/observability/):
timeline tracing, the dashboard, memory accounting, post-mortem bundles
and the device profiler.

Reference counterpart: python/ray/dashboard, ray.timeline,
_private/memory_monitor.py.
"""
from .dashboard import Dashboard, start_dashboard, stop_dashboard
from .forensics import build_post_mortem, write_post_mortem
from .memory_monitor import MemoryMonitor, memory_summary
from .timeline import timeline, timeline_events
from . import profiler  # noqa: F401

__all__ = ["Dashboard", "start_dashboard", "stop_dashboard",
           "MemoryMonitor", "memory_summary", "timeline",
           "timeline_events", "profiler", "build_post_mortem",
           "write_post_mortem"]
