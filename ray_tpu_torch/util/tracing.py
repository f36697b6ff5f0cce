"""Cross-process trace-span context.

Reference counterpart: OpenTelemetry-style span propagation through
ray.remote submissions (python/ray/util/tracing/). Kept dependency-free:
a span context is just (trace_id, span_id) carried on the TaskSpec; the
submitting side stamps the spec with a fresh submit-span id parented to
whatever span is active on the current thread, and the executing worker
opens a child execution span whose record ships back to the driver over
the telemetry channel (core/worker.py) so observability/timeline.py can
export one parented tree across processes.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Optional, Tuple

from ..core.ids import rand_hex

_local = threading.local()


def new_span_id() -> str:
    return rand_hex(16)


def new_trace_id() -> str:
    return rand_hex(32)


def derived_span_id(*parts) -> str:
    """Deterministic span id from structural coordinates (e.g.
    ``(dag_id, stage_id, seqno)``). Both endpoints of a zero-driver hop
    can derive the SAME id independently, so compiled-DAG stage spans
    parent across processes without any driver coordination or extra
    wire traffic."""
    key = ".".join(str(p) for p in parts).encode()
    return hashlib.blake2b(key, digest_size=8).hexdigest()


def derived_trace_id(*parts) -> str:
    """Deterministic trace id companion to derived_span_id."""
    key = ".".join(str(p) for p in parts).encode()
    return hashlib.blake2b(key, digest_size=16).hexdigest()


def current() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the span active on this thread, or None."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def active(trace_id: str, span_id: str):
    """Make (trace_id, span_id) the current span for this thread; tasks
    submitted inside the block parent to it."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = (trace_id, span_id)
    try:
        yield
    finally:
        _local.ctx = prev


def submit_context() -> Tuple[str, str, str]:
    """(trace_id, span_id, parent_span_id) for a task being submitted on
    this thread. The returned span_id names the SUBMIT span (queued →
    dispatched, driver side); the worker's execution span parents to it."""
    ctx = current()
    if ctx is None:
        return new_trace_id(), new_span_id(), ""
    return ctx[0], new_span_id(), ctx[1]
