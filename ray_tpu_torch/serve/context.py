"""Per-request serve context: the request deadline (counterpart of
ray_tpu/serve/context.py).

Whoever handles a request sets its absolute deadline (epoch seconds)
with `_set_request_deadline` in the thread that runs the handler;
`LLMServer` reads it with `get_request_deadline` and passes it to the
engine, which sheds a request whose deadline passed before admission;
`remaining_budget` gives a handler the seconds it has left.
"""
from __future__ import annotations

import contextvars
import time
from typing import Optional

_request_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_request_deadline", default=None)


def _set_request_deadline(deadline_ts: Optional[float]) -> None:
    _request_deadline.set(deadline_ts)


def get_request_deadline() -> Optional[float]:
    """Absolute deadline (epoch seconds) of the request being handled,
    or None when the caller set none."""
    return _request_deadline.get()


def remaining_budget() -> Optional[float]:
    """Seconds until the current request's deadline (clamped at 0), or
    None when no deadline was propagated."""
    d = _request_deadline.get()
    if d is None:
        return None
    return max(0.0, d - time.time())
