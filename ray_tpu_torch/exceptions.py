"""Exceptions of the port (counterpart of the serve-plane part of
ray_tpu/exceptions.py).

Only the two errors the LLM engine raises are here. The class names are
the reference's: its serve plane matches retriable causes by name.
"""
from __future__ import annotations


class RayTpuTorchError(Exception):
    """Base class of the port's errors."""


class EngineWedgedError(RayTpuTorchError):
    """The LLM engine's loop made no forward progress for longer than
    its watchdog window while requests were admitted (a hung device
    call, a stuck control command). In-flight requests are aborted with
    this error and the server's health check fails until the replica is
    replaced."""


class DeadlineExceededError(RayTpuTorchError, TimeoutError):
    """The request's absolute deadline passed before it could be
    admitted: it was shed rather than run."""


__all__ = ["RayTpuTorchError", "EngineWedgedError",
           "DeadlineExceededError"]
