"""joblib parallel backend running batches as ray_tpu_torch tasks.

Reference parity: ray.util.joblib (python/ray/util/joblib/__init__.py —
``register_ray()`` installs a joblib backend so scikit-learn-style
``Parallel(n_jobs=...)`` code fans out over the cluster unchanged).
Here ``register_ray_tpu()`` registers the same idea over the ray_tpu_torch
runtime: each joblib batch (a ``BatchedCalls`` callable) becomes one
remote task; results stream back through ObjectRefs.

Usage::

    import joblib
    from ray_tpu_torch.util.joblib_backend import register_ray_tpu

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch"):
        out = joblib.Parallel(n_jobs=8)(
            joblib.delayed(f)(x) for x in inputs)
"""
from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["register_ray_tpu", "RayTpuJoblibBackend"]


def _make_backend_class():
    # deferred so importing ray_tpu_torch.util never hard-requires joblib
    from joblib.parallel import AutoBatchingMixin, ParallelBackendBase

    import ray_tpu_torch
    from .. import api

    @ray_tpu_torch.remote
    def _run_batch(batch: Callable[[], Any]):
        return batch()

    class _RefFuture:
        """joblib future shim over an ObjectRef: supports get(timeout)."""

        def __init__(self, ref, callback: Optional[Callable]):
            self._ref = ref
            if callback is not None:
                import threading

                def waiter():
                    # wait (no value transfer: results fetch once, in
                    # retrieve_result); the callback paces joblib's
                    # dispatcher and must fire on failure too
                    try:
                        ray_tpu_torch.wait([ref], num_returns=1, timeout=None)
                    finally:
                        callback(None)
                threading.Thread(target=waiter, daemon=True).start()

        def get(self, timeout: Optional[float] = None):
            return ray_tpu_torch.get(self._ref, timeout=timeout)

    class RayTpuJoblibBackend(AutoBatchingMixin, ParallelBackendBase):
        supports_timeout = True
        supports_retrieve_callback = False

        def configure(self, n_jobs: int = 1, parallel=None, **_kw) -> int:
            if not api.is_initialized():
                api.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs: int) -> int:
            # joblib contract (cf. LokyBackend): None -> 1, 0 -> error,
            # -1 -> everything (here: the CLUSTER's CPUs, not local cores)
            if n_jobs is None or n_jobs == 1:
                return 1
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 in Parallel has no meaning")
            total = api._ensure_init().get_resources().get("CPU", 1.0)
            if n_jobs < 0:
                return max(1, int(total))
            return max(1, min(int(n_jobs), int(total)))

        def submit(self, func: Callable[[], Any],
                   callback: Optional[Callable] = None) -> _RefFuture:
            return _RefFuture(_run_batch.remote(func), callback)

        # joblib < 1.4 calls apply_async; same protocol
        def apply_async(self, func: Callable[[], Any],
                        callback: Optional[Callable] = None) -> _RefFuture:
            return self.submit(func, callback)

        def abort_everything(self, ensure_ready: bool = True) -> None:
            # Tasks already dispatched run to completion (ray semantics:
            # joblib abort doesn't force-kill remote workers); nothing to
            # reclaim — the runtime owns the worker pool.
            if ensure_ready:
                self.configure(n_jobs=self.parallel.n_jobs,
                               parallel=self.parallel)

    return RayTpuJoblibBackend


_backend_cls = None


def _get_backend_class():
    global _backend_cls
    if _backend_cls is None:
        _backend_cls = _make_backend_class()
    return _backend_cls


def register_ray_tpu() -> None:
    """Register the 'ray_tpu_torch' joblib backend (idempotent: the same class
    object is reused across calls)."""
    from joblib.parallel import BACKENDS, register_parallel_backend

    cls = _get_backend_class()
    if BACKENDS.get("ray_tpu_torch") is not cls:
        register_parallel_backend("ray_tpu_torch", cls)


# Resolved lazily for `from ray_tpu_torch.util.joblib_backend import
# RayTpuJoblibBackend` introspection without forcing registration;
# identity is stable (memoized) and matches the registered class.
def __getattr__(name: str):
    if name == "RayTpuJoblibBackend":
        return _get_backend_class()
    raise AttributeError(name)
