"""multiprocessing.Pool-compatible API over ray_tpu_torch tasks.

Reference parity: python/ray/util/multiprocessing (Pool running on ray
tasks) — drop-in for the stdlib Pool shapes people actually use: map /
starmap / imap / imap_unordered / apply / apply_async, close/terminate/
join, context manager. Work is chunked into remote tasks; `processes`
bounds how many chunks are in flight at once (the runtime's scheduler
does the real placement).
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterable, List, Optional, Union

from .. import api as _api
from ..core.object_ref import ObjectRef


class AsyncResult:
    """Matches multiprocessing.pool.AsyncResult."""

    def __init__(self, refs: Union[ObjectRef, List[ObjectRef]],
                 flatten: bool = False):
        self._refs = refs if isinstance(refs, list) else [refs]
        self._flatten = flatten

    def get(self, timeout: Optional[float] = None):
        out = _api.get(self._refs, timeout=timeout)
        if self._flatten:
            return list(itertools.chain.from_iterable(out))
        return out[0] if len(self._refs) == 1 else out

    def wait(self, timeout: Optional[float] = None) -> None:
        _api.wait(self._refs, num_returns=len(self._refs),
                  timeout=timeout)

    def ready(self) -> bool:
        ready, _ = _api.wait(self._refs, num_returns=len(self._refs),
                             timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        """True iff every task finished without error. Reads the sealed
        object state — no value fetch, so big/cross-node results can't
        fake a failure via a fetch timeout."""
        if not self.ready():
            raise ValueError("result is not ready")
        from ..core import runtime as runtime_mod
        rt = runtime_mod.get_runtime()
        if rt.is_driver:
            for r in self._refs:
                e = rt.gcs.objects.get(r.id)
                if e is None or e.state != "ready":
                    return False
            return True
        try:
            _api.get(self._refs, timeout=30)
            return True
        except BaseException:  # noqa: BLE001
            return False


def _run_chunk(fn: Callable, chunk: List, star: bool) -> List:
    if star:
        return [fn(*args) for args in chunk]
    return [fn(x) for x in chunk]


def _apply_fn(fn: Callable, args: tuple, kwds: Optional[dict]):
    return fn(*args, **(kwds or {}))


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 ray_remote_args: Optional[dict] = None):
        if not _api.is_initialized():
            _api.init()
        self._processes = max(1, int(
            processes or _api.cluster_resources().get("CPU", 4) or 1))
        self._remote_args = ray_remote_args or {}
        self._task = _api.remote(**self._remote_args)(_run_chunk) \
            if self._remote_args else _api.remote(_run_chunk)
        self._apply = _api.remote(**self._remote_args)(_apply_fn) \
            if self._remote_args else _api.remote(_apply_fn)
        self._closed = False

    # -- internals ----------------------------------------------------------
    def _check(self):
        if self._closed:
            raise ValueError("Pool not running (closed)")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            # stdlib heuristic: ~4 chunks per process
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        for i in range(0, len(items), chunksize):
            yield items[i:i + chunksize]

    def _map_refs(self, fn, iterable, chunksize, star) -> List[ObjectRef]:
        self._check()
        refs = []
        inflight: List[ObjectRef] = []
        for chunk in self._chunks(iterable, chunksize):
            if len(inflight) >= self._processes:
                ready, inflight = _api.wait(inflight, num_returns=1,
                                            timeout=None)
            ref = self._task.remote(fn, chunk, star)
            refs.append(ref)
            inflight.append(ref)
        return refs

    # -- public API ---------------------------------------------------------
    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List:
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        return list(itertools.chain.from_iterable(_api.get(refs)))

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List:
        refs = self._map_refs(fn, iterable, chunksize, star=True)
        return list(itertools.chain.from_iterable(_api.get(refs)))

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        # no gather hop: the AsyncResult concatenates chunk results
        # driver-side, avoiding one extra serialization of every value
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        return AsyncResult(refs, flatten=True)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        """Ordered lazy iteration (results stream as chunks finish)."""
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        for ref in refs:
            yield from _api.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        pending = list(refs)
        while pending:
            ready, pending = _api.wait(pending, num_returns=1, timeout=None)
            for ref in ready:
                yield from _api.get(ref)

    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        self._check()
        return AsyncResult(self._apply.remote(fn, args, kwds))

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


__all__ = ["Pool", "AsyncResult"]
