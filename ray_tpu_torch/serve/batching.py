"""@serve.batch — coalesce concurrent requests into one handler call
(counterpart of ray_tpu/serve/batching.py).

Reference parity: python/ray/serve/batching.py (_BatchQueue semantics:
max_batch_size, batch_wait_timeout_s; the wrapped fn receives a list and
must return a list of equal length). A replica handling N concurrent
requests runs ONE forward pass of batch N instead of N singleton passes,
which keeps the GPU's matrix units fed.
"""
from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._queue: Optional[asyncio.Queue] = None
        self._runner_task = None

    def _ensure_started(self):
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._runner_task = asyncio.ensure_future(self._runner())

    async def submit(self, item) -> Any:
        self._ensure_started()
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((item, fut))
        return await fut

    async def _runner(self):
        while True:
            item, fut = await self._queue.get()
            batch = [(item, fut)]
            if self._timeout > 0:
                deadline = asyncio.get_running_loop().time() + self._timeout
                while len(batch) < self._max:
                    remaining = deadline - asyncio.get_running_loop().time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), timeout=remaining))
                    except asyncio.TimeoutError:
                        break
            else:
                while len(batch) < self._max and not self._queue.empty():
                    batch.append(self._queue.get_nowait())
            items = [b[0] for b in batch]
            try:
                results = self._fn(items)
                if asyncio.iscoroutine(results):
                    results = await results
                if len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch fn returned {len(results)} results "
                        f"for {len(items)} inputs")
                for (_, f), r in zip(batch, results):
                    if not f.done():
                        f.set_result(r)
            except BaseException as e:  # noqa: BLE001
                for _, f in batch:
                    if not f.done():
                        f.set_exception(e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped handler receives List[request] and returns
    List[response]. Callers invoke it with a single request."""

    def deco(fn):
        queues = {}  # per-instance queue for methods; single for functions

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                self_obj, item = args
                key = id(self_obj)
                if key not in queues:
                    queues[key] = _BatchQueue(
                        functools.partial(fn, self_obj),
                        max_batch_size, batch_wait_timeout_s)
                return await queues[key].submit(item)
            (item,) = args
            if None not in queues:
                queues[None] = _BatchQueue(fn, max_batch_size,
                                           batch_wait_timeout_s)
            return await queues[None].submit(item)

        def _set(**kw):
            nonlocal max_batch_size, batch_wait_timeout_s
            max_batch_size = kw.get("max_batch_size", max_batch_size)
            batch_wait_timeout_s = kw.get("batch_wait_timeout_s",
                                          batch_wait_timeout_s)
            queues.clear()
        wrapper.set_max_batch_size = \
            lambda v: _set(max_batch_size=v)
        wrapper.set_batch_wait_timeout_s = \
            lambda v: _set(batch_wait_timeout_s=v)
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
