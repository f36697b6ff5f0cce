"""Distributed FIFO queue backed by an actor.

Reference counterpart: python/ray/util/queue.py (Queue over an
_QueueActor). Blocking semantics are client-side polls against a
non-blocking actor so one slow consumer never wedges the actor.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, List, Optional

from ..exceptions import GetTimeoutError


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._q: deque = deque()

    def qsize(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def full(self) -> bool:
        return self.maxsize > 0 and len(self._q) >= self.maxsize

    def put_nowait(self, item) -> bool:
        if self.full():
            return False
        self._q.append(item)
        return True

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self.maxsize > 0 and len(self._q) + len(items) > self.maxsize:
            return False
        self._q.extend(items)
        return True

    def get_nowait(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()

    def get_nowait_batch(self, n: int):
        n = min(n, len(self._q))
        return [self._q.popleft() for _ in range(n)]


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options=None):
        import ray_tpu_torch
        opts = actor_options or {}
        cls = ray_tpu_torch.remote(_QueueActor)
        if opts:
            cls = cls.options(**opts)
        self.actor = cls.remote(maxsize)
        self.maxsize = maxsize

    def __getstate__(self):
        return {"actor": self.actor, "maxsize": self.maxsize}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def qsize(self) -> int:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.001
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if not block:
                raise Full("queue full")
            if deadline is not None and time.monotonic() >= deadline:
                raise Full(f"put timed out after {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 0.05)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        import ray_tpu_torch
        if not ray_tpu_torch.get(
                self.actor.put_nowait_batch.remote(list(items))):
            raise Full("batch does not fit")

    def get(self, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.001
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if not block:
                raise Empty("queue empty")
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty(f"get timed out after {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 0.05)

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, n: int) -> List[Any]:
        import ray_tpu_torch
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(n))

    def shutdown(self) -> None:
        import ray_tpu_torch
        ray_tpu_torch.kill(self.actor)
