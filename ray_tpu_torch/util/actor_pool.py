"""ActorPool: round-robin work distribution over a fixed actor set.

Reference counterpart: python/ray/util/actor_pool.py — same API
(submit/get_next/get_next_unordered/map/map_unordered/has_next,
push/pop_idle).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional


class ActorPool:
    def __init__(self, actors: List[Any]):
        import ray_tpu_torch
        self._ray = ray_tpu_torch
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending: List = []     # (fn, value) waiting for an idle actor

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queued until an actor frees up."""
        if self._idle:
            actor = self._idle.pop(0)
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def _drain_pending(self) -> None:
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    def has_next(self) -> bool:
        return bool(self._index_to_future or self._pending)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order. A timeout raises without
        consuming the slot (retryable); a task error consumes the slot and
        releases the actor, so the pool keeps working."""
        from ..exceptions import GetTimeoutError
        if not self.has_next():
            raise StopIteration("no pending results")
        self._drain_pending()
        # skip indices already consumed by get_next_unordered
        while (self._next_return_index < self._next_task_index
               and self._next_return_index not in self._index_to_future):
            self._next_return_index += 1
        if self._next_return_index not in self._index_to_future:
            raise StopIteration("no pending results")
        ref = self._index_to_future[self._next_return_index]
        try:
            value = self._ray.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise                       # state intact: retryable
        except Exception:
            del self._index_to_future[self._next_return_index]
            self._next_return_index += 1
            self._release(ref)
            raise
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._release(ref)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Whichever pending result lands first."""
        if not self._index_to_future:
            if not self.has_next():
                raise StopIteration("no pending results")
            self._drain_pending()
        refs = list(self._index_to_future.values())
        ready, _ = self._ray.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError(f"no result within {timeout}s")
        ref = ready[0]
        for idx, r in list(self._index_to_future.items()):
            if r is ref:
                del self._index_to_future[idx]
                break
        try:
            return self._ray.get(ref)
        finally:
            self._release(ref)

    def _release(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)
        self._drain_pending()

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor: Any) -> None:
        self._idle.append(actor)
        self._drain_pending()

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None
