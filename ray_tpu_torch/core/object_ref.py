"""ObjectRef — distributed future handle.

Reference parity: ObjectRef in python/ray/_raylet.pyx plus ownership notes
in python/ray/includes/object_ref.pxi. Refs are cheap, picklable, hashable,
awaitable, and resolve through whichever runtime (driver or worker) the
current process hosts.
"""
from __future__ import annotations

import asyncio
from typing import Any


class ObjectRef:
    __slots__ = ("id", "_owner_hint")

    def __init__(self, object_id: str, owner_hint: str = ""):
        self.id = object_id
        self._owner_hint = owner_hint

    def hex(self) -> str:
        return self.id

    def binary(self) -> bytes:
        return self.id.encode()

    def __repr__(self) -> str:
        return f"ObjectRef({self.id})"

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __reduce__(self):
        # Escape hook for the direct-call plane: serializing a ref means
        # it may reach a reader that resolves through the driver, so a
        # worker holding this oid as a LOCAL direct-call future must
        # publish the value driver-side (WorkerRuntime.on_ref_serialized;
        # no-op on the driver and for ordinary refs).
        from . import runtime  # noqa: PLC0415
        rt = runtime._runtime
        if rt is not None:
            hook = getattr(rt, "on_ref_serialized", None)
            if hook is not None:
                try:
                    hook(self.id)
                except Exception:
                    pass
        return (ObjectRef, (self.id, self._owner_hint))

    # Support `await ref` inside async actors / drivers.
    def __await__(self):
        return self.as_future().__await__()

    def as_future(self) -> "asyncio.Future":
        from . import runtime  # noqa: PLC0415
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()

        def _resolve():
            rt = runtime.get_runtime()
            try:
                val = rt.get([self], timeout=None)[0]
                loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_result(val))
            except BaseException as e:  # noqa: BLE001
                loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_exception(e))

        import threading  # noqa: PLC0415
        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def future(self) -> "asyncio.Future":
        return self.as_future()


class ObjectRefGenerator:
    """Handle to a streaming-generator task (num_returns="streaming").

    Iterating yields ObjectRefs in the order the remote generator yields
    values; each ref resolves via ray_tpu_torch.get. Works from the driver and
    from inside workers, and survives serialization (it carries only the
    task id). Reference parity: ObjectRefGenerator in _raylet.pyx.
    """
    __slots__ = ("_task_id",)

    def __init__(self, task_id: str):
        self._task_id = task_id

    @property
    def task_id(self) -> str:
        return self._task_id

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        from . import runtime  # noqa: PLC0415
        ref = runtime.get_runtime().gen_next(self._task_id, timeout=None)
        if ref is None:
            raise StopIteration
        return ref

    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio  # noqa: PLC0415
        from . import runtime  # noqa: PLC0415
        rt = runtime.get_runtime()
        ref = await asyncio.get_event_loop().run_in_executor(
            None, lambda: rt.gen_next(self._task_id, timeout=None))
        if ref is None:
            raise StopAsyncIteration
        return ref

    def __reduce__(self):
        return (ObjectRefGenerator, (self._task_id,))

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id})"
