"""@serve.multiplexed — per-replica LRU cache of loaded models
(counterpart of ray_tpu/serve/multiplex.py).

Reference parity: python/ray/serve/multiplex.py (_ModelMultiplexWrapper)
+ serve.get_multiplexed_model_id(). One replica serves many fine-tuned
model variants; the decorated async loader is called on cache miss and
the least-recently-used model is evicted (its __del__ / unload hook runs).
"""
from __future__ import annotations

import asyncio
import contextvars
import functools
from collections import OrderedDict
from typing import Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a handler: the model id of the in-flight request."""
    return _current_model_id.get()


def _set_multiplexed_model_id(model_id: str):
    _current_model_id.set(model_id)


def multiplexed(_fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    def deco(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async loader")
        caches = {}

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:
                self_obj, model_id = args
                call = functools.partial(fn, self_obj)
                key = id(self_obj)
            else:
                (model_id,) = args
                call = fn
                key = None
            cache: OrderedDict = caches.setdefault(key, OrderedDict())
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = await call(model_id)
            cache[model_id] = model
            if len(cache) > max_num_models_per_replica:
                _evicted_id, evicted = cache.popitem(last=False)
                unload = getattr(evicted, "unload", None)
                if unload is not None:
                    r = unload()
                    if asyncio.iscoroutine(r):
                        await r
            return model

        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
