"""Worker-local device-resident object store (counterpart of
ray_tpu/core/device_store.py).

Reference parity: python/ray/experimental/channel/shared_memory_channel.py
+ torch_tensor_nccl_channel.py — the reference's accelerated DAG moves
tensors actor->actor through typed channels without host round-trips.
A task/actor return whose value contains a `torch.Tensor` leaf stays
DEVICE-RESIDENT in the producing worker process; the ObjectRef's
location is a lightweight device handle (kind="device",
name=<worker_id>). Consumers on the SAME worker (actor method chains,
locality-scheduled DAG stages) read the live value out of this table —
no device->host copy, no serialization, no shm traffic. Only when a
consumer elsewhere (another worker, or the driver) actually gets the
object does the holder materialize it to the shm store, via the normal
serialization path: a CUDA tensor is copied to the host once there
(core/serialization.py), and the consumer rebuilds it on its own
default device (the card in a process that holds a GPU, else the CPU).

As the reference keeps any `jax.Array` on any backend, this keeps any
tensor, CPU tensors included, so the counters below mean the same on
the CPU and on the card.

The table is process-local; COUNTERS make transfer behavior testable
(tests assert device_hits == n_intermediate_edges, materialized == n_
final_reads).

Contract: a same-worker consumer receives the LIVE object, not a copy —
the same read-only discipline as the shm path's zero-copy views. Don't
mutate a tensor you returned from a task in place. Once an object
materializes (a consumer elsewhere read it), the device entry is dropped
— the host copy becomes the single source of truth and device memory is
reclaimed.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Dict, Optional

from ..util import knobs

# kept-resident returns / local-table dep reads / D2H serializations
COUNTERS = {"kept_device": 0, "device_hits": 0, "materialized": 0}

_TABLE: Dict[str, Any] = {}
_LOCK = threading.Lock()

# Bound the number of live device values a worker pins (each holds HBM
# until consumed/freed/materialized). A full table does NOT evict —
# new values simply refuse residency and serialize through the normal
# shm path until frees/materializations make room.
MAX_ENTRIES = knobs.get_int("RAY_TPU_DEVICE_OBJECTS_MAX")


def enabled() -> bool:
    return knobs.get_bool("RAY_TPU_DEVICE_OBJECTS")


def should_keep(value: Any) -> bool:
    """Keep device-resident iff torch is already loaded in this process
    and the value contains at least one torch.Tensor leaf. Never imports
    torch into a worker that wasn't using it."""
    if not enabled():
        return False
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    with _LOCK:
        if len(_TABLE) >= MAX_ENTRIES:
            return False
    try:
        from torch.utils import _pytree  # noqa: PLC0415
        return any(isinstance(leaf, torch.Tensor)
                   for leaf in _pytree.tree_leaves(value))
    except Exception:  # exotic non-pytree values: serialize normally
        return False


def put(oid: str, value: Any) -> None:
    with _LOCK:
        _TABLE[oid] = value
    COUNTERS["kept_device"] += 1


def try_keep(store, worker_id: str, oid: str, value: Any):
    """The ONE seal-or-keep decision shared by task returns and
    worker-side api.put: keep device-resident when policy allows,
    else serialize into the shm store. Returns the ObjectLocation."""
    from .object_store import ObjectLocation, current_node_id  # noqa: PLC0415
    from .spilling import put_value_or_spill  # noqa: PLC0415
    if should_keep(value):
        put(oid, value)
        return ObjectLocation(kind="device", size=0, name=worker_id,
                              node_id=current_node_id())
    return put_value_or_spill(store, oid, value)


def get(oid: str) -> Any:
    """Raises KeyError when not resident here."""
    with _LOCK:
        value = _TABLE[oid]
    COUNTERS["device_hits"] += 1
    return value


def contains(oid: str) -> bool:
    with _LOCK:
        return oid in _TABLE


def peek(oid: str) -> Optional[Any]:
    """No-counter read for the materialization path."""
    with _LOCK:
        return _TABLE.get(oid)


def drop(oid: str) -> None:
    with _LOCK:
        _TABLE.pop(oid, None)


def clear() -> None:
    with _LOCK:
        _TABLE.clear()
    COUNTERS.update({"kept_device": 0, "device_hits": 0,
                     "materialized": 0})
