"""Host -> device double-buffered batch loader (counterpart of
ray_tpu/data/device_loader.py).

Reference parity: ray.train.torch.prepare_data_loader's device-mover +
iter_torch_batches prefetching. A background thread stages the NEXT
batches on the device while the current step runs, so the copy rides
behind compute.

On a CUDA device the producer thread (which sets the device first: a
new thread starts on device 0) copies each numeric column into pinned
host memory and issues a `non_blocking` copy to the card on a side
stream, then records an event. The consumer makes its current stream
wait on that event before it yields the batch, and calls `record_stream`
on each tensor: the caching allocator then does not hand the tensor's
memory out again, once the consumer drops it, before the consumer
stream's work on it has finished. Each batch gets its own pinned buffer
from PyTorch's caching host allocator, which records the copy on it and
does not reuse the buffer before that copy has finished. On the CPU
the tensors are made from the arrays with no copy beyond the narrowing.

Prefetch depth defaults to the ``RAY_TPU_DATA_PREFETCH_DEPTH`` knob when
``prefetch=None``. Abandoning the iterator mid-stream (``close()`` /
``GeneratorExit`` / garbage collection) signals the producer thread to
stop: its puts are timeout-bounded and re-check a stop event, so it never
parks forever on a full queue the consumer will no longer drain.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..util.device import DeviceLike, resolve_device

_SENTINEL = object()


def device_put_iterator(host_batches: Iterator[Dict[str, np.ndarray]],
                        *, sharding=None, prefetch: Optional[int] = None,
                        dtypes: Optional[Dict[str, Any]] = None,
                        device: DeviceLike = "cuda") -> Iterator[Dict]:
    """Iterate over `host_batches` (dicts of arrays) as dicts of tensors
    on `device`, `prefetch` batches staged ahead by a thread.

    int64 columns become int32 and float64 float32 unless `dtypes` names
    a numpy dtype for the column; string and object columns stay on the
    host as arrays. With `sharding` (a `parallel.sharding.BatchSharding`)
    only this rank's rows (and sequence chunk) of each numeric column
    are copied, and the batch comes as a `LocalBatch`, which a mesh
    train step takes as this rank's share: under sp, a `tokens` batch
    of S + 1 columns comes as this rank's chunk of `inputs` and
    `targets`, as the step cuts it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if prefetch is None:
        from ..util import knobs
        prefetch = knobs.data_prefetch_depth()
    return _iterate(host_batches, sharding, max(prefetch, 1), dtypes, dev)


def _host_arrays(batch, sharding, dtypes):
    """(numeric columns narrowed and cut to this rank's share, the
    others as they are). Under sp a `tokens` column becomes the
    `inputs` and `targets` the step would cut (`shift_tokens`)."""
    numeric, other = {}, {}
    if sharding is not None:
        batch = sharding.shift_tokens(batch)
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            # non-numeric columns (paths, labels-as-text) stay on the
            # host (reference: iter_torch_batches passes them through)
            other[k] = arr
            continue
        if sharding is not None:
            arr = sharding.shard(arr)
        if dtypes and k in dtypes:
            arr = arr.astype(dtypes[k])
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        numeric[k] = arr
    return numeric, other


def _iterate(host_batches, sharding, depth, dtypes, dev):
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()
    cuda = dev.type == "cuda"

    def convert(batch, stream):
        numeric, out = _host_arrays(batch, sharding, dtypes)
        event = None
        if cuda:
            with torch.cuda.stream(stream):
                for k, arr in numeric.items():
                    pinned = torch.from_numpy(
                        np.ascontiguousarray(arr)).pin_memory()
                    out[k] = pinned.to(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        else:
            for k, arr in numeric.items():
                out[k] = torch.from_numpy(np.ascontiguousarray(arr))
        if sharding is not None:
            from ..parallel.sharding import LocalBatch
            out = LocalBatch(out, sharding)
        return out, event

    def bounded_put(item) -> bool:
        """Put that never parks past the stop signal. Returns False if
        the consumer abandoned the iterator."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = None
            if cuda:
                torch.cuda.set_device(dev)
                stream = torch.cuda.Stream(dev)
            for batch in host_batches:
                if not bounded_put(convert(batch, stream)):
                    return  # consumer gone; drop remaining batches
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        finally:
            close = getattr(host_batches, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            bounded_put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True,
                         name="rtpu-device-loader")
    t.start()

    try:
        while True:
            # raylint: disable=RT003 the producer's finally ALWAYS posts
            # the sentinel (even on error), and a full queue drains as
            # this consumer iterates: the get cannot park forever
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            out, event = item
            if event is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                for v in out.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            yield out
    finally:
        # consumer abandoned us (GeneratorExit / close / GC) or we hit
        # the sentinel: release the producer, then drain so a put that
        # raced the stop flag cannot strand it
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


__all__ = ["device_put_iterator"]
