"""The port's device loader (ray_tpu_torch.data.device_put_iterator) on
the CPU: tests/test_data_service.py's device-loader tests (the
prefetch knob and int64 narrowing, an abandoned iterator's producer
thread exits, an abandoned source is closed) on device="cpu", plus the
narrowing of every column kind and a sharded loader's rows."""
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.data import device_put_iterator
from ray_tpu_torch.parallel.sharding import BatchSharding, LocalBatch


def test_device_loader_prefetch_knob(monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_PREFETCH_DEPTH", "3")
    batches = [{"x": np.arange(4)} for _ in range(5)]
    got = list(device_put_iterator(iter(batches), device="cpu"))
    assert len(got) == 5
    assert got[0]["x"].dtype == torch.int32   # int64 narrowed


def test_device_loader_abandoned_iterator_releases_producer():
    produced = []

    def infinite():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.full(4, i)}
            i += 1

    it = device_put_iterator(infinite(), prefetch=2, device="cpu")
    first = next(it)
    assert int(first["x"][0]) == 0
    it.close()     # abandon mid-stream -> producer must stop
    time.sleep(0.5)
    n_after_close = len(produced)
    time.sleep(0.5)
    assert len(produced) == n_after_close, \
        "producer thread kept running after the consumer abandoned it"
    assert not any(t.name == "rtpu-device-loader" and t.is_alive()
                   for t in threading.enumerate())


def test_device_loader_closes_abandoned_source():
    closed = []

    class Src:
        def __iter__(self):
            return self

        def __next__(self):
            return {"x": np.arange(2)}

        def close(self):
            closed.append(True)

    it = device_put_iterator(Src(), prefetch=1, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline and not closed:
        time.sleep(0.05)
    assert closed, "device loader never closed the abandoned source"


def test_device_loader_columns_and_the_producers_error():
    """float64 -> float32, a `dtypes` override, strings left on the
    host; an error in the source is raised to the consumer."""
    batch = {"f": np.ones((2, 3)), "i": np.arange(6).reshape(2, 3),
             "keep": np.arange(2), "name": np.array(["a", "b"])}
    got = next(device_put_iterator(iter([batch]), device="cpu",
                                   dtypes={"keep": np.int64}))
    assert got["f"].dtype == torch.float32 and got["i"].dtype == torch.int32
    assert got["keep"].dtype == torch.int64
    assert isinstance(got["name"], np.ndarray)

    def broken():
        yield batch
        raise KeyError("source failed")

    it = device_put_iterator(broken(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="source failed"):
        next(it)


def test_device_loader_copies_this_ranks_rows():
    sharding = BatchSharding(row_index=1, n_rows=2)
    tokens = np.arange(8 * 5).reshape(8, 5)
    got = next(device_put_iterator(iter([{"tokens": tokens}]),
                                   sharding=sharding, device="cpu"))
    assert isinstance(got, LocalBatch) and got.sharding == sharding
    np.testing.assert_array_equal(got["tokens"].numpy(), tokens[4:])
    assert sharding.shard(got) is got     # the step takes it as it is
    with pytest.raises(ValueError, match="local to"):
        BatchSharding(0, 2).shard(got)


def test_device_loader_asks_for_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_put_iterator(iter([]))
