"""ray_tpu_torch.data — scalable datasets for ML (counterpart of
ray_tpu/data/; reference: python/ray/data).

Numpy-columnar blocks, lazy fused plans, a streaming executor and the
shuffle exchange over the port's runtime, the shared data service, and
a device loader that prefetches batches onto the card. The reference's
`iter_jax_batches` is `iter_device_batches` here (see dataset.py).
"""
from .block import Block
from .dataset import (Dataset, from_items, from_blocks, from_numpy,
                      from_pandas, range_,
                      read_text, read_jsonl, read_csv, read_npy,
                      read_parquet, read_images, read_binary_files,
                      read_tfrecords, AggregateFn)
from .device_loader import device_put_iterator
from . import preprocessors
from . import service

# ray.data.range parity name
range = range_  # noqa: A001

__all__ = ["Block", "Dataset", "from_items", "from_blocks", "from_numpy",
           "from_pandas",
           "range", "range_", "read_text", "read_jsonl", "read_csv",
           "read_npy", "read_parquet", "read_images", "read_binary_files",
           "read_tfrecords", "AggregateFn",
           "device_put_iterator", "preprocessors", "service"]
