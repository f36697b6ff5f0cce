"""Data loading of the port (counterpart of ray_tpu/data/): so far the
device loader, which prefetches host batches onto the card. The
datasets and the streaming executor need the runtime and wait for a
later slice."""
from .device_loader import device_put_iterator

__all__ = ["device_put_iterator"]
