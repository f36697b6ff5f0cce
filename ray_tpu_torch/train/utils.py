"""Training prep utilities (counterpart of ray_tpu/train/utils.py).

`prepare_module` shards a model onto the mesh by the rule table, the
counterpart of the reference's device_put with NamedShardings;
`prepare_loader` gives each worker its rank's shard of a Dataset as
batches prefetched onto the device; `iter_batches_sharded` prefetches
any host-batch iterator onto the device, this rank's share of each
batch only.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator

from torch import nn

from ..util.device import DeviceLike, resolve_device


def prepare_module(model: nn.Module, mesh=None, *, rules=None,
                   device: DeviceLike = "cuda") -> nn.Module:
    """Shard `model` onto `mesh` by the rule table (`rules`, default the
    table; see parallel.sharding.shard_module); no mesh -> the model on
    `device`. Returns the model (changed in place)."""
    if mesh is None:
        return model.to(resolve_device(device))
    from ..parallel.sharding import shard_module
    return shard_module(model, mesh, rules)


def prepare_loader(dataset, *, rank: int, world_size: int,
                   batch_size: int, sharding=None, prefetch: int = 2,
                   device: DeviceLike = "cuda") -> Iterable:
    """Per-worker shard of a `ray_tpu_torch.data` Dataset as device
    batches (reference: ray.train.torch.prepare_data_loader): rank-split,
    batch, then double-buffered host->device prefetch
    (data.device_loader)."""
    from ..data.device_loader import device_put_iterator
    shard = dataset.split_for_worker(rank, world_size)
    return device_put_iterator(shard.iter_batches(batch_size=batch_size),
                               sharding=sharding, prefetch=prefetch,
                               device=device)


def iter_batches_sharded(arrays_iter: Iterator[Any], sharding,
                         prefetch: int = 2, *,
                         device: DeviceLike = "cuda") -> Iterator[Any]:
    """Wrap any host-batch iterator with sharded device prefetch
    (`sharding` a BatchSharding, e.g. `SpmdStep.batch_shardings`)."""
    from ..data.device_loader import device_put_iterator
    return device_put_iterator(arrays_iter, sharding=sharding,
                               prefetch=prefetch, device=device)


__all__ = ["prepare_module", "prepare_loader", "iter_batches_sharded"]
