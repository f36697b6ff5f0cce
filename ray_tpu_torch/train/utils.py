"""Training prep utilities (counterpart of ray_tpu/train/utils.py).

`prepare_module` shards a model onto the mesh by the rule table, the
counterpart of the reference's device_put with NamedShardings;
`iter_batches_sharded` prefetches any host-batch iterator onto the
device, this rank's share of each batch only. The reference's
`prepare_loader` splits a `ray_tpu.data` Dataset per worker; it waits
for a port of the data layer.
"""
from __future__ import annotations

from typing import Any, Iterator

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


def iter_batches_sharded(arrays_iter: Iterator[Any], sharding,
                         prefetch: int = 2, *,
                         device: DeviceLike = "cuda") -> Iterator[Any]:
    """Wrap any host-batch iterator with sharded device prefetch
    (`sharding` a BatchSharding, e.g. `SpmdStep.batch_shardings`)."""
    from ..data.device_loader import device_put_iterator
    return device_put_iterator(arrays_iter, sharding=sharding,
                               prefetch=prefetch, device=device)


__all__ = ["prepare_module", "iter_batches_sharded"]
