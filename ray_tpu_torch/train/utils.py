"""Training prep utilities (counterpart of ray_tpu/train/utils.py).

`prepare_module` shards a model onto the mesh by the rule table, the
counterpart of the reference's device_put with NamedShardings. The
reference's `prepare_loader` and `iter_batches_sharded` split a
`ray_tpu.data` Dataset per worker and prefetch onto the device; they
wait for a port of the data layer and its device loader.
"""
from __future__ import annotations


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


__all__ = ["prepare_module"]
