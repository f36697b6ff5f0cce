"""Utilities (reference: python/ray/util).

Exports resolve lazily (PEP 562): several util modules import
ray_tpu_torch.core at module level, and core modules import util.knobs at
module level — eager imports here would close that cycle in the middle
of `import ray_tpu_torch`. Lazy resolution keeps `from ray_tpu_torch.util
import ActorPool` working while letting core modules import the leaf
submodules (knobs, events, metrics_catalog) freely.
"""
import importlib
import sys
import types

# public name -> (submodule, attribute | None for the module itself)
_EXPORTS = {
    "ActorPool": ("actor_pool", "ActorPool"),
    "PlacementGroup": ("placement_group", "PlacementGroup"),
    "get_placement_group": ("placement_group", "get_placement_group"),
    "placement_group": ("placement_group", "placement_group"),
    "placement_group_table": ("placement_group",
                              "placement_group_table"),
    "remove_placement_group": ("placement_group",
                               "remove_placement_group"),
    "Queue": ("queue", "Queue"),
    "metrics": ("metrics", None),
    "state": ("state", None),
    "scheduling_strategies": ("scheduling_strategies", None),
    "knobs": ("knobs", None),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod_name, attr = _EXPORTS[name]
    elif not name.startswith("_"):
        mod_name, attr = name, None   # any submodule by its own name
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    try:
        mod = importlib.import_module(f".{mod_name}", __name__)
    except ImportError as e:
        # only a MISSING submodule reads as "no such attribute" — an
        # ImportError raised INSIDE an existing submodule is a real
        # failure and must surface with its own traceback
        if getattr(e, "name", None) == f"{__name__}.{mod_name}":
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}"
            ) from None
        raise
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value   # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


class _UtilModule(types.ModuleType):
    """`placement_group` names BOTH a submodule and the Ray-parity
    FUNCTION exported from it. Whenever anything imports the submodule
    directly, the import machinery rebinds the package attribute to
    the module — under lazy exports that would permanently shadow the
    function (`ray_tpu_torch.util.placement_group(bundles)` -> TypeError).
    A data descriptor on the module's class outranks the instance
    attribute, so the public name stays the function; the module
    remains reachable via from-imports and sys.modules."""

    @property
    def placement_group(self):
        mod = importlib.import_module(".placement_group", __name__)
        return mod.placement_group


sys.modules[__name__].__class__ = _UtilModule
