"""Experimental APIs (reference: python/ray/experimental)."""
from . import internal_kv  # noqa: F401
from . import tqdm_ray     # noqa: F401

__all__ = ["internal_kv", "tqdm_ray"]
