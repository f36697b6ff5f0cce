"""Parallelism of the port (counterpart of ray_tpu/parallel/).

Only the precision policy is ported so far; the mesh, sharding rules and
pipelines wait for the parallelism slice.
"""
from .precision import BF16, FP32, Precision

__all__ = ["Precision", "BF16", "FP32"]
