"""Reference-parity import location for scheduling strategies
(python/ray/util/scheduling_strategies.py)."""
from ..core.scheduling import (NodeAffinitySchedulingStrategy,
                               PlacementGroupSchedulingStrategy)

__all__ = ["NodeAffinitySchedulingStrategy",
           "PlacementGroupSchedulingStrategy"]
