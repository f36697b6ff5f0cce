"""Placement groups: reserve resource bundles ahead of scheduling.

Reference counterpart: python/ray/util/placement_group.py (PACK/SPREAD/
STRICT_PACK/STRICT_SPREAD bundles, .ready(), remove_placement_group) —
on a TPU pod these reserve chips/hosts for an actor gang before the
gang is created, so a mesh never half-forms.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..core.resources import check_gpu_request
from ..core.runtime import get_runtime
from ..core.object_ref import ObjectRef

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, state):
        self._state = state

    @property
    def id(self) -> str:
        return self._state.pg_id

    @property
    def pg_id(self) -> str:
        return self._state.pg_id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._state.bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._state.bundles)

    def ready(self) -> ObjectRef:
        """ObjectRef that resolves True once all bundles are reserved —
        `ray_tpu_torch.get(pg.ready())` mirrors the reference idiom."""
        return ObjectRef(self._state.ready_ref)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        import ray_tpu_torch
        try:
            ray_tpu_torch.get(self.ready(), timeout=timeout_seconds)
            return True
        except Exception:
            return False

    def __repr__(self):
        return (f"PlacementGroup(id={self.id}, "
                f"strategy={self._state.strategy}, "
                f"bundles={self._state.bundles}, "
                f"state={self._state.state})")


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    for b in bundles:
        check_gpu_request(b)
    rt = get_runtime()
    state = rt.placement_group(bundles, strategy, name)
    return PlacementGroup(state)


def remove_placement_group(pg: PlacementGroup) -> None:
    get_runtime().remove_placement_group(pg.pg_id)


def get_placement_group(name: str) -> Optional[PlacementGroup]:
    rt = get_runtime()
    for state in list(rt.placement_groups.values()):
        if state.name == name and state.state != "REMOVED":
            return PlacementGroup(state)
    return None


def placement_group_table() -> Dict[str, Dict]:
    rt = get_runtime()
    return {pg.pg_id: {"name": pg.name, "strategy": pg.strategy,
                       "state": pg.state, "bundles": list(pg.bundles)}
            for pg in list(rt.placement_groups.values())}
