"""Scheduling strategies for tasks/actors.

Reference parity: python/ray/util/scheduling_strategies.py —
NodeAffinitySchedulingStrategy (pin to / prefer a node) and
PlacementGroupSchedulingStrategy (schedule into a bundle), plus the
"DEFAULT" / "SPREAD" string strategies. The dispatcher honors these in
`runtime._schedule` (hard affinity fails fast when the target node is
dead; soft affinity degrades to any node; SPREAD round-robins tasks
across nodes, best-effort, instead of driver-first packing).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


def strategy_plan(strategy, pg_allowed: List[str]):
    """Turn a scheduling_strategy into an ordered list of allowed-node
    constraints to try (each a list of node ids; [] = unconstrained) plus
    a spread flag. Returns (tries, spread). A placement-group constraint
    (pg_allowed non-empty) wins outright — mirrors the reference, where a
    bundle pin overrides other strategies."""
    if pg_allowed:
        return [pg_allowed], False
    if strategy is None or strategy == "DEFAULT":
        return [[]], False
    if strategy == "SPREAD":
        return [[]], True
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        if strategy.soft:
            return [[strategy.node_id], []], False
        return [[strategy.node_id]], False
    # Unknown strategy objects degrade to DEFAULT rather than wedging the
    # dispatcher loop.
    return [[]], False


def leaseable(spec) -> bool:
    """True when a task may ride a multi-slot worker lease (batched
    dispatch, runtime._schedule): placement must be unconstrained —
    leased slots execute wherever the lease head landed — and the task
    must be safe to re-queue without side effects on the worker pool.
    Excluded: placement groups and affinity/SPREAD strategies (their
    placement is per-task), TPU tasks (chip reservations are per-task),
    streaming generators (their item protocol is per-dispatch), and
    max_calls tasks (worker recycling counts individual dispatches)."""
    return (getattr(spec, "placement_group_id", None) is None
            and (spec.scheduling_strategy is None
                 or spec.scheduling_strategy == "DEFAULT")
            and not getattr(spec, "streaming", False)
            and getattr(spec, "max_calls", 0) == 0
            and spec.resources.get("GPU", 0) <= 0)


def node_leaseable(spec) -> bool:
    """True when a task may ride a NODE-level bulk lease (two-level
    scheduling, docs/SCHEDULING.md): everything `leaseable` requires,
    plus a deserializable payload — the driver hands the whole batch to
    the node agent sight-unseen, so a spec whose user blob failed the
    wire must stay on the per-worker path where the dispatcher's
    failure reporting sees it directly."""
    return leaseable(spec) and not getattr(spec, "wire_error", None)


def shape_key(resources) -> tuple:
    """Canonical hashable key for a resource shape — node-lease batches
    and the blocked-shape skip set group tasks by this."""
    return tuple(sorted(resources.items()))


def hard_affinity_node(strategy) -> Optional[str]:
    if (isinstance(strategy, NodeAffinitySchedulingStrategy)
            and not strategy.soft):
        return strategy.node_id
    return None


def compiled_stage_node(deps, node_of, driver_node: str) -> str:
    """Preferred node for a compiled-DAG stage (docs/DAG.md): the node
    where most of its upstream stages landed — a same-node channel is a
    shm rewrite, a cross-node one is a socket copy — falling back to
    the driver's node for roots. `node_of` maps already-placed stage
    ids to node ids; unplaced deps (shouldn't happen in topo order) are
    ignored. Ties break toward the first-listed dependency, keeping
    chains anchored where their head landed."""
    counts: dict = {}
    order: List[str] = []
    for d in deps:
        nid = node_of.get(d)
        if nid is None:
            continue
        if nid not in counts:
            order.append(nid)
        counts[nid] = counts.get(nid, 0) + 1
    if not counts:
        return driver_node
    return max(order, key=lambda n: counts[n])
