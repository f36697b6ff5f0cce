"""Logical plan + optimizer for Datasets (counterpart of
ray_tpu/data/plan.py).

Reference parity: python/ray/data/_internal/logical/ (operators) and
_internal/planner/ (fusion). The plan is a linear chain of stages over
blocks; the optimizer fuses adjacent row/batch transforms into one task
per block (same goal as the reference's OperatorFusionRule).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .block import (Block, block_concat, block_from_rows, block_num_rows,
                    block_select, block_slice, block_sort, block_take,
                    block_to_rows)


@dataclasses.dataclass
class Stage:
    name: str
    # "map_block" | "shuffle" | "exchange" | "window" | "source"
    kind: str
    fn: Optional[Callable] = None  # map_block: Block -> Block
    shuffle_fn: Optional[Callable] = None  # shuffle: List[Block] -> List[Block]
    can_fuse: bool = True
    compute: str = "tasks"         # "tasks" | "actors"
    fn_constructor: Optional[Callable] = None  # for actor compute
    exchange: Optional[Any] = None  # ExchangeSpec for kind="exchange"
    # window: Iterator[Block] -> Iterator[Block], streaming (holds only
    # a bounded carry — never the whole dataset)
    window_fn: Optional[Callable] = None


def map_rows_stage(name: str, row_fn: Callable[[Dict], Optional[Dict]],
                   *, flat: bool = False, drop_none: bool = False) -> Stage:
    def fn(block: Block) -> Block:
        out_rows: List[Dict] = []
        for row in block_to_rows(block):
            r = row_fn(row)
            if r is None and drop_none:
                continue
            if flat:
                out_rows.extend(r)
            else:
                out_rows.append(r)
        return block_from_rows(out_rows)
    return Stage(name=name, kind="map_block", fn=fn)


def filter_stage(name: str, pred: Callable[[Dict], bool]) -> Stage:
    def fn(block: Block) -> Block:
        if not block:
            return block
        mask = np.asarray([bool(pred(r)) for r in block_to_rows(block)])
        return block_select(block, mask)
    return Stage(name=name, kind="map_block", fn=fn)


def map_batches_stage(name: str, batch_fn: Callable[[Block], Block],
                      compute: str = "tasks",
                      fn_constructor: Optional[Callable] = None) -> Stage:
    return Stage(name=name, kind="map_block", fn=batch_fn, compute=compute,
                 fn_constructor=fn_constructor,
                 can_fuse=(compute == "tasks"))


def fn_wants_index(fn: Callable) -> bool:
    """Stage fns marked `_wants_block_index = True` receive the block's
    position in the stage's input stream as a second argument — the
    hook that lets per-block randomness (random_sample) derive seeds
    from a value that SURVIVES serialization to workers, instead of a
    closure counter that restarts at 0 in every deserialized copy."""
    return bool(getattr(fn, "_wants_block_index", False))


def call_block_fn(fn: Callable, block: Block, index: int) -> Block:
    return fn(block, index) if fn_wants_index(fn) else fn(block)


def fuse_stages(stages: Sequence[Stage]) -> List[Stage]:
    """Fuse runs of adjacent fusible map_block stages into single stages."""
    fused: List[Stage] = []
    run: List[Stage] = []

    def flush():
        nonlocal run
        if not run:
            return
        if len(run) == 1:
            fused.append(run[0])
        else:
            fns = [s.fn for s in run]
            name = "+".join(s.name for s in run)

            def combined(block: Block, _index: int = 0,
                         fns=fns) -> Block:
                for f in fns:
                    block = call_block_fn(f, block, _index)
                return block
            combined._wants_block_index = any(
                fn_wants_index(f) for f in fns)
            fused.append(Stage(name=name, kind="map_block", fn=combined))
        run = []

    for s in stages:
        if s.kind == "map_block" and s.can_fuse and s.compute == "tasks":
            run.append(s)
        else:
            flush()
            fused.append(s)
    flush()
    return fused
