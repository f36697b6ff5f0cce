"""Blocks: the unit of distributed data (counterpart of
ray_tpu/data/block.py).

Reference parity: python/ray/data/block.py (Block + BlockAccessor) and
_internal/arrow_block.py / pandas_block.py. Design difference: blocks are
numpy-columnar dicts ({column: ndarray}) — device input pipelines end in
fixed-shape numeric batches, so an Arrow layer would only add copies; the
accessor ops below are exactly the ones the exec plan needs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

Block = Dict[str, np.ndarray]


def block_from_rows(rows: Sequence[Dict[str, Any]]) -> Block:
    if not rows:
        return {}
    cols: Dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r[k])
    return {k: np.asarray(v) for k, v in cols.items()}


def block_to_rows(block: Block) -> List[Dict[str, Any]]:
    if not block:
        return []
    n = block_num_rows(block)
    keys = list(block)
    out = []
    for i in range(n):
        out.append({k: block[k][i] for k in keys})
    return out


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_size_bytes(block: Block) -> int:
    return sum(v.nbytes if isinstance(v, np.ndarray) else 0
               for v in block.values())


def block_slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def block_concat(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_sort(block: Block, key: str, descending: bool = False) -> Block:
    order = np.argsort(block[key], kind="stable")
    if descending:
        order = order[::-1]
    return block_take(block, order)


def block_select(block: Block, mask: np.ndarray) -> Block:
    return {k: v[mask] for k, v in block.items()}
