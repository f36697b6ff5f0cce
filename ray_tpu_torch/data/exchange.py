"""Distributed exchange (shuffle) execution: map-partition + reduce-merge
(counterpart of ray_tpu/data/exchange.py).

Reference parity: python/ray/data/_internal/planner/exchange/
(push_based_shuffle_task_scheduler.py, pull_based_shuffle_task_scheduler.py,
sort_task_spec.py). The reference fans each input block out to N partition
pieces via map tasks, then merges piece i from every map via reduce tasks —
no process ever holds more than ~1/N of the dataset. The port re-designs the
same two-round exchange over its own runtime:

  map round:   one task per input block — `partition_fn` splits the block
               into `n_parts` pieces, each piece `put()` into the shm store
               from the worker; only the (tiny) piece refs return.
  reduce round: one task per partition — receives the matching piece refs
               as top-level args (the runtime resolves them to values in
               the worker), merges via `reduce_fn`, returns output blocks.

The driver holds refs + at most one in-flight output block (bounded
window); input refs are freed after the map round and piece refs after
each reduce, so store residency decays as the exchange drains.

Sort/groupby use sampled range partitioning (reference sort_task_spec.py's
SortTaskSpec.sample_boundaries): the driver gathers per-block key samples,
picks n-1 quantile boundaries, and range-partitions so reduce outputs are
globally ordered end-to-end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np

from .block import (Block, block_concat, block_num_rows, block_sort,
                    block_take)

# piece sample cap per block for boundary estimation
_SAMPLE_PER_BLOCK = 64


@dataclasses.dataclass
class ExchangeSpec:
    """A two-round distributed exchange.

    partition_fn(block, block_idx, n_parts, meta) -> List[Block] of
        exactly n_parts pieces (piece j goes to reduce task j).
    reduce_fn(pieces, part_idx, meta) -> List[Block] output blocks.
    sample_fn(block) -> small ndarray used by meta_fn (e.g. key samples).
    meta_fn(samples, counts, n_parts) -> broadcast metadata (boundaries,
        global offsets, ...) shipped to every map/reduce task.
    """
    name: str
    partition_fn: Callable[[Block, int, int, Any], List[Block]]
    reduce_fn: Callable[[List[Block], int, Any], List[Block]]
    n_partitions: Optional[int] = None   # default: len(input blocks)
    sample_fn: Optional[Callable[[Block], np.ndarray]] = None
    meta_fn: Optional[Callable[[list, list, int], Any]] = None


def exchange_map_task(partition_fn, block, block_idx, n_parts, meta):
    """Map round body (runs in a worker): partition and put each piece
    separately so a reduce task fetches only its own 1/n_parts share."""
    from .. import api
    pieces = partition_fn(block, block_idx, n_parts, meta)
    assert len(pieces) == n_parts, (len(pieces), n_parts)
    return [api.put(p) for p in pieces]


def exchange_reduce_task(reduce_fn, part_idx, meta, *pieces):
    """Reduce round body: pieces arrive as values (refs resolved by the
    runtime). Returns (out_blocks, in_bytes) — in_bytes instruments the
    1/N-footprint guarantee for stats/tests."""
    from .block import block_size_bytes
    in_bytes = sum(block_size_bytes(p) for p in pieces)
    return reduce_fn(list(pieces), part_idx, meta), in_bytes


# ---------------------------------------------------------------------------
# concrete exchanges


def random_shuffle_spec(seed: Optional[int]) -> ExchangeSpec:
    """Uniform global permutation: map assigns each row an independent
    uniform partition, reduce permutes its merged rows. Deterministic for
    a fixed seed (per-block / per-partition derived streams)."""
    if seed is None:
        # non-deterministic run: draw a fresh base seed once
        seed = int(np.random.randint(0, 2**31 - 1))

    def partition(block: Block, block_idx: int, n_parts: int,
                  meta: Any) -> List[Block]:
        rng = np.random.RandomState((seed * 1_000_003 + block_idx)
                                    % (2**32 - 1))
        assign = rng.randint(0, n_parts, size=block_num_rows(block))
        return [block_take(block, np.nonzero(assign == j)[0])
                for j in range(n_parts)]

    def reduce(pieces: List[Block], part_idx: int, meta: Any) -> List[Block]:
        merged = block_concat(pieces)
        n = block_num_rows(merged)
        if n == 0:
            return []
        rng = np.random.RandomState((seed * 7_368_787 + 31 + part_idx)
                                    % (2**32 - 1))
        return [block_take(merged, rng.permutation(n))]

    return ExchangeSpec("random_shuffle", partition, reduce)


def repartition_spec(num_blocks: int) -> ExchangeSpec:
    """Contiguous re-chunking: row order is preserved; output block j
    holds global rows [j*per, (j+1)*per)."""
    def meta(samples: list, counts: List[int], n_parts: int):
        offsets = np.concatenate([[0], np.cumsum(counts)])
        total = int(offsets[-1])
        per = -(-total // max(n_parts, 1))  # ceil
        return {"offsets": offsets, "per": max(per, 1)}

    def partition(block: Block, block_idx: int, n_parts: int,
                  meta: Any) -> List[Block]:
        start = int(meta["offsets"][block_idx])
        per = meta["per"]
        n = block_num_rows(block)
        gids = (start + np.arange(n)) // per
        return [block_take(block, np.nonzero(gids == j)[0])
                for j in range(n_parts)]

    def reduce(pieces: List[Block], part_idx: int, meta: Any) -> List[Block]:
        merged = block_concat(pieces)  # map order == global row order
        return [merged] if block_num_rows(merged) else []

    return ExchangeSpec(f"repartition({num_blocks})", partition, reduce,
                        n_partitions=num_blocks, meta_fn=meta)


def _boundaries_from_samples(samples: list, n_parts: int) -> np.ndarray:
    allv = (np.concatenate([s for s in samples if len(s)])
            if any(len(s) for s in samples) else np.asarray([]))
    if allv.size == 0 or n_parts <= 1:
        return np.asarray([])
    allv = np.sort(allv)
    idx = (np.arange(1, n_parts) * allv.size) // n_parts
    return allv[np.minimum(idx, allv.size - 1)]


def sort_spec(key: str, descending: bool) -> ExchangeSpec:
    """Sampled range partition + per-partition sort => globally sorted
    output (reference sort_task_spec.py). Descending is handled by
    reversing both the partition ids and the in-partition sort."""
    def sample(block: Block) -> np.ndarray:
        keys = block[key]
        if len(keys) <= _SAMPLE_PER_BLOCK:
            return np.asarray(keys)
        step = len(keys) // _SAMPLE_PER_BLOCK
        return np.asarray(keys[::step][:_SAMPLE_PER_BLOCK])

    def meta(samples: list, counts: List[int], n_parts: int):
        return {"bounds": _boundaries_from_samples(samples, n_parts)}

    def partition(block: Block, block_idx: int, n_parts: int,
                  meta: Any) -> List[Block]:
        bounds = meta["bounds"]
        ids = (np.searchsorted(bounds, block[key], side="right")
               if len(bounds) else np.zeros(block_num_rows(block), np.int64))
        if descending:
            ids = (n_parts - 1) - ids
        return [block_take(block, np.nonzero(ids == j)[0])
                for j in range(n_parts)]

    def reduce(pieces: List[Block], part_idx: int, meta: Any) -> List[Block]:
        merged = block_concat(pieces)
        if not block_num_rows(merged):
            return []
        return [block_sort(merged, key, descending)]

    return ExchangeSpec(f"sort({key})", partition, reduce,
                        sample_fn=sample, meta_fn=meta)


def groupby_agg_spec(key: str, aggs: List[tuple],
                     agg_factory: Callable) -> ExchangeSpec:
    """Range-partition rows by group key (samples, like sort) so every
    group lands wholly in one partition AND partitions come out in
    ascending key order — preserving the single-process implementation's
    sorted-by-key output. Reduce groups + aggregates its partition."""
    def sample(block: Block) -> np.ndarray:
        keys = block[key]
        step = max(1, len(keys) // _SAMPLE_PER_BLOCK)
        return np.asarray(keys[::step][:_SAMPLE_PER_BLOCK])

    def meta(samples: list, counts: List[int], n_parts: int):
        return {"bounds": _boundaries_from_samples(samples, n_parts)}

    def partition(block: Block, block_idx: int, n_parts: int,
                  meta: Any) -> List[Block]:
        bounds = meta["bounds"]
        ids = (np.searchsorted(bounds, block[key], side="right")
               if len(bounds) else np.zeros(block_num_rows(block), np.int64))
        return [block_take(block, np.nonzero(ids == j)[0])
                for j in range(n_parts)]

    def reduce(pieces: List[Block], part_idx: int, meta: Any) -> List[Block]:
        from .block import block_from_rows
        merged = block_concat(pieces)
        if not block_num_rows(merged):
            return []
        keys = merged[key]
        rows = []
        for kval in np.unique(keys):   # np.unique returns sorted keys
            mask = keys == kval
            row = {key: kval.item() if hasattr(kval, "item") else kval}
            for kind, col in aggs:
                agg = agg_factory(kind, col or key)
                vals = merged[col][mask] if col else \
                    next(iter(merged.values()))[mask]
                row[agg.name] = agg.finalize(
                    agg.accumulate(agg.init(), vals))
            rows.append(row)
        return [block_from_rows(rows)]

    return ExchangeSpec(f"groupby({key})", partition, reduce,
                        sample_fn=sample, meta_fn=meta)


def groupby_map_spec(key: str, fn: Callable) -> ExchangeSpec:
    """GroupedData.map_groups (reference grouped_data.py): range-
    partition by key so each group lands wholly in one reduce task,
    then apply `fn` to each group's block; results concatenate in
    ascending key order."""
    base = groupby_agg_spec(key, [], lambda *a: None)

    def reduce(pieces: List[Block], part_idx: int, meta: Any) -> List[Block]:
        merged = block_concat(pieces)
        if not block_num_rows(merged):
            return []
        keys = merged[key]
        out: List[Block] = []
        for kval in np.unique(keys):   # sorted group order
            mask = keys == kval
            res = fn({c: v[mask] for c, v in merged.items()})
            if res and block_num_rows(res):
                out.append(res)
        return out

    return ExchangeSpec(f"map_groups({key})", base.partition_fn, reduce,
                        sample_fn=base.sample_fn, meta_fn=base.meta_fn)


# ---------------------------------------------------------------------------
# execution


def run_exchange_local(blocks: List[Block], spec: ExchangeSpec
                       ) -> List[Block]:
    """Inline fallback when the runtime isn't initialized: identical
    two-round structure, one process (small-data / unit-test path)."""
    n_parts = spec.n_partitions or max(1, len(blocks))
    samples = [spec.sample_fn(b) for b in blocks] if spec.sample_fn else []
    counts = [block_num_rows(b) for b in blocks]
    meta = spec.meta_fn(samples, counts, n_parts) if spec.meta_fn else None
    buckets: List[List[Block]] = [[] for _ in range(n_parts)]
    for i, b in enumerate(blocks):
        for j, piece in enumerate(spec.partition_fn(b, i, n_parts, meta)):
            buckets[j].append(piece)
    out: List[Block] = []
    for j in range(n_parts):
        out.extend(spec.reduce_fn(buckets[j], j, meta))
    return out


def run_exchange_distributed(stream, spec: ExchangeSpec, stats,
                             parallelism: int):
    """Two-round exchange over the core runtime. Yields output blocks.

    Driver residency: refs + one in-flight result; every piece travels
    worker->store->worker without the driver touching its bytes.
    """
    import time

    from .. import api

    t0 = time.time()
    # Every store ref the exchange creates registers here and is removed
    # as it's freed; the finally block frees the remainder, so an
    # abandoned generator (e.g. .take(5) breaking out mid-drain) cannot
    # pin the dataset in the shm store.
    live: dict = {}

    def track(ref):
        live[ref.id] = ref
        return ref

    def untrack_free(refs):
        for r in refs:
            live.pop(r.id, None)
        api.free(refs)

    max_reduce_bytes = 0
    n_out = 0
    n_maps = 0
    n_parts = 0
    # Peer-transfer accounting: pieces travel worker->store->worker, and
    # on a multi-node cluster the transfer plane moves them holder->
    # requester directly — any driver-relayed byte during the exchange
    # shows up in this delta (0 on a healthy peer path).
    from ..core import runtime as _rt_mod
    _rt = _rt_mod.get_runtime() if _rt_mod.runtime_initialized() else None
    relay_before = getattr(_rt, "relay_bytes", 0)
    try:
        block_refs: List[Any] = []
        samples: list = []
        counts: List[int] = []
        for b in stream:
            counts.append(block_num_rows(b))
            if spec.sample_fn:
                samples.append(spec.sample_fn(b))
            # driver drops the block right away
            block_refs.append(track(api.put(b)))
        if not block_refs:
            return
        n_maps = len(block_refs)
        n_parts = spec.n_partitions or max(1, n_maps)
        meta = (spec.meta_fn(samples, counts, n_parts)
                if spec.meta_fn else None)

        map_remote = api.remote(num_cpus=1)(exchange_map_task)
        reduce_remote = api.remote(num_cpus=1)(exchange_reduce_task)
        pfn_ref = track(api.put(spec.partition_fn))
        meta_ref = track(api.put(meta))

        # map round: bounded submission window; results are tiny ref lists
        piece_refs: List[List[Any]] = []
        pending: List[Any] = []

        def pop_map_result():
            ref = track(pending.pop(0))
            pieces = api.get(ref)
            for p in pieces:
                track(p)
            piece_refs.append(pieces)
            untrack_free([ref])  # the ref-list envelope, not the pieces
        for i, bref in enumerate(block_refs):
            pending.append(map_remote.remote(pfn_ref, bref, i, n_parts,
                                             meta_ref))
            if len(pending) >= parallelism:
                pop_map_result()
        while pending:
            pop_map_result()
        untrack_free(block_refs)  # inputs fully partitioned; drop them

        rfn_ref = track(api.put(spec.reduce_fn))

        inflight: List[tuple] = []  # (result_ref, pieces_to_free)

        def drain_one():
            nonlocal max_reduce_bytes, n_out
            ref, to_free = inflight.pop(0)
            out_blocks, in_bytes = api.get(ref)
            max_reduce_bytes = max(max_reduce_bytes, in_bytes)
            # pieces + the consumed result object
            untrack_free(to_free + [ref])
            n_out += len(out_blocks)
            return out_blocks

        for j in range(n_parts):
            pieces_j = [pr[j] for pr in piece_refs]
            inflight.append(
                (track(reduce_remote.remote(rfn_ref, j, meta_ref,
                                            *pieces_j)),
                 pieces_j))
            if len(inflight) >= max(2, parallelism // 2):
                yield from drain_one()
        while inflight:
            yield from drain_one()
    finally:
        if live:
            api.free(list(live.values()))
            live.clear()
        stats.record(spec.name, time.time() - t0, n_out)
        stats.exchange[spec.name] = {
            "map_tasks": n_maps, "reduce_tasks": n_parts,
            "max_reduce_in_bytes": int(max_reduce_bytes),
            "relay_bytes": int(getattr(_rt, "relay_bytes", 0)
                               - relay_before)}
