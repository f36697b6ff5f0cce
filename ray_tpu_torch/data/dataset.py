"""Dataset: lazy, distributed, streaming data pipelines (counterpart of
ray_tpu/data/dataset.py).

Reference parity: python/ray/data/dataset.py (transform/consume verbs),
read_api.py (sources), grouped_data.py (groupby/aggregate),
iterator.py (iter_batches). Execution goes through executor.py;
terminal `iter_device_batches` double-buffers host->card transfers
(device_loader.py) so the card never waits on input (reference:
iter_torch_batches + its prefetching).

Deliberate difference: the reference's `iter_jax_batches` is
`iter_device_batches` here. It takes the same arguments and a
`device=` (default "cuda"; asking for CUDA where there is none raises,
`device="cpu"` gives host tensors), and its `sharding` is a
`parallel.sharding.BatchSharding`, as `device_put_iterator` takes one.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from .block import (Block, block_concat, block_from_rows, block_num_rows,
                    block_select, block_slice, block_take,
                    block_to_rows,
                    block_size_bytes)
from .executor import DatasetStats, execute_plan
from .plan import (Stage, filter_stage, map_batches_stage, map_rows_stage)

DEFAULT_BLOCK_ROWS = 1024


@dataclasses.dataclass
class _Source:
    name: str
    make_blocks: Callable[[], Iterator[Block]]
    num_rows: Optional[int] = None


class Dataset:
    def __init__(self, source: _Source, stages: Tuple[Stage, ...] = ()):
        self._source = source
        self._stages = tuple(stages)
        self._stats = DatasetStats()
        self._materialized: Optional[List[Block]] = None

    # ---------------- transforms (lazy) ----------------
    def _with_stage(self, stage: Stage) -> "Dataset":
        return Dataset(self._source, self._stages + (stage,))

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._with_stage(map_rows_stage(f"map({_name(fn)})", fn))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return self._with_stage(
            map_rows_stage(f"flat_map({_name(fn)})", fn, flat=True))

    def filter(self, pred: Callable[[Dict], bool]) -> "Dataset":
        return self._with_stage(filter_stage(f"filter({_name(pred)})", pred))

    def map_batches(self, fn, *, batch_size: Optional[int] = None,
                    compute: str = "tasks",
                    fn_constructor_args: Tuple = ()) -> "Dataset":
        if isinstance(fn, type):
            ctor = (lambda fn=fn, a=fn_constructor_args: fn(*a))
            stage = map_batches_stage(f"map_batches({fn.__name__})",
                                      None, compute="actors",
                                      fn_constructor=ctor)
        else:
            stage = map_batches_stage(f"map_batches({_name(fn)})", fn,
                                      compute=compute)
        ds = self._with_stage(stage)
        if batch_size is not None:
            return ds._rebatched(batch_size)
        return ds

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]
                   ) -> "Dataset":
        def add(block: Block) -> Block:
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out
        return self._with_stage(map_batches_stage(f"add_column({name})", add))

    def drop_columns(self, cols: Sequence[str]) -> "Dataset":
        cols = set(cols)
        return self._with_stage(map_batches_stage(
            f"drop_columns({sorted(cols)})",
            lambda b: {k: v for k, v in b.items() if k not in cols}))

    def select_columns(self, cols: Sequence[str]) -> "Dataset":
        keep = list(cols)
        return self._with_stage(map_batches_stage(
            f"select_columns({keep})",
            lambda b: {k: b[k] for k in keep}))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self._with_stage(map_batches_stage(
            f"rename_columns({mapping})",
            lambda b: {mapping.get(k, k): v for k, v in b.items()}))

    def _rebatched(self, rows_per_block: int) -> "Dataset":
        """STREAMING re-chunk: holds at most (carry + one block), never
        the concatenated dataset."""
        def window_fn(stream):
            # parts accumulate as SLICES and concat once per emitted
            # batch — concatenating the carry into every incoming block
            # would copy O(rows_per_block^2) rows for tiny input blocks
            parts: List[Block] = []
            have = 0
            for block in stream:
                i = 0
                n = block_num_rows(block)
                while i < n:
                    take = min(rows_per_block - have, n - i)
                    parts.append(block_slice(block, i, i + take))
                    have += take
                    i += take
                    if have == rows_per_block:
                        yield block_concat(parts)
                        parts, have = [], 0
            if have:
                yield block_concat(parts)
        return self._with_stage(Stage(
            name=f"rebatch({rows_per_block})", kind="window",
            window_fn=window_fn))

    # ---------------- shuffles (distributed exchanges) ----------------
    # Each is a two-round map-partition + reduce-merge exchange over the
    # core runtime (exchange.py) — no process ever holds the
    # concatenated dataset (reference: _internal/planner/exchange/).
    def repartition(self, num_blocks: int) -> "Dataset":
        from .exchange import repartition_spec
        spec = repartition_spec(num_blocks)
        return self._with_stage(Stage(name=spec.name, kind="exchange",
                                      exchange=spec))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        from .exchange import random_shuffle_spec
        spec = random_shuffle_spec(seed)
        return self._with_stage(Stage(name=spec.name, kind="exchange",
                                      exchange=spec))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        from .exchange import sort_spec
        spec = sort_spec(key, descending)
        return self._with_stage(Stage(name=spec.name, kind="exchange",
                                      exchange=spec))

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        """Bernoulli sample each row with probability `fraction`
        (reference: Dataset.random_sample) — a vectorized per-block
        mask, deterministic per (seed, block index)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")

        def sample(block: Block, block_index: int = 0) -> Block:
            n = block_num_rows(block)
            # Seed from (seed, block_index) — the index is threaded
            # through the stage by the executor, so every deserialized
            # worker copy of this fn derives the SAME per-block stream.
            # A closure counter here would restart at 0 in each copy and
            # correlate masks across blocks under distributed execution.
            rng = np.random.default_rng(
                None if seed is None
                else (seed & 0xFFFF_FFFF_FFFF_FFFF, block_index))
            keep = rng.random(n) < fraction
            return {k: np.asarray(v)[keep] for k, v in block.items()}

        sample._wants_block_index = True
        return self._with_stage(map_batches_stage(
            f"random_sample({fraction})", sample))

    def limit(self, n: int) -> "Dataset":
        def shuffle_fn(blocks: List[Block]) -> List[Block]:
            out, got = [], 0
            for b in blocks:
                take = min(block_num_rows(b), n - got)
                if take > 0:
                    out.append(block_slice(b, 0, take))
                    got += take
                if got >= n:
                    break
            return out
        return self._with_stage(Stage(name=f"limit({n})", kind="shuffle",
                                      shuffle_fn=shuffle_fn))

    def union(self, other: "Dataset") -> "Dataset":
        left, right = self, other

        def make_blocks():
            yield from left.iter_blocks()
            yield from right.iter_blocks()
        return Dataset(_Source("union", make_blocks))

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned column zip, STREAMING: both sides advance block
        by block with bounded carries, never either dataset whole.
        Extra rows on the longer side drop (reference zip semantics:
        truncate to the shorter)."""
        left, right = self, other

        def make_blocks():
            rit = right.iter_blocks()
            rcarry: Optional[Block] = None
            right_done = False
            for lb in left.iter_blocks():
                need = block_num_rows(lb)
                if need == 0:
                    continue   # empty left block (e.g. filtered out)
                parts: List[Block] = []
                got = 0
                while got < need:
                    if rcarry is None or not block_num_rows(rcarry):
                        rcarry = next(rit, None)
                        if rcarry is None:
                            right_done = True
                            break
                    take = min(block_num_rows(rcarry), need - got)
                    parts.append(block_slice(rcarry, 0, take))
                    rcarry = block_slice(rcarry, take,
                                         block_num_rows(rcarry))
                    got += take
                if got:
                    rb = block_concat(parts)
                    merged = dict(block_slice(lb, 0, got))
                    for k, v in rb.items():
                        merged[k if k not in merged else f"{k}_1"] = v
                    yield merged
                if right_done:
                    return   # truncate to the shorter side
        return Dataset(_Source("zip", make_blocks))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # ---------------- splits ----------------
    def split(self, n: int) -> List["Dataset"]:
        """Contiguous n-way split at BLOCK granularity: interior blocks
        pass through by reference, only boundary blocks are sliced —
        no whole-dataset concatenation (same approach as
        split_proportionately)."""
        blocks = list(self.iter_blocks())
        counts = [block_num_rows(b) for b in blocks]
        total = sum(counts)
        per = math.ceil(total / n)
        out: List["Dataset"] = []
        bi, off = 0, 0
        for i in range(n):
            need = min(per, total - i * per) if total > i * per else 0
            parts: List[Block] = []
            while need > 0 and bi < len(blocks):
                take = min(counts[bi] - off, need)
                if take == counts[bi] and off == 0:
                    parts.append(blocks[bi])
                else:
                    parts.append(block_slice(blocks[bi], off, off + take))
                need -= take
                off += take
                if off >= counts[bi]:
                    bi += 1
                    off = 0
            out.append(from_blocks(parts, name=f"split_{i}"))
        return out

    def split_proportionately(self, fractions: Sequence[float]
                              ) -> List["Dataset"]:
        """Split by row fractions; the remainder forms a final dataset
        (reference: Dataset.split_proportionately — n fractions yield
        n+1 datasets)."""
        if not fractions or sum(fractions) >= 1.0 \
                or any(f <= 0 for f in fractions):
            raise ValueError("fractions must be positive and sum to <1")
        # one plan execution at BLOCK granularity: only boundary blocks
        # are sliced; interior blocks pass through by reference (no
        # per-row materialization in driver memory)
        blocks = list(self.iter_blocks())
        counts = [block_num_rows(b) for b in blocks]
        total = sum(counts)
        sizes = [int(total * f) for f in fractions]
        sizes.append(total - sum(sizes))
        out: List["Dataset"] = []
        bi, off = 0, 0
        for sz in sizes:
            need = sz
            parts: List[Block] = []
            while need > 0 and bi < len(blocks):
                take = min(counts[bi] - off, need)
                if take == counts[bi] and off == 0:
                    parts.append(blocks[bi])
                else:
                    parts.append(block_slice(blocks[bi], off, off + take))
                need -= take
                off += take
                if off >= counts[bi]:
                    bi += 1
                    off = 0
            out.append(from_blocks(parts, name="split_prop"))
        return out

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        """(train, test) split (reference: Dataset.train_test_split)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        train, test = ds.split_proportionately([1.0 - test_size])
        return train, test

    def streaming_split(self, n: int) -> List["Dataset"]:
        """Round-robin block split; each shard re-streams the parent."""
        parent = self

        def make_shard(idx):
            def make_blocks():
                for i, b in enumerate(parent.iter_blocks()):
                    if i % n == idx:
                        yield b
            return Dataset(_Source(f"stream_split_{idx}", make_blocks))
        return [make_shard(i) for i in range(n)]

    def split_for_worker(self, rank: int, world: int) -> "Dataset":
        return self.streaming_split(world)[rank]

    def to_service(self, job_name: str, *, mode: str = "fcfs",
                   world_size: int = 1, epochs: int = 1,
                   dataset_name: Optional[str] = None,
                   n_slices: Optional[int] = None) -> str:
        """Register this dataset's plan with the shared data service.

        The plan runs once on the service's data-worker pool no matter
        how many jobs consume it; consumers obtain per-consumer
        iterators via ``data.service.iterator(job_name, rank=...)``.
        Returns the dataset key (jobs registering the same plan — or
        the same explicit ``dataset_name`` — share production). See
        docs/DATA_SERVICE.md.
        """
        from . import service
        return service.register(self, job_name, mode=mode,
                                world_size=world_size, epochs=epochs,
                                dataset_name=dataset_name,
                                n_slices=n_slices)

    # ---------------- execution ----------------
    def iter_blocks(self) -> Iterator[Block]:
        if self._materialized is not None:
            yield from self._materialized
            return
        yield from execute_plan(self._source.make_blocks(), self._stages,
                                self._stats)

    def materialize(self) -> "Dataset":
        self._materialized = list(self.iter_blocks())
        return self

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self.iter_blocks():
            yield from block_to_rows(block)

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Block]:
        """Batches of `batch_size` rows. local_shuffle_buffer_size
        enables reference-style windowed shuffling at iteration time: a
        rolling buffer of at least that many rows is sampled without
        replacement per batch — an O(buffer) approximate shuffle, no
        full-dataset pass (reference: iter_batches
        local_shuffle_buffer_size)."""
        if local_shuffle_buffer_size:
            yield from self._iter_batches_shuffled(
                batch_size, drop_last, local_shuffle_buffer_size,
                local_shuffle_seed)
            return
        carry: Optional[Block] = None
        for block in self.iter_blocks():
            if carry is not None:
                block = block_concat([carry, block])
                carry = None
            n = block_num_rows(block)
            i = 0
            while n - i >= batch_size:
                yield block_slice(block, i, i + batch_size)
                i += batch_size
            if i < n:
                carry = block_slice(block, i, n)
        if carry is not None and not drop_last:
            yield carry

    def _iter_batches_shuffled(self, batch_size: int, drop_last: bool,
                               buffer_rows: int,
                               seed: Optional[int]) -> Iterator[Block]:
        rng = np.random.RandomState(seed)
        buf: Optional[Block] = None
        for block in self.iter_blocks():
            buf = block if buf is None else block_concat([buf, block])
            while block_num_rows(buf) >= buffer_rows + batch_size:
                pick = rng.choice(block_num_rows(buf), batch_size,
                                  replace=False)
                yield block_take(buf, pick)
                keep = np.ones(block_num_rows(buf), bool)
                keep[pick] = False
                buf = block_select(buf, keep)
        if buf is not None:
            order = rng.permutation(block_num_rows(buf))
            buf = block_take(buf, order)
            n = block_num_rows(buf)
            for i in range(0, n, batch_size):
                if i + batch_size <= n:
                    yield block_slice(buf, i, i + batch_size)
                elif not drop_last:
                    yield block_slice(buf, i, n)

    def iter_device_batches(self, *, batch_size: int = 256,
                            drop_last: bool = True, sharding=None,
                            prefetch: int = 2,
                            dtypes: Optional[Dict[str, Any]] = None,
                            device="cuda"):
        """Batches as dicts of tensors on `device`, `prefetch` of them
        staged ahead (the reference's iter_jax_batches). int64 columns
        arrive as int32 and float64 as float32 unless `dtypes` names a
        numpy dtype for the column; a `BatchSharding` gives this rank's
        share of each batch as a `LocalBatch`."""
        from .device_loader import device_put_iterator
        host_iter = self.iter_batches(batch_size=batch_size,
                                      drop_last=drop_last)
        return device_put_iterator(host_iter, sharding=sharding,
                                   prefetch=prefetch, dtypes=dtypes,
                                   device=device)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False, device=None,
                           dtypes: Optional[Dict[str, Any]] = None):
        """Batches as torch tensors (reference: iter_torch_batches).
        Object-dtype columns (strings) pass through as-is."""
        import torch  # noqa: PLC0415
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                if v.dtype == object:
                    out[k] = v
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                if device is not None:
                    t = t.to(device)
                out[k] = t
            yield out

    # ---------------- consumption ----------------
    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        if self._source.num_rows is not None and not self._stages:
            return self._source.num_rows
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def schema(self) -> Dict[str, Any]:
        for block in self.iter_blocks():
            return {k: v.dtype for k, v in block.items()}
        return {}

    def columns(self) -> List[str]:
        return list(self.schema().keys())

    # ---- global aggregate terminals (reference: Dataset.sum/mean/...) ----
    def _col_blocks(self, col: str):
        for block in self.iter_blocks():
            if col not in block:
                raise KeyError(f"no column {col!r}; have "
                               f"{list(block.keys())}")
            yield np.asarray(block[col])

    def sum(self, col: str):
        return sum(b.sum() for b in self._col_blocks(col))

    def min(self, col: str):
        return min(b.min() for b in self._col_blocks(col))

    def max(self, col: str):
        return max(b.max() for b in self._col_blocks(col))

    def mean(self, col: str) -> float:
        total, n = 0.0, 0
        for b in self._col_blocks(col):
            total += float(b.sum())
            n += b.size
        return total / max(n, 1)

    def std(self, col: str, ddof: int = 1) -> float:
        # two-pass over streamed blocks: exact, no full materialization
        mu = self.mean(col)
        ssq, n = 0.0, 0
        for b in self._col_blocks(col):
            ssq += float(((b - mu) ** 2).sum())
            n += b.size
        return math.sqrt(ssq / max(n - ddof, 1))

    def unique(self, col: str) -> List[Any]:
        seen = set()
        out: List[Any] = []
        for b in self._col_blocks(col):
            for v in np.unique(b):
                key = v.item() if hasattr(v, "item") else v
                if key not in seen:
                    seen.add(key)
                    out.append(key)
        return out

    def size_bytes(self) -> int:
        return sum(block_size_bytes(b) for b in self.iter_blocks())

    def stats(self) -> str:
        return self._stats.summary()

    def stats_object(self) -> DatasetStats:
        """The raw DatasetStats (per-stage wall/blocks + per-exchange
        map/reduce task counts and max reduce-task bytes)."""
        return self._stats

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    # ---- writes (reference: Dataset.write_csv/json/numpy/parquet; one
    # part-<i> file per block into a directory) ----
    def _write_parts(self, path: str, ext: str, write_block) -> List[str]:
        import os as osmod
        osmod.makedirs(path, exist_ok=True)
        out = []
        for i, block in enumerate(self.iter_blocks()):
            fname = osmod.path.join(path, f"part-{i:05d}.{ext}")
            write_block(fname, block)
            out.append(fname)
        return out

    def write_csv(self, path: str) -> List[str]:
        import csv as csvmod

        def wb(fname, block):
            cols = list(block.keys())
            n = len(next(iter(block.values()))) if block else 0
            # csv.writer quotes/escapes commas, quotes, and newlines —
            # pairs with read_csv's csv.DictReader
            with open(fname, "w", newline="") as f:
                w = csvmod.writer(f)
                w.writerow(cols)
                for r in range(n):
                    w.writerow([block[c][r] for c in cols])
        return self._write_parts(path, "csv", wb)

    def write_jsonl(self, path: str) -> List[str]:
        import json as jsonmod

        def wb(fname, block):
            cols = list(block.keys())
            n = len(next(iter(block.values()))) if block else 0
            with open(fname, "w") as f:
                for r in range(n):
                    row = {c: block[c][r].item()
                           if hasattr(block[c][r], "item")
                           else block[c][r] for c in cols}
                    f.write(jsonmod.dumps(row) + "\n")
        return self._write_parts(path, "jsonl", wb)

    def write_json(self, path: str) -> List[str]:
        return self.write_jsonl(path)

    def write_npy(self, path: str, column: str) -> List[str]:
        def wb(fname, block):
            # write through the handle: np.save(path) would append a
            # second .npy to the part name
            with open(fname, "wb") as f:
                np.save(f, np.asarray(block[column]))
        return self._write_parts(path, "npy", wb)

    def to_pandas(self, limit: Optional[int] = None):
        """Materialize into one pandas DataFrame (reference:
        Dataset.to_pandas). `limit` caps rows like the reference's
        default guard; None = no cap."""
        import pandas as pd  # noqa: PLC0415
        frames = []
        seen = 0
        for block in self.iter_blocks():
            n = len(next(iter(block.values()))) if block else 0
            if limit is not None and seen + n > limit:
                block = {k: v[:limit - seen] for k, v in block.items()}
                n = limit - seen
            frames.append(pd.DataFrame(
                {k: np.asarray(v) for k, v in block.items()}))
            seen += n
            if limit is not None and seen >= limit:
                break
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def write_parquet(self, path: str) -> List[str]:
        import pyarrow as pa  # noqa: PLC0415
        import pyarrow.parquet as pq  # noqa: PLC0415

        def wb(fname, block):
            table = pa.table({k: pa.array(np.asarray(v))
                              for k, v in block.items()})
            pq.write_table(table, fname)
        return self._write_parts(path, "parquet", wb)

    def __repr__(self):
        stages = " -> ".join(s.name for s in self._stages) or "identity"
        return f"Dataset(source={self._source.name}, plan={stages})"


# ---------------- grouped data ----------------
@dataclasses.dataclass
class AggregateFn:
    name: str
    init: Callable[[], Any]
    accumulate: Callable[[Any, np.ndarray], Any]
    finalize: Callable[[Any], Any]


def _builtin_agg(kind: str, col: str) -> AggregateFn:
    if kind == "count":
        return AggregateFn(f"count()", lambda: 0,
                           lambda acc, v: acc + len(v), lambda acc: acc)
    ops = {
        "sum": (lambda: 0.0, lambda acc, v: acc + v.sum(), lambda a: a),
        "min": (lambda: np.inf, lambda acc, v: min(acc, v.min()),
                lambda a: a),
        "max": (lambda: -np.inf, lambda acc, v: max(acc, v.max()),
                lambda a: a),
        "mean": (lambda: (0.0, 0), lambda acc, v: (acc[0] + v.sum(),
                                                   acc[1] + len(v)),
                 lambda a: a[0] / max(a[1], 1)),
        "std": (lambda: (0.0, 0.0, 0),
                lambda acc, v: (acc[0] + v.sum(),
                                acc[1] + (v.astype(np.float64) ** 2).sum(),
                                acc[2] + len(v)),
                lambda a: float(np.sqrt(max(
                    a[1] / max(a[2], 1) - (a[0] / max(a[2], 1)) ** 2, 0.0)))),
    }
    init, acc, fin = ops[kind]
    return AggregateFn(f"{kind}({col})", init, acc, fin)


class GroupedData:
    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _aggregate(self, aggs: List[Tuple[str, Optional[str]]]) -> Dataset:
        """Distributed: range-partition rows by group key (sampled
        boundaries, like sort) so each group lands wholly in one reduce
        task AND the concatenated output stays globally key-sorted —
        the same order as a single-process group-by."""
        from .exchange import groupby_agg_spec
        spec = groupby_agg_spec(self._key, list(aggs), _builtin_agg)
        return self._ds._with_stage(Stage(name=spec.name, kind="exchange",
                                          exchange=spec))

    def count(self) -> Dataset:
        return self._aggregate([("count", None)])

    def sum(self, col: str) -> Dataset:
        return self._aggregate([("sum", col)])

    def mean(self, col: str) -> Dataset:
        return self._aggregate([("mean", col)])

    def min(self, col: str) -> Dataset:
        return self._aggregate([("min", col)])

    def max(self, col: str) -> Dataset:
        return self._aggregate([("max", col)])

    def std(self, col: str) -> Dataset:
        return self._aggregate([("std", col)])

    def aggregate(self, *specs: Tuple[str, str]) -> Dataset:
        return self._aggregate(list(specs))

    def map_groups(self, fn: Callable[[Block], Block]) -> Dataset:
        """Apply `fn` to each group's block (reference:
        GroupedData.map_groups); distributed like the aggregations —
        each group lands wholly in one reduce task, output stays in
        ascending key order."""
        from .exchange import groupby_map_spec
        spec = groupby_map_spec(self._key, fn)
        return self._ds._with_stage(Stage(name=spec.name, kind="exchange",
                                          exchange=spec))


def _name(fn) -> str:
    return getattr(fn, "__name__", "fn")


# ---------------- sources (read_api parity) ----------------
def from_blocks(blocks: List[Block], name: str = "blocks") -> Dataset:
    n = sum(block_num_rows(b) for b in blocks)
    return Dataset(_Source(name, lambda: iter(list(blocks)), num_rows=n))


def from_items(items: List[Any],
               block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    blocks = [block_from_rows(rows[i:i + block_rows])
              for i in range(0, len(rows), block_rows)]
    return from_blocks(blocks, "from_items")


def range_(n: int, block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    def make_blocks():
        for i in range(0, n, block_rows):
            hi = min(i + block_rows, n)
            yield {"id": np.arange(i, hi, dtype=np.int64)}
    return Dataset(_Source("range", make_blocks, num_rows=n))


def from_numpy(arrays: Dict[str, np.ndarray],
               block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    n = len(next(iter(arrays.values())))

    def make_blocks():
        for i in range(0, n, block_rows):
            yield {k: v[i:min(i + block_rows, n)] for k, v in arrays.items()}
    return Dataset(_Source("from_numpy", make_blocks, num_rows=n))


def from_pandas(df, block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    """pandas DataFrame -> numpy-columnar Dataset (reference:
    ray.data.from_pandas; object-dtype columns stay object arrays)."""
    arrays = {str(col): df[col].to_numpy() for col in df.columns}
    if not arrays:
        return from_items([])
    return from_numpy(arrays, block_rows)


def read_text(path: str, block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    def make_blocks():
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        for i in range(0, len(lines), block_rows):
            yield {"text": np.asarray(lines[i:i + block_rows], dtype=object)}
    return Dataset(_Source(f"read_text({path})", make_blocks))


def read_jsonl(path: str, block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    import json

    def make_blocks():
        rows = []
        with open(path) as f:
            for ln in f:
                if ln.strip():
                    rows.append(json.loads(ln))
        for i in range(0, len(rows), block_rows):
            yield block_from_rows(rows[i:i + block_rows])
    return Dataset(_Source(f"read_jsonl({path})", make_blocks))


def read_csv(path: str, block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    import csv

    def make_blocks():
        with open(path) as f:
            rows = list(csv.DictReader(f))
        conv = []
        for r in rows:
            out = {}
            for k, v in r.items():
                try:
                    out[k] = float(v) if "." in v else int(v)
                except (ValueError, TypeError):
                    out[k] = v
            conv.append(out)
        for i in range(0, len(conv), block_rows):
            yield block_from_rows(conv[i:i + block_rows])
    return Dataset(_Source(f"read_csv({path})", make_blocks))


def read_npy(path: str, column: str = "data",
             block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    arr = np.load(path)
    return from_numpy({column: arr}, block_rows)


def _list_files(path: str, *, suffixes=None,
                pattern: str = "*") -> List[str]:
    """Shared reader file listing: directory (recursive) or single
    file; case-insensitive suffix filter; deterministic order."""
    import glob as globmod
    import os as osmod
    if not osmod.path.isdir(path):
        return [path]
    sfx = (None if suffixes is None
           else tuple(s.lower() for s in suffixes))
    files = sorted(
        f for f in globmod.glob(osmod.path.join(path, "**", pattern),
                                recursive=True)
        if osmod.path.isfile(f)
        and (sfx is None or f.lower().endswith(sfx)))
    if not files:
        raise FileNotFoundError(f"no matching files under {path!r}")
    return files


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def read_images(path: str, *, size: Optional[Tuple[int, int]] = None,
                mode: str = "RGB", include_paths: bool = False,
                block_rows: int = 64) -> Dataset:
    """Directory (recursive) or single file of images -> blocks with an
    "image" column of uint8 arrays (reference: python/ray/data
    read_api.py read_images — Arrow/PIL there; numpy blocks + PIL here,
    feeding the ViT/CLIP pipeline of BASELINE config 3).

    size=(H, W) resizes at decode so the column stacks into one dense
    (N, H, W, C) array per block — the layout iter_device_batches ships
    to the card. Without `size`, images keep their native resolutions as an
    object column (stack later with a map_batches resize).
    """
    from PIL import Image

    files = _list_files(path, suffixes=_IMAGE_EXTS)

    def decode(fp: str) -> np.ndarray:
        with Image.open(fp) as im:
            im = im.convert(mode)
            if size is not None:
                im = im.resize((size[1], size[0]))  # PIL wants (W, H)
            return np.asarray(im, dtype=np.uint8)

    def make_blocks():
        for i in range(0, len(files), block_rows):
            chunk = files[i:i + block_rows]
            imgs = [decode(f) for f in chunk]
            if size is not None:
                col = np.stack(imgs)
            else:
                col = np.empty(len(imgs), dtype=object)
                for j, a in enumerate(imgs):
                    col[j] = a
            block: Block = {"image": col}
            if include_paths:
                block["path"] = np.asarray(chunk, dtype=object)
            yield block

    return Dataset(_Source(f"read_images({path})", make_blocks,
                           num_rows=len(files)))


def read_binary_files(path: str, *, include_paths: bool = True,
                      suffixes: Optional[Sequence[str]] = None,
                      block_rows: int = 64) -> Dataset:
    """Directory (recursive) or single file -> blocks with a "bytes"
    object column (+ "path"). Reference: read_api.py
    read_binary_files — the escape hatch for formats without a
    dedicated reader."""
    files = _list_files(path, suffixes=suffixes)

    def make_blocks():
        for i in range(0, len(files), block_rows):
            chunk = files[i:i + block_rows]
            col = np.empty(len(chunk), dtype=object)
            for j, f in enumerate(chunk):
                with open(f, "rb") as fh:
                    col[j] = fh.read()
            block: Block = {"bytes": col}
            if include_paths:
                block["path"] = np.asarray(chunk, dtype=object)
            yield block

    return Dataset(_Source(f"read_binary_files({path})", make_blocks,
                           num_rows=len(files)))


def _tfrecord_records(path: str):
    """Iterate raw record payloads of one TFRecord file. Framing per the
    public format: uint64 length, uint32 masked-crc(length), payload,
    uint32 masked-crc(payload); CRCs are not verified (no snappy/crc32c
    dependency in-image)."""
    import struct
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return                     # clean EOF between records
            if len(header) < 8:
                raise ValueError(f"truncated TFRecord {path!r} "
                                 f"(partial length header)")
            (length,) = struct.unpack("<Q", header)
            if len(f.read(4)) < 4:         # length crc
                raise ValueError(f"truncated TFRecord {path!r} "
                                 f"(missing length crc)")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"truncated TFRecord {path!r}")
            if len(f.read(4)) < 4:         # payload crc
                raise ValueError(f"truncated TFRecord {path!r} "
                                 f"(missing payload crc)")
            yield payload


def read_tfrecords(path: str, *, parse_fn: Optional[Callable] = None,
                   block_rows: int = DEFAULT_BLOCK_ROWS) -> Dataset:
    """TFRecord file(s) -> blocks (reference: read_api.py
    read_tfrecords; Arrow/TFX there, numpy blocks here).

    Default rows are {"bytes": record} — pass parse_fn(record_bytes) ->
    dict to decode (e.g. a tf.train.Example parser via the protobuf
    runtime); its dicts become columnar blocks."""
    files = _list_files(path, pattern="*.tfrecord*")

    def make_blocks():
        rows: List[Dict[str, Any]] = []
        for f in files:
            for rec in _tfrecord_records(f):
                rows.append(parse_fn(rec) if parse_fn
                            else {"bytes": rec})
                if len(rows) >= block_rows:
                    yield block_from_rows(rows)
                    rows = []
        if rows:
            yield block_from_rows(rows)

    return Dataset(_Source(f"read_tfrecords({path})", make_blocks))


def read_parquet(path: str,
                 block_rows: int = DEFAULT_BLOCK_ROWS,
                 columns=None) -> Dataset:
    """Parquet file(s) -> numpy-columnar blocks, one block per row group
    (re-chunked to block_rows). `path` may be a file or a directory of
    .parquet files. Reference: python/ray/data read_parquet (Arrow-backed
    there; columns land as numpy here like every other block)."""
    import glob as globmod
    import os as osmod
    try:
        import pyarrow.parquet as pq  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover - baked into this image
        raise ImportError("read_parquet requires pyarrow") from e

    if osmod.path.isdir(path):
        files = sorted(globmod.glob(osmod.path.join(path, "*.parquet")))
        if not files:
            raise FileNotFoundError(
                f"no *.parquet files in directory {path!r}")
    else:
        files = [path]

    def make_blocks():
        for f in files:
            pf = pq.ParquetFile(f)
            for batch in pf.iter_batches(batch_size=block_rows,
                                         columns=columns):
                cols = {}
                for name, col in zip(batch.schema.names, batch.columns):
                    arr = col.to_numpy(zero_copy_only=False)
                    if not arr.flags.writeable:
                        # Arrow hands out read-only views; every other
                        # source yields mutable blocks, so copy for a
                        # consistent contract.
                        arr = np.array(arr)
                    cols[name] = arr
                yield cols
    return Dataset(_Source(f"read_parquet({path})", make_blocks))
