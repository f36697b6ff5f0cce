"""Streaming executor for Dataset plans (counterpart of
ray_tpu/data/executor.py).

Reference parity: python/ray/data/_internal/execution/streaming_executor.py
— per-block tasks flow through the stage chain with bounded in-flight
parallelism (backpressure), stateful stages run on an actor pool, shuffle
stages act as barriers. Runs over the port's core runtime when
initialized; otherwise executes inline (local mode), which is also the
fast path for small datasets.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


from ..util import knobs
from .block import Block, block_size_bytes
from .plan import Stage, call_block_fn, fuse_stages

MAX_IN_FLIGHT = 8
# Byte budget for in-flight blocks (count-only
# backpressure lets 8 x 1-GB blocks pin 8 GB). Mirrors the reference's
# resource-budgeted streaming_executor_state; the count bound still
# applies on top. At least one block is always admitted so a single
# over-budget block can't deadlock the stream.
MAX_IN_FLIGHT_BYTES = knobs.get_int("RAY_TPU_DATA_INFLIGHT_BYTES")


class DatasetStats:
    def __init__(self):
        self.stage_wall: Dict[str, float] = {}
        self.stage_blocks: Dict[str, int] = {}
        # per-exchange instrumentation: map/reduce task counts and the
        # max bytes any single reduce task held (the ~1/N guarantee)
        self.exchange: Dict[str, Dict[str, int]] = {}
        # per-stage backpressure: byte budget + peak in-flight bytes
        self.backpressure: Dict[str, Dict[str, int]] = {}

    def record(self, name: str, dt: float, nblocks: int = 1):
        self.stage_wall[name] = self.stage_wall.get(name, 0.0) + dt
        self.stage_blocks[name] = self.stage_blocks.get(name, 0) + nblocks

    def summary(self) -> str:
        lines = ["Dataset execution stats:"]
        for name, wall in self.stage_wall.items():
            lines.append(f"  {name}: {wall*1000:.1f} ms over "
                         f"{self.stage_blocks.get(name, 0)} blocks")
        for name, ex in self.exchange.items():
            lines.append(
                f"  {name}: {ex['map_tasks']} map + {ex['reduce_tasks']} "
                f"reduce tasks, max reduce input "
                f"{ex['max_reduce_in_bytes']} B")
        for name, bp in self.backpressure.items():
            lines.append(
                f"  {name}: in-flight peak {bp['peak_inflight_bytes']} B "
                f"(budget {bp['budget_bytes']} B)")
        return "\n".join(lines)


def _runtime():
    from ..core import runtime as runtime_mod
    if runtime_mod.runtime_initialized():
        return runtime_mod.get_runtime()
    return None


def _stage_metrics():
    """(inflight-bytes gauge, stall counter, blocks counter); any
    registry failure degrades to None (metrics never break execution)."""
    try:
        from ..util import metrics_catalog as mcat
        return (mcat.get("ray_tpu_data_inflight_bytes"),
                mcat.get("ray_tpu_data_backpressure_stall_s_total"),
                mcat.get("ray_tpu_data_blocks_total"))
    except Exception:
        return None, None, None


def _emit_stall_event(stage_name: str, stall_s: float,
                      peak_bytes: int) -> None:
    """One cluster event per stage run that actually stalled on the
    in-flight budget (the counter metric carries the magnitude; the
    event makes the episode visible in `events` / post-mortems)."""
    if stall_s <= 0:
        return
    try:
        from ..util import events as events_mod
        events_mod.emit(
            "data.executor_stall",
            f"stage {stage_name!r} stalled {stall_s:.3f}s on the "
            f"in-flight backpressure budget",
            stage=stage_name, stall_s=round(stall_s, 4),
            budget_bytes=MAX_IN_FLIGHT_BYTES,
            peak_inflight_bytes=peak_bytes)
    except Exception:
        pass


def _apply_map(fn: Callable[[Block], Block], block: Block,
               index: int = 0) -> Block:
    return call_block_fn(fn, block, index)


class _StatefulMapActor:
    """Actor wrapper for map_batches(compute="actors") with a class fn."""

    def __init__(self, ctor_bytes):
        import cloudpickle
        ctor = cloudpickle.loads(ctor_bytes)
        self.fn = ctor()

    def apply(self, block: Block, index: int = 0) -> Block:
        return call_block_fn(self.fn, block, index)


def execute_plan(source_blocks: Iterator[Block], stages: Sequence[Stage],
                 stats: Optional[DatasetStats] = None,
                 parallelism: int = MAX_IN_FLIGHT,
                 local: bool = False) -> Iterator[Block]:
    """Stream blocks through the fused stage chain.

    ``local=True`` forces the inline execution paths even when the core
    runtime is initialized — used by data-service workers, which are
    themselves actors and must not fan out nested remote tasks.
    """
    stats = stats or DatasetStats()
    stages = fuse_stages(list(stages))
    stream: Iterator[Block] = source_blocks
    for stage in stages:
        stream = _apply_stage(stream, stage, stats, parallelism, local)
    return stream


def _apply_stage(stream: Iterator[Block], stage: Stage, stats: DatasetStats,
                 parallelism: int, local: bool = False) -> Iterator[Block]:
    if stage.kind == "map_block":
        if stage.compute == "actors" and stage.fn_constructor is not None:
            return _actor_pool_map(stream, stage, stats, parallelism, local)
        return _task_map(stream, stage, stats, parallelism, local)
    if stage.kind == "shuffle":
        def shuffled() -> Iterator[Block]:
            t0 = time.time()
            blocks = list(stream)
            out = stage.shuffle_fn(blocks)
            stats.record(stage.name, time.time() - t0, len(out))
            yield from out
        return shuffled()
    if stage.kind == "exchange":
        return _apply_exchange(stream, stage, stats, parallelism, local)
    if stage.kind == "window":
        def windowed() -> Iterator[Block]:
            t0 = time.time()
            n = 0
            for out in stage.window_fn(stream):
                n += 1
                yield out
            stats.record(stage.name, time.time() - t0, n)
        return windowed()
    raise ValueError(f"unknown stage kind {stage.kind}")


def _apply_exchange(stream: Iterator[Block], stage: Stage,
                    stats: DatasetStats,
                    parallelism: int,
                    local_mode: bool = False) -> Iterator[Block]:
    """Distributed two-round shuffle (map-partition + reduce-merge) over
    the core runtime; inline two-round fallback without it."""
    from .exchange import run_exchange_distributed, run_exchange_local
    if not local_mode and _runtime() is not None:
        return run_exchange_distributed(stream, stage.exchange, stats,
                                        parallelism)

    def local() -> Iterator[Block]:
        t0 = time.time()
        out = run_exchange_local(list(stream), stage.exchange)
        stats.record(stage.name, time.time() - t0, len(out))
        yield from out
    return local()


def _task_map(stream: Iterator[Block], stage: Stage, stats: DatasetStats,
              parallelism: int, local: bool = False) -> Iterator[Block]:
    rt = None if local else _runtime()
    if rt is None:
        def local() -> Iterator[Block]:
            for i, block in enumerate(stream):
                t0 = time.time()
                out = call_block_fn(stage.fn, block, i)
                stats.record(stage.name, time.time() - t0)
                yield out
        return local()

    from .. import api

    remote_fn = api.remote(num_cpus=1)(_apply_map)

    def distributed() -> Iterator[Block]:
        import collections
        t_start = time.time()
        window: "collections.deque" = collections.deque()  # (ref, bytes)
        inflight_bytes = 0
        peak = 0
        stall_s = 0.0
        g_inflight, c_stall, c_blocks = _stage_metrics()
        mtags = {"stage": stage.name}
        fn_ref = api.put(stage.fn)  # ship the (possibly fused) fn once

        def drain_one():
            nonlocal inflight_bytes
            ref, nbytes = window.popleft()
            inflight_bytes -= nbytes
            out = api.get(ref)
            if g_inflight is not None:
                g_inflight.set(float(inflight_bytes), tags=mtags)
            return out

        for i, block in enumerate(stream):
            nbytes = block_size_bytes(block)
            # byte budget first (count cap on top); always admit one
            while window and (inflight_bytes + nbytes
                              > MAX_IN_FLIGHT_BYTES
                              or len(window) >= parallelism):
                t0 = time.perf_counter()
                out = drain_one()
                dt = time.perf_counter() - t0
                stall_s += dt
                if c_stall is not None:
                    c_stall.inc(dt, tags=mtags)
                yield out
            window.append((remote_fn.remote(fn_ref, block, i), nbytes))
            inflight_bytes += nbytes
            peak = max(peak, inflight_bytes)
            if g_inflight is not None:
                g_inflight.set(float(inflight_bytes), tags=mtags)
            if c_blocks is not None:
                c_blocks.inc(tags=mtags)
        while window:
            yield drain_one()
        stats.record(stage.name, time.time() - t_start)
        stats.backpressure[stage.name] = {
            "budget_bytes": MAX_IN_FLIGHT_BYTES,
            "peak_inflight_bytes": peak,
            "stall_s": stall_s}
        _emit_stall_event(stage.name, stall_s, peak)
    return distributed()


def _actor_pool_map(stream: Iterator[Block], stage: Stage,
                    stats: DatasetStats, parallelism: int,
                    local: bool = False) -> Iterator[Block]:
    rt = None if local else _runtime()
    import cloudpickle
    ctor_bytes = cloudpickle.dumps(stage.fn_constructor)
    if rt is None:
        fn = stage.fn_constructor()

        def local() -> Iterator[Block]:
            for i, block in enumerate(stream):
                t0 = time.time()
                out = call_block_fn(fn, block, i)
                stats.record(stage.name, time.time() - t0)
                yield out
        return local()

    from .. import api
    pool_size = min(2, parallelism)
    actor_cls = api.remote(num_cpus=1)(_StatefulMapActor)
    actors = [actor_cls.remote(ctor_bytes) for _ in range(pool_size)]

    def distributed() -> Iterator[Block]:
        import collections
        t_start = time.time()
        window: "collections.deque" = collections.deque()  # (ref, bytes)
        inflight_bytes = 0
        peak = 0
        stall_s = 0.0
        i = 0
        g_inflight, c_stall, c_blocks = _stage_metrics()
        mtags = {"stage": stage.name}

        def drain_one():
            nonlocal inflight_bytes
            ref, nbytes = window.popleft()
            inflight_bytes -= nbytes
            out = api.get(ref)
            if g_inflight is not None:
                g_inflight.set(float(inflight_bytes), tags=mtags)
            return out

        for block in stream:
            nbytes = block_size_bytes(block)
            while window and (inflight_bytes + nbytes
                              > MAX_IN_FLIGHT_BYTES
                              or len(window) >= parallelism):
                t0 = time.perf_counter()
                out = drain_one()
                dt = time.perf_counter() - t0
                stall_s += dt
                if c_stall is not None:
                    c_stall.inc(dt, tags=mtags)
                yield out
            actor = actors[i % pool_size]
            window.append((actor.apply.remote(block, i), nbytes))
            i += 1
            inflight_bytes += nbytes
            peak = max(peak, inflight_bytes)
            if g_inflight is not None:
                g_inflight.set(float(inflight_bytes), tags=mtags)
            if c_blocks is not None:
                c_blocks.inc(tags=mtags)
        while window:
            yield drain_one()
        stats.record(stage.name, time.time() - t_start)
        stats.backpressure[stage.name] = {
            "budget_bytes": MAX_IN_FLIGHT_BYTES,
            "peak_inflight_bytes": peak,
            "stall_s": stall_s}
        _emit_stall_event(stage.name, stall_s, peak)
        for a in actors:
            try:
                api.kill(a)
            except Exception:
                pass
    return distributed()
