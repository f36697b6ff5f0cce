"""CUDA graphs of a decoder's one-token decode forward over a paged cache.

A serving engine's decode step runs the model once over one token a
slot. Issued op by op from Python that is a few thousand small launches
(Mixtral at 16 layers: ~7,400 a step), and on the card the host issuing
them, not the card, sets the step's pace. `DecodeGraphs` captures the
model's own eager forward once per page-table width as a
`torch.cuda.CUDAGraph` and replays it: the same kernels (K3 among them)
in the same order, on the same weights and KV pools.

The model's forward takes the graphs (`forward(..., graphs=)`) and asks
`replay` first. A call that `decode_key` keys and that has a graph is
replayed: its tokens, positions, lengths and page table are copied into
the graph's static inputs, the graph replays inside the span
`llm.decode_graph`, and what the forward counted at capture
(`moe.rows_computed`; observability/profiler.py) and K3's launches are
counted again (the capture counts K3 only for its side-stream pass,
the one that launches). `replay` returns the graph's outputs, which the next
replay overwrites: the caller reads them on the stream first. Every
other call gets None and runs the forward eagerly.

A graph holds the addresses it was captured on. Weights copied in place
(`LLMEngine.set_params`) are read by the next replay; a replay that
finds the model's weights or the pools in other storage than at
capture drops every graph and runs eagerly.

`capture` runs the forward once on a side stream (the warm-up torch
asks for) and once under capture, on static inputs whose page table is
all `fill` (the engine's trash page), so neither pass writes a live
page. All graphs share one memory pool: one replays at a time, and its
outputs are read before another replays.
"""
from __future__ import annotations

import inspect
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch.distributed.tensor import DTensor

from ..observability.profiler import annotate, count, recording_counts
from ..ops.attention import PagedKV, paged_attn_impl
from ..ops.kernels import paged_attention as _k3


def available(device) -> bool:
    """Whether decode graphs run on `device`: CUDA only."""
    return torch.device(device).type == "cuda"


def supported(model) -> bool:
    """Whether `model`'s decode forward can be captured: its forward
    takes `graphs=`, and it is not sharded (a DTensor weight, a MoE
    layer's mesh or a tp rank's kv heads exchange sizes with the host or
    talk to other ranks inside the forward)."""
    if "graphs" not in inspect.signature(model.forward).parameters:
        return False
    if any(isinstance(p, DTensor) for p in model.parameters()):
        return False
    return not any(getattr(m, "moe_mesh", None) is not None
                   or getattr(m, "kv_index", None) is not None
                   for m in model.modules())


def decode_key(tokens: torch.Tensor, cache, positions) -> Optional[tuple]:
    """(rows, page-table width, page size, paged route) of a one-token
    forward over a paged cache whose layers share one page table and
    one lengths tensor, as the engine's decode step calls it; None for
    any other call (a prefill, a chunk, a verify step, the contiguous
    cache)."""
    if (positions is None or tokens.dim() != 2 or tokens.shape[1] != 1
            or not cache):
        return None
    first = cache[0]
    if not isinstance(first, PagedKV) or first.fresh:
        return None
    for c in cache:
        if (not isinstance(c, PagedKV) or c.fresh
                or c.page_table is not first.page_table
                or c.lengths is not first.lengths):
            return None
    return (tokens.shape[0], first.page_table.shape[1], first.page_size,
            paged_attn_impl())


def _tensor_slots(model) -> List[Tuple[dict, str]]:
    """(dict, name) of every weight and buffer of the model's modules:
    reading the dicts again finds a tensor rebound since."""
    return [(d, name) for m in model.modules()
            for d in (m._parameters, m._buffers) for name in d]


def _addresses(slots, pools) -> List[Optional[int]]:
    """The addresses a graph reads: the tensors in `slots` and every
    pool."""
    out = []
    for d, name in slots:
        t = d.get(name)
        out.append(None if t is None else t.data_ptr())
    return out + [t.data_ptr() for kv in pools for t in kv]


def _capture_graph(fn, pool):
    """fn() once on a side stream, then captured as a CUDA graph in the
    memory pool `pool` (a new one when None). Returns (replay, what fn
    returned under capture, the pool)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph.replay, out, graph.pool()


class _Graph(NamedTuple):
    replay: Callable[[], None]
    page_table: torch.Tensor        # static input (rows, width)
    out: tuple                      # (logits, new cache entries)
    counts: Dict[str, int]          # what one forward counted
    k3_launches: int                # K3 calls of one forward


class DecodeGraphs:
    """The captured decode forwards of one model over one set of pools,
    keyed by `decode_key`. `replays` counts the replays made, and
    `DecodeGraphs.replay.launches` those of every instance in the
    process, as the kernels' wrappers count their launches."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._inputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._pool = None
        self._slots: List[Tuple[dict, str]] = []
        self._storage: Optional[List[Optional[int]]] = None
        self.replays = 0

    @property
    def captured(self) -> bool:
        return bool(self._graphs)

    def keys(self) -> List[tuple]:
        return sorted(self._graphs)

    def clear(self) -> None:
        """Drop every graph and the memory they hold."""
        self._graphs.clear()
        self._inputs = self._pool = self._storage = None
        self._slots = []

    def capture(self, model, pools, page_size: int, rows: int,
                widths: Sequence[int], fill: int) -> None:
        """Capture the forward of `rows` one-token rows over `pools` (per
        layer (k_flat, v_flat)) at each page-table width in `widths`;
        the page tables of both passes are all `fill`, a page no live
        row reads."""
        self.clear()
        dev = pools[0][0].device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        tokens, positions, lengths = zeros(rows, 1), zeros(rows, 1), \
            zeros(rows)
        route = paged_attn_impl()
        for width in widths:
            table = torch.full((rows, width), fill, dtype=torch.int32,
                               device=dev)
            cache = [PagedKV(k, v, table, lengths, page_size)
                     for k, v in pools]

            def forward(cache=cache):
                k3 = _k3.paged_decode_attention.launches
                with recording_counts() as counts:
                    out = type(model).forward(model, tokens, cache=cache,
                                              positions=positions)
                return out, dict(counts), \
                    _k3.paged_decode_attention.launches - k3

            replay, (out, counts, k3), self._pool = _capture_graph(
                forward, self._pool)
            # the pass under capture recorded K3 and launched nothing
            _k3.paged_decode_attention.launches -= k3
            self._graphs[(rows, width, page_size, route)] = _Graph(
                replay, table, out, counts, k3)
        self._inputs = (tokens, positions, lengths)
        self._slots = _tensor_slots(model)
        self._storage = _addresses(self._slots, pools)

    def replay(self, model, tokens, cache, positions):
        """The captured forward's (logits, new cache entries) for this
        call, or None when it has no graph (module docstring)."""
        if not self._graphs or not available(tokens.device):
            return None
        key = decode_key(tokens, cache, positions)
        graph = self._graphs.get(key) if key is not None else None
        if graph is None:
            return None
        if _addresses(self._slots, [(c.k_flat, c.v_flat)
                                    for c in cache]) != self._storage:
            self.clear()
            return None
        static_tokens, static_positions, static_lengths = self._inputs
        static_tokens.copy_(tokens)
        static_positions.copy_(positions)
        static_lengths.copy_(cache[0].lengths)
        graph.page_table.copy_(cache[0].page_table)
        with annotate("llm.decode_graph"):
            graph.replay()
        for name, n in graph.counts.items():
            count(name, n)
        _k3.paged_decode_attention.launches += graph.k3_launches
        self.replays += 1
        DecodeGraphs.replay.launches += 1
        return graph.out


# replays made in this process, by every engine's graphs
DecodeGraphs.replay.launches = 0
