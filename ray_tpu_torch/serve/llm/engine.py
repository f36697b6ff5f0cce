"""Paged continuous-batching LLM engine (counterpart of
ray_tpu/serve/llm/engine.py, paged configuration only).

* KV lives in a shared page pool per layer, (n_pages + trash) *
  page_size token rows, with one page-table row per slot. A request
  reserves the pages for prompt + budget at admission; when the pool
  runs short the head request is held (FIFO) until releases refill it.
* Prefill: waiting prompts that share a length bucket run together, up
  to `max_prefill_batch` rows, the group padded to a power of two with
  rows aimed at a scratch slot whose page row is all trash. Attention
  runs over the prompt itself (kernel K1 on the GPU); KV scatters into
  the pages. The first token is sampled on the device.
* Decode: one step advances every slot (kernel K3 reads the pages in
  place), with greedy, temperature, global top-k and per-row top-p
  sampling on the device.
* Pipelined host loop: decode steps are issued up to `pipeline_depth`
  ahead of the host reading their tokens. Each step's sampled tokens go
  to pinned host memory by a non-blocking copy, recorded with a CUDA
  event that the drain waits on. Termination decisions lag by at most
  `pipeline_depth` steps; lagged tokens of finished requests are
  discarded.

JAX's buffer donation becomes in-place updates here: the pools are
written with `index_copy_` inside attention, and the page table and
lengths with indexed assignment, all on the engine loop thread.

Not ported yet (their config fields must keep their defaults): the
contiguous cache, chunked prefill, `decode_block`, prefix caching,
n-gram speculation, guided decoding, penalties, logprobs, precompile,
the watchdog, metrics and events.
"""
from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...ops.attention import PagedKV
from ...util.device import DeviceLike, resolve_device


@dataclass
class LLMEngineConfig:
    max_slots: int = 8              # max concurrently-decoding sequences
    max_seq_len: int = 1024         # prompt + generation budget per slot
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    eos_token_id: Optional[int] = None
    max_new_tokens_default: int = 64
    top_k: int = 0                  # 0 = full softmax sampling
    # Decode steps issued ahead of the host reading their tokens: it
    # trades termination lag (at most this many discarded tokens per
    # finished request) against hiding the device->host fetch. The
    # default mirrors the JAX engine; the right depth for the GPU has
    # not been measured.
    pipeline_depth: int = 10
    # Waiting prompts sharing a length bucket prefill together, up to
    # this many rows (padded to a power of two on the scratch slot).
    max_prefill_batch: int = 4
    # Page size of the KV pool. The port serves the paged configuration
    # only: 0 (the contiguous per-slot cache) raises.
    kv_page_size: int = 16
    # Pool budget in KV tokens (rounded up to whole pages);
    # 0 = max_slots * max_seq_len.
    kv_pool_tokens: int = 0
    # Fields of the JAX engine that are not ported yet; any other value
    # than the default raises NotImplementedError.
    decode_block: int = 1
    prefill_chunk: int = 0
    logprobs: bool = False
    precompile: bool = False
    max_prefixes: int = 0
    ngram_speculation: int = 0
    ngram_order: int = 2
    ngram_lookback: int = 256
    watchdog_s: Optional[float] = None

    _NOT_PORTED = ("decode_block", "prefill_chunk", "logprobs", "precompile",
                   "max_prefixes", "ngram_speculation", "ngram_order",
                   "ngram_lookback", "watchdog_s")

    def __post_init__(self):
        if self.kv_page_size <= 0:
            raise NotImplementedError(
                "kv_page_size must be > 0: the port serves the paged KV "
                "configuration only")
        for name in self._NOT_PORTED:
            default = self.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"LLMEngineConfig.{name}={getattr(self, name)!r}: not "
                    f"ported yet (only the default {default!r} is served)")


@dataclass
class _Request:
    request_id: str
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int
    temperature: float
    top_p: float = 1.0
    stop_ids: frozenset = frozenset()
    out_queue: queue_mod.Queue = field(
        default_factory=lambda: queue_mod.Queue(maxsize=4096))
    slot: int = -1
    generated: int = 0
    aborted: bool = False
    submit_ts: float = field(default_factory=time.time)
    admit_ts: Optional[float] = None       # slot assigned
    prefill_dispatch_ms: float = 0.0       # host time issuing the prefill
    first_token_ts: Optional[float] = None


_END = ("__end__", None)


def _put_dropping_one(q: "queue_mod.Queue", item) -> None:
    """Publish a control item (_END) to a possibly-full out_queue without
    blocking the engine loop: on Full, drop one buffered token."""
    try:
        q.put_nowait(item)
        return
    except queue_mod.Full:
        pass
    try:
        q.get_nowait()
    except queue_mod.Empty:
        pass
    try:
        q.put_nowait(item)
    except queue_mod.Full:
        pass


def _next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


class _Fetch:
    """A device tensor on its way to the host: a non-blocking copy into
    pinned memory, recorded with a CUDA event. On the CPU the values are
    copied at once (later in-place writes must not reach them)."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()
            self.event = None

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class LLMEngine:
    """Continuous-batching engine over a ray_tpu_torch Llama-family model.

    `model` follows ray_tpu_torch/models/llama.py: model(tokens,
    cache=[PagedKV per layer], positions=...) -> (logits, new_cache).
    `state` is a state_dict loaded into it, or None when the model
    already holds its weights. Runs on `device` (default CUDA; raises
    where there is none unless device="cpu"). Sampling draws from a
    torch.Generator on the device seeded `seed`.
    """

    def __init__(self, model, state, cfg: LLMEngineConfig, *,
                 device: DeviceLike = "cuda", seed: int = 0):
        self.device = dev = resolve_device(device)
        if state is not None:
            model.load_state_dict(state)
        self.model = model.to(dev).eval()
        self.cfg = cfg
        mcfg = model.cfg
        if cfg.eos_token_id is None:
            cfg.eos_token_id = getattr(mcfg, "eos_token_id", None)
        if cfg.max_seq_len > mcfg.max_seq_len:
            raise ValueError(
                f"engine max_seq_len {cfg.max_seq_len} exceeds the "
                f"model's max_seq_len {mcfg.max_seq_len}")
        S, L, ps = cfg.max_slots, cfg.max_seq_len, cfg.kv_page_size
        # +1 scratch slot: padding rows of a batched prefill write there;
        # it is never admitted and its page row is all trash
        self._n_slots = S + 1
        self._scratch_slot = S
        self._pages_per_slot = -(-L // ps)
        pool_tokens = cfg.kv_pool_tokens or S * L
        self._n_pages = max(1, -(-pool_tokens // ps))
        self._trash_page = self._n_pages  # never read as valid
        n_flat = (self._n_pages + 1) * ps
        kv_shape = (n_flat, mcfg.n_kv_heads, mcfg.head_dim)
        self._pools = [(torch.zeros(kv_shape, dtype=mcfg.dtype, device=dev),
                        torch.zeros(kv_shape, dtype=mcfg.dtype, device=dev))
                       for _ in range(mcfg.n_layers)]
        self._page_table = torch.full((self._n_slots, self._pages_per_slot),
                                      self._trash_page, dtype=torch.int32,
                                      device=dev)
        self._lengths = torch.zeros((self._n_slots,), dtype=torch.int32,
                                    device=dev)
        self._last_tokens = torch.zeros((self._n_slots,), dtype=torch.int32,
                                        device=dev)
        # host-side page allocator
        self._free_pages: List[int] = list(range(self._n_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        self._pending_head: Optional[_Request] = None
        self._page_hwm = 0
        # host mirror of each occupied slot's length: sizes the decode
        # step's page window
        self._disp_len: Dict[int, int] = {}

        self._free_slots = list(range(S))
        self._active: Dict[int, _Request] = {}
        self._waiting: "queue_mod.Queue[_Request]" = queue_mod.Queue()
        self._requests: Dict[str, _Request] = {}
        self._req_counter = itertools.count()
        self._lock = threading.Lock()
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._mask_state = None
        self._mask_dirty = True
        self._shutdown = threading.Event()
        self.stats = {"prefills": 0, "decode_steps": 0,
                      "tokens_generated": 0}
        self._ttft_samples: collections.deque = collections.deque(maxlen=512)
        self._tpot_samples: collections.deque = collections.deque(maxlen=512)
        self._prefill_first_ms: Dict[int, float] = {}  # bucket -> ms
        self._loop_thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="llm-engine")
        self._loop_thread.start()

    # ---- device work --------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _sample_tokens(self, logits, temps, top_ps, any_temp: bool,
                       any_top_p: bool):
        """Sample per row of logits (N, V): greedy where temp == 0, else
        temperature + optional global top-k + per-row nucleus top-p.
        `any_temp` / `any_top_p` are the host's knowledge of whether any
        row samples / asks for top_p < 1; without them the draw (and the
        full-vocab sort) is skipped. Returns (N,) int32."""
        if self.cfg.top_k and self.cfg.top_k > 0:
            kth = torch.topk(logits, self.cfg.top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, float("-inf")),
                                 logits)
        greedy = torch.argmax(logits, dim=-1)
        if not any_temp:
            return greedy.to(torch.int32)
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        if any_top_p:
            # smallest prefix of the prob-sorted vocab whose mass reaches
            # top_p (always keeps the argmax)
            sorted_vals, sort_idx = torch.sort(scaled, dim=-1,
                                               descending=True)
            sorted_probs = torch.softmax(sorted_vals, dim=-1)
            cum = torch.cumsum(sorted_probs, dim=-1)
            keep_sorted = (cum - sorted_probs) < top_ps[:, None]
            keep = torch.zeros_like(keep_sorted).scatter(1, sort_idx,
                                                         keep_sorted)
            drop = (top_ps < 1.0)[:, None] & ~keep
            scaled = torch.where(drop, torch.full_like(scaled, float("-inf")),
                                 scaled)
        # Gumbel-max in its exponential form: argmax p / E, E ~ Exp(1)
        probs = torch.softmax(scaled, dim=-1)
        noise = torch.empty_like(probs).exponential_(generator=self._gen)
        sampled = torch.argmax(probs / noise, dim=-1)
        return torch.where(temps > 0, sampled, greedy).to(torch.int32)

    def _prefill_paged(self, tokens, slots, true_lens, temps, top_ps,
                       pad_len: int, any_temp: bool, any_top_p: bool):
        """Prefill G prompts: tokens (G, pad_len); slots / true_lens /
        temps / top_ps (G,). KV streams straight into each slot's pages;
        padding rows target the scratch slot (all-trash page row).
        Returns the sampled first tokens (G,) int32."""
        ps = self.cfg.kv_page_size
        g = tokens.shape[0]
        rows = self._page_table[slots.long()][:, :-(-pad_len // ps)]
        rows = rows.contiguous()
        zeros = torch.zeros((g,), dtype=torch.int32, device=self.device)
        entries = [PagedKV(k, v, rows, zeros, ps, fresh=True)
                   for (k, v) in self._pools]
        positions = torch.arange(pad_len, device=self.device)[None, :] \
            .expand(g, pad_len)
        logits, _ = self.model(tokens, cache=entries, positions=positions)
        self._lengths[slots.long()] = true_lens
        last = logits[torch.arange(g, device=self.device),
                      true_lens.long() - 1]
        return self._sample_tokens(last, temps, top_ps, any_temp, any_top_p)

    def _decode_paged(self, mask, temps, top_ps, window_pages: int,
                      any_temp: bool, any_top_p: bool):
        """One decode step for every slot. Released slots' page rows
        point at the trash page, so their writes are inert; inactive
        slots keep their lengths. window_pages > 0 narrows the page
        table to its first columns (a power-of-2 bucket covering the
        longest occupied slot). Returns (next tokens, new lengths)."""
        ps = self.cfg.kv_page_size
        pt = self._page_table
        if window_pages and window_pages < pt.shape[1]:
            pt = pt[:, :window_pages].contiguous()
        entries = [PagedKV(k, v, pt, self._lengths, ps)
                   for (k, v) in self._pools]
        positions = self._lengths[:, None]
        logits, new_entries = self.model(self._last_tokens[:, None],
                                         cache=entries, positions=positions)
        new_lengths = torch.where(mask, new_entries[0].lengths,
                                  self._lengths)
        nxt = self._sample_tokens(logits[:, 0], temps, top_ps, any_temp,
                                  any_top_p)
        return torch.where(mask, nxt, self._last_tokens), new_lengths

    # ---- public API -----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               stop_token_ids=None) -> str:
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self._bucket(prompt.size)  # validate in the caller, not the loop
        budget = max_new_tokens or self.cfg.max_new_tokens_default
        if prompt.size + budget > self.cfg.max_seq_len:
            budget = self.cfg.max_seq_len - prompt.size
            if budget <= 0:
                raise ValueError(
                    f"prompt length {prompt.size} exceeds max_seq_len "
                    f"{self.cfg.max_seq_len}")
        need = -(-(prompt.size + budget) // self.cfg.kv_page_size)
        if need > self._n_pages:
            raise ValueError(
                f"request needs {need} KV pages; pool has {self._n_pages} "
                f"total — it could never be admitted")
        req = _Request(request_id=f"req-{next(self._req_counter)}",
                       prompt=prompt, max_new_tokens=budget,
                       temperature=float(temperature), top_p=float(top_p),
                       stop_ids=frozenset(stop_token_ids or ()))
        with self._lock:
            self._requests[req.request_id] = req
        self._waiting.put(req)
        return req.request_id

    def stream(self, request_id: str):
        """Blocking generator of token ids for one request."""
        for tok, _lp in self.stream_detailed(request_id):
            yield tok

    def stream_detailed(self, request_id: str):
        """Like stream() but yields (token_id, logprob); logprob is
        always None (logprobs are not ported yet)."""
        req = self._requests.get(request_id)
        if req is None:
            raise KeyError(request_id)
        while True:
            kind, payload = req.out_queue.get()
            if kind == "token":
                yield payload, None
            elif kind == "error":
                raise payload
            else:  # end
                break
        with self._lock:
            self._requests.pop(request_id, None)

    def abort(self, request_id: str) -> None:
        """Best-effort early termination. A decoding request's budget
        collapses to what it has generated, so its slot is released at
        the next drain (a few lagged tokens may still arrive). A request
        still queued is cancelled outright."""
        req = self._requests.get(request_id)
        if req is None:
            return
        req.aborted = True
        if req.generated == 0 and req.slot == -1:
            req.out_queue.put(_END)
        elif req.generated > 0:
            req.max_new_tokens = min(req.max_new_tokens, req.generated)

    def generate_sync(self, prompt_ids, max_new_tokens=None,
                      temperature: float = 0.0, top_p: float = 1.0,
                      stop_token_ids=None) -> List[int]:
        rid = self.submit(prompt_ids, max_new_tokens, temperature,
                          top_p=top_p, stop_token_ids=stop_token_ids)
        return list(self.stream(rid))

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {**self.stats, "active": len(self._active),
                   "waiting": self._waiting.qsize(),
                   "free_slots": len(self._free_slots),
                   "kv_pages": {
                       "page_size": self.cfg.kv_page_size,
                       "total": self._n_pages,
                       "free": len(self._free_pages),
                       "in_use": self._n_pages - len(self._free_pages),
                       "peak_in_use": self._page_hwm}}
            samples = list(self._ttft_samples)
            tpots = sorted(self._tpot_samples)
        if tpots:
            out["tpot_p50_ms"] = round(tpots[len(tpots) // 2] * 1000, 2)
        if samples:
            def p50(key):
                vals = sorted(s[key] for s in samples)
                return round(vals[len(vals) // 2], 1)
            out["ttft_breakdown_p50_ms"] = {
                k: p50(k) for k in ("queue_ms", "prefill_dispatch_ms",
                                    "emit_ms", "total_ms")}
        out["prefill_first_dispatch_ms"] = dict(self._prefill_first_ms)
        return out

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the engine loop and wait for its thread."""
        self._shutdown.set()
        if threading.current_thread() is not self._loop_thread:
            self._loop_thread.join(timeout)

    # ---- engine loop ----------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b and b <= self.cfg.max_seq_len:
                return b
        raise ValueError(f"prompt length {n} exceeds largest prefill "
                         f"bucket {self.cfg.prefill_buckets[-1]}")

    def _admit_paged(self, req: _Request) -> bool:
        """Reserve pages + a slot; False when the pool is short."""
        pages = self._alloc_pages(self._pages_needed(req))
        if pages is None:
            return False
        slot = self._free_slots.pop()
        req.slot = slot
        req.admit_ts = time.time()
        self._slot_pages[slot] = pages
        self._set_page_row(slot, pages)
        # reset the slot's device length now: a reused slot's stale
        # length would aim inactive decode steps' writes at an arbitrary
        # position of the new occupant's pages
        self._lengths[slot] = 0
        self._disp_len[slot] = 0
        return True

    def _admit_all(self, inflight) -> None:
        """Issue prefills for every waiting request that gets a slot and
        its pages. Requests sharing a length bucket prefill together;
        their first tokens drain through the same pipeline as decode."""
        taken: List[tuple] = []
        while self._free_slots:
            if self._pending_head is not None:
                req, self._pending_head = self._pending_head, None
            else:
                try:
                    req = self._waiting.get_nowait()
                except queue_mod.Empty:
                    break
            if req.aborted:
                # cancelled before admission: abort() already unblocked
                # the consumer
                self._requests.pop(req.request_id, None)
                continue
            if not self._admit_paged(req):
                # page pool exhausted: hold the head request (FIFO) until
                # releases refill the pool
                self._pending_head = req
                break
            taken.append((self._bucket(req.prompt.size), req, req.slot))
        groups: Dict[int, List[tuple]] = {}
        for pad_len, req, slot in taken:
            groups.setdefault(pad_len, []).append((req, slot))
        cap = max(1, self.cfg.max_prefill_batch)
        for pad_len, members in groups.items():
            for i in range(0, len(members), cap):
                self._dispatch_prefill(inflight, pad_len,
                                       members[i:i + cap])

    def _dispatch_prefill(self, inflight, pad_len: int, members) -> None:
        """One prefill call for members = [(req, slot), ...] of a shared
        bucket; the group size pads to a power of two on the scratch
        slot."""
        g_real = len(members)
        t_dispatch = time.time()
        g = _next_pow2(g_real)
        tokens = np.zeros((g, pad_len), np.int32)
        slots = np.full((g,), self._scratch_slot, np.int32)
        lens = np.ones((g,), np.int32)
        temps = np.zeros((g,), np.float32)
        top_ps = np.ones((g,), np.float32)
        for i, (req, slot) in enumerate(members):
            tokens[i, :req.prompt.size] = req.prompt
            slots[i] = slot
            lens[i] = req.prompt.size
            temps[i] = req.temperature
            top_ps[i] = req.top_p
        try:
            toks = self._prefill_paged(
                self._to_dev(tokens), self._to_dev(slots),
                self._to_dev(lens), self._to_dev(temps),
                self._to_dev(top_ps), pad_len,
                any_temp=bool((temps > 0).any()),
                any_top_p=bool((top_ps < 1.0).any()))[:g_real]
            real_slots = self._to_dev(slots[:g_real]).long()
            self._last_tokens[real_slots] = toks
        except Exception as e:  # noqa: BLE001  per-request containment
            for req, slot in members:
                self._free_slot_pages(slot)
                self._free_slots.append(slot)
                req.slot = -1
                req.out_queue.put(("error", e))
                req.out_queue.put(_END)
            return
        dispatch_ms = (time.time() - t_dispatch) * 1000
        self._prefill_first_ms.setdefault(pad_len, round(dispatch_ms, 1))
        self.stats["prefills"] += g_real
        for req, slot in members:
            req.prefill_dispatch_ms = dispatch_ms
            self._disp_len[slot] = req.prompt.size
            self._active[slot] = req
        self._mask_dirty = True
        inflight.append(("prefill_batch", [r for r, _ in members],
                         _Fetch(toks)))

    def _emit(self, req: _Request, tok: int) -> None:
        req.generated += 1
        self.stats["tokens_generated"] += 1
        if req.first_token_ts is None:
            now = time.time()
            req.first_token_ts = now
            admit = req.admit_ts or req.submit_ts
            self._ttft_samples.append({
                "queue_ms": (admit - req.submit_ts) * 1000,
                "prefill_dispatch_ms": req.prefill_dispatch_ms,
                "emit_ms": max(0.0, (now - admit) * 1000
                               - req.prefill_dispatch_ms),
                "total_ms": (now - req.submit_ts) * 1000})
        # Bounded-wait put: a full out_queue means the consumer is slow
        # or gone; one silent past _CONSUMER_STALL_TTL_S gets its request
        # aborted so a dead reader cannot stall the shared loop forever.
        parked_since = None
        while True:
            try:
                req.out_queue.put(("token", tok), timeout=1.0)
                break
            except queue_mod.Full:
                if req.aborted:
                    break
                now = time.time()
                if parked_since is None:
                    parked_since = now
                elif now - parked_since > self._CONSUMER_STALL_TTL_S:
                    req.aborted = True
                    req.max_new_tokens = min(req.max_new_tokens,
                                             req.generated)
                    break
        if ((self.cfg.eos_token_id is not None
             and tok == self.cfg.eos_token_id) or tok in req.stop_ids):
            req.max_new_tokens = req.generated  # finish after EOS/stop

    _CONSUMER_STALL_TTL_S = 60.0

    # ---- page allocator (host side) ---------------------------------------
    def _pages_needed(self, req: _Request) -> int:
        """Whole pages for prompt + budget, reserved at admission, so a
        decode never runs out of pages mid-stream."""
        ps = self.cfg.kv_page_size
        return -(-(req.prompt.size + req.max_new_tokens) // ps)

    def _alloc_pages(self, n: int) -> "Optional[List[int]]":
        if len(self._free_pages) < n:
            return None
        pages = [self._free_pages.pop() for _ in range(n)]
        self._page_hwm = max(self._page_hwm,
                             self._n_pages - len(self._free_pages))
        return pages

    def _set_page_row(self, slot: int, pages: "List[int]") -> None:
        """Write a slot's page-table row (unused entries -> trash)."""
        row = np.full((self._pages_per_slot,), self._trash_page, np.int32)
        row[:len(pages)] = pages
        self._page_table[slot] = self._to_dev(row)

    def _free_slot_pages(self, slot: int) -> None:
        """Return the slot's pages to the pool and point its row at the
        trash page so lagged decode writes cannot reach a reused page."""
        self._disp_len.pop(slot, None)
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            return
        self._free_pages.extend(pages)
        self._set_page_row(slot, [])

    def _release(self, req: _Request) -> None:
        # slot bookkeeping first, end marker last: _END wakes the
        # consumer, which must not see a finished request still holding
        # engine state; the finally always unblocks it
        try:
            if req.slot >= 0:
                self._free_slot_pages(req.slot)
                self._free_slots.append(req.slot)
                self._active.pop(req.slot, None)
                self._mask_dirty = True
                req.slot = -1
            if req.first_token_ts is not None and req.generated > 1:
                self._tpot_samples.append(
                    (time.time() - req.first_token_ts)
                    / (req.generated - 1))
        finally:
            _put_dropping_one(req.out_queue, _END)

    def _decode_window_pages(self) -> int:
        """Power-of-2 page window covering every occupied slot plus this
        step's new token; 0 = the full table."""
        ps = self.cfg.kv_page_size
        need = max(self._disp_len.values(), default=0) + 1
        w = _next_pow2(-(-need // ps))
        return 0 if w >= self._pages_per_slot else w

    def _device_mask_temps(self):
        """(active_mask, temps, top_ps, any_temp, any_top_p), rebuilt
        only when the active set changed."""
        if self._mask_dirty or self._mask_state is None:
            S = self._n_slots
            mask = np.zeros((S,), bool)
            temps = np.zeros((S,), np.float32)
            top_ps = np.ones((S,), np.float32)
            for slot, req in self._active.items():
                mask[slot] = True
                temps[slot] = req.temperature
                top_ps[slot] = req.top_p
            self._mask_state = (self._to_dev(mask), self._to_dev(temps),
                                self._to_dev(top_ps),
                                bool((temps > 0).any()),
                                bool((top_ps < 1.0).any()))
            self._mask_dirty = False
        return self._mask_state

    def _drain_one(self, inflight) -> None:
        """Read the oldest in-flight result and emit its tokens.
        Termination checks happen here, `pipeline_depth` steps behind
        dispatch; lagged tokens of finished or reused slots are
        discarded by the (req.slot == slot, generated < budget) guards."""
        kind, payload, fetch = inflight.popleft()
        try:
            host = fetch.result()
        except Exception as e:  # noqa: BLE001  device-side failure
            targets = (list(payload) if kind == "prefill_batch"
                       else [r for _, r in payload])
            for req in targets:
                if req.slot >= 0:
                    req.out_queue.put(("error", e))
                    self._release(req)
            return
        if kind == "prefill_batch":
            for i, req in enumerate(payload):
                if req.slot < 0:
                    continue
                if req.aborted and req.generated == 0:
                    # aborted while its prefill was in flight
                    self._release(req)
                    continue
                self._emit(req, int(host[i]))
                if (req.generated >= req.max_new_tokens
                        or req.prompt.size + req.generated
                        >= self.cfg.max_seq_len):
                    self._release(req)
            return
        self.stats["decode_steps"] += 1
        for slot, req in payload:
            if req.slot != slot:
                continue  # released/reused slot: lagged, discard
            if req.generated >= req.max_new_tokens:
                # budget shrank out of band (abort())
                self._release(req)
                continue
            self._emit(req, int(host[slot]))
            if (req.generated >= req.max_new_tokens
                    or req.prompt.size + req.generated
                    >= self.cfg.max_seq_len):
                self._release(req)

    def _engine_loop(self) -> None:
        with torch.no_grad():
            inflight: collections.deque = collections.deque()
            while not self._shutdown.is_set():
                try:
                    self._step(inflight)
                except Exception as e:  # noqa: BLE001  loop must survive
                    traceback.print_exc()
                    for req in list(self._active.values()):
                        req.out_queue.put(("error", e))
                        self._release(req)
                    inflight.clear()

    def _step(self, inflight) -> None:
        self._admit_all(inflight)
        if self._active:
            mask, temps, top_ps, any_temp, any_top_p = \
                self._device_mask_temps()
            snapshot = list(self._active.items())
            toks, self._lengths = self._decode_paged(
                mask, temps, top_ps, self._decode_window_pages(),
                any_temp, any_top_p)
            for slot in self._active:
                self._disp_len[slot] += 1
            self._last_tokens = toks
            inflight.append(("decode", snapshot, _Fetch(toks)))
        if not inflight:
            time.sleep(0.002)
            return
        # stay `pipeline_depth` steps ahead while decoding; drain fully
        # once nothing is active
        target = self.cfg.pipeline_depth if self._active else 0
        while len(inflight) > target:
            self._drain_one(inflight)
