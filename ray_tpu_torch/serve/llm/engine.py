"""Continuous-batching LLM engine (counterpart of
ray_tpu/serve/llm/engine.py).

* Two KV caches, as in the reference. `kv_page_size=0` (the default) is
  the contiguous slot cache: per layer (n_slots, max_seq_len, Hkv, D)
  k/v buffers. Attention over it is the plain einsum over a slot's whole
  row (`ops.attention._attend_cached`); the reference has no Pallas
  kernel on this cache either. `kv_page_size > 0` is a shared page pool
  per layer, (n_pages + trash) * page_size token rows, with one
  page-table row per slot. A request reserves the pages for prompt +
  budget at admission; when the pool runs short the head request is
  held (FIFO) until releases refill it.
* Prefill: waiting prompts that share a length bucket run together, up
  to `max_prefill_batch` rows, the group padded to a power of two with
  rows aimed at a scratch slot (paged: its page row is all trash). On
  the paged cache attention runs over the prompt itself (kernel K1 on
  the GPU) and KV scatters into the pages. On the contiguous cache a
  single prompt (`max_prefill_batch=1`) runs against views of its
  slot's rows, so the writes land in the cache in place; a group runs
  on a small (G, bucket) cache that is scattered into the slots after.
  The first token is sampled on the device.
* Chunked prefill (`prefill_chunk > 0`): a prompt longer than the chunk
  or than the largest bucket prefills one chunk per loop iteration,
  between decode steps, against the slot's cached prefix. The last
  chunk is not padded: eager PyTorch needs no static width, and padding
  could run past max_seq_len. The suffix of a prefix request takes the
  same path.
* Decode: one step advances every slot (on the paged cache kernel K3
  reads the pages in place), with greedy, temperature, global top-k and
  per-row top-p sampling on the device. `decode_block > 1` runs that
  many one-token steps back to back on the loop thread (the reference's
  `lax.scan`) and fetches their (block, S) tokens with one copy.
* Prefix caching (`max_prefixes > 0`): `register_prefix` prefills a
  shared prefix once, on the engine loop thread. Paged: into pinned
  pages through the scratch slot's row (a fresh prefill, K1); adopters
  share its full pages by page-table reference and copy only its
  partial last page. Contiguous: into a row of a (max_prefixes, L, Hkv,
  D) buffer (the reference's extra row only serves `precompile`, which
  is not ported); adopters copy its rows into their slot.
* Pipelined host loop: decode steps are issued up to `pipeline_depth`
  ahead of the host reading their tokens. Each step's sampled tokens go
  to pinned host memory by a non-blocking copy, recorded with a CUDA
  event that the drain waits on. Termination decisions lag by at most
  `pipeline_depth` dispatches; lagged tokens of finished requests are
  discarded.

JAX's buffer donation becomes in-place updates here: the caches are
written with `index_copy_` / indexed assignment inside attention, and
the page table and lengths with indexed assignment, all on the engine
loop thread.

Not ported yet (their config fields must keep their defaults): n-gram
speculation, guided decoding, penalties, logprobs, precompile, the
watchdog, metrics and events.
"""
from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
import time
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

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
    # trades termination lag (at most this many discarded dispatches per
    # finished request) against hiding the device->host fetch. The
    # default mirrors the JAX engine; the right depth for the GPU has
    # not been measured.
    pipeline_depth: int = 10
    # One-token decode steps per dispatch, their tokens fetched together.
    # 1 = the classic one-token step.
    decode_block: int = 1
    # Waiting prompts sharing a length bucket prefill together, up to
    # this many rows (padded to a power of two on the scratch slot).
    # 1 disables batching.
    max_prefill_batch: int = 4
    # Prompts longer than this (or than the largest bucket) prefill in
    # chunks of this many tokens, one per loop iteration between decode
    # steps. 0 disables chunking.
    prefill_chunk: int = 0
    # Registered shared prefixes (register_prefix); 0 disables.
    max_prefixes: int = 0
    # 0 = the contiguous per-slot cache (max_slots x max_seq_len rows per
    # layer); > 0 = a shared page pool of pages of this many tokens.
    kv_page_size: int = 0
    # Pool budget in KV tokens (rounded up to whole pages);
    # 0 = max_slots * max_seq_len.
    kv_pool_tokens: int = 0
    # Fields of the JAX engine that are not ported yet; any other value
    # than the default raises NotImplementedError.
    logprobs: bool = False
    precompile: bool = False
    ngram_speculation: int = 0
    ngram_order: int = 2
    ngram_lookback: int = 256
    watchdog_s: Optional[float] = None

    _NOT_PORTED = ("logprobs", "precompile", "ngram_speculation",
                   "ngram_order", "ngram_lookback", "watchdog_s")

    def __post_init__(self):
        for name in self._NOT_PORTED:
            default = self.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"LLMEngineConfig.{name}={getattr(self, name)!r}: not "
                    f"ported yet (only the default {default!r} is served)")


@dataclass
class _Request:
    request_id: str
    prompt: np.ndarray              # (P,) int32, a prefix's tokens included
    max_new_tokens: int
    temperature: float
    top_p: float = 1.0
    stop_ids: frozenset = frozenset()
    out_queue: queue_mod.Queue = field(
        default_factory=lambda: queue_mod.Queue(maxsize=4096))
    slot: int = -1
    generated: int = 0
    aborted: bool = False
    prefix_id: int = -1             # registered prefix whose KV it adopts
    prefill_pos: int = 0            # next prompt index (chunked prefill)
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
    cache=[per-layer (k, v, lengths) or PagedKV], positions=...) ->
    (logits, new_cache). `state` is a state_dict loaded into it, or None
    when the model already holds its weights. Runs on `device` (default
    CUDA; raises where there is none unless device="cpu"). Sampling
    draws from a torch.Generator on the device seeded `seed`.
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
        S, L = cfg.max_slots, cfg.max_seq_len
        self._paged = cfg.kv_page_size > 0
        # +1 scratch slot, never admitted: padding rows of a batched
        # prefill write there, and on the paged cache prefix
        # registration prefills through its page row (all trash
        # otherwise). Without batching the contiguous cache has none.
        self._n_slots = (S + 1 if (cfg.max_prefill_batch > 1 or self._paged)
                         else S)
        self._scratch_slot = S
        kv = (mcfg.n_kv_heads, mcfg.head_dim)

        def zeros(*shape):
            return torch.zeros(shape, dtype=mcfg.dtype, device=dev)

        if self._paged:
            ps = cfg.kv_page_size
            self._pages_per_slot = -(-L // ps)
            pool_tokens = cfg.kv_pool_tokens or S * L
            self._n_pages = max(1, -(-pool_tokens // ps))
            self._trash_page = self._n_pages  # never read as valid
            n_flat = (self._n_pages + 1) * ps
            self._pools = [(zeros(n_flat, *kv), zeros(n_flat, *kv))
                           for _ in range(mcfg.n_layers)]
            self._page_table = torch.full(
                (self._n_slots, self._pages_per_slot), self._trash_page,
                dtype=torch.int32, device=dev)
            # host-side page allocator; slot -> (shared prefix pages at
            # the front, every page in table order)
            self._free_pages: List[int] = list(range(self._n_pages))
            self._slot_pages: Dict[int, Tuple[int, List[int]]] = {}
            self._prefix_pages: Dict[int, List[int]] = {}  # pinned
            self._page_hwm = 0
        else:
            self._cache = [(zeros(self._n_slots, L, *kv),
                            zeros(self._n_slots, L, *kv))
                           for _ in range(mcfg.n_layers)]
        self._lengths = torch.zeros((self._n_slots,), dtype=torch.int32,
                                    device=dev)
        self._last_tokens = torch.zeros((self._n_slots,), dtype=torch.int32,
                                        device=dev)
        self._pending_head: Optional[_Request] = None
        # host mirror of each slot's length (prefilled and chunking
        # slots too): sizes the paged decode step's page window
        self._disp_len: Dict[int, int] = {}
        # prefix caching: pid -> tokens; contiguous KV rows
        self._prefixes: Dict[int, np.ndarray] = {}
        self._prefix_counter = itertools.count()
        self._prefix_cache = None
        if cfg.max_prefixes > 0 and not self._paged:
            self._prefix_cache = [(zeros(cfg.max_prefixes, L, *kv),
                                   zeros(cfg.max_prefixes, L, *kv))
                                  for _ in range(mcfg.n_layers)]

        self._free_slots = list(range(S))
        self._active: Dict[int, _Request] = {}
        self._prefilling: collections.deque = collections.deque()
        self._waiting: "queue_mod.Queue[_Request]" = queue_mod.Queue()
        # commands that mutate the caches run on the loop thread
        self._control_q: "queue_mod.Queue" = queue_mod.Queue()
        self._requests: Dict[str, _Request] = {}
        self._req_counter = itertools.count()
        self._lock = threading.Lock()
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._mask_state = None
        self._mask_dirty = True
        self._shutdown = threading.Event()
        self.stats = {"prefills": 0, "decode_steps": 0,
                      "tokens_generated": 0, "prefix_tokens_saved": 0}
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

    def _small_cache(self, g: int, width: int):
        """A fresh per-layer (g, width) contiguous cache at length 0."""
        mcfg = self.model.cfg
        shape = (g, width, mcfg.n_kv_heads, mcfg.head_dim)
        lens = torch.zeros((g,), dtype=torch.int32, device=self.device)
        return [(torch.zeros(shape, dtype=mcfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=mcfg.dtype, device=self.device),
                 lens) for _ in range(mcfg.n_layers)]

    def _prefill(self, tokens, slots, true_lens, temps, top_ps,
                 pad_len: int, any_temp: bool, any_top_p: bool,
                 single_slot: Optional[int] = None):
        """Prefill G prompts: tokens (G, pad_len); slots / true_lens /
        temps / top_ps (G,). Padding rows target the scratch slot.
        Returns the sampled first tokens (G,) int32.

        Paged: KV streams straight into each slot's pages (K1 for the
        attention); the scratch slot's page row is all trash. Contiguous
        with `single_slot` (no batching): the prompt runs against views
        of that slot's rows, as `_prefill_impl` slices them. Contiguous
        otherwise: a (G, pad_len) cache, scattered into the slots after
        (`_prefill_batch_impl`)."""
        g = tokens.shape[0]
        positions = torch.arange(pad_len, device=self.device)[None, :] \
            .expand(g, pad_len)
        idx = slots.long()
        if self._paged:
            ps = self.cfg.kv_page_size
            rows = self._page_table[idx][:, :-(-pad_len // ps)].contiguous()
            zeros = torch.zeros((g,), dtype=torch.int32, device=self.device)
            entries = [PagedKV(k, v, rows, zeros, ps, fresh=True)
                       for (k, v) in self._pools]
            logits, _ = self.model(tokens, cache=entries, positions=positions)
        elif single_slot is not None:
            s = single_slot
            zeros = torch.zeros((1,), dtype=torch.int32, device=self.device)
            entries = [(ck[s:s + 1], cv[s:s + 1], zeros)
                       for (ck, cv) in self._cache]
            logits, _ = self.model(tokens, cache=entries, positions=positions)
        else:
            small = self._small_cache(g, pad_len)
            logits, _ = self.model(tokens, cache=small, positions=positions)
            # duplicate scratch indices of padding rows are harmless: the
            # scratch slot is never admitted
            for (ck, cv), (k1, v1, _l) in zip(self._cache, small):
                ck[idx, :pad_len] = k1
                cv[idx, :pad_len] = v1
        self._lengths[idx] = true_lens
        last = logits[torch.arange(g, device=self.device),
                      true_lens.long() - 1]
        return self._sample_tokens(last, temps, top_ps, any_temp, any_top_p)

    def _prefill_chunk(self, tokens, slot: int, start: int, temp: float,
                       top_p: float, sample: bool):
        """One chunk of a long prompt through the cached path: tokens
        (1, n) written at positions [start, start + n); the slot's length
        becomes start + n. The slot's current length IS `start`: a reused
        slot's stored length would be stale from the previous occupant
        (`_prefill_chunk_impl`). The paged cache gathers the slot's page
        row (`_chunk_paged_impl`). sample=True (the final chunk) samples
        the first token, (1,) int32; else returns None."""
        n = tokens.shape[1]
        l1 = torch.full((1,), start, dtype=torch.int32, device=self.device)
        if self._paged:
            row = self._page_table[slot:slot + 1]
            entries = [PagedKV(k, v, row, l1, self.cfg.kv_page_size)
                       for (k, v) in self._pools]
        else:
            entries = [(ck[slot:slot + 1], cv[slot:slot + 1], l1)
                       for (ck, cv) in self._cache]
        positions = torch.arange(start, start + n, device=self.device)[None]
        logits, _ = self.model(tokens, cache=entries, positions=positions)
        self._lengths[slot] = start + n
        if not sample:
            return None
        return self._sample_tokens(
            logits[0, -1:], self._to_dev(np.array([temp], np.float32)),
            self._to_dev(np.array([top_p], np.float32)), temp > 0,
            top_p < 1.0)

    def _decode(self, mask, temps, top_ps, window_pages: int,
                any_temp: bool, any_top_p: bool):
        """One decode step for every slot. Inactive slots keep their
        lengths; released paged slots' rows point at the trash page, so
        their writes are inert. window_pages > 0 narrows the page table
        to its first columns (a power-of-2 bucket covering the longest
        slot). Returns (next tokens, new lengths)."""
        # a lagged step of a request that filled max_seq_len writes at
        # the last position instead of past it; its token is discarded
        positions = self._lengths.clamp(max=self.cfg.max_seq_len - 1)[:, None]
        if self._paged:
            pt = self._page_table
            if window_pages and window_pages < pt.shape[1]:
                pt = pt[:, :window_pages].contiguous()
            entries = [PagedKV(k, v, pt, self._lengths, self.cfg.kv_page_size)
                       for (k, v) in self._pools]
        else:
            entries = [(ck, cv, self._lengths) for (ck, cv) in self._cache]
        logits, new_entries = self.model(self._last_tokens[:, None],
                                         cache=entries, positions=positions)
        new = new_entries[0]
        new_len = new.lengths if self._paged else new[2]
        new_lengths = torch.where(mask, new_len, self._lengths)
        nxt = self._sample_tokens(logits[:, 0], temps, top_ps, any_temp,
                                  any_top_p)
        return torch.where(mask, nxt, self._last_tokens), new_lengths

    # ---- public API -----------------------------------------------------
    def register_prefix(self, prefix_ids) -> int:
        """Prefill a shared prompt prefix (e.g. a system prompt) once;
        returns a prefix_id for submit(prefix_id=...). Needs
        cfg.max_prefixes > 0; registering more raises. The prefill runs
        on the engine loop thread; this call blocks until it is done."""
        if self.cfg.max_prefixes <= 0:
            raise ValueError("engine built with max_prefixes=0")
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        if prefix.size == 0:
            raise ValueError("empty prefix")
        if prefix.size >= self.cfg.max_seq_len - 1:
            raise ValueError(f"prefix length {prefix.size} leaves no room "
                             f"in max_seq_len {self.cfg.max_seq_len}")
        pid = next(self._prefix_counter)
        if pid >= self.cfg.max_prefixes:
            raise ValueError(
                f"prefix slots exhausted ({self.cfg.max_prefixes})")
        fill = (self._register_prefix_paged if self._paged
                else self._fill_prefix_row)
        self._run_on_loop(lambda: fill(pid, prefix))
        return pid

    def _run_on_loop(self, fn) -> None:
        """Run `fn` on the engine loop thread (cache mutations must not
        race its dispatches); block until done and re-raise its
        exception. Raises if the engine shuts down first."""
        if self._shutdown.is_set():
            raise RuntimeError("engine is shut down")
        fut: Future = Future()
        self._control_q.put((fn, fut))
        while True:
            try:
                fut.result(timeout=0.1)
                return
            except FutureTimeout:
                if self._shutdown.is_set() and not fut.done():
                    raise RuntimeError(
                        "engine shut down before command ran") from None

    def _register_prefix_paged(self, pid: int, prefix: np.ndarray) -> None:
        """Prefill a prefix into freshly allocated pinned pages (loop
        thread). Adopters share its full pages by reference."""
        ps = self.cfg.kv_page_size
        pages = self._alloc_pages(-(-prefix.size // ps))
        if pages is None:
            raise ValueError("page pool exhausted registering prefix")
        scratch = self._scratch_slot
        pad = min(_next_pow2(prefix.size), self.cfg.max_seq_len)
        tokens = np.zeros((1, pad), np.int32)
        tokens[0, :prefix.size] = prefix
        self._set_page_row(scratch, pages)
        try:
            self._prefill(
                self._to_dev(tokens), self._to_dev(np.array([scratch],
                                                            np.int32)),
                self._to_dev(np.array([prefix.size], np.int32)),
                self._to_dev(np.zeros((1,), np.float32)),
                self._to_dev(np.ones((1,), np.float32)), pad,
                any_temp=False, any_top_p=False)
        except BaseException:
            self._free_pages.extend(pages)
            raise
        finally:
            # scratch row back to all trash: batch-padding rows write
            # through it and must never reach the pinned prefix pages
            self._set_page_row(scratch, [])
        self._prefix_pages[pid] = pages
        self._prefixes[pid] = prefix

    def _unregister_prefix_paged(self, pid: int) -> None:
        """Free a prefix's pinned pages (loop thread; only safe once no
        slot shares them)."""
        pages = self._prefix_pages.pop(pid, None)
        self._prefixes.pop(pid, None)
        if pages:
            self._free_pages.extend(pages)

    def _fill_prefix_row(self, pid: int, prefix: np.ndarray) -> None:
        """Prefill a prefix into row `pid` of the contiguous prefix
        buffers (loop thread; `_prefix_fill_impl`)."""
        pad = min(_next_pow2(prefix.size), self.cfg.max_seq_len)
        tokens = np.zeros((1, pad), np.int32)
        tokens[0, :prefix.size] = prefix
        small = self._small_cache(1, pad)
        self.model(self._to_dev(tokens), cache=small,
                   positions=torch.arange(pad, device=self.device)[None])
        for (pk, pv), (k1, v1, _l) in zip(self._prefix_cache, small):
            pk[pid, :pad] = k1[0]
            pv[pid, :pad] = v1[0]
        self._prefixes[pid] = prefix

    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               stop_token_ids=None, prefix_id: Optional[int] = None) -> str:
        """prefix_id: a registered prefix; `prompt_ids` is then the
        suffix. The engine re-attaches the prefix's tokens but adopts its
        KV instead of prefilling it."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if prefix_id is not None:
            prefix = self._prefixes.get(prefix_id)
            if prefix is None:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            prompt = np.concatenate([prefix, prompt])
        elif not self._use_chunked(prompt.size):
            # chunked prompts bypass the buckets; all others must fit one
            self._bucket(prompt.size)  # validate in the caller, not loop
        budget = max_new_tokens or self.cfg.max_new_tokens_default
        if prompt.size + budget > self.cfg.max_seq_len:
            budget = self.cfg.max_seq_len - prompt.size
            if budget <= 0:
                raise ValueError(
                    f"prompt length {prompt.size} exceeds max_seq_len "
                    f"{self.cfg.max_seq_len}")
        if self._paged:
            need = -(-(prompt.size + budget) // self.cfg.kv_page_size)
            if need > self._n_pages:
                raise ValueError(
                    f"request needs {need} KV pages; pool has "
                    f"{self._n_pages} total — it could never be admitted")
        req = _Request(request_id=f"req-{next(self._req_counter)}",
                       prompt=prompt, max_new_tokens=budget,
                       temperature=float(temperature), top_p=float(top_p),
                       stop_ids=frozenset(stop_token_ids or ()),
                       prefix_id=-1 if prefix_id is None else prefix_id)
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
        still queued is cancelled outright; one that is chunk-prefilling
        is cancelled at its next chunk."""
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
                      stop_token_ids=None,
                      prefix_id: Optional[int] = None) -> List[int]:
        rid = self.submit(prompt_ids, max_new_tokens, temperature,
                          top_p=top_p, stop_token_ids=stop_token_ids,
                          prefix_id=prefix_id)
        return list(self.stream(rid))

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {**self.stats, "active": len(self._active),
                   "waiting": self._waiting.qsize(),
                   "prefilling": len(self._prefilling),
                   "free_slots": len(self._free_slots)}
            if self._paged:
                out["kv_pages"] = {
                    "page_size": self.cfg.kv_page_size,
                    "total": self._n_pages,
                    "free": len(self._free_pages),
                    "in_use": self._n_pages - len(self._free_pages),
                    "pinned_prefix": sum(
                        len(p) for p in self._prefix_pages.values()),
                    "peak_in_use": self._page_hwm}
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

    def _largest_bucket(self) -> int:
        """0 when no bucket fits max_seq_len (then every prompt that
        chunking can take is chunked)."""
        return max((b for b in self.cfg.prefill_buckets
                    if b <= self.cfg.max_seq_len), default=0)

    def _chunk_for(self, remaining: int) -> int:
        """Chunk width of one chunked-prefill dispatch: the configured
        chunk, or (a prefix's suffix with chunking off) the smallest
        bucket covering the rest of the prompt, so a short suffix does
        not pay a largest-bucket-wide pass."""
        if self.cfg.prefill_chunk > 0:
            return self.cfg.prefill_chunk
        for b in sorted(self.cfg.prefill_buckets):
            if remaining <= b <= self.cfg.max_seq_len:
                return b
        return self._largest_bucket() or self.cfg.max_seq_len

    def _use_chunked(self, n: int) -> bool:
        """Chunked prefill takes prompts longer than prefill_chunk and
        any prompt past the largest bucket."""
        if self.cfg.prefill_chunk <= 0:
            return False
        return n > self.cfg.prefill_chunk or n > self._largest_bucket()

    def _fail_admission(self, req: _Request, slot: int, err) -> None:
        self._free_slots.append(slot)
        req.slot = -1
        req.out_queue.put(("error", err))
        req.out_queue.put(_END)

    def _admit_contiguous(self, req: _Request) -> bool:
        """Take a slot; a prefix request adopts its prefix's KV with one
        on-device row copy. False when the request failed (its stream is
        errored)."""
        slot = self._free_slots.pop()
        req.slot = slot
        req.admit_ts = time.time()
        plen = 0
        if req.prefix_id >= 0:
            plen = int(self._prefixes[req.prefix_id].size)
            try:
                for (ck, cv), (pk, pv) in zip(self._cache,
                                              self._prefix_cache):
                    ck[slot, :plen] = pk[req.prefix_id, :plen]
                    cv[slot, :plen] = pv[req.prefix_id, :plen]
            except Exception as e:  # noqa: BLE001  per-request containment
                self._fail_admission(req, slot, e)
                return False
            req.prefill_pos = plen
            self.stats["prefix_tokens_saved"] += plen
        # reset the slot's stale length (a previous occupant's) now
        self._lengths[slot] = plen
        self._disp_len[slot] = plen
        return True

    def _admit_paged(self, req: _Request) -> str:
        """Reserve pages + a slot. Returns "ok", "nopages" (hold the
        request) or "failed" (its stream is errored). A prefix request
        shares the prefix's full pages by page-table reference and copies
        only its partial last page."""
        ps = self.cfg.kv_page_size
        need_total = self._pages_needed(req)
        # pinned prefix pages never return to the pool: a request needing
        # more than can ever be free would hold the queue head forever
        pinned = sum(len(p) for p in self._prefix_pages.values())
        n_shared = (int(self._prefixes[req.prefix_id].size) // ps
                    if req.prefix_id >= 0 else 0)
        if need_total - n_shared > self._n_pages - pinned:
            req.out_queue.put(("error", ValueError(
                f"request needs {need_total - n_shared} exclusive KV pages "
                f"but only {self._n_pages - pinned} can ever be free "
                f"({pinned} pinned by prefixes)")))
            req.out_queue.put(_END)
            return "failed"
        excl = self._alloc_pages(need_total - n_shared)
        if excl is None:
            return "nopages"
        slot = self._free_slots.pop()
        req.slot = slot
        req.admit_ts = time.time()
        plen = 0
        pages = excl
        if req.prefix_id >= 0:
            prefix_pages = self._prefix_pages[req.prefix_id]
            plen = int(self._prefixes[req.prefix_id].size)
            if plen % ps:
                try:
                    self._copy_page(prefix_pages[n_shared], excl[0])
                except Exception as e:  # noqa: BLE001
                    self._free_pages.extend(excl)
                    self._fail_admission(req, slot, e)
                    return "failed"
            pages = prefix_pages[:n_shared] + excl
            req.prefill_pos = plen
            self.stats["prefix_tokens_saved"] += plen
        self._slot_pages[slot] = (n_shared, pages)
        self._set_page_row(slot, pages)
        # a reused slot's stale length would aim inactive decode steps'
        # writes at an arbitrary position of the new occupant's pages
        self._lengths[slot] = plen
        self._disp_len[slot] = plen
        return "ok"

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page's k/v rows in every layer: the only copy a
        paged prefix adoption makes (its partial last page)."""
        ps = self.cfg.kv_page_size
        for (k, v) in self._pools:
            k[dst * ps:(dst + 1) * ps] = k[src * ps:(src + 1) * ps]
            v[dst * ps:(dst + 1) * ps] = v[src * ps:(src + 1) * ps]

    def _admit_all(self, inflight) -> None:
        """Issue prefills for every waiting request that gets a slot (and
        its pages). Requests sharing a length bucket prefill together;
        long prompts and prefix requests join the chunked-prefill queue.
        First tokens drain through the same pipeline as decode."""
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
            if self._paged:
                outcome = self._admit_paged(req)
                if outcome == "nopages":
                    # hold the head request (FIFO) until releases refill
                    # the pool
                    self._pending_head = req
                    break
                if outcome == "failed":
                    continue
            elif not self._admit_contiguous(req):
                continue
            if req.prefix_id >= 0 or self._use_chunked(req.prompt.size):
                self._prefilling.append(req)
            else:
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
        slot (a contiguous cache without batching prefills one prompt in
        place)."""
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
        single = (not self._paged and self.cfg.max_prefill_batch <= 1)
        try:
            toks = self._prefill(
                self._to_dev(tokens), self._to_dev(slots),
                self._to_dev(lens), self._to_dev(temps),
                self._to_dev(top_ps), pad_len,
                any_temp=bool((temps > 0).any()),
                any_top_p=bool((top_ps < 1.0).any()),
                single_slot=int(slots[0]) if single else None)[:g_real]
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

    def _dispatch_chunk(self, inflight) -> None:
        """Advance the oldest chunk-prefilling request by one chunk. The
        final chunk samples the first token and activates the slot."""
        req = self._prefilling[0]
        if req.aborted:
            # cancelled mid-prefill: drop the rest, free the slot, close
            # the stream with no token forced
            self._prefilling.popleft()
            self._release(req)
            return
        start = req.prefill_pos
        n = min(self._chunk_for(req.prompt.size - start),
                req.prompt.size - start)
        is_last = start + n >= req.prompt.size
        t_dispatch = time.time()
        try:
            tok = self._prefill_chunk(
                self._to_dev(req.prompt[None, start:start + n]), req.slot,
                start, req.temperature, req.top_p, sample=is_last)
        except Exception as e:  # noqa: BLE001  per-request containment
            self._prefilling.popleft()
            self._free_slot_pages(req.slot)
            self._free_slots.append(req.slot)
            req.slot = -1
            req.out_queue.put(("error", e))
            req.out_queue.put(_END)
            return
        req.prefill_pos = start + n
        self._disp_len[req.slot] = req.prefill_pos
        req.prefill_dispatch_ms += (time.time() - t_dispatch) * 1000
        if is_last:
            self._prefilling.popleft()
            self.stats["prefills"] += 1
            self._last_tokens[req.slot:req.slot + 1] = tok
            self._active[req.slot] = req
            self._mask_dirty = True
            inflight.append(("prefill_batch", [req], _Fetch(tok)))

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
        """Forget the slot's length mirror; on the paged cache return its
        exclusive pages to the pool (shared prefix pages stay pinned) and
        point its row at the trash page, so lagged decode writes cannot
        reach a reused page."""
        self._disp_len.pop(slot, None)
        if not self._paged:
            return
        entry = self._slot_pages.pop(slot, None)
        if entry is None:
            return
        n_shared, pages = entry
        self._free_pages.extend(pages[n_shared:])
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
        """Power-of-2 page window covering every slot that holds KV
        (decoding and chunk-prefilling: a narrower window would let the
        clamped write index of `PagedKV.flat_rows` reach a prefilling
        slot's pages) plus this dispatch's new tokens; 0 = the full
        table."""
        ps = self.cfg.kv_page_size
        need = (max(self._disp_len.values(), default=0)
                + max(1, self.cfg.decode_block))
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
        """Read the oldest in-flight result and emit its tokens in step
        order. Termination checks happen here, `pipeline_depth`
        dispatches behind; lagged tokens of finished or reused slots are
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
        rows = host if host.ndim == 2 else host[None, :]   # (block, S)
        self.stats["decode_steps"] += rows.shape[0]
        for row in rows:
            for slot, req in payload:
                if req.slot != slot:
                    continue  # released/reused slot: lagged, discard
                if req.generated >= req.max_new_tokens:
                    # budget shrank out of band (abort())
                    self._release(req)
                    continue
                self._emit(req, int(row[slot]))
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

    def _run_commands(self) -> None:
        """Run queued cache mutations (prefix registration) between
        dispatches."""
        while True:
            try:
                fn, done = self._control_q.get_nowait()
            except queue_mod.Empty:
                return
            try:
                fn()
                done.set_result(None)
            except Exception as e:  # noqa: BLE001  raised in the caller
                done.set_exception(e)

    def _step(self, inflight) -> None:
        self._run_commands()
        self._admit_all(inflight)
        if self._prefilling:
            self._dispatch_chunk(inflight)
        if self._active:
            mask, temps, top_ps, any_temp, any_top_p = \
                self._device_mask_temps()
            snapshot = list(self._active.items())
            block = max(1, self.cfg.decode_block)
            window = self._decode_window_pages() if self._paged else 0
            steps = []
            for _ in range(block):
                toks, self._lengths = self._decode(
                    mask, temps, top_ps, window, any_temp, any_top_p)
                self._last_tokens = toks
                steps.append(toks)
            for slot in self._active:
                self._disp_len[slot] += block
            out = steps[0] if block == 1 else torch.stack(steps)
            inflight.append(("decode", snapshot, _Fetch(out)))
        if not inflight:
            time.sleep(0.002)
            return
        # stay `pipeline_depth` dispatches ahead while decoding; drain
        # fully once nothing is active
        target = self.cfg.pipeline_depth if self._active else 0
        while len(inflight) > target:
            self._drain_one(inflight)
