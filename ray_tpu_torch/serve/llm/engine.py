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
* Decode graphs (the paged cache on CUDA, a model whose forward takes
  `graphs=`: Llama, Mixtral, GPT-2, unsharded): the one-token decode
  forward is captured as a CUDA graph per page-table width the window
  can take (`_graph_widths`: the powers of two below the table's width
  and the full table), all at the first plain decode step, and the
  model's forward replays it (models/decode_graph.py): one launch where
  the eager forward issues thousands from Python. The engine still
  calls the model once a step, so its forward hooks run. Sampling stays
  eager: it reads the graph's logits on the stream before the next
  replay overwrites them, into tokens of its own that the fetch copies.
  Guided and penalised steps, verify steps, prefills and chunks
  run the same forward eagerly, as does every step on the CPU or the
  contiguous cache. `get_stats()["decode_graphs"]` says whether the
  graphs are captured, and why a capture that raised left the engine
  eager.
* Prefix caching (`max_prefixes > 0`): `register_prefix` prefills a
  shared prefix once, on the engine loop thread. Paged: into pinned
  pages through the scratch slot's row (a fresh prefill, K1); adopters
  share its full pages by page-table reference and copy only its
  partial last page. Contiguous: into a row of a (max_prefixes + 1, L,
  Hkv, D) buffer (the extra row is `precompile`'s scratch prefix);
  adopters copy its rows into their slot.
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

Request controls, as in the reference:
* guided decoding (`guided_fsm`, serve/llm/guided.py): a host-side token
  FSM whose per-state vocab mask is uploaded for each step; guided
  traffic steps synchronously, since the next mask depends on the token
  just sampled;
* presence / frequency penalties and `logit_bias`: per-slot token counts
  (S, V) int32 and a static bias (S, V) fp32 stay on the device, the
  counts updated in place from the tokens fed to each step, so
  penalised traffic keeps the pipeline;
* logprobs (`logprobs=True`): each token's log-probability under the raw
  model distribution, fetched with the tokens in one copy;
* n-gram speculation (`ngram_speculation=K`): for greedy, unguided,
  unpenalised requests the host proposes K tokens from the request's own
  history and one forward over 1 + K tokens verifies them (greedy prefix
  acceptance); it steps synchronously and backs off after 8 steps
  without a proposal. The verify step's attention takes the page-gather
  route on the paged cache (only one-token steps take K3);
* deadlines: a request whose `deadline_ts` passed is refused at submit
  or shed at admission with DeadlineExceededError;
* the watchdog (`watchdog_s`): a thread that declares the engine wedged
  when its loop makes no progress while it has work; requests then fail
  with EngineWedgedError;
* `precompile()` warms every prefill bucket, the chunked and the prefix
  paths before real traffic (the kernels' build and load, cuBLAS and the
  allocator).

Telemetry, as in the reference: registry metrics (`ray_tpu_llm_engine_*`,
one series per engine under the `engine` tag: tokens, TTFT, TPOT, active
slots, waiting requests, batch occupancy, KV page utilisation) and
cluster events (request admit / preempt / finish / abort, `wedged`,
`serve.request.shed` with the `ray_tpu_serve_requests_shed_total`
counter, consumer-stall hangs) through `util/metrics.py` and
`util/events.py`; inside an actor the worker's telemetry flush ships
them to the driver.

Beyond the reference: every request's way to its first token on the
monotonic clock (`request_timings()`: submit, admit, the prefill
dispatch's return, the first token; `ttft_breakdown_p50_ms` is read
from them), always on; and while a torch.profiler capture runs on the
loop thread (`observability/profiler.py`, `start_trace(engine=)`) the
loop's spans, `llm.step` around each iteration with `llm.admit`,
`llm.prefill`, `llm.chunk`, `llm.decode` (holding `llm.decode_graph`
round a replay), `llm.publish` and `llm.drain` (holding
`llm.fetch_wait` and `llm.emit`) inside it, and its counters of the
work dispatched: `llm.prefill_tokens` and `llm.prefill_pairs` (the true
prompts' tokens and causal (query, key) pairs), `llm.decode_tokens`
(active rows), `llm.decode_keys` (the keys K3 reads per layer), and
`llm.decode_graph_steps` and `llm.decode_eager_steps` (the one-token
steps that replayed a graph and those that ran the forward eagerly,
verify steps among the latter). A replay counts what its forward
counted at capture (`moe.rows_computed`); the kernels it launches fall
under `llm.decode_graph`, not under the model's spans.
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

from ...exceptions import DeadlineExceededError, EngineWedgedError
from ...models import decode_graph
from ...observability.profiler import annotate, capturing, count
from ...ops.attention import PagedKV
from ...util.device import DeviceLike, resolve_device
from ...util import events as events_mod
from ...util.knobs import engine_watchdog_s


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
    # finished request) against hiding the device->host fetch. A token
    # is read this many dispatches after its own; with decode graphs a
    # dispatch costs about a step of device time, eager ones cost the
    # host's issue of the forward's ops. The default mirrors the JAX
    # engine; the right depth for the GPU has not been measured.
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
    # Fetch each sampled token's log-probability under the raw model
    # distribution (stream_detailed); one fp32 log_softmax over (S, V)
    # a step, fetched with the tokens.
    logprobs: bool = False
    # Warm every prefill bucket, the chunked and the prefix paths in
    # __init__ (blocking), so no first request pays a first-use cost.
    precompile: bool = False
    # n-gram (prompt-lookup) speculation: propose this many tokens a
    # step from the request's own history, verify them in one forward.
    # Greedy, unguided, unpenalised requests only; 0 disables.
    ngram_speculation: int = 0
    ngram_order: int = 2
    # tokens of trailing history searched for a proposal
    ngram_lookback: int = 256
    # No-forward-progress window of the watchdog while requests are
    # admitted or waiting; None reads RAY_TPU_ENGINE_WATCHDOG_S
    # (default 30); <= 0 disables.
    watchdog_s: Optional[float] = None


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
    preempt_emitted: bool = False   # the pool-exhausted event, once
    prefix_id: int = -1             # registered prefix whose KV it adopts
    prefill_pos: int = 0            # next prompt index (chunked prefill)
    # guided decoding: host-side token FSM and its state (advanced at
    # emit)
    fsm: Optional[object] = None
    fsm_state: int = 0
    # n-gram speculation: prompt + generated tokens (the proposal
    # source); None when the request is not eligible
    hist: Optional[list] = None
    # OpenAI penalties on generated tokens, and a static
    # {token_id: bias}
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: Optional[dict] = None
    # absolute deadline (epoch seconds); a request still queued past it
    # is shed at admission
    deadline_ts: Optional[float] = None
    # time.perf_counter() stamps of its way to the first token
    # (request_timings)
    t_submit: float = field(default_factory=time.perf_counter)
    t_admit: Optional[float] = None        # slot assigned
    t_prefill_end: Optional[float] = None  # its prefill dispatch returned
    t_first: Optional[float] = None        # first token emitted


_END = ("__end__", None)

# get_stats()["ttft_breakdown_p50_ms"]: each part's (start, end) stamps
# in request_timings()
_TTFT_PARTS = {"queue_ms": ("submit", "admit"),
               "prefill_dispatch_ms": ("admit", "prefill_end"),
               "emit_ms": ("prefill_end", "first_token"),
               "total_ms": ("submit", "first_token")}


_engine_ids = itertools.count()
_metrics_singletons = None


def _engine_metrics():
    """Shared built-in registry metrics, resolved through the catalog
    (util/metrics_catalog.py) so names stay `ray_tpu_`-prefixed and
    documented in one place. Per-engine series ride the `engine` tag —
    re-instantiating per engine would clobber the registry entry and
    drop earlier engines' series. A cleared registry (tests do that)
    is detected and the metrics re-register fresh."""
    global _metrics_singletons
    from ...util import metrics as metrics_mod  # noqa: PLC0415
    from ...util import metrics_catalog as mcat  # noqa: PLC0415
    if (_metrics_singletons is not None
            and metrics_mod.get_metric(
                "ray_tpu_llm_engine_tokens_generated")
            is not _metrics_singletons["tokens"]):
        _metrics_singletons = None
    if _metrics_singletons is None:
        _metrics_singletons = {
            "tokens": mcat.get("ray_tpu_llm_engine_tokens_generated"),
            "active": mcat.get("ray_tpu_llm_engine_active_slots"),
            "waiting": mcat.get("ray_tpu_llm_engine_waiting_requests"),
            "occupancy": mcat.get("ray_tpu_llm_engine_batch_occupancy"),
            "kv_util": mcat.get(
                "ray_tpu_llm_engine_kv_page_utilization"),
            "ttft": mcat.get("ray_tpu_llm_engine_ttft_s"),
            "tpot": mcat.get("ray_tpu_llm_engine_tpot_s"),
        }
    return _metrics_singletons


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
    """Device tensors on their way to the host in one copy: int32 parts
    and fp32 parts (viewed as int32) are flattened into one tensor, and
    on CUDA copied without blocking into pinned memory, recorded with a
    CUDA event. On the CPU the values are copied at once (later in-place
    writes must not reach them). `result()` gives the parts back as
    numpy arrays."""

    def __init__(self, *parts: torch.Tensor):
        self._meta = [(tuple(p.shape), p.dtype) for p in parts]
        flat = [(p.view(torch.int32) if p.dtype == torch.float32
                 else p).reshape(-1) for p in parts]
        flat = flat[0] if len(flat) == 1 else torch.cat(flat)
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat.clone()
            self.event = None

    def result(self) -> List[np.ndarray]:
        with annotate("llm.fetch_wait"):
            if self.event is not None:
                self.event.synchronize()
        host = self.host.numpy()
        out, off = [], 0
        for shape, dtype in self._meta:
            n = int(np.prod(shape, dtype=np.int64))
            part = host[off:off + n].reshape(shape)
            out.append(part.view(np.float32) if dtype == torch.float32
                       else part)
            off += n
        return out


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
        # the paged one-token decode forward as CUDA graphs, captured at
        # the first plain decode step (`_step_graphs`)
        self._graphs = (decode_graph.DecodeGraphs() if self._paged
                        and decode_graph.available(dev)
                        and decode_graph.supported(model) else None)
        # why the first capture failed ("Type: message"), else None
        self._graph_error: Optional[str] = None
        self._pending_head: Optional[_Request] = None
        # host mirror of each slot's length (prefilled and chunking
        # slots too): sizes the paged decode step's page window
        self._disp_len: Dict[int, int] = {}
        # prefix caching: pid -> tokens; contiguous KV rows
        self._prefixes: Dict[int, np.ndarray] = {}
        self._prefix_counter = itertools.count()
        self._prefix_cache = None
        if cfg.max_prefixes > 0 and not self._paged:
            # + 1 row: precompile's scratch prefix (pid max_prefixes,
            # never handed out)
            self._prefix_cache = [(zeros(cfg.max_prefixes + 1, L, *kv),
                                   zeros(cfg.max_prefixes + 1, L, *kv))
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
        # guided decoding: the (slots, V) host mask kept across steps,
        # and each slot's (request_id, fsm_state) it was built for
        self._guided_allow_buf: Optional[np.ndarray] = None
        self._guided_prev: Optional[Dict[int, tuple]] = None
        # n-gram speculation backoff (steps without a proposal; re-probe
        # counter)
        self._spec_idle = 0
        self._spec_retry = 0
        # penalties: per-slot token counts (S, V) int32 and static bias
        # (S, V) fp32 on the device, made on first use; a slot's rows are
        # seeded once per request (slot -> request_id)
        self._pen_counts: Optional[torch.Tensor] = None
        self._pen_static: Optional[torch.Tensor] = None
        self._pen_seeded: Dict[int, str] = {}
        self._pen_coef = None
        self._pen_coef_dirty = True
        self._shutdown = threading.Event()
        self.stats = {"prefills": 0, "decode_steps": 0,
                      "tokens_generated": 0, "prefix_tokens_saved": 0,
                      "spec_steps": 0, "spec_accepted": 0}
        # request_timings: one entry per request that got a first token
        self._timings: collections.deque = collections.deque(maxlen=4096)
        self._tpot_samples: collections.deque = collections.deque(maxlen=512)
        # registry metrics, one labeled series per engine; the dict is
        # refreshed once per loop step, not per token
        self._mtags = {"engine": f"llm-{next(_engine_ids)}"}
        self._tokens_unpublished = 0
        self._m = _engine_metrics()
        # watchdog: _progress_ts advances on every admission, chunk and
        # emitted token; a thread of its own reads it, since the loop
        # thread may be the one that is stuck
        self._watchdog_s = (float(cfg.watchdog_s) if cfg.watchdog_s
                            is not None else engine_watchdog_s())
        self._progress_ts = time.time()
        self._wedged_since: Optional[float] = None
        # True while the loop thread admits, dispatches, drains or runs a
        # command: a stall there may be a first use (the kernels' nvcc
        # build, CUDA's lazy init), so it gets _DISPATCH_GRACE x the
        # window
        self._in_dispatch = False
        self._loop_thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="llm-engine")
        self._loop_thread.start()
        self._watchdog_thread = None
        if self._watchdog_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name="llm-engine-watchdog")
            self._watchdog_thread.start()
        if cfg.precompile:
            self.precompile()

    # ---- device work --------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _sample_tokens(self, logits, temps, top_ps, any_temp: bool,
                       any_top_p: bool, allow=None, bias=None):
        """Sample per row of logits (N, V): greedy where temp == 0, else
        temperature + optional global top-k + per-row nucleus top-p.
        `any_temp` / `any_top_p` are the host's knowledge of whether any
        row samples / asks for top_p < 1; without them the draw (and the
        full-vocab sort) is skipped. `bias` (N, V) is added to the logits
        (logit_bias and penalties), then tokens outside `allow` (N, V)
        bool (guided decoding) are made impossible, in the reference's
        order. Returns (N,) int32."""
        if bias is not None:
            logits = logits + bias.to(logits.dtype)
        if allow is not None:
            logits = logits.masked_fill(~allow, float("-inf"))
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

    def _sample(self, logits, temps, top_ps, any_temp: bool,
                any_top_p: bool, allow=None, bias=None):
        """`_sample_tokens` and, with cfg.logprobs, each token's
        log-probability under the raw model distribution (before the
        bias and the mask): (tokens (N,) int32, logprobs (N,) fp32 or
        None)."""
        toks = self._sample_tokens(logits, temps, top_ps, any_temp,
                                   any_top_p, allow=allow, bias=bias)
        if not self.cfg.logprobs:
            return toks, None
        raw_logp = torch.log_softmax(logits.float(), dim=-1)
        return toks, raw_logp.gather(1, toks.long()[:, None])[:, 0]

    @staticmethod
    def _pen_bias(pen, last_tokens, active_mask):
        """Penalty bias of one decode step. pen = (counts (S, V) int32,
        static_bias (S, V) fp32, presence (S,), frequency (S,)), all on
        the device. The token fed to this step (the previous emission,
        the prefill's first token included) is counted first, in place,
        so each generated token penalises from the next step on without
        a trip to the host. Returns bias (S, V) fp32, or None."""
        if pen is None:
            return None
        counts, static_bias, presence, freq = pen
        rows = torch.arange(counts.shape[0], device=counts.device)
        counts.index_put_((rows, last_tokens.long()),
                          active_mask.to(counts.dtype), accumulate=True)
        return (static_bias - presence[:, None] * (counts > 0)
                - freq[:, None] * counts)

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
                 single_slot: Optional[int] = None, allow=None, bias=None):
        """Prefill G prompts: tokens (G, pad_len); slots / true_lens /
        temps / top_ps (G,). Padding rows target the scratch slot.
        Returns the sampled first tokens (G,) int32 and their logprobs
        (or None); `allow` / `bias` (G, V) constrain that sample.

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
        return self._sample(last, temps, top_ps, any_temp, any_top_p,
                            allow=allow, bias=bias)

    def _prefill_chunk(self, tokens, slot: int, start: int, temp: float,
                       top_p: float, sample: bool, allow=None, bias=None):
        """One chunk of a long prompt through the cached path: tokens
        (1, n) written at positions [start, start + n); the slot's length
        becomes start + n. The slot's current length IS `start`: a reused
        slot's stored length would be stale from the previous occupant
        (`_prefill_chunk_impl`). The paged cache gathers the slot's page
        row (`_chunk_paged_impl`). sample=True (the final chunk) samples
        the first token under `allow` / `bias` (1, V) and returns it
        (1,) int32 with its logprob (or None); else returns None."""
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
        return self._sample(
            logits[0, -1:], self._to_dev(np.array([temp], np.float32)),
            self._to_dev(np.array([top_p], np.float32)), temp > 0,
            top_p < 1.0, allow=allow, bias=bias)

    def _cache_entries(self, window_pages: int):
        """Per-layer cache entries of a decode or verify step over every
        slot. window_pages > 0 narrows the page table to its first
        columns (a power-of-2 bucket covering the longest slot)."""
        if not self._paged:
            return [(ck, cv, self._lengths) for (ck, cv) in self._cache]
        pt = self._page_table
        if window_pages and window_pages < pt.shape[1]:
            pt = pt[:, :window_pages].contiguous()
        return [PagedKV(k, v, pt, self._lengths, self.cfg.kv_page_size)
                for (k, v) in self._pools]

    def _decode(self, mask, temps, top_ps, window_pages: int,
                any_temp: bool, any_top_p: bool, allow=None, pen=None,
                graphs=None):
        """One decode step for every slot. Inactive slots keep their
        lengths; released paged slots' rows point at the trash page, so
        their writes are inert. `allow` (S, V) is the guided mask and
        `pen` the penalty state (`_pen_args`); `graphs` the decode
        graphs the model's forward replays (`_step_graphs`), sampling
        stays eager. Returns (next tokens, logprobs or None, new
        lengths)."""
        # a lagged step of a request that filled max_seq_len writes at
        # the last position instead of past it; its token is discarded
        positions = self._lengths.clamp(max=self.cfg.max_seq_len - 1)[:, None]
        replays = 0 if graphs is None else graphs.replays
        logits, new_entries = self.model(
            self._last_tokens[:, None],
            cache=self._cache_entries(window_pages), positions=positions,
            **({} if graphs is None else {"graphs": graphs}))
        count("llm.decode_graph_steps" if graphs is not None
              and graphs.replays > replays else "llm.decode_eager_steps")
        new = new_entries[0]
        new_len = new.lengths if self._paged else new[2]
        new_lengths = torch.where(mask, new_len, self._lengths)
        bias = self._pen_bias(pen, self._last_tokens, mask)
        nxt, logps = self._sample(logits[:, 0], temps, top_ps, any_temp,
                                  any_top_p, allow=allow, bias=bias)
        return torch.where(mask, nxt, self._last_tokens), logps, new_lengths

    def _verify(self, proposals, mask, temps, top_ps, window_pages: int,
                any_temp: bool, any_top_p: bool):
        """n-gram speculation verify (`_verify_impl` /
        `_verify_paged_impl`): one forward of [last, p1..pK] for every
        slot, then greedy prefix acceptance. proposals (S, K) int32, -1 =
        no proposal at that offset. Rejected positions' KV stays past
        the new length, masked, and is overwritten by later writes.
        Positions clamp to max_seq_len - 1 for slots that are not active
        (`_spec_plan` vetoes a step that would take an active slot past
        it). Returns (out (S, K+1), n_emit (S,), logprobs (S, K+1) or
        None); emit out[s, :n_emit[s]]."""
        k = proposals.shape[1]
        toks_in = torch.cat([self._last_tokens[:, None],
                             proposals.clamp(min=0)], dim=1)
        positions = (self._lengths[:, None]
                     + torch.arange(k + 1, device=self.device)[None, :]
                     ).clamp(max=self.cfg.max_seq_len - 1)
        logits, _ = self.model(toks_in,
                               cache=self._cache_entries(window_pages),
                               positions=positions)       # (S, K+1, V)
        count("llm.decode_eager_steps")
        out, n_emit, logps, last = self._verify_accept(
            logits, proposals, mask, temps, top_ps, any_temp, any_top_p)
        self._lengths = self._lengths + n_emit
        self._last_tokens = last
        return out, n_emit, logps

    def _verify_accept(self, logits, proposals, mask, temps, top_ps,
                       any_temp: bool, any_top_p: bool):
        """Acceptance of a verify step: a greedy chain for speculating
        rows (the proposals that equal the argmax in order, and the
        argmax after them); a sampled row takes position 0 only, sampled
        as in a decode step."""
        k = proposals.shape[1]
        s = logits.shape[0]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)   # (S, K+1)
        match = (proposals == greedy[:, :k]) & (proposals >= 0)
        m = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        out0, lp0 = self._sample(logits[:, 0], temps, top_ps, any_temp,
                                 any_top_p)
        out = torch.cat([out0[:, None], greedy[:, 1:]], dim=1)
        logps = None
        if self.cfg.logprobs:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            logps = lsm.gather(2, out.long()[..., None])[..., 0]
            logps[:, 0] = lp0
        n_emit = torch.where(temps > 0, 1, m + 1)
        n_emit = torch.where(mask, n_emit, 0).to(torch.int32)
        rows = torch.arange(s, device=self.device)
        last = out[rows, (n_emit - 1).clamp(min=0).long()]
        last = torch.where(mask, last, self._last_tokens)
        return out, n_emit, logps, last

    # ---- public API -----------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The weights every dispatch reads: the model's parameters, live
        (the reference's `engine.params`)."""
        return dict(self.model.named_parameters())

    @params.setter
    def params(self, state) -> None:
        self.set_params(state)

    def set_params(self, state) -> None:
        """Put `state` (name -> tensor: some or all of the model's
        parameters and buffers) into the model in place; the
        reference's `engine.params = params`. The copy runs on the loop
        thread between dispatches and under the engine's lock, so no
        dispatch sees half the tree; steps already issued read the old
        weights (they come before the copy on the stream). A tensor that
        already is the model's own (a learner sharing the engine's
        module) is not copied. Registered prefixes keep the KV they were
        prefilled with, as in the reference, whose prefix caches also
        outlive a swap."""
        own = self.model.state_dict(keep_vars=True)
        items = []
        for name, src in state.items():
            if name not in own:
                raise KeyError(f"{name!r} is not a weight of the engine's "
                               f"model")
            dst = own[name]
            if src.shape != dst.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != the "
                                 f"model's {tuple(dst.shape)}")
            if (src.data_ptr() == dst.data_ptr() and src.dtype == dst.dtype
                    and src.stride() == dst.stride()):
                continue
            items.append((dst, src))

        def swap():
            with self._lock, torch.no_grad():
                for dst, src in items:
                    dst.copy_(src)

        if items:
            self._run_on_loop(swap)

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
               stop_token_ids=None, prefix_id: Optional[int] = None,
               guided_fsm=None, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               logit_bias: Optional[dict] = None,
               deadline_ts: Optional[float] = None) -> str:
        """Queue one request; returns its id for stream().

        prefix_id: a registered prefix; `prompt_ids` is then the
        suffix. The engine re-attaches the prefix's tokens but adopts its
        KV instead of prefilling it.
        guided_fsm: a serve.llm.guided.TokenFSM constraining the output
        (per-step vocab masks; EOS only at accepting states). Guided
        traffic steps synchronously.
        presence_penalty / frequency_penalty (in [-2, 2]) and logit_bias
        ({token_id: bias}): OpenAI semantics over the generated tokens.
        deadline_ts: absolute deadline (epoch seconds). One already past
        is refused here, one that passes while the request is queued
        sheds it at admission, both with DeadlineExceededError."""
        if self.wedged:
            raise EngineWedgedError(
                "engine is wedged; replica awaiting replacement")
        if deadline_ts is not None and time.time() >= deadline_ts:
            # the queued-expiry path's telemetry: every shed is visible
            self._event("serve.request.shed", reason="deadline_expired",
                        stage="submit",
                        late_s=round(time.time() - deadline_ts, 3))
            events_mod.emit_safe(
                counter="ray_tpu_serve_requests_shed_total",
                counter_tags={"reason": "deadline_expired"})
            raise DeadlineExceededError(
                "deadline already expired at submit; request rejected "
                "at admission")
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if not -2.0 <= presence_penalty <= 2.0 \
                or not -2.0 <= frequency_penalty <= 2.0:
            raise ValueError("presence/frequency penalties must be in "
                             "[-2, 2] (OpenAI semantics)")
        if guided_fsm is not None:
            vs = self.model.cfg.vocab_size
            if guided_fsm.vocab_size != vs:
                raise ValueError(
                    f"guided_fsm.vocab_size {guided_fsm.vocab_size} != "
                    f"model vocab_size {vs}")
            if (self.cfg.eos_token_id is not None
                    and guided_fsm.eos_id != self.cfg.eos_token_id):
                raise ValueError(
                    f"guided_fsm.eos_id {guided_fsm.eos_id} != engine "
                    f"eos_token_id {self.cfg.eos_token_id}")
            if not guided_fsm.allowed(guided_fsm.start).any():
                raise ValueError("guided_fsm allows no token at its "
                                 "start state (empty language)")
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
        speculates = (self.cfg.ngram_speculation > 0 and temperature == 0.0
                      and guided_fsm is None
                      and not (presence_penalty or frequency_penalty
                               or logit_bias))
        req = _Request(request_id=f"req-{next(self._req_counter)}",
                       prompt=prompt, max_new_tokens=budget,
                       temperature=float(temperature), top_p=float(top_p),
                       stop_ids=frozenset(stop_token_ids or ()),
                       prefix_id=-1 if prefix_id is None else prefix_id,
                       fsm=guided_fsm,
                       fsm_state=(guided_fsm.start
                                  if guided_fsm is not None else 0),
                       hist=list(map(int, prompt)) if speculates else None,
                       presence_penalty=float(presence_penalty),
                       frequency_penalty=float(frequency_penalty),
                       logit_bias=dict(logit_bias) if logit_bias else None,
                       deadline_ts=deadline_ts)
        with self._lock:
            self._requests[req.request_id] = req
        self._waiting.put(req)
        return req.request_id

    def stream(self, request_id: str):
        """Blocking generator of token ids for one request."""
        for tok, _lp in self.stream_detailed(request_id):
            yield tok

    def stream_detailed(self, request_id: str):
        """Like stream() but yields (token_id, logprob); logprob is None
        unless the engine was built with logprobs=True. Raises the
        request's error (DeadlineExceededError when it was shed,
        EngineWedgedError when the watchdog aborted it)."""
        req = self._requests.get(request_id)
        if req is None:
            raise KeyError(request_id)
        try:
            while True:
                # raylint: disable=RT003 the engine loop cannot exit with
                # this request registered: its catch-all errors every
                # active request's queue, failed admits error theirs, and
                # the watchdog aborts stalled requests, while a timeout
                # here would kill a legitimate long first prefill
                kind, payload = req.out_queue.get()
                if kind == "token":
                    yield payload
                elif kind == "error":
                    raise payload
                else:  # end
                    break
        finally:
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
        self._event("llm_engine.request_abort", req=req,
                    generated=req.generated)
        if req.generated == 0 and req.slot == -1:
            req.out_queue.put(_END)
        elif req.generated > 0:
            req.max_new_tokens = min(req.max_new_tokens, req.generated)

    def precompile(self) -> None:
        """Warm every path before real traffic: one request of 2 tokens
        per prefill bucket (a prompt that takes the bucket's unchunked
        path), one chunked prompt when chunking is on, and with
        prefixes, the fill, adopt and chunk paths through a scratch
        prefix (pid max_prefixes, never handed out), one suffix length
        per reachable chunk width. On the GPU the first use of a path
        builds and loads the kernels and warms cuBLAS and the allocator.
        Blocks until the requests finish; every slot is free afterwards
        and prefix_tokens_saved is reset (the other stats count the
        warm-up)."""
        cfg = self.cfg
        rids = []
        prev = 0
        for b in sorted(cfg.prefill_buckets):
            if b > cfg.max_seq_len:
                continue
            n = min(b, cfg.max_seq_len - 2)
            if cfg.prefill_chunk > 0:
                n = min(n, cfg.prefill_chunk)
            n = max(1, n)
            if n <= prev:
                prev = b
                continue  # no unchunked prompt can reach this bucket
            rids.append(self.submit(np.ones((n,), np.int32),
                                    max_new_tokens=2))
            prev = b
        if cfg.prefill_chunk > 0:
            n = max(1, min(cfg.prefill_chunk + 1, cfg.max_seq_len - 2))
            rids.append(self.submit(np.ones((n,), np.int32),
                                    max_new_tokens=2))
        for rid in rids:
            for _ in self.stream(rid):
                pass
        if cfg.max_prefixes <= 0:
            return
        scratch = cfg.max_prefixes
        fill = (self._register_prefix_paged if self._paged
                else self._fill_prefix_row)
        self._run_on_loop(lambda: fill(scratch, np.ones((2,), np.int32)))
        widths = ({cfg.prefill_chunk} if cfg.prefill_chunk > 0 else
                  {b for b in cfg.prefill_buckets if b <= cfg.max_seq_len})
        lens = {max(1, min(w, cfg.max_seq_len - 4)) for w in widths}
        if cfg.prefill_chunk <= 0 and widths:
            # a suffix longer than the largest bucket takes several
            # chunks, the first not sampling
            lens.add(max(1, min(max(widths) + 1, cfg.max_seq_len - 4)))
        warm = [self.submit(np.ones((n,), np.int32), max_new_tokens=2,
                            prefix_id=scratch) for n in sorted(lens)]
        for rid in warm:
            for _ in self.stream(rid):
                pass
        if self._paged:
            self._run_on_loop(lambda: self._unregister_prefix_paged(scratch))
        else:
            self._prefixes.pop(scratch, None)
        self.stats["prefix_tokens_saved"] = 0   # the warm-up's adoptions

    def generate_sync(self, prompt_ids, max_new_tokens=None,
                      temperature: float = 0.0, top_p: float = 1.0,
                      stop_token_ids=None, prefix_id: Optional[int] = None,
                      guided_fsm=None, presence_penalty: float = 0.0,
                      frequency_penalty: float = 0.0,
                      logit_bias: Optional[dict] = None) -> List[int]:
        rid = self.submit(prompt_ids, max_new_tokens, temperature,
                          top_p=top_p, stop_token_ids=stop_token_ids,
                          prefix_id=prefix_id, guided_fsm=guided_fsm,
                          presence_penalty=presence_penalty,
                          frequency_penalty=frequency_penalty,
                          logit_bias=logit_bias)
        return list(self.stream(rid))

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {**self.stats, "active": len(self._active),
                   "waiting": self._waiting.qsize(),
                   "prefilling": len(self._prefilling),
                   "free_slots": len(self._free_slots),
                   "decode_graphs": self._graph_state()}
            if self._paged:
                out["kv_pages"] = {
                    "page_size": self.cfg.kv_page_size,
                    "total": self._n_pages,
                    "free": len(self._free_pages),
                    "in_use": self._n_pages - len(self._free_pages),
                    "pinned_prefix": sum(
                        len(p) for p in self._prefix_pages.values()),
                    "peak_in_use": self._page_hwm}
            timings = list(self._timings)
            tpots = sorted(self._tpot_samples)
        if tpots:
            out["tpot_p50_ms"] = round(tpots[len(tpots) // 2] * 1000, 2)
        if timings:
            def p50(start, end):
                vals = sorted(t[end] - t[start] for t in timings)
                return round(vals[len(vals) // 2] * 1000, 1)
            out["ttft_breakdown_p50_ms"] = {
                k: p50(*span) for k, span in _TTFT_PARTS.items()}
        return out

    def _graph_state(self) -> str:
        """get_stats()["decode_graphs"]: "off" (this engine runs every
        step eagerly: not CUDA, not the paged cache, or a model that
        takes no graphs), "pending" (none captured yet, or dropped with a
        rebound weight until the next plain step), "captured", or
        "failed: <error>" (the capture raised; decode runs eagerly)."""
        if self._graph_error is not None:
            return f"failed: {self._graph_error}"
        if self._graphs is None:
            return "off"
        return "captured" if self._graphs.captured else "pending"

    def request_timings(self) -> List[Dict[str, Any]]:
        """The way to the first token of the last 4096 requests that got
        one, oldest first: {"request_id", "submit", "admit",
        "prefill_end", "first_token"}, time.perf_counter() seconds
        (admission took a slot; the prefill dispatch returned; the first
        token was emitted to the request's stream). A copy."""
        with self._lock:
            return [dict(t) for t in self._timings]

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the engine loop and the watchdog and wait for their
        threads."""
        self._shutdown.set()
        for t in (self._loop_thread, self._watchdog_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)

    # ---- watchdog ---------------------------------------------------------
    @property
    def wedged(self) -> bool:
        """True once the watchdog declared the engine wedged (sticky: the
        replica is to be replaced)."""
        return self._wedged_since is not None

    def _note_progress(self) -> None:
        self._progress_ts = time.time()

    def _has_work(self) -> bool:
        return bool(self._active or self._prefilling
                    or not self._waiting.empty())

    # A stall inside a dispatch may be a first use (the kernels' build,
    # CUDA's lazy init): it gets this many times the window.
    _DISPATCH_GRACE = 10.0

    def _watchdog_loop(self) -> None:
        period = max(0.05, min(1.0, self._watchdog_s / 4.0))
        while not self._shutdown.is_set():
            self._shutdown.wait(period)
            if self._wedged_since is not None:
                continue
            if not self._has_work():
                # idle is not wedged; keep the clock fresh so the first
                # request after a quiet spell is not blamed at once
                self._note_progress()
                continue
            budget = self._watchdog_s * (
                self._DISPATCH_GRACE if self._in_dispatch else 1.0)
            stall = time.time() - self._progress_ts
            if stall > budget:
                self._declare_wedged(stall)

    def _event(self, etype: str, message: str = "", req=None,
               **attrs) -> None:
        """A lifecycle event on the cluster event plane (util/events.py);
        never raises into the engine."""
        try:
            events_mod.emit(
                etype, message,
                request_id=req.request_id if req is not None else None,
                engine=self._mtags["engine"], **attrs)
        except Exception:  # noqa: BLE001 - telemetry never fails serving
            pass

    def _declare_wedged(self, stall_s: float) -> None:
        self._wedged_since = time.time()
        self._event("llm_engine.wedged",
                    f"no forward progress for {stall_s:.1f}s "
                    f"(watchdog_s={self._watchdog_s}); aborting "
                    f"in-flight requests", stall_s=round(stall_s, 2),
                    active=len(self._active),
                    waiting=self._waiting.qsize())
        err = EngineWedgedError(
            f"engine wedged: no forward progress for {stall_s:.1f}s "
            f"(> RAY_TPU_ENGINE_WATCHDOG_S={self._watchdog_s}); "
            "request aborted for failover")
        # lock-free: the loop may have wedged while holding the lock; a
        # snapshot of the dict's values is safe to iterate
        for req in list(self._requests.values()):
            req.aborted = True
            # an error, not _END, so consumers raise; a full queue must
            # not swallow it
            _put_dropping_one(req.out_queue, ("error", err))

    def _chaos_stall(self, seconds: float) -> None:
        """Park the engine loop thread for `seconds` through the control
        queue (fault injection for tests): the watchdog then sees the
        stall as it would a hung device call. Returns at once."""
        self._control_q.put((lambda: time.sleep(seconds), Future()))

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
        req.t_admit = time.perf_counter()
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
        req.t_admit = time.perf_counter()
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
        with annotate("llm.admit"):
            groups = self._admit_waiting()
        cap = max(1, self.cfg.max_prefill_batch)
        for pad_len, members in groups.items():
            for i in range(0, len(members), cap):
                with annotate("llm.prefill"):
                    self._dispatch_prefill(inflight, pad_len,
                                           members[i:i + cap])

    def _admit_waiting(self) -> Dict[int, List[tuple]]:
        """Take a slot (and pages) for each waiting request while slots
        last; returns the bucketed ones grouped by bucket, {pad_len:
        [(req, slot), ...]}, and queues the chunked ones."""
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
            if (req.deadline_ts is not None
                    and time.time() >= req.deadline_ts):
                # expired while queued: shed instead of spending prefill
                # and decode on an answer nobody waits for
                self._shed_expired(req)
                continue
            self._note_progress()   # watchdog: admission
            if self._paged:
                outcome = self._admit_paged(req)
                if outcome == "nopages":
                    # hold the head request (FIFO) until releases refill
                    # the pool
                    self._pending_head = req
                    if not req.preempt_emitted:
                        req.preempt_emitted = True
                        self._event("llm_engine.request_preempt",
                                    "KV page pool exhausted; holding "
                                    "at admission", req=req)
                    break
                if outcome == "failed":
                    continue
            elif not self._admit_contiguous(req):
                continue
            self._event("llm_engine.request_admit", req=req, slot=req.slot,
                        prompt_len=int(req.prompt.size))
            if req.prefix_id >= 0 or self._use_chunked(req.prompt.size):
                self._prefilling.append(req)
            else:
                taken.append((self._bucket(req.prompt.size), req, req.slot))
        groups: Dict[int, List[tuple]] = {}
        for pad_len, req, slot in taken:
            groups.setdefault(pad_len, []).append((req, slot))
        return groups

    def _dispatch_prefill(self, inflight, pad_len: int, members) -> None:
        """One prefill call for members = [(req, slot), ...] of a shared
        bucket; the group size pads to a power of two on the scratch
        slot (a contiguous cache without batching prefills one prompt in
        place)."""
        g_real = len(members)
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
        reqs = [r for r, _ in members]
        try:
            toks, lps = self._prefill(
                self._to_dev(tokens), self._to_dev(slots),
                self._to_dev(lens), self._to_dev(temps),
                self._to_dev(top_ps), pad_len,
                any_temp=bool((temps > 0).any()),
                any_top_p=bool((top_ps < 1.0).any()),
                single_slot=int(slots[0]) if single else None,
                allow=self._guided_prefill_allow(reqs, g),
                bias=self._pen_prefill_bias(reqs, g))
            toks = toks[:g_real]
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
        t_end = time.perf_counter()
        if capturing():
            n = [int(r.prompt.size) for r in reqs]
            count("llm.prefill_tokens", sum(n))
            count("llm.prefill_pairs", sum(x * (x + 1) // 2 for x in n))
        self.stats["prefills"] += g_real
        for req, slot in members:
            req.t_prefill_end = t_end
            self._disp_len[slot] = req.prompt.size
            self._active[slot] = req
        self._mask_dirty = True
        self._pen_coef_dirty = True
        inflight.append(("prefill_batch", reqs, _Fetch(
            toks, *(() if lps is None else (lps[:g_real],)))))

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
        try:
            kw = {}
            if is_last and req.fsm is not None:
                kw["allow"] = self._guided_prefill_allow([req], 1)
            if is_last and req.logit_bias:
                kw["bias"] = self._pen_prefill_bias([req], 1)
            sampled = self._prefill_chunk(
                self._to_dev(req.prompt[None, start:start + n]), req.slot,
                start, req.temperature, req.top_p, sample=is_last, **kw)
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
        # a chunk's queries attend to the prefix before it and causally
        # among themselves
        count("llm.prefill_tokens", n)
        count("llm.prefill_pairs", n * start + n * (n + 1) // 2)
        self._note_progress()   # watchdog: a chunk advanced
        if is_last:
            req.t_prefill_end = time.perf_counter()
            tok, lp = sampled
            self._prefilling.popleft()
            self.stats["prefills"] += 1
            self._last_tokens[req.slot:req.slot + 1] = tok
            self._active[req.slot] = req
            self._mask_dirty = True
            self._pen_coef_dirty = True
            inflight.append(("prefill_batch", [req], _Fetch(
                tok, *(() if lp is None else (lp,)))))

    def _emit(self, req: _Request, tok: int,
              logp: Optional[float] = None) -> None:
        req.generated += 1
        self.stats["tokens_generated"] += 1
        self._note_progress()   # watchdog: forward progress
        self._tokens_unpublished += 1
        if req.t_first is None:
            req.t_first = now = time.perf_counter()
            with self._lock:
                self._timings.append({
                    "request_id": req.request_id, "submit": req.t_submit,
                    "admit": req.t_admit, "prefill_end": req.t_prefill_end,
                    "first_token": now})
            self._m["ttft"].observe(now - req.t_submit, tags=self._mtags)
        if req.hist is not None:
            req.hist.append(tok)
        # Bounded-wait put: a full out_queue means the consumer is slow
        # or gone, not that the engine is wedged, so the watchdog clock
        # is refreshed while parked; one silent past
        # _CONSUMER_STALL_TTL_S gets its request aborted so a dead reader
        # cannot stall the shared loop forever.
        parked_since = None
        while True:
            try:
                req.out_queue.put(("token", (tok, logp)), timeout=1.0)
                break
            except queue_mod.Full:
                if req.aborted:
                    break
                now = time.time()
                if parked_since is None:
                    parked_since = now
                    # flag the stall while it is live
                    self._event("sched.hang.suspected",
                                "request output queue full; consumer "
                                "stalled (TTL abort after "
                                f"{self._CONSUMER_STALL_TTL_S:.0f}s)",
                                req=req, kind="consumer_stalled")
                elif now - parked_since > self._CONSUMER_STALL_TTL_S:
                    req.aborted = True
                    req.max_new_tokens = min(req.max_new_tokens,
                                             req.generated)
                    self._event("llm_engine.request_abort", req=req,
                                generated=req.generated,
                                reason="consumer_stalled")
                    self._event("sched.hang.resolved",
                                f"consumer stalled "
                                f"{now - parked_since:.0f}s; request "
                                "aborted by the consumer-stall TTL",
                                req=req, kind="consumer_stalled",
                                stalled_s=round(now - parked_since, 1))
                    break
                self._note_progress()
        if ((self.cfg.eos_token_id is not None
             and tok == self.cfg.eos_token_id) or tok in req.stop_ids):
            req.max_new_tokens = req.generated  # finish after EOS/stop
        if req.fsm is not None:
            # guided: advance the automaton; a dead state (impossible
            # under the mask) or a completed match ends the request
            req.fsm_state = req.fsm.advance(req.fsm_state, tok)
            if req.fsm_state < 0 or req.fsm.is_complete(req.fsm_state):
                req.max_new_tokens = min(req.max_new_tokens, req.generated)

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
                self._pen_coef_dirty = True
                req.slot = -1
            if req.t_first is not None and req.generated > 1:
                tpot = ((time.perf_counter() - req.t_first)
                        / (req.generated - 1))
                self._tpot_samples.append(tpot)
                try:
                    self._m["tpot"].observe(tpot, tags=self._mtags)
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
        finally:
            self._publish_tokens()
            self._event("llm_engine.request_finish", req=req,
                        generated=req.generated, aborted=req.aborted)
            _put_dropping_one(req.out_queue, _END)

    def _publish_tokens(self) -> None:
        """Add the tokens emitted since the last call to the registry's
        token counter: once a loop step and before a request's end
        marker, not once a token."""
        n, self._tokens_unpublished = self._tokens_unpublished, 0
        if n:
            self._m["tokens"].inc(float(n), tags=self._mtags)

    def _shed_expired(self, req: _Request) -> None:
        """A queued request whose deadline passed: error its stream
        without taking a slot (load shedding)."""
        self._event("serve.request.shed", req=req,
                    reason="deadline_expired",
                    late_s=round(time.time() - req.deadline_ts, 3))
        events_mod.emit_safe(
            counter="ray_tpu_serve_requests_shed_total",
            counter_tags={"reason": "deadline_expired"})
        req.out_queue.put(("error", DeadlineExceededError(
            f"deadline expired {time.time() - req.deadline_ts:.3f}s "
            f"before engine admission of {req.request_id}")))

    def _decode_window_pages(self, new_tokens: int) -> int:
        """Power-of-2 page window covering every slot that holds KV
        (decoding and chunk-prefilling: a narrower window would let the
        clamped write index of `PagedKV.flat_rows` land a write on a
        live page of the slot instead of the trash page) plus the
        `new_tokens` this dispatch writes (decode_block, or 1 + K for a
        verify step); 0 = the full table."""
        ps = self.cfg.kv_page_size
        need = max(self._disp_len.values(), default=0) + new_tokens
        w = _next_pow2(-(-need // ps))
        return 0 if w >= self._pages_per_slot else w

    def _graph_widths(self) -> List[int]:
        """Every page-table width a one-token decode step can take: each
        window `_decode_window_pages` gives (the powers of two below the
        table's width) and the full table."""
        widths, w = [], 1
        while w < self._pages_per_slot:
            widths.append(w)
            w *= 2
        return widths + [self._pages_per_slot]

    def _step_graphs(self, allow, pen):
        """The decode graphs a plain decode step's forward replays, or
        None: guided and penalised steps (and verify steps, which never
        ask) run eagerly, as does every step of an engine without graphs
        (`self._graphs`: the paged cache on CUDA, a model that takes
        them). The first call captures every width (`_graph_widths`) at
        once, so no capture waits for traffic to reach a new window; a
        capture that fails leaves the engine eager, and
        `get_stats()["decode_graphs"]` says why."""
        if self._graphs is None or allow is not None or pen is not None:
            return None
        if not self._graphs.captured:
            try:
                self._graphs.capture(
                    self.model, self._pools, self.cfg.kv_page_size,
                    self._n_slots, self._graph_widths(), self._trash_page)
            except Exception as e:  # noqa: BLE001  serving goes on eagerly
                traceback.print_exc()
                self._graph_error = f"{type(e).__name__}: {e}"
                self._graphs.clear()
                self._graphs = None
                return None
        return self._graphs

    # ---- n-gram speculation (host side) -----------------------------------
    def _propose_ngram(self, req: _Request) -> Optional[List[int]]:
        """Prompt lookup: the K tokens that followed the latest earlier
        occurrence of the trailing `ngram_order`-gram in the request's
        own history. None = no match (plain decode)."""
        k = self.cfg.ngram_speculation
        g = max(1, self.cfg.ngram_order)
        h = req.hist
        if h is None or len(h) < g + 1:
            return None
        key = h[-g:]
        lo = max(0, len(h) - g - 1 - max(g + 1, self.cfg.ngram_lookback))
        for i in range(len(h) - g - 1, lo - 1, -1):
            if h[i:i + g] == key:
                return h[i + g:i + g + k] or None
        return None

    def _spec_plan(self) -> Optional[torch.Tensor]:
        """Proposals (S, K) int32 on the device for one verify step, or
        None when no active slot proposes anything or any active slot is
        within K + 1 of max_seq_len (the verify step writes K + 1
        positions)."""
        k = self.cfg.ngram_speculation
        if not k:
            return None
        eligible = [(slot, r) for slot, r in self._active.items()
                    if r.hist is not None]
        if not eligible:
            return None
        for r in self._active.values():
            if r.prompt.size + r.generated + k + 1 > self.cfg.max_seq_len:
                return None  # one slot near the end vetoes the step
        props = np.full((self._n_slots, k), -1, np.int32)
        any_prop = False
        for slot, r in eligible:
            p = self._propose_ngram(r)
            if p:
                props[slot, :len(p)] = p
                any_prop = True
        if not any_prop:
            self._spec_idle += 1
            return None
        self._spec_idle = 0
        return self._to_dev(props)

    def _spec_sync_active(self) -> bool:
        """True when speculation wants synchronous stepping (an eligible
        request is active): proposals come from tokens the host has
        seen. After 8 steps in a row without a proposal it backs off to
        pipelined plain decode, and re-probes every 64 calls."""
        if not self.cfg.ngram_speculation or not any(
                r.hist is not None for r in self._active.values()):
            return False
        self._spec_retry = (self._spec_retry + 1) % 64
        if self._spec_retry == 0:
            self._spec_idle = 0
        return self._spec_idle < 8

    # ---- guided masks and penalties (host side) ---------------------------
    def _guided_prefill_allow(self, reqs, g: int):
        """(g, V) bool mask rows on the device for a prefill group
        (padding rows all True); None when no member is guided."""
        fsms = [r.fsm for r in reqs if r.fsm is not None]
        if not fsms:
            return None
        allow = np.ones((g, fsms[0].vocab_size), dtype=bool)
        for i, r in enumerate(reqs):
            if r.fsm is not None:
                allow[i] = r.fsm.allowed(r.fsm_state)
        return self._to_dev(allow)

    def _guided_decode_allow(self):
        """(slots, V) bool mask on the device for one decode step; None
        when no active request is guided. The host buffer is kept across
        steps and a slot's row is rewritten only when its (request_id,
        fsm_state) moved; `_to_dev` uploads it from a fresh pinned copy,
        so the buffer may be rewritten while that copy is in flight."""
        guided = {slot: r for slot, r in self._active.items()
                  if r.fsm is not None}
        if not guided:
            self._guided_prev = None
            return None
        V = next(iter(guided.values())).fsm.vocab_size
        buf = self._guided_allow_buf
        prev = self._guided_prev
        if buf is None or buf.shape != (self._n_slots, V) or prev is None:
            buf = self._guided_allow_buf = np.ones((self._n_slots, V),
                                                   dtype=bool)
            prev = {}
        for slot in [sl for sl in prev if sl not in guided]:
            buf[slot] = True
            del prev[slot]
        for slot, r in guided.items():
            # keyed on the request id: a freed request's id() can be
            # reused by a new one, which would inherit a stale row
            key = (r.request_id, r.fsm_state)
            if prev.get(slot) != key:
                buf[slot] = r.fsm.allowed(r.fsm_state)
                prev[slot] = key
        self._guided_prev = prev
        return self._to_dev(buf)

    @staticmethod
    def _bias_row(r: _Request, V: int) -> np.ndarray:
        row = np.zeros((V,), np.float32)
        for tid, b in (r.logit_bias or {}).items():
            tid = int(tid)
            if 0 <= tid < V:
                row[tid] = float(b)
        return row

    @staticmethod
    def _req_has_pen(r: _Request) -> bool:
        return bool(r.presence_penalty or r.frequency_penalty
                    or r.logit_bias)

    def _pen_active(self) -> bool:
        return any(self._req_has_pen(r) for r in self._active.values())

    def _pen_args(self):
        """(counts, static_bias, presence, frequency) on the device for
        one decode step, or None when no active request is penalised.
        Seeds a slot's count and static rows once per request that owns
        it, so nothing leaks across slot reuse; the coefficients are
        uploaded again only when the active set changed."""
        if not self._pen_active():
            return None
        V = int(self.model.cfg.vocab_size)
        S = self._n_slots
        if self._pen_counts is None:
            self._pen_counts = torch.zeros((S, V), dtype=torch.int32,
                                           device=self.device)
            self._pen_static = torch.zeros((S, V), dtype=torch.float32,
                                           device=self.device)
        for slot, r in self._active.items():
            if self._pen_seeded.get(slot) == r.request_id:
                continue
            self._pen_seeded[slot] = r.request_id
            self._pen_counts[slot].zero_()
            self._pen_static[slot] = self._to_dev(self._bias_row(r, V))
        for slot in [sl for sl in self._pen_seeded if sl not in self._active]:
            del self._pen_seeded[slot]
        if self._pen_coef_dirty or self._pen_coef is None:
            pres = np.zeros((S,), np.float32)
            freq = np.zeros((S,), np.float32)
            for slot, r in self._active.items():
                pres[slot] = r.presence_penalty
                freq[slot] = r.frequency_penalty
            self._pen_coef = (self._to_dev(pres), self._to_dev(freq))
            self._pen_coef_dirty = False
        return (self._pen_counts, self._pen_static) + self._pen_coef

    def _pen_prefill_bias(self, reqs, g: int):
        """(g, V) static logit_bias rows on the device for a prefill
        group's first tokens (presence and frequency have nothing to
        count yet); None when no member has a logit_bias."""
        if not any(r.logit_bias for r in reqs):
            return None
        V = int(self.model.cfg.vocab_size)
        bias = np.zeros((g, V), np.float32)
        for i, r in enumerate(reqs):
            bias[i] = self._bias_row(r, V)
        return self._to_dev(bias)

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

    # ---- draining ---------------------------------------------------------
    def _finished(self, req: _Request) -> bool:
        return (req.generated >= req.max_new_tokens
                or req.prompt.size + req.generated >= self.cfg.max_seq_len)

    def _drain_one(self, inflight) -> None:
        """Read the oldest in-flight result and emit its tokens in step
        order. Termination checks happen here, `pipeline_depth`
        dispatches behind; lagged tokens of finished or reused slots are
        discarded by the (req.slot == slot, generated < budget) guards."""
        kind, payload, fetch = inflight.popleft()
        try:
            parts = fetch.result()
        except Exception as e:  # noqa: BLE001  device-side failure
            targets = (list(payload) if kind == "prefill_batch"
                       else [r for _, r in payload])
            for req in targets:
                if req.slot >= 0:
                    req.out_queue.put(("error", e))
                    self._release(req)
            return
        with annotate("llm.emit"):
            self._emit_result(kind, payload, parts)

    def _emit_result(self, kind: str, payload, parts) -> None:
        """Emit one in-flight result's tokens in step order and release
        the requests that finished."""
        if kind == "verify":
            self._drain_verify(payload, *parts)
            return
        host = parts[0]
        lps = parts[1] if len(parts) > 1 else None
        if kind == "prefill_batch":
            for i, req in enumerate(payload):
                if req.slot < 0:
                    continue
                if req.aborted and req.generated == 0:
                    # aborted while its prefill was in flight
                    self._release(req)
                    continue
                self._emit(req, int(host[i]),
                           None if lps is None else float(lps[i]))
                if self._finished(req):
                    self._release(req)
            return
        rows = host if host.ndim == 2 else host[None, :]   # (block, S)
        lp_rows = None
        if lps is not None:
            lp_rows = lps if lps.ndim == 2 else lps[None, :]
        self.stats["decode_steps"] += rows.shape[0]
        for ri, row in enumerate(rows):
            for slot, req in payload:
                if req.slot != slot:
                    continue  # released/reused slot: lagged, discard
                if req.generated >= req.max_new_tokens:
                    # budget shrank out of band (abort())
                    self._release(req)
                    continue
                self._emit(req, int(row[slot]),
                           None if lp_rows is None
                           else float(lp_rows[ri][slot]))
                if self._finished(req):
                    self._release(req)

    def _drain_verify(self, snapshot, out, n_emit, lps=None) -> None:
        """Emit a verify step's 1 .. K+1 tokens per slot. Emission may
        stop early (EOS, stop ids, budget): the request is released at
        once, so the device length running ahead does not matter."""
        self.stats["decode_steps"] += 1
        for slot, req in snapshot:
            if req.slot != slot:
                continue  # released/reused slot
            if req.generated >= req.max_new_tokens:
                self._release(req)
                continue
            emitted = 0
            for j in range(int(n_emit[slot])):
                if req.generated >= req.max_new_tokens:
                    break
                self._emit(req, int(out[slot, j]),
                           None if lps is None else float(lps[slot, j]))
                emitted += 1
            self.stats["spec_accepted"] += max(0, emitted - 1)
            if req.slot == slot and slot in self._disp_len:
                # the dispatch bumped the window mirror by K + 1
                self._disp_len[slot] = req.prompt.size + req.generated
            if self._finished(req):
                self._release(req)

    # ---- engine loop ------------------------------------------------------
    def _engine_loop(self) -> None:
        with torch.no_grad():
            inflight: collections.deque = collections.deque()
            while not self._shutdown.is_set():
                try:
                    # commands run between steps, so a capture that one
                    # starts or stops holds whole steps
                    self._run_commands()
                    with annotate("llm.step"):
                        self._step(inflight)
                except Exception as e:  # noqa: BLE001  loop must survive
                    traceback.print_exc()
                    self._in_dispatch = False
                    for req in list(self._active.values()):
                        req.out_queue.put(("error", e))
                        self._release(req)
                    inflight.clear()

    def _run_commands(self) -> None:
        """Run queued cache mutations (prefix registration) between
        dispatches. A command is engine work for the watchdog: a first
        prefix prefill may build kernels, so it gets the dispatch
        grace."""
        while True:
            try:
                fn, done = self._control_q.get_nowait()
            except queue_mod.Empty:
                return
            self._in_dispatch = True
            try:
                fn()
                done.set_result(None)
            except Exception as e:  # noqa: BLE001  raised in the caller
                done.set_exception(e)
            finally:
                self._in_dispatch = False

    def _step(self, inflight) -> None:
        self._in_dispatch = True   # watchdog: first-use grace
        self._admit_all(inflight)
        if self._prefilling:
            with annotate("llm.chunk"):
                self._dispatch_chunk(inflight)
        # guided masks and n-gram proposals depend on the tokens of the
        # step before: such traffic waits for the drain below
        need_sync = False
        if self._active:
            with annotate("llm.decode"):
                allow = self._guided_decode_allow()
                pen = self._pen_args()
                # the verify step threads no penalties: speculation (and
                # its synchronous stepping) is off while a penalised
                # request is active
                spec_sync = pen is None and self._spec_sync_active()
                need_sync = allow is not None or spec_sync
                if not need_sync or not inflight:
                    self._dispatch_decode(inflight, allow, pen, spec_sync)
        with annotate("llm.publish"):
            self._publish_gauges()
        if not inflight:
            self._in_dispatch = False
            time.sleep(0.002)
            return
        # stay `pipeline_depth` dispatches ahead while decoding; drain
        # fully once nothing is active, or when the next step needs this
        # one's tokens
        target = self.cfg.pipeline_depth if self._active else 0
        if need_sync:
            target = 0
        while len(inflight) > target:
            with annotate("llm.drain"):
                self._drain_one(inflight)
        self._in_dispatch = False

    def _publish_gauges(self) -> None:
        """The token counter and the loop's gauges, once a step."""
        m = self._m = _engine_metrics()
        self._publish_tokens()
        m["active"].set(float(len(self._active)), tags=self._mtags)
        m["waiting"].set(float(self._waiting.qsize()), tags=self._mtags)
        m["occupancy"].set(len(self._active) / max(1, self.cfg.max_slots),
                           tags=self._mtags)
        if self._paged:
            m["kv_util"].set((self._n_pages - len(self._free_pages))
                             / max(1, self._n_pages), tags=self._mtags)

    def _dispatch_decode(self, inflight, allow, pen, spec_sync: bool) -> None:
        """Dispatch the next step for every active slot: a verify step when
        speculation has proposals; decode_block one-token steps when no
        mask and no penalty is active; else one step under them."""
        mask, temps, top_ps, any_temp, any_top_p = self._device_mask_temps()
        snapshot = list(self._active.items())
        props = self._spec_plan() if spec_sync and allow is None else None
        if props is not None:
            k = self.cfg.ngram_speculation
            window = self._decode_window_pages(k + 1) if self._paged else 0
            out, n_emit, lps = self._verify(props, mask, temps, top_ps,
                                            window, any_temp, any_top_p)
            for slot in self._active:
                self._disp_len[slot] += k + 1
            self.stats["spec_steps"] += 1
            inflight.append(("verify", snapshot, _Fetch(
                out, n_emit, *(() if lps is None else (lps,)))))
            return
        block = (max(1, self.cfg.decode_block)
                 if allow is None and pen is None else 1)
        window = (self._decode_window_pages(max(1, self.cfg.decode_block))
                  if self._paged else 0)
        graphs = self._step_graphs(allow, pen)
        steps, step_lps = [], []
        for _ in range(block):
            toks, lps, self._lengths = self._decode(
                mask, temps, top_ps, window, any_temp, any_top_p,
                allow=allow, pen=pen, graphs=graphs)
            self._last_tokens = toks
            steps.append(toks)
            step_lps.append(lps)
        for slot in self._active:
            self._disp_len[slot] += block
        if capturing():
            # K3 reads, per layer, each active slot's keys up to its
            # length after each of the block's steps
            count("llm.decode_tokens", block * len(self._active))
            count("llm.decode_keys", sum(
                block * self._disp_len[slot] - block * (block - 1) // 2
                for slot in self._active))
        out = steps[0] if block == 1 else torch.stack(steps)
        parts = [out]
        if self.cfg.logprobs:
            parts.append(step_lps[0] if block == 1 else torch.stack(step_lps))
        inflight.append(("decode", snapshot, _Fetch(*parts)))
