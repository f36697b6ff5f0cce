"""Replica actor: hosts one copy of a deployment's callable
(counterpart of ray_tpu/serve/replica.py).

Reference parity: python/ray/serve/_private/replica.py (request handling,
ongoing-request accounting, health checks, reconfigure, streaming) —
re-shaped for this runtime: one actor per replica, async
`handle_request` running on the worker's persistent asyncio loop, and a
poll-based streaming protocol (`stream_next`) instead of gRPC streams.
A replica that reserved a GPU (`ray_actor_options={"num_gpus": 1}`)
runs with CUDA_VISIBLE_DEVICES naming its card; one without runs with
the cards hidden.
"""
from __future__ import annotations

import asyncio
import inspect
import itertools
import queue as queue_mod
import threading
import time
from typing import Any, Dict, Optional

from ..exceptions import DeadlineExceededError, ReplicaDrainingError

_STREAM_END = "__ray_tpu_stream_end__"


class _StreamCancelled(BaseException):
    """Internal: consumer abandoned the stream; stop the drain task.
    BaseException so a handler's own `except Exception` can't eat it."""


class Replica:
    """The actor class the controller instantiates per replica.

    Wraps either a user class (instantiated with init args) or a plain
    function. All requests land on `handle_request`; generators/async
    generators are exposed through `stream_start`/`stream_next` so HTTP
    proxies and handles can pull token-by-token.
    """

    def __init__(self, deployment_name: str, replica_id: str,
                 callable_bytes: bytes, init_args, init_kwargs,
                 user_config: Optional[Dict[str, Any]] = None,
                 max_ongoing_requests: int = 5):
        from .. import core  # noqa: F401  (ensures runtime symbols loaded)
        from ..core import serialization
        self._deployment_name = deployment_name
        self._replica_id = replica_id
        self._max_ongoing = max_ongoing_requests
        self._ongoing = 0
        self._total_served = 0
        self._lock = threading.Lock()
        self._draining = False
        # chaos-injection state (serve/chaos.py): deterministic fault
        # modes for the fault-tolerance tests; all default off
        self._chaos_delay_s = 0.0
        self._chaos_health_mode = ""   # "" | "fail" | "hang" | "wedged"
        self._streams: Dict[str, queue_mod.Queue] = {}
        self._stream_counter = itertools.count()
        # stream ids whose consumer hung up: _drain stops pumping (and
        # the parked _put unblocks) instead of leaking the queue and a
        # permanently-elevated _ongoing count
        self._cancelled_streams: set = set()
        # stream ids whose drain task is still pumping: stream_cancel
        # only flags these — flagging a FINISHED drain would leave the
        # id in _cancelled_streams forever (its finally-discard already
        # ran), an unbounded leak under abandon-after-completion traffic
        self._live_drains: set = set()

        target = serialization.loads_call(callable_bytes)
        if inspect.isclass(target):
            self._callable = target(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = target
            self._is_function = True
        if user_config is not None:
            self.reconfigure(user_config)

    # ---- lifecycle --------------------------------------------------------
    def ready(self) -> str:
        """Readiness probe: returns once __init__ (and any model load in
        the user ctor) has completed."""
        return self._replica_id

    def health_check(self) -> bool:
        if self._chaos_health_mode == "hang":
            time.sleep(3600)           # probe times out controller-side
        if self._chaos_health_mode == "fail":
            raise RuntimeError("chaos: health check failing")
        if self._chaos_health_mode == "wedged":
            from ..exceptions import EngineWedgedError
            raise EngineWedgedError("chaos: wedged")
        user_check = getattr(self._callable, "check_health", None)
        if user_check is not None:
            user_check()
        return True

    def reconfigure(self, user_config: Dict[str, Any]) -> None:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def prepare_for_shutdown(self) -> int:
        """Graceful drain: stop admitting new requests (they raise the
        retriable ReplicaDrainingError and fail over) and report the
        in-flight count so the controller can wait for it to hit zero.
        Counts BOTH running handlers (_ongoing) and streams whose
        consumer is still pulling buffered chunks (_streams keeps the
        id until the consumer reads the end marker or cancels) —
        _ongoing alone drops when the PRODUCER finishes, which would
        let the controller kill us mid-consumer-read. Idempotent; the
        controller re-calls it as its drain poll."""
        with self._lock:
            self._draining = True
            return self._ongoing + len(self._streams)

    def chaos(self, mode: str, seconds: float = 0.0) -> bool:
        """Deterministic fault injection (serve/chaos.py; tests only).
        Modes: "delay" (every request sleeps `seconds` first),
        "health_fail" / "health_hang" / "health_wedged" (health probe
        fails / blocks / raises EngineWedgedError), "wedge" (stall the
        hosted LLM engine's loop for `seconds` — real watchdog path),
        "die" (hard-exit the replica process), "reset" (clear all)."""
        if mode == "delay":
            self._chaos_delay_s = float(seconds)
        elif mode in ("health_fail", "health_hang", "health_wedged"):
            self._chaos_health_mode = mode.split("_", 1)[1]
        elif mode == "wedge":
            engine = getattr(self._callable, "engine", None)
            if engine is None:
                raise ValueError("replica hosts no LLM engine to wedge")
            engine._chaos_stall(float(seconds))
        elif mode == "die":
            import os
            os._exit(1)
        elif mode == "reset":
            self._chaos_delay_s = 0.0
            self._chaos_health_mode = ""
        else:
            raise ValueError(f"unknown chaos mode {mode!r}")
        return True

    def _admit(self, kwargs) -> Optional[float]:
        """Shared admission gate for unary + stream paths: reject while
        draining (retriable — the handle fails over), shed requests
        whose propagated deadline already expired, and apply the chaos
        delay. Returns the request's absolute deadline (or None)."""
        deadline_ts = kwargs.pop("__serve_deadline_ts", None)
        if self._draining:
            raise ReplicaDrainingError(
                f"replica {self._replica_id} is draining")
        if deadline_ts is not None and time.time() >= deadline_ts:
            self._shed("deadline_expired")
            raise DeadlineExceededError(
                f"deadline expired {time.time() - deadline_ts:.3f}s "
                f"before admission on {self._replica_id}")
        if self._chaos_delay_s > 0:
            time.sleep(self._chaos_delay_s)
        return deadline_ts

    def _shed(self, reason: str) -> None:
        from ..util import events as events_mod
        events_mod.emit_safe("serve.request.shed",
                             counter="ray_tpu_serve_requests_shed_total",
                             counter_tags={"reason": reason},
                             replica_id=self._replica_id,
                             deployment=self._deployment_name,
                             reason=reason)

    def shutdown_user_callable(self) -> None:
        fn = getattr(self._callable, "__del__", None)
        del fn  # user __del__ runs when the process exits; nothing to do

    # ---- metrics ----------------------------------------------------------
    def get_metrics(self) -> Dict[str, Any]:
        with self._lock:
            return {"replica_id": self._replica_id,
                    "ongoing": self._ongoing,
                    "total": self._total_served,
                    "max_ongoing": self._max_ongoing}

    def get_queue_len(self) -> int:
        with self._lock:
            return self._ongoing

    def get_autoscale_metrics(self) -> Dict[str, Any]:
        """Live load sample for the controller's autoscaler/scale-down
        victim selection: in-flight handlers + undrained streams, plus
        whatever the hosted callable exposes via an `autoscale_metrics`
        hook (LLMServer reports engine queue depth, TTFT/TPOT, and
        KV-page utilization through it)."""
        with self._lock:
            out: Dict[str, Any] = {"replica_id": self._replica_id,
                                   "ongoing": self._ongoing,
                                   "streams": len(self._streams),
                                   "total": self._total_served,
                                   "ts": time.time()}
        hook = getattr(self._callable, "autoscale_metrics", None)
        if callable(hook):
            try:
                engine = hook()
                if isinstance(engine, dict):
                    out["engine"] = engine
            except Exception:  # noqa: BLE001  telemetry must not fail
                pass
        return out

    # ---- request path -----------------------------------------------------
    def _resolve_method(self, method_name: str):
        if self._is_function:
            if method_name not in ("__call__", None):
                raise AttributeError(
                    f"function deployment has no method {method_name!r}")
            return self._callable
        return getattr(self._callable, method_name or "__call__")

    async def handle_request(self, method_name: str, args, kwargs) -> Any:
        """Unary request. Runs user coroutines on the worker loop; sync
        handlers run in the default executor so they don't block the loop
        (and so max_ongoing_requests > 1 gives real concurrency)."""
        deadline_ts = self._admit(kwargs)
        with self._lock:
            self._ongoing += 1
        try:
            mux_id = kwargs.pop("__serve_multiplexed_model_id", "")
            from .context import _set_request_deadline
            from .multiplex import _set_multiplexed_model_id
            method = self._resolve_method(method_name)
            if inspect.iscoroutinefunction(method):
                if mux_id:
                    _set_multiplexed_model_id(mux_id)
                _set_request_deadline(deadline_ts)
                result = await method(*args, **kwargs)
            else:
                def _call_sync():
                    # contextvar set inside the executor thread: plain
                    # run_in_executor does not propagate context.
                    if mux_id:
                        _set_multiplexed_model_id(mux_id)
                    _set_request_deadline(deadline_ts)
                    return method(*args, **kwargs)
                loop = asyncio.get_running_loop()
                result = await loop.run_in_executor(None, _call_sync)
                if inspect.iscoroutine(result):
                    result = await result
            if inspect.isgenerator(result) or inspect.isasyncgen(result):
                raise TypeError(
                    "handler returned a generator; call it via the "
                    "streaming path (handle.options(stream=True))")
            return result
        finally:
            with self._lock:
                self._ongoing -= 1
                self._total_served += 1

    # ---- streaming path ---------------------------------------------------
    async def stream_start(self, method_name: str, args, kwargs) -> str:
        """Start a streaming call; returns a stream id to poll with
        stream_next(). The generator is drained on a background task and
        chunks buffered, so slow consumers don't stall the handler."""
        deadline_ts = self._admit(kwargs)
        stream_id = f"{self._replica_id}-s{next(self._stream_counter)}"
        q: queue_mod.Queue = queue_mod.Queue(maxsize=1024)
        self._streams[stream_id] = q
        with self._lock:
            self._ongoing += 1
        mux_id = kwargs.pop("__serve_multiplexed_model_id", "")
        from .context import _set_request_deadline
        from .multiplex import _set_multiplexed_model_id
        if mux_id:
            _set_multiplexed_model_id(mux_id)
        _set_request_deadline(deadline_ts)
        method = self._resolve_method(method_name)

        async def _put(item):
            # never block the event loop: the queue is bounded, so park
            # in short async sleeps when a slow consumer falls behind.
            while True:
                if stream_id in self._cancelled_streams:
                    raise _StreamCancelled()
                try:
                    q.put_nowait(item)
                    return
                except queue_mod.Full:
                    await asyncio.sleep(0.01)

        def _next_with_ctx(it):
            # executor threads don't inherit the loop's contextvars; a
            # sync generator reading get_multiplexed_model_id() needs the
            # var set in the thread actually running its frames.
            if mux_id:
                _set_multiplexed_model_id(mux_id)
            _set_request_deadline(deadline_ts)
            return next(it, _STREAM_END)

        async def _drain():
            try:
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                if inspect.isasyncgen(result):
                    async for chunk in result:
                        await _put(("chunk", chunk))
                elif inspect.isgenerator(result):
                    loop = asyncio.get_running_loop()
                    it = iter(result)
                    while True:
                        chunk = await loop.run_in_executor(
                            None, _next_with_ctx, it)
                        if chunk == _STREAM_END:
                            break
                        await _put(("chunk", chunk))
                else:  # unary result streamed as a single chunk
                    await _put(("chunk", result))
                await _put(("end", None))
            except _StreamCancelled:
                pass               # consumer gone: just stop pumping
            except BaseException as e:  # noqa: BLE001
                try:
                    await _put(("error", e))
                except _StreamCancelled:
                    pass
            finally:
                with self._lock:
                    # same lock as stream_cancel's check-then-add: the
                    # cancel path runs on a threadpool thread while this
                    # finally runs on the asyncio loop thread — unlocked
                    # interleaving could add the id AFTER this discard,
                    # leaking it forever
                    self._live_drains.discard(stream_id)
                    self._cancelled_streams.discard(stream_id)
                    self._ongoing -= 1
                    self._total_served += 1

        self._live_drains.add(stream_id)
        asyncio.ensure_future(_drain())
        return stream_id

    def stream_cancel(self, stream_id: str) -> bool:
        """Consumer abandoned the stream (client hung up): stop the
        drain task and drop the buffer. Idempotent; unknown/finished
        ids are a no-op."""
        if stream_id in self._streams:
            with self._lock:
                if stream_id in self._live_drains:
                    # only a still-running drain needs the flag (its
                    # finally-discard cleans it up); a finished drain
                    # would never remove it — leak
                    self._cancelled_streams.add(stream_id)
            self._streams.pop(stream_id, None)
            return True
        return False

    def stream_next(self, stream_id: str, batch: int = 64,
                    timeout_s: float = 30.0):
        """Pull up to `batch` buffered chunks. Returns (chunks, done).
        Raises the handler's exception if the stream errored."""
        q = self._streams.get(stream_id)
        if q is None:
            return [], True
        chunks = []
        done = False
        from ..util import waits as waits_mod  # noqa: PLC0415
        wtok = waits_mod.park("serve-stream", stream_id,
                              pending=q.qsize())
        try:
            try:
                kind, payload = q.get(timeout=timeout_s)
            finally:
                waits_mod.unpark(wtok)
            while True:
                if kind == "chunk":
                    chunks.append(payload)
                elif kind == "end":
                    done = True
                    break
                elif kind == "error":
                    self._streams.pop(stream_id, None)
                    raise payload
                if len(chunks) >= batch:
                    break
                try:
                    kind, payload = q.get_nowait()
                except queue_mod.Empty:
                    break
        except queue_mod.Empty:
            pass
        if done:
            self._streams.pop(stream_id, None)
        return chunks, done
