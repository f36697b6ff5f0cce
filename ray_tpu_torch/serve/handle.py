"""DeploymentHandle: the client-side request path (counterpart of
ray_tpu/serve/handle.py).

Reference parity: python/ray/serve/handle.py (DeploymentHandle,
DeploymentResponse) + _private/replica_scheduler/pow_2_scheduler.py.
Routing is client-side power-of-two-choices over in-flight counts the
handle tracks locally, with the replica set refreshed from the controller.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

from ..exceptions import (ActorDiedError, ActorUnavailableError,
                          EngineWedgedError, NoCapacityError, RayTpuError,
                          ReplicaDrainingError, StreamInterruptedError,
                          TaskError, error_cause_is)
from .router import (AffinityRouter, extract_affinity_key,
                     pick_least_loaded)

_REPLICA_REFRESH_S = 1.0
# a replica that just failed a request is skipped by routing for this
# long (the controller usually replaces it well within the window)
_SUSPECT_TTL_S = 10.0

# Replica-side raises cross the actor boundary wrapped in TaskError
# (repr string, original type lost) — match retriable causes by name.
_RETRIABLE_CAUSE_NAMES = ("EngineWedgedError", "ReplicaDrainingError",
                          "ActorDiedError", "ActorUnavailableError")


def _retriable_failure(exc: BaseException) -> bool:
    """True when resubmitting to a DIFFERENT replica can succeed: the
    serving replica died, its engine wedged, or it started draining."""
    if isinstance(exc, (ActorDiedError, ActorUnavailableError,
                        EngineWedgedError, ReplicaDrainingError)):
        return True
    return isinstance(exc, TaskError) and error_cause_is(
        exc, *_RETRIABLE_CAUSE_NAMES)


def _note_failover(kind: str, deployment: str, replica_id: str,
                   exc: BaseException) -> None:
    """serve.request.failover event + counter; never fails the retry."""
    from ..util import events as events_mod
    events_mod.emit_safe("serve.request.failover",
                         f"resubmitting after {type(exc).__name__} "
                         f"on {replica_id}",
                         counter="ray_tpu_serve_failovers_total",
                         counter_tags={"kind": kind},
                         deployment=deployment, replica_id=replica_id,
                         cause=repr(exc)[:200], kind=kind)


class BackPressureError(RayTpuError):
    """Raised when max_queued_requests would be exceeded."""


class DeploymentResponse:
    """Future for one request. `.result()` blocks; awaitable in async code;
    passable to another `.remote()` call (resolves to the ObjectRef).

    If the serving replica died (e.g. killed during a rolling update), the
    request is transparently re-routed to a live replica, up to
    `max_retries` times (reference: serve retries replica-death failures
    at the router).
    """

    def __init__(self, ref, on_done=None, resubmit=None, max_retries=3):
        self._ref = ref
        self._on_done = on_done
        self._resubmit = resubmit
        self._max_retries = max_retries
        self._done = False

    def _settle(self):
        if not self._done:
            self._done = True
            if self._on_done is not None:
                self._on_done()

    def result(self, timeout_s: Optional[float] = None) -> Any:
        import ray_tpu_torch
        deadline = (None if timeout_s is None
                    else time.time() + timeout_s)
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        except Exception as e:  # noqa: BLE001  typed check below
            if (self._resubmit is None or self._max_retries <= 0
                    or not _retriable_failure(e)):
                raise
            # retries share the ORIGINAL wait budget — restarting
            # timeout_s per attempt would stretch the caller's bound
            # to retries x budget. The deadline also rides into the
            # resubmit so the retry's replica-pick wait is bounded too.
            retry = self._resubmit(e, deadline_override=deadline)
            retry._max_retries = self._max_retries - 1
            self._ref = retry._ref
            return retry.result(timeout_s=(
                None if deadline is None
                else max(0.1, deadline - time.time())))
        finally:
            self._settle()

    # Bound on the SYNCHRONOUS replica-pick wait a failover retry may
    # spend inside __await__: the pick loop's sleeps run on the event
    # loop thread (this runtime's handle is poll-based), so an open-
    # ended 30s wait would freeze every other coroutine and defeat
    # asyncio.wait_for. Requests that carry a propagated deadline are
    # bounded by it instead.
    _AWAIT_RETRY_PICK_BUDGET_S = 5.0

    def __await__(self):
        # same failover contract as result(): async callers get the
        # transparent re-route too
        while True:
            try:
                v = yield from self._ref.__await__()
                self._settle()
                return v
            except Exception as e:  # noqa: PERF203  typed check below
                if (self._resubmit is None or self._max_retries <= 0
                        or not _retriable_failure(e)):
                    self._settle()
                    raise
                retry = self._resubmit(
                    e, deadline_override=(
                        time.time() + self._AWAIT_RETRY_PICK_BUDGET_S))
                self._max_retries -= 1
                self._ref = retry._ref
                # adopt the retry's resubmit closure (it captured the
                # NEW replica id) — keeping ours would suspect the
                # ORIGINAL replica again on a second failover, same as
                # the stream-adoption fix
                self._resubmit = retry._resubmit

    @property
    def object_ref(self):
        return self._ref

    def _to_object_ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response: iterate to pull chunks from the replica.

    Failover contract: if the serving replica dies/wedges/drains BEFORE
    this consumer has received any chunk, the stream is transparently
    resubmitted to a healthy replica (up to `max_retries` times). Once
    a chunk has been received, resubmission would replay delivered
    tokens, so the failure surfaces as the typed, retriable
    StreamInterruptedError instead.
    """

    def __init__(self, replica_handle, stream_id_ref, on_done=None,
                 resubmit=None, max_retries=3):
        self._replica = replica_handle
        self._stream_id_ref = stream_id_ref
        self._stream_id = None
        self._buffer: List[Any] = []
        self._finished = False
        self._on_done = on_done
        self._resubmit = resubmit
        self._max_retries = max_retries
        self._got_first = False   # any chunk received from the replica

    def __iter__(self):
        return self

    def _pull(self):
        import ray_tpu_torch
        if self._stream_id is None:
            self._stream_id = ray_tpu_torch.get(self._stream_id_ref)
        while not self._buffer:
            chunks, done = ray_tpu_torch.get(
                self._replica.stream_next.remote(self._stream_id))
            self._buffer.extend(chunks)
            if chunks:
                self._got_first = True
            if done:
                self._finished = True
                if self._on_done is not None:
                    self._on_done()
                break

    def __next__(self):
        if self._buffer:
            return self._buffer.pop(0)
        if self._finished:
            raise StopIteration
        try:
            self._pull()
        except Exception as e:  # noqa: BLE001  typed check below
            if (self._resubmit is None or self._max_retries <= 0
                    or not _retriable_failure(e)):
                raise
            if self._got_first:
                # post-first-token: surface a typed retriable error —
                # the caller decides whether replaying is acceptable
                self._finished = True
                if self._on_done is not None:
                    self._on_done()
                raise StreamInterruptedError(
                    f"stream lost its replica after first token: "
                    f"{e!r}", cause_repr=repr(e)) from e
            fresh = self._resubmit(e)
            # release the dead replica's in-flight count, then adopt
            # the fresh generator's replica/stream/accounting wholesale
            # — INCLUDING its resubmit closure, which captured the NEW
            # replica id (keeping ours would suspect the original
            # replica again on a second failover and leave the one
            # that just died routable)
            if self._on_done is not None:
                self._on_done()
            self._replica = fresh._replica
            self._stream_id_ref = fresh._stream_id_ref
            self._stream_id = None
            self._on_done = fresh._on_done
            self._resubmit = fresh._resubmit
            self._max_retries -= 1
            return next(self)
        if self._buffer:
            return self._buffer.pop(0)
        raise StopIteration

    def close(self):
        """Abandoned stream (client cancelled before draining): release
        the router's manual in-flight count AND cancel the replica-side
        drain task — otherwise the replica keeps pumping until its
        bounded buffer fills, parks forever, and its _ongoing count
        stays elevated (hanging graceful shutdown). Idempotent; a
        fully-drained stream already fired on_done."""
        if self._finished:
            return
        self._finished = True
        try:
            import ray_tpu_torch
            if self._stream_id is None:
                self._stream_id = ray_tpu_torch.get(self._stream_id_ref)
            self._replica.stream_cancel.remote(self._stream_id)
        except Exception:  # noqa: BLE001  replica already gone
            pass
        if self._on_done is not None:
            self._on_done()

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return next(self)
        except StopIteration:
            raise StopAsyncIteration from None


class _RouterState:
    """Shared per-(app, deployment) routing state.

    In-flight accounting is by pending ObjectRef: a request stops counting
    against its replica the moment the replica finishes it (pruned via
    wait(timeout=0)), NOT when the caller reads the result — so issuing
    many .remote() calls before consuming any cannot deadlock routing.
    Streams (no single completion ref) use a manual count released when
    the generator finishes.
    """

    def __init__(self, deployment: str = "", app: str = "default"):
        self.replicas: List[tuple] = []  # (replica_id, actor_handle)
        self.pending: Dict[str, list] = {}   # replica_id -> [ObjectRef]
        self.manual: Dict[str, int] = {}     # replica_id -> stream count
        self.suspects: Dict[str, float] = {}  # replica_id -> marked ts
        self.last_refresh = 0.0
        self.lock = threading.Lock()
        self.max_ongoing = 5
        self.max_queued = -1
        self.queued = 0
        # scale-out router state (serve/router.py): sticky
        # session/prefix bindings + the deployment's registered
        # prefixes (refreshed from the controller with the replica set)
        self.affinity = AffinityRouter(deployment, app)
        self.registered_prefixes: List[dict] = []
        self.last_prune = 0.0

    def mark_suspect(self, replica_id: str) -> None:
        """A request just failed on this replica (death/wedge/drain):
        skip it in routing for _SUSPECT_TTL_S and drop its in-flight
        accounting so p2c doesn't keep favoring/avoiding a ghost."""
        with self.lock:
            self.suspects[replica_id] = time.time()
            self.pending.pop(replica_id, None)
            self.manual.pop(replica_id, None)
            # affinity keys bound to the dead replica re-bind (and
            # re-warm) on their next request instead of chasing a ghost
            self.affinity.forget(replica_id)

    def live_candidates(self) -> List[tuple]:
        """Routing candidates minus recently-failed replicas. Caller
        must hold lock. When EVERY replica is suspect the result is
        empty and the pick loop keeps waiting — the controller is
        usually seconds from delivering a replacement, and routing
        straight back to the replica that just failed (the old
        _resubmit bug) only burns the retry budget. Suspicion expires
        after _SUSPECT_TTL_S in case the controller disagrees."""
        if not self.suspects:          # hot path: nothing ever failed
            return self.replicas
        now = time.time()
        for rid in [rid for rid, ts in self.suspects.items()
                    if now - ts > _SUSPECT_TTL_S]:
            del self.suspects[rid]
        return [c for c in self.replicas if c[0] not in self.suspects]

    _PRUNE_INTERVAL_S = 0.02

    def prune(self, force: bool = False):
        """Drop refs whose tasks completed. Caller must NOT hold lock.

        Throttled: the wait(timeout=0) completion scan is a runtime
        round trip, and paying it on EVERY request put ~20% on the
        router's happy path. Between scans the in-flight counts can
        only over-estimate (finished-but-unpruned refs), which at worst
        biases p2c — correctness never depends on them. Saturation
        paths pass force=True so a full replica never looks full a
        moment longer than real."""
        import ray_tpu_torch
        now = time.time()
        # unlocked pre-check: a stale read just delays one scan by an
        # interval; the locked re-check below keeps the scan single
        if not force and now - self.last_prune < self._PRUNE_INTERVAL_S:
            return
        with self.lock:
            if not force and now - self.last_prune < \
                    self._PRUNE_INTERVAL_S:
                return
            self.last_prune = now
            all_refs = [ref for refs in self.pending.values()
                        for ref in refs]
        if not all_refs:
            return
        ready, _ = ray_tpu_torch.wait(all_refs, num_returns=len(all_refs),
                                timeout=0)
        done = {r.id for r in ready}
        with self.lock:
            for rid in self.pending:
                self.pending[rid] = [r for r in self.pending[rid]
                                     if r.id not in done]

    def load(self, replica_id: str) -> int:
        return (len(self.pending.get(replica_id, ()))
                + self.manual.get(replica_id, 0))


class DeploymentHandle:
    """Serializable handle for calling a deployment from anywhere."""

    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = "",
                 deadline_s: Optional[float] = None):
        self._deployment = deployment_name
        self._app = app_name
        self._method = method_name
        self._stream = stream
        self._multiplexed_model_id = multiplexed_model_id
        self._deadline_s = deadline_s
        self._router = _RouterState(deployment_name, app_name)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._deployment, self._app, self._method, self._stream,
                 self._multiplexed_model_id, self._deadline_s))

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                deadline_s: Optional[float] = None,
                ) -> "DeploymentHandle":
        h = DeploymentHandle(
            self._deployment, self._app,
            method_name if method_name is not None else self._method,
            stream if stream is not None else self._stream,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._multiplexed_model_id,
            deadline_s if deadline_s is not None else self._deadline_s)
        h._router = self._router  # share in-flight accounting
        return h

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundMethod(self, name)

    # ---- routing ----------------------------------------------------------
    def _controller(self):
        import ray_tpu_torch
        return ray_tpu_torch.get_actor("_SERVE_CONTROLLER")

    def _refresh_replicas(self, force: bool = False):
        import ray_tpu_torch
        r = self._router
        now = time.time()
        if not force and r.replicas and \
                now - r.last_refresh < _REPLICA_REFRESH_S:
            return
        ctrl = self._controller()
        replicas = ray_tpu_torch.get(
            ctrl.get_replicas.remote(self._app, self._deployment))
        info = ray_tpu_torch.get(
            ctrl.get_deployment_info.remote(self._app, self._deployment))
        with r.lock:
            r.replicas = replicas
            r.last_refresh = now
            if info:
                r.max_ongoing = info["max_ongoing_requests"]
                r.max_queued = info["max_queued_requests"]
                r.registered_prefixes = list(
                    info.get("registered_prefixes") or [])

    def _pick_replica(self, deadline_ts: Optional[float] = None,
                      affinity_key: Optional[str] = None):
        """Least-loaded power-of-two-choices over live (non-suspect)
        replicas that still have request slots (serve/router.py);
        requests carrying an affinity key are sticky-routed first
        (consistent hash with bounded load) and only fall back to p2c
        when every preferred replica is over the load bound. Waits with
        exponential backoff + jitter (not a hot loop) when every
        replica is at max_ongoing_requests. The wait is bounded by the
        request's propagated deadline when one is set, else 30s;
        exhaustion raises the typed NoCapacityError the proxy maps to
        503."""
        r = self._router
        start = time.time()
        budget = (30.0 if deadline_ts is None
                  else max(0.0, deadline_ts - start))
        sleep_s = 0.002
        first_pass = True
        while True:
            self._refresh_replicas(force=not r.replicas)
            # retries after a full pass must see completions instantly
            # (a saturated replica may have just freed a slot)
            r.prune(force=not first_pass)
            first_pass = False
            with r.lock:
                candidates = r.live_candidates()
                total = len(r.replicas)
                if candidates:
                    if affinity_key is not None:
                        chosen = r.affinity.pick(
                            affinity_key, candidates, r.load,
                            r.max_ongoing)
                        if chosen is not None:
                            return chosen
                    chosen = pick_least_loaded(candidates, r.load,
                                               r.max_ongoing)
                    if chosen is not None:
                        return chosen
            if time.time() - start > budget:
                # name the REAL cause: "saturated" vs "all replicas just
                # failed" point an operator at opposite remediations
                if total == 0:
                    why = "no replicas in the routing table"
                elif not candidates:
                    why = (f"all {total} replicas recently failed "
                           "(suspect-listed) and no replacement became "
                           "available in time")
                else:
                    why = (f"every replica at max_ongoing_requests="
                           f"{r.max_ongoing}")
                raise NoCapacityError(
                    f"no capacity on {self._deployment} after "
                    f"{budget:.1f}s: {why}")
            # backoff with jitter: spinning at a fixed 20ms hammered the
            # router lock and the refresh path under saturation
            time.sleep(sleep_s * (0.5 + random.random()))
            sleep_s = min(sleep_s * 2, 0.05)

    def _flush_binding_notes(self) -> None:
        """Deliver queued binding transitions to the controller's
        router table (state API / dashboard surface). Fire-and-forget,
        best-effort, and ALWAYS outside the router lock — resolving the
        controller is a driver round trip from proxy processes."""
        r = self._router
        with r.lock:
            notes = r.affinity.take_notes()
        if not notes:
            return
        try:
            ctrl = self._controller()
            for key, replica_id, outcome in notes:
                ctrl.note_session_binding.remote(
                    self._app, self._deployment, key, replica_id,
                    outcome)
        except Exception:  # noqa: BLE001
            pass

    def remote(self, *args, **kwargs):
        r = self._router
        # absolute deadline: explicit kwarg (proxy-stamped; retries keep
        # the ORIGINAL deadline) or this handle's relative deadline_s
        deadline_ts = kwargs.get("__serve_deadline_ts")
        if deadline_ts is None and self._deadline_s is not None:
            deadline_ts = time.time() + self._deadline_s
            kwargs["__serve_deadline_ts"] = deadline_ts
        # affinity key: explicit kwarg (proxy session header / caller),
        # else a session id or registered-prefix match in a dict body.
        # Popped here — replicas never see the routing hint.
        affinity_key = kwargs.pop("__serve_affinity_key", None)
        if affinity_key is None:
            if not r.replicas:
                # cold handle: fetch the routing table (and with it the
                # registered-prefix list) BEFORE key extraction, so the
                # very first prefix-keyed request routes warm
                try:
                    self._refresh_replicas(force=True)
                except Exception:  # noqa: BLE001  pick loop will retry
                    pass
            affinity_key = extract_affinity_key(
                args, r.registered_prefixes)
        if affinity_key is not None:
            affinity_key = str(affinity_key)
        # the queued counter only backs max_queued_requests enforcement;
        # with the unbounded default (-1) skip both lock rounds
        track_queue = r.max_queued >= 0
        if track_queue:
            with r.lock:
                if r.queued >= r.max_queued:
                    raise BackPressureError(
                        f"{self._deployment}: max_queued_requests "
                        f"({r.max_queued}) exceeded")
                r.queued += 1
        try:
            replica_id, handle = self._pick_replica(deadline_ts,
                                                    affinity_key)
        finally:
            if track_queue:
                with r.lock:
                    r.queued -= 1
        if affinity_key is not None:
            self._flush_binding_notes()
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        if self._multiplexed_model_id:
            kwargs["__serve_multiplexed_model_id"] = \
                self._multiplexed_model_id

        def resubmit(exc, kind, a=args, kw=dict(kwargs),
                     failed=replica_id, deadline_override=None):
            # the fix for routing straight back to the dead replica:
            # suspect-list it AND force the routing table to re-resolve
            # from the controller before the retry picks a target
            r.mark_suspect(failed)
            r.last_refresh = 0.0
            _note_failover(kind, self._deployment, failed, exc)
            if affinity_key is not None:
                # keep the session key on the retry: the failed replica
                # is suspect, so the key re-binds to a live one instead
                # of degrading to keyless routing
                kw = {**kw, "__serve_affinity_key": affinity_key}
            if (deadline_override is not None
                    and "__serve_deadline_ts" not in kw):
                # a deadline-less request retried from result(timeout_s=)
                # inherits the caller's remaining budget, so the retry's
                # replica-pick wait can't exceed the original bound
                kw = {**kw, "__serve_deadline_ts": deadline_override}
            return self.remote(*a, **kw)

        if self._stream:
            with r.lock:
                r.manual[replica_id] = r.manual.get(replica_id, 0) + 1

            def done():
                with r.lock:
                    # decrement only while the key exists: after
                    # mark_suspect popped a dead replica's count, a
                    # late done() must not resurrect a ghost entry
                    if replica_id in r.manual:
                        r.manual[replica_id] = max(
                            0, r.manual[replica_id] - 1)
            sid_ref = handle.stream_start.remote(self._method, args, kwargs)
            return DeploymentResponseGenerator(
                handle, sid_ref, on_done=done,
                resubmit=lambda exc: resubmit(exc, "stream"))
        ref = handle.handle_request.remote(self._method, args, kwargs)
        with r.lock:
            r.pending.setdefault(replica_id, []).append(ref)

        def unary_done(ref=ref, rid=replica_id):
            # consuming the response releases its in-flight count right
            # away — the prune() completion scan (a runtime round trip)
            # is then only a backstop for responses nobody reads
            with r.lock:
                refs = r.pending.get(rid)
                if refs is not None:
                    try:
                        refs.remove(ref)
                    except ValueError:
                        pass    # prune() already dropped it
        return DeploymentResponse(
            ref, on_done=unary_done,
            resubmit=lambda exc, deadline_override=None: resubmit(
                exc, "unary", deadline_override=deadline_override))


class _BoundMethod:
    def __init__(self, handle: DeploymentHandle, method_name: str):
        self._handle = handle
        self._method = method_name

    def remote(self, *args, **kwargs):
        return self._handle.options(method_name=self._method).remote(
            *args, **kwargs)
