"""Exception hierarchy of the port (counterpart of ray_tpu/exceptions.py).

Parity: python/ray/exceptions.py in the reference (RayError, RayTaskError,
RayActorError, GetTimeoutError, ObjectLostError, TaskCancelledError).
The class names are the reference's: the runtime and the serve plane
match causes by name across process boundaries. `RayTpuTorchError` is
the root of every error the port raises; `RayTpuError`, the reference's
base of its runtime errors, derives from it.
"""
from __future__ import annotations


class RayTpuTorchError(Exception):
    """Base class of the port's errors."""


class RayTpuError(RayTpuTorchError):
    """Base class of the runtime's errors (the reference's name)."""


class TaskError(RayTpuError):
    """Wraps an exception raised inside a remote task.

    Re-raised at the `get()` call site with the worker-side traceback
    attached, mirroring RayTaskError (reference python/ray/exceptions.py).
    """

    def __init__(self, cause_repr: str, traceback_str: str = "",
                 task_name: str = ""):
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        self.task_name = task_name
        super().__init__(
            f"task {task_name or '<unknown>'} failed: {cause_repr}\n"
            f"{traceback_str}")


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor process died (crash or kill) before/while serving a call."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """Object was evicted or its producing worker died irrecoverably."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get(timeout=...)` expired before the object became available."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled with `ray_tpu_torch.cancel`."""


class WorkerCrashedError(RayTpuError):
    """A worker process died unexpectedly while executing a task."""


class RuntimeNotInitializedError(RayTpuError):
    """An API call was made before `ray_tpu_torch.init()`."""


class ObjectStoreFullError(RayTpuError):
    """The shared-memory object store could not satisfy an allocation."""


class PlacementGroupError(RayTpuError):
    """A placement group cannot be satisfied (e.g. STRICT_SPREAD with more
    bundles than alive nodes)."""


class ActorExitRequest(RayTpuError):
    """Raised by ray_tpu_torch.actor_exit() inside an actor method: the current
    call completes as a normal (None) result and the actor shuts down
    gracefully without restart (reference: ray.actor.exit_actor)."""


# ---- serve-plane fault tolerance -------------------------------------------
# These are RETRIABLE request failures: the serve handle resubmits the
# request to a different replica (after refreshing the routing table)
# when it sees one of them, and the HTTP proxy maps them to retriable
# status codes. Replica-side raises cross process boundaries wrapped in
# TaskError (repr-string), so the handle matches them by cause name —
# keep the class names stable.

class EngineWedgedError(RayTpuError):
    """The LLM engine's loop made no forward progress for longer than
    its watchdog window while requests were admitted (a hung device
    call, a stuck control command). In-flight requests are aborted with
    this error and the server's health check fails until the replica is
    replaced."""


class ReplicaDrainingError(RayTpuError):
    """The replica is gracefully draining (rolling update / scale-down /
    shutdown) and admits no new requests; in-flight work completes.
    Retriable: the handle re-routes to a RUNNING replica."""


class NoCapacityError(RayTpuError, TimeoutError):
    """Every replica of the deployment stayed at max_ongoing_requests
    for the whole routing wait. The proxy maps this to 503 with
    Retry-After. Subclasses TimeoutError for callers of the old
    `_pick_replica` timeout contract."""


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's absolute deadline passed before it could be
    admitted: it was shed rather than run."""


def error_cause_is(exc: BaseException, *names: str) -> bool:
    """True when `exc` is one of the named types, or is a TaskError
    whose cause_repr names one. Replica-side raises cross the actor
    boundary wrapped in TaskError (repr string; the original type is
    lost), so the serve plane matches retriable causes by class name —
    this is the ONE place that encodes that convention."""
    if type(exc).__name__ in names:
        return True
    cause = getattr(exc, "cause_repr", "") or ""
    return any(cause.startswith(name + "(") for name in names)


def classify_request_failure(exc: BaseException) -> str:
    """Symbolic failure class of a serve request, shared by every
    ingress so the retriable/shed/timeout taxonomy can't drift between
    proxies: "backpressure" (client should back off), "no_capacity"
    (all replicas saturated; retriable), "shed" (deadline expired
    before execution; retriable), "timeout" (executed but blew the
    budget), "error" (everything else). Name-based via error_cause_is,
    so TaskError-wrapped replica raises classify identically."""
    if error_cause_is(exc, "BackPressureError"):
        return "backpressure"
    if error_cause_is(exc, "NoCapacityError"):
        return "no_capacity"
    if error_cause_is(exc, "DeadlineExceededError"):
        return "shed"
    if error_cause_is(exc, "StreamInterruptedError"):
        return "interrupted"   # retriable by contract (post-first-token)
    if error_cause_is(exc, "GetTimeoutError"):
        return "timeout"
    return "error"


# ---- elastic training fault tolerance --------------------------------------
# Gang-plane failures cross the actor boundary wrapped in TaskError
# (repr string), so like the serve plane these are matched by class
# name (error_cause_is) — keep the names stable.

class CollectiveRankDiedError(RayTpuError):
    """A member rank of a collective gang died mid-round. Surviving
    ranks parked in `poll` get this immediately (naming the dead rank
    and the round) instead of spinning out the round timeout, so the
    elastic layer can tear the gang down and reform within seconds."""

    def __init__(self, message: str, *, rank: int = -1,
                 round_key=None):
        self.rank = rank
        self.round_key = round_key
        super().__init__(message)


class CollectiveStaleGenerationError(RayTpuError):
    """A contribute/poll arrived stamped with a superseded gang
    generation: the gang reformed while this rank was parked or
    stalled, and its world no longer exists. The rank must exit (the
    elastic layer already replaced it) — mirrors the node-incarnation
    fencing."""


class GangReformError(RayTpuError):
    """The elastic gang could not be reformed: no feasible world (not
    even a shrunken one) within RAY_TPU_GANG_REFORM_TIMEOUT_S, or the
    re-gang itself failed."""


class StreamInterruptedError(RayTpuError):
    """A streaming response died AFTER yielding its first chunk (replica
    death or wedged engine mid-stream). Transparent resubmission would
    replay already-delivered tokens, so the caller gets this typed,
    retriable error instead; `cause_repr` names the underlying failure.
    Streams that die before the first chunk fail over transparently and
    never surface this."""

    def __init__(self, message: str, cause_repr: str = ""):
        self.cause_repr = cause_repr
        super().__init__(message)


class CompiledDagError(RayTpuError):
    """A compiled DAG's pipeline infrastructure failed: a pinned
    participant died, a channel peer closed mid-execution, or the
    install handshake broke. In-flight executions fail with this (the
    `cause` names what broke); the channels are torn down and the next
    `execute()` transparently re-compiles. User exceptions raised
    INSIDE a stage do not surface this — they propagate through the
    channels as ordinary TaskErrors without tearing the pipeline
    down."""

    def __init__(self, message: str, cause: str = ""):
        self.cause = cause
        super().__init__(message if not cause
                         else f"{message} (cause: {cause})")
