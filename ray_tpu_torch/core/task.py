"""Task & actor specs plus the user-facing RemoteFunction wrapper.

Reference parity: python/ray/remote_function.py (RemoteFunction, .options),
src/ray/common/task/task_spec.h (TaskSpec fields).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from . import serialization
from .ids import new_task_id, new_object_id


@dataclasses.dataclass
class TaskSpec:
    task_id: str
    name: str
    func_bytes: bytes                  # cloudpickled callable (None for actor methods)
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_returns: int = 1
    return_ids: List[str] = dataclasses.field(default_factory=list)
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    # recycle the executing worker after this many calls of this
    # function (0 = never; reference: @ray.remote(max_calls=N) for
    # leaky native libraries)
    max_calls: int = 0
    # streaming-generator task: yielded items become individually sealed
    # objects announced via "gen_item"; return_ids stays empty
    streaming: bool = False
    # actor fields
    actor_id: Optional[str] = None
    method_name: Optional[str] = None
    # named concurrency group (@ray_tpu_torch.method(concurrency_group=...));
    # None = the actor's default max_concurrency lane
    concurrency_group: Optional[str] = None
    # placement
    placement_group_id: Optional[str] = None
    bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    runtime_env: Optional[dict] = None
    # chip indices assigned by the dispatcher at dispatch time
    # (ray_tpu_torch.get_gpu_ids inside the task reads these)
    gpu_ids: List[int] = dataclasses.field(default_factory=list)
    # bookkeeping
    func_id: str = ""                  # cache key for deserialized functions
    dep_object_ids: List[str] = dataclasses.field(default_factory=list)
    # times this task was re-queued by lineage reconstruction (a lost
    # output re-executing its producer; args referenced by ObjectRef
    # stay refs, so the retained spec is cheap unless args are by-value)
    reconstructions: int = 0
    # cross-process tracing (util/tracing.py): span_id names this task's
    # SUBMIT span; the executing worker opens a child execution span
    # parented to it, so the timeline links driver and worker sides
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    # multi-slot lease this spec was granted under (runtime lease
    # dispatch stamps it); the worker's exec span carries it so the
    # timeline links every slot back to its lease-grant span
    lease_id: str = ""


@dataclasses.dataclass
class ActorCreationSpec:
    actor_id: str
    class_bytes: bytes
    class_name: str
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    max_restarts: int = 0
    max_concurrency: int = 1
    # named method groups with INDEPENDENT concurrency limits
    # (reference: python/ray/actor.py concurrency_groups) — a slow
    # group can't starve e.g. health-check methods in another group
    concurrency_groups: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    name: Optional[str] = None
    namespace: str = "default"
    # min seconds between __ray_save__ checkpoint ships (None = the
    # RAY_TPU_ACTOR_CHECKPOINT_INTERVAL_S default; only actors defining
    # the hook checkpoint at all)
    checkpoint_interval_s: Optional[float] = None
    placement_group_id: Optional[str] = None
    bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    runtime_env: Optional[dict] = None
    gpu_ids: List[int] = dataclasses.field(default_factory=list)
    # @ray_tpu_torch.method defaults per method name, carried so handles from
    # get_actor() behave identically to the creation-time handle
    method_opts: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    dep_object_ids: List[str] = dataclasses.field(default_factory=list)


def extract_arg_deps(args: Tuple, kwargs: Dict[str, Any]) -> List[str]:
    """Top-level ObjectRef args become scheduling dependencies; the worker
    substitutes their values before invoking the function (same contract as
    the reference: nested refs are passed through un-resolved)."""
    from .object_ref import ObjectRef  # noqa: PLC0415
    if not args and not kwargs:
        return []
    deps = []
    for a in args:
        if isinstance(a, ObjectRef):
            deps.append(a.id)
    for a in kwargs.values():
        if isinstance(a, ObjectRef):
            deps.append(a.id)
    return deps


def make_task_spec(func, args, kwargs, *, name=None, num_returns=1,
                   resources=None, max_retries=0, retry_exceptions=False,
                   max_calls=0, func_bytes=None, func_id="",
                   placement_group_id=None,
                   bundle_index=-1, scheduling_strategy=None,
                   runtime_env=None) -> TaskSpec:
    from ..util import tracing  # noqa: PLC0415
    tid = new_task_id()
    trace_id, span_id, parent_span_id = tracing.submit_context()
    spec = TaskSpec(
        task_id=tid,
        name=name or getattr(func, "__qualname__", "anonymous"),
        func_bytes=func_bytes if func_bytes is not None
        else serialization.dumps_call(func),
        args=tuple(args),
        kwargs=dict(kwargs or {}),
        num_returns=num_returns,
        return_ids=[new_object_id() for _ in range(max(num_returns, 1))],
        resources=dict(resources or {"CPU": 1.0}),
        max_retries=max_retries,
        retry_exceptions=retry_exceptions,
        max_calls=max_calls,
        func_id=func_id,
        placement_group_id=placement_group_id,
        bundle_index=bundle_index,
        scheduling_strategy=scheduling_strategy,
        runtime_env=runtime_env,
        dep_object_ids=extract_arg_deps(args, kwargs or {}),
        trace_id=trace_id, span_id=span_id,
        parent_span_id=parent_span_id,
    )
    return spec
