"""Actor API: ActorClass (decorated class) and ActorHandle.

Reference parity: python/ray/actor.py (ActorClass.remote, ActorHandle
method invocation, .options, named actors, max_restarts/max_concurrency).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

from . import runtime as runtime_mod
from . import serialization
from .ids import new_actor_id, new_task_id, new_object_id
from .object_ref import ObjectRef
from .task import TaskSpec, ActorCreationSpec, extract_arg_deps


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method_name, args, kwargs,
                                    self._num_returns)

    def options(self, num_returns: int = 1):
        return ActorMethod(self._handle, self._method_name, num_returns)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor methods cannot be called directly; use "
            f"`.{self._method_name}.remote()`")


class ActorHandle:
    """Serializable handle to a running actor (pass freely between tasks)."""

    def __init__(self, actor_id: str, class_name: str = "",
                 method_opts: Optional[Dict[str, Dict[str, Any]]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        # per-method defaults declared with @ray_tpu_torch.method(...) on the
        # class (reference: python/ray/actor.py ray.method decorator)
        self._method_opts = method_opts or {}

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        opts = self.__dict__.get("_method_opts", {}).get(name, {})
        # concurrency_group is applied at TaskSpec build, not here
        m = ActorMethod(self, name,
                        num_returns=opts.get("num_returns", 1))
        # cache on the instance: hot call loops (`h.ping.remote()` per
        # request) stop paying __getattr__ + an ActorMethod alloc per
        # call; __reduce__ controls pickling, so the cache never ships
        self.__dict__[name] = m
        return m

    def _make_task_spec(self, method_name: str, args, kwargs,
                        num_returns=1):
        """Build the method-call TaskSpec without submitting (compiled
        DAGs batch these through runtime.submit_many). Returns
        (spec, streaming)."""
        from ..util import tracing  # noqa: PLC0415
        streaming = num_returns in ("streaming", "dynamic")
        n = 1 if streaming else num_returns
        trace_id, span_id, parent_span_id = tracing.submit_context()
        spec = TaskSpec(
            task_id=new_task_id(),
            name=f"{self._class_name}.{method_name}",
            func_bytes=b"",
            args=tuple(args),
            kwargs=dict(kwargs),
            num_returns=n,
            return_ids=[] if streaming
            else [new_object_id() for _ in range(max(n, 1))],
            resources={},
            actor_id=self._actor_id,
            method_name=method_name,
            concurrency_group=(self._method_opts.get(method_name)
                               or {}).get("concurrency_group"),
            streaming=streaming,
            dep_object_ids=extract_arg_deps(args, kwargs),
            trace_id=trace_id, span_id=span_id,
            parent_span_id=parent_span_id,
        )
        return spec, streaming

    def _invoke(self, method_name: str, args, kwargs,
                num_returns=1) -> Any:
        rt = runtime_mod.get_runtime()
        spec, streaming = self._make_task_spec(method_name, args, kwargs,
                                               num_returns)
        refs = rt.submit_actor_task(spec)
        if streaming:
            from .object_ref import ObjectRefGenerator  # noqa: PLC0415
            return ObjectRefGenerator(spec.task_id)
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._method_opts))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id})"


def _collect_method_opts(cls) -> Dict[str, Dict[str, Any]]:
    opts: Dict[str, Dict[str, Any]] = {}
    for name in dir(cls):
        if name.startswith("__"):
            continue
        fn = getattr(cls, name, None)
        mo = getattr(fn, "__ray_tpu_method_opts__", None)
        if mo:
            opts[name] = dict(mo)
    return opts


class ActorClass:
    def __init__(self, cls, *, num_cpus=None, num_gpus=None, resources=None,
                 max_restarts=0, max_concurrency=1, concurrency_groups=None,
                 name=None, namespace=None, lifetime=None, runtime_env=None,
                 placement_group=None, bundle_index=-1,
                 scheduling_strategy=None, get_if_exists=False,
                 checkpoint_interval_s=None):
        from . import runtime_env as renv_mod
        runtime_env = renv_mod.validate(runtime_env) or None
        self._cls = cls
        if concurrency_groups and any(
                n < 1 for n in concurrency_groups.values()):
            raise ValueError("concurrency_groups limits must be >= 1")
        self._default_opts = dict(
            num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
            max_restarts=max_restarts, max_concurrency=max_concurrency,
            concurrency_groups=dict(concurrency_groups or {}),
            name=name, namespace=namespace, lifetime=lifetime,
            runtime_env=runtime_env, placement_group=placement_group,
            bundle_index=bundle_index,
            scheduling_strategy=scheduling_strategy,
            get_if_exists=get_if_exists,
            checkpoint_interval_s=checkpoint_interval_s)
        self._class_bytes: Optional[bytes] = None

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._default_opts)
        merged.update(opts)
        ac = ActorClass(self._cls, **{k: v for k, v in merged.items()
                                      if k in self._default_opts})
        ac._class_bytes = self._class_bytes
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._default_opts
        if opts.get("get_if_exists") and opts.get("name"):
            # Reference: .options(name=..., get_if_exists=True) — return the
            # live named actor instead of failing on the name collision.
            # Name registration is async in the dispatcher, so a miss here
            # may be a race with an in-flight creation: create our own, then
            # re-resolve through the registry — the first registrant wins and
            # a losing duplicate dies on the name collision unreferenced.
            from .. import api as _api  # noqa: PLC0415
            try:
                return _api.get_actor(opts["name"], opts["namespace"],
                                      timeout=0.0)
            except ValueError:
                self._create(args, kwargs)
                return _api.get_actor(opts["name"], opts["namespace"])
        return self._create(args, kwargs)

    def _create(self, args, kwargs) -> ActorHandle:
        from . import resources as res_mod  # noqa: PLC0415
        from ..api import _resolve_pg_strategy  # noqa: PLC0415
        rt = runtime_mod.get_runtime()
        opts = _resolve_pg_strategy(self._default_opts)
        if self._class_bytes is None:
            self._class_bytes = serialization.dumps_call(self._cls)
        actor_id = new_actor_id()
        pg = opts.get("placement_group")
        req = res_mod.normalize_task_resources(
            num_cpus=opts["num_cpus"], num_gpus=opts["num_gpus"],
            resources=opts["resources"], default_cpus=1.0)
        method_opts = _collect_method_opts(self._cls)
        acspec = ActorCreationSpec(
            actor_id=actor_id,
            class_bytes=self._class_bytes,
            class_name=self._cls.__name__,
            method_opts=method_opts,
            args=tuple(args),
            kwargs=dict(kwargs),
            resources={} if pg is not None else req,
            max_restarts=opts["max_restarts"] or 0,
            max_concurrency=opts["max_concurrency"] or 1,
            concurrency_groups=dict(opts.get("concurrency_groups") or {}),
            name=opts["name"],
            namespace=opts["namespace"] or getattr(rt, "namespace", "default"),
            checkpoint_interval_s=opts.get("checkpoint_interval_s"),
            placement_group_id=getattr(pg, "pg_id", None),
            bundle_index=opts.get("bundle_index", -1),
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=opts["runtime_env"],
            dep_object_ids=extract_arg_deps(args, kwargs),
        )
        rt.create_actor(acspec)
        return ActorHandle(actor_id, self._cls.__name__,
                           method_opts=method_opts)

    def bind(self, *args, **kwargs):
        """Record a lazy actor-construction DAG node (ray.dag ClassNode)."""
        from ..dag import ClassNode
        return ClassNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "Actor classes must be instantiated with `.remote()`")
