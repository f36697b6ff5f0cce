"""Public ray_tpu_torch API (counterpart of ray_tpu/api.py).

Reference parity: python/ray/__init__.py + python/ray/_private/worker.py
(init/shutdown/remote/get/put/wait/kill/cancel, get_actor, is_initialized).
"""
from __future__ import annotations

import functools
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .core import runtime as runtime_mod
from .core import serialization
from .core import resources as res_mod
from .core.actor import ActorClass, ActorHandle
from .core.object_ref import ObjectRef
from .core.runtime import DriverRuntime
from .core.task import make_task_spec
from .exceptions import RuntimeNotInitializedError

_init_lock = threading.Lock()

AUTO_PUT_THRESHOLD = 256 * 1024  # large ndarray args go through the store


def init(*, address=None, num_cpus=None, num_gpus=None, resources=None,
         object_store_memory=None, namespace="default",
         max_workers=None, ignore_reinit_error=True, log_to_driver=True,
         listen=None, state_dir=None, resume=False, **_ignored):
    """Start the ray_tpu_torch runtime in this (driver) process.

    num_gpus (default: the host's cards, core/resources.py detect_gpus)
    is the node's "GPU" resource. address="ray://host:port" makes this
    process a thin client of the cluster a `ray_tpu_torch.client.server`
    hosts (client/__init__.py); it counts no cards and touches no CUDA.

    listen="host:port" (port 0 = ephemeral) additionally opens a TCP
    listener so remote hosts can join with
    `python -m ray_tpu_torch.core.node tcp://host:port`; the bound address is
    `init(...).tcp_address`.

    state_dir (or RAY_TPU_STATE_DIR) makes the control plane DURABLE:
    every GCS mutation appends to a write-ahead log with periodic
    snapshots. resume=True rebuilds the cluster from that state after a
    driver crash — node agents reattach, actors restart from their
    `__ray_save__` checkpoints, lost objects reconstruct via lineage —
    under a bumped driver incarnation (resume="auto" resumes when state
    exists and starts fresh otherwise). See docs/FAULT_TOLERANCE.md
    "Driver restart & job resume".
    """
    with _init_lock:
        if runtime_mod.runtime_initialized():
            if ignore_reinit_error:
                return runtime_mod.get_runtime()
            raise RuntimeError("ray_tpu_torch.init() already called")
        if address is not None:
            if not str(address).startswith("ray://"):
                raise ValueError(
                    "init(address=...) expects a 'ray://host:port' client "
                    "address (start one with ray_tpu_torch.client.server)")
            sizing = {"num_cpus": num_cpus, "num_gpus": num_gpus,
                      "resources": resources,
                      "object_store_memory": object_store_memory,
                      "max_workers": max_workers, "listen": listen,
                      "state_dir": state_dir,
                      "resume": resume or None}
            bad = [k for k, v in sizing.items() if v is not None]
            if bad:
                raise ValueError(
                    f"init(address='ray://...') connects to an EXISTING "
                    f"cluster; cluster-sizing options {bad} don't apply "
                    f"(reference semantics: ray.init with a ray:// "
                    f"address rejects local-cluster kwargs)")
            from .client import ClientRuntime  # noqa: PLC0415
            crt = ClientRuntime(address, namespace=namespace)
            runtime_mod.set_runtime(crt)
            return crt
        rt = DriverRuntime(num_cpus=num_cpus, num_gpus=num_gpus,
                           resources=resources,
                           object_store_memory=object_store_memory,
                           namespace=namespace, max_workers=max_workers,
                           log_to_driver=log_to_driver, listen=listen,
                           state_dir=state_dir, resume=resume)
        runtime_mod.set_runtime(rt)
        return rt


def shutdown():
    if runtime_mod.runtime_initialized():
        runtime_mod.get_runtime().shutdown()


def is_initialized() -> bool:
    return runtime_mod.runtime_initialized()


def _ensure_init():
    if not runtime_mod.runtime_initialized():
        init()
    return runtime_mod.get_runtime()


def _auto_put_large_args(rt, args, kwargs):
    """Large array args are placed in the object store and passed by ref
    (reference: put_threshold in core_worker task arg inlining)."""
    if not args and not kwargs:
        return args, kwargs

    def conv(a):
        if isinstance(a, np.ndarray) and a.nbytes > AUTO_PUT_THRESHOLD:
            return rt.put(a)
        return a
    return tuple(conv(a) for a in args), {k: conv(v) for k, v in kwargs.items()}


def _resolve_pg_strategy(opts: Dict[str, Any]) -> Dict[str, Any]:
    """A PlacementGroupSchedulingStrategy is sugar for the
    placement_group/bundle_index options (reference parity: ray accepts
    either form)."""
    from .core.scheduling import PlacementGroupSchedulingStrategy
    strat = opts.get("scheduling_strategy")
    if isinstance(strat, PlacementGroupSchedulingStrategy):
        opts = dict(opts)
        opts["placement_group"] = strat.placement_group
        opts["bundle_index"] = strat.placement_group_bundle_index
        opts["scheduling_strategy"] = None
    return opts


class RemoteFunction:
    def __init__(self, fn, *, num_cpus=None, num_gpus=None, resources=None,
                 num_returns=1, max_retries=0, retry_exceptions=False,
                 max_calls=0, placement_group=None, bundle_index=-1,
                 scheduling_strategy=None, runtime_env=None):
        from .core import runtime_env as renv_mod
        self._fn = fn
        functools.update_wrapper(self, fn)
        self._opts = dict(num_cpus=num_cpus, num_gpus=num_gpus,
                          resources=resources, num_returns=num_returns,
                          max_retries=max_retries,
                          retry_exceptions=retry_exceptions,
                          max_calls=max_calls,
                          placement_group=placement_group,
                          bundle_index=bundle_index,
                          scheduling_strategy=scheduling_strategy,
                          runtime_env=renv_mod.validate(runtime_env) or None)
        self._func_bytes: Optional[bytes] = None
        self._func_id: str = ""

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update({k: v for k, v in opts.items() if k in merged})
        rf = RemoteFunction(self._fn, **merged)
        rf._func_bytes, rf._func_id = self._func_bytes, self._func_id
        return rf

    def _make_spec(self, rt, args, kwargs):
        """Build the TaskSpec WITHOUT submitting (compiled DAGs batch
        specs from many nodes into one runtime.submit_many call).
        Returns (spec, streaming)."""
        if self._func_bytes is None:
            self._func_bytes = serialization.dumps_call(self._fn)
            self._func_id = hashlib.sha1(self._func_bytes).hexdigest()
        args, kwargs = _auto_put_large_args(rt, args, kwargs)
        o = _resolve_pg_strategy(self._opts)
        pg = o.get("placement_group")
        streaming = o["num_returns"] in ("streaming", "dynamic")
        spec = make_task_spec(
            self._fn, args, kwargs,
            name=getattr(self._fn, "__qualname__", "task"),
            num_returns=1 if streaming else o["num_returns"],
            resources=res_mod.normalize_task_resources(
                num_cpus=o["num_cpus"], num_gpus=o["num_gpus"],
                resources=o["resources"]),
            max_retries=o["max_retries"],
            retry_exceptions=o["retry_exceptions"],
            max_calls=o.get("max_calls", 0),
            func_bytes=self._func_bytes, func_id=self._func_id,
            placement_group_id=getattr(pg, "pg_id", None),
            bundle_index=o.get("bundle_index", -1),
            scheduling_strategy=o.get("scheduling_strategy"),
            runtime_env=o.get("runtime_env"))
        return spec, streaming

    def remote(self, *args, **kwargs):
        rt = _ensure_init()
        spec, streaming = self._make_spec(rt, args, kwargs)
        o = self._opts
        if streaming:
            # generator task: items become refs as the remote yields
            spec.streaming = True
            spec.return_ids = []
            rt.submit(spec)
            from .core.object_ref import ObjectRefGenerator  # noqa: PLC0415
            return ObjectRefGenerator(spec.task_id)
        refs = rt.submit(spec)
        return refs[0] if o["num_returns"] == 1 else refs

    def bind(self, *args, **kwargs):
        """Record a lazy DAG node (reference: ray.dag f.bind)."""
        from .dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote functions must be invoked with `.remote()` "
            f"(got direct call to {self.__name__})")


def remote(*args, **kwargs):
    """`@remote` decorator for tasks and actors, with or without options."""
    def decorate(target, opts):
        if isinstance(target, type):
            if opts.get("max_calls"):
                raise ValueError(
                    "max_calls is not supported for actors (reference "
                    "semantics); use max_restarts or actor_exit()")
            allowed = ("num_cpus", "num_gpus", "resources", "max_restarts",
                       "max_concurrency", "concurrency_groups", "name",
                       "namespace", "lifetime", "runtime_env",
                       "placement_group", "bundle_index",
                       "scheduling_strategy", "get_if_exists",
                       "checkpoint_interval_s")
            return ActorClass(target,
                              **{k: v for k, v in opts.items()
                                 if k in allowed})
        allowed = ("num_cpus", "num_gpus", "resources", "num_returns",
                   "max_retries", "retry_exceptions", "max_calls",
                   "placement_group", "bundle_index",
                   "scheduling_strategy", "runtime_env")
        return RemoteFunction(target,
                              **{k: v for k, v in opts.items()
                                 if k in allowed})

    if len(args) == 1 and not kwargs and (callable(args[0])
                                          or isinstance(args[0], type)):
        return decorate(args[0], {})
    opts = kwargs
    return lambda target: decorate(target, opts)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    rt = runtime_mod.get_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout=timeout)[0]
    # compiled-DAG futures (docs/DAG.md): resolved by the pipeline's
    # driver-side controller, never by the object store
    if getattr(refs, "_is_dag_ref", False):
        return refs.get(timeout=timeout)
    refs = list(refs)
    if any(getattr(r, "_is_dag_ref", False) for r in refs):
        return [r.get(timeout=timeout)
                if getattr(r, "_is_dag_ref", False)
                else rt.get([r], timeout=timeout)[0] for r in refs]
    return rt.get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    return _ensure_init().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return runtime_mod.get_runtime().wait(
        list(refs), num_returns=num_returns, timeout=timeout,
        fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    runtime_mod.get_runtime().kill_actor(actor.actor_id,
                                         no_restart=no_restart)


def cancel(ref, *, force: bool = False, recursive: bool = True):
    from .core.object_ref import ObjectRefGenerator  # noqa: PLC0415
    rt = runtime_mod.get_runtime()
    if isinstance(ref, ObjectRefGenerator):
        rt.cancel_task(ref.task_id, force=force)
    else:
        rt.cancel(ref, force=force)


def get_actor(name: str, namespace: Optional[str] = None, *,
              timeout: float = 2.0) -> ActorHandle:
    rt = runtime_mod.get_runtime()
    ns = namespace or getattr(rt, "namespace", "default")
    # Creation registers the name asynchronously in the dispatcher; poll
    # briefly so `Actor.options(name=...).remote(); get_actor(name)` works.
    import time as _time
    deadline = _time.time() + timeout
    while True:
        if rt.is_driver:
            aid = rt.gcs.lookup_named_actor(ns, name)
            if aid is None:
                found = None
            else:
                ae = rt.gcs.actors[aid]
                found = (aid, ae.class_name,
                         getattr(ae.create_spec, "method_opts", {}) or {})
        else:
            # Workers and clients resolve names through the driver's GCS.
            # A worker has no namespace attribute (None -> the driver
            # substitutes its own default); a ClientRuntime DOES carry the
            # client's namespace, which must win over the host default.
            ns_wire = namespace if namespace is not None \
                else getattr(rt, "namespace", None)
            found = rt.report_sync("sys.lookup_actor", (ns_wire, name),
                                   timeout=5.0)
        if found is not None:
            return ActorHandle(found[0], found[1],
                               method_opts=found[2] if len(found) > 2
                               else {})
        if _time.time() > deadline:
            raise ValueError(f"no actor named {name!r} in namespace {ns!r}")
        _time.sleep(0.01)


def free(refs: Sequence[ObjectRef]):
    runtime_mod.get_runtime().free(list(refs))


def actor_exit():
    """Gracefully shut down the current actor from inside one of its
    methods (reference: ray.actor.exit_actor). The in-flight call
    returns None; the actor dies without restart; subsequent calls
    raise ActorDiedError."""
    from .exceptions import ActorExitRequest  # noqa: PLC0415
    rt = runtime_mod.get_runtime()
    if rt.is_driver or getattr(rt, "current_actor_id", None) is None:
        raise RuntimeError("actor_exit() must be called inside an "
                           "actor method")
    raise ActorExitRequest()


def method(**opts):
    """Per-method actor defaults, e.g. `@ray_tpu_torch.method(num_returns=2)`.

    Reference parity: ray.method (python/ray/actor.py) — the declared
    options become the defaults every time the method is invoked through
    an ActorHandle. num_returns is overridable per call with
    `.options(...)`; concurrency_group is declaration-only (a method
    belongs to one group for the actor's lifetime).
    """
    allowed = {"num_returns", "concurrency_group"}
    bad = set(opts) - allowed
    if bad:
        raise ValueError(f"unsupported @method option(s): {sorted(bad)}")

    def decorate(fn):
        fn.__ray_tpu_method_opts__ = dict(opts)
        return fn

    return decorate


def nodes():
    """Cluster node table. Reference parity: ray.nodes()."""
    from .util.state import list_nodes  # noqa: PLC0415
    return list_nodes(limit=10_000)


def timeline(filename: Optional[str] = None):
    """Export task/actor spans as chrome://tracing JSON.
    Reference parity: ray.timeline()."""
    from .observability.timeline import timeline as _timeline  # noqa: PLC0415
    return _timeline(filename)


def get_gpu_ids():
    """GPU indices reserved for the current task/actor (ray.get_gpu_ids;
    the reference's get_tpu_ids). They index the host's cards; the
    worker runs with CUDA_VISIBLE_DEVICES set to them, so inside the
    task the first granted card is `cuda:0`."""
    rt = runtime_mod.get_runtime()
    return list(getattr(rt, "current_gpu_ids", []) or [])


def cluster_resources() -> Dict[str, float]:
    return runtime_mod.get_runtime().get_resources()


def available_resources() -> Dict[str, float]:
    return runtime_mod.get_runtime().available_resources()


class RuntimeContext:
    """Parity: python/ray/runtime_context.py."""

    def __init__(self, rt):
        self._rt = rt

    @property
    def job_id(self):
        return getattr(self._rt, "job_id", "job-default")

    @property
    def node_id(self):
        return getattr(self._rt, "node_id", "node-local")

    def get_task_id(self):
        return getattr(self._rt, "current_task_id", None)

    def get_actor_id(self):
        return getattr(self._rt, "current_actor_id", None)

    @property
    def was_current_actor_reconstructed(self):
        # True inside an actor whose current life began with a
        # __ray_restore__ (worker-death restart OR driver resume)
        return bool(getattr(self._rt, "actor_restored", False))

    def get_resources(self):
        return self._rt.get_resources() if self._rt.is_driver else {}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(runtime_mod.get_runtime())
