"""Lazy task/actor DAGs: `.bind()` builds, `.execute()` runs.

Reference counterpart: python/ray/dag (DAGNode, FunctionNode, ClassNode,
ClassMethodNode, InputNode, MultiOutputNode). Binding records the graph
without running anything; execute() walks it, submits every function/
method node as a normal task with ObjectRefs wired as dependencies, and
returns the terminal ObjectRef(s). The scheduler's dependency tracking
(C4) gives the same pipelining the reference's compiled DAGs get from
ownership: downstream tasks are queued immediately and start the moment
their upstream refs seal.

`experimental_compile()` goes further (docs/DAG.md): when the graph is
pipeline-eligible it resolves placement ONCE — a pinned worker per
stage, dependency-local — wires reusable object channels between them,
and every execute() just pushes the input into the root channels. Data
flows worker->worker with zero driver control messages; the driver only
sees the terminal value. Ineligible graphs (and
RAY_TPU_COMPILED_DAGS=0) fall back to the dynamic level-batched plan,
which submits each topological level in one driver call.

Serve's deployment graphs (`ray_tpu/serve`) build on the same bind()
idiom.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

_node_ids = itertools.count()


class DAGNode:
    """Base: a recorded, not-yet-executed computation."""

    def __init__(self, bound_args: Tuple, bound_kwargs: Dict[str, Any]):
        self._node_id = next(_node_ids)
        self._bound_args = bound_args
        self._bound_kwargs = bound_kwargs

    # -- traversal --
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _resolve_args(self, ctx: "_ExecContext"):
        args = tuple(ctx.resolve(a) if isinstance(a, DAGNode) else a
                     for a in self._bound_args)
        kwargs = {k: ctx.resolve(v) if isinstance(v, DAGNode) else v
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _exec(self, ctx: "_ExecContext"):
        raise NotImplementedError

    def execute(self, *input_args, **input_kwargs):
        """Run the DAG; returns ObjectRef (or list for MultiOutputNode)."""
        ctx = _ExecContext(input_args, input_kwargs)
        return ctx.resolve(self)

    def experimental_compile(self) -> "CompiledDAG":
        """Compile the graph once into a reusable level-ordered plan
        (SURVEY C16; reference: ray.dag DAGNode.experimental_compile /
        python/ray/dag/compiled_dag_node.py). Every execute() then
        submits each topological level in ONE batched driver call."""
        return CompiledDAG(self)


class _ExecContext:
    def __init__(self, input_args: Tuple, input_kwargs: Dict[str, Any]):
        self.input_args = input_args
        self.input_kwargs = input_kwargs
        self._memo: Dict[int, Any] = {}

    def resolve(self, node: DAGNode):
        if node._node_id not in self._memo:
            self._memo[node._node_id] = node._exec(self)
        return self._memo[node._node_id]


class InputNode(DAGNode):
    """Placeholder for execute()-time input (reference: ray.dag.InputNode).

    Usable as a context manager for the reference idiom:
        with InputNode() as inp:
            dag = f.bind(inp)
    Attribute/index access binds a sub-field of the input.
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _exec(self, ctx: _ExecContext):
        if ctx.input_kwargs or len(ctx.input_args) != 1:
            if not ctx.input_args and not ctx.input_kwargs:
                raise TypeError("DAG has an InputNode; execute() needs an "
                                "argument")
            return (ctx.input_args, ctx.input_kwargs)
        return ctx.input_args[0]

    def __getattr__(self, key: str):
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key, "attr")

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key, "item")


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key, kind: str):
        super().__init__((parent,), {})
        self._key = key
        self._kind = kind

    def _exec(self, ctx: _ExecContext):
        base = ctx.resolve(self._bound_args[0])
        if self._kind == "attr":
            return getattr(base, self._key)
        return base[self._key]


class FunctionNode(DAGNode):
    """A bound remote-function call (reference: ray.dag.FunctionNode)."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _exec(self, ctx: _ExecContext):
        args, kwargs = self._resolve_args(ctx)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor construction. The actor is created on first execute
    and reused across executions (reference: compiled-DAG actor reuse)."""

    def __init__(self, actor_cls, args: Tuple, kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        return _MethodBinder(self, method_name)

    def _exec(self, ctx: _ExecContext):
        if self._handle is None:
            args, kwargs = self._resolve_args(ctx)
            self._handle = self._actor_cls.remote(*args, **kwargs)
        return self._handle


class _MethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name,
                               args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str,
                 args: Tuple, kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self) -> List[DAGNode]:
        # the actor itself is a dependency (compiled scheduling needs
        # the handle materialized before the method spec is built)
        return [self._class_node] + super()._children()

    def _exec(self, ctx: _ExecContext):
        handle = ctx.resolve(self._class_node)
        args, kwargs = self._resolve_args(ctx)
        return getattr(handle, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several terminal nodes (reference: ray.dag.MultiOutputNode);
    execute() returns their refs as a list."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _exec(self, ctx: _ExecContext):
        return [ctx.resolve(n) for n in self._bound_args]


class _CompiledCtx:
    """resolve() view over the compiled executor's value table, so
    inline nodes (Input*, ClassNode, MultiOutput) reuse their _exec."""

    def __init__(self, values: Dict[int, Any], input_args, input_kwargs):
        self._values = values
        self.input_args = input_args
        self.input_kwargs = input_kwargs

    def resolve(self, node: DAGNode):
        return self._values[node._node_id]


class _Ineligible(Exception):
    """Graph shape the pipelined engine cannot express; carries the
    reason string surfaced in the dag.exec.fallback event."""


class CompiledDAG:
    """A DAG compiled ONCE — pipelined when eligible, level-batched
    otherwise (docs/DAG.md).

    Reference parity: python/ray/dag/compiled_dag_node.py. In pipelined
    mode the graph gets what the reference's accelerated DAGs get from
    pre-resolved channels: placement happens at compile (one pinned
    worker per task stage, actor stages on their actor's worker,
    dependency-local via scheduling.compiled_stage_node), values move
    over reusable object channels (same-node: one rewritten shm
    segment; cross-node: a persistent socket), and execute() costs the
    driver zero control messages — it writes the input into the root
    channels and the terminal value comes back on the driver's own
    channel host. Worker death / revoked capacity fails in-flight
    executions with a typed CompiledDagError, tears the channels down,
    and the NEXT execute() transparently re-compiles.

    The batched fallback submits each topological level in one
    dispatcher round-trip (runtime.submit_many) — same result contract,
    ObjectRefs between levels.

    `stats`: {"levels", "nodes", "mode", "recompiles", "execs",
    "submit_calls"} — submit_calls counts batched-mode driver calls of
    the LAST execute (always 0 in pipelined mode).
    """

    def __init__(self, root: DAGNode):
        self._root = root
        # -- one-time compile: collect + topo-order + level-assign --
        order: List[DAGNode] = []
        seen: Dict[int, DAGNode] = {}
        on_path: set = set()

        def visit(n: DAGNode):
            if n._node_id in seen:
                if n._node_id in on_path:
                    raise ValueError("cycle detected in DAG")
                return
            seen[n._node_id] = n
            on_path.add(n._node_id)
            for c in n._children():
                visit(c)
            on_path.discard(n._node_id)
            order.append(n)              # postorder = topological

        visit(root)
        self._order = order
        self._levels_of: Dict[int, int] = {}
        for n in order:
            dep_lvl = max((self._levels_of[c._node_id]
                           for c in n._children()), default=-1)
            submittable = isinstance(n, (FunctionNode, ClassMethodNode))
            # submittable: one level below its deepest dependency;
            # inline: rides its deepest dependency's level (floor 0)
            self._levels_of[n._node_id] = (dep_lvl + 1 if submittable
                                           else max(dep_lvl, 0))
            if submittable and self._num_returns_of(n) in ("streaming",
                                                           "dynamic"):
                raise NotImplementedError(
                    "streaming (num_returns='streaming') nodes cannot "
                    "be compiled; use .execute() on the lazy DAG")
        self._n_levels = 1 + max(self._levels_of.values(), default=0)
        # fixed level schedule, built once (not rescanned per execute)
        self._levels: List[List[DAGNode]] = [
            [] for _ in range(self._n_levels)]
        for n in order:
            self._levels[self._levels_of[n._node_id]].append(n)
        self.stats = {"levels": self._n_levels, "nodes": len(order),
                      "submit_calls": 0, "mode": "batched",
                      "recompiles": 0, "execs": 0}
        # -- pipelined-mode eligibility + static plan (docs/DAG.md) --
        self._ctl = None
        self._fallback_reason: Optional[str] = None
        self._fallback_emitted = False
        self._stage_proto: Dict[int, dict] = {}
        self._stage_class_node: Dict[int, "ClassNode"] = {}
        self._drv_exprs: List[Tuple] = []
        self._out_desc: Optional[Tuple] = None
        from .util import knobs  # noqa: PLC0415
        if not knobs.get_bool("RAY_TPU_COMPILED_DAGS"):
            self._mode = "batched"
            self._fallback_reason = "disabled by RAY_TPU_COMPILED_DAGS=0"
        else:
            try:
                self._build_plan()
                self._mode = "pipelined"
                self.stats["mode"] = "pipelined"
            except _Ineligible as e:
                self._mode = "batched"
                self._fallback_reason = str(e)

    # ---------------- pipelined mode ----------------
    def _build_plan(self) -> None:
        """Static analysis: raises _Ineligible unless every node maps
        onto the channel pipeline. Builds per-stage prototypes (args as
        const/input/stage entries) and the output-slot descriptor."""
        from .core.object_ref import ObjectRef  # noqa: PLC0415
        root = self._root

        def expr_of(n) -> Tuple:
            if isinstance(n, InputNode):
                return ("whole",)
            return (("attr", n._key) if n._kind == "attr"
                    else ("item", n._key))

        def entry_of(a) -> Tuple:
            if isinstance(a, (InputNode, InputAttributeNode)):
                return ("input", expr_of(a))
            if isinstance(a, (FunctionNode, ClassMethodNode)):
                return ("stage", a._node_id)
            if isinstance(a, DAGNode):
                raise _Ineligible(
                    f"unsupported argument node {type(a).__name__}")
            if isinstance(a, ObjectRef):
                raise _Ineligible("ObjectRef argument (dynamic value)")
            return ("const", a)

        n_stages = 0
        for n in self._order:
            if isinstance(n, MultiOutputNode) and n is not root:
                raise _Ineligible("MultiOutputNode below the root")
            if isinstance(n, ClassNode):
                for a in (list(n._bound_args)
                          + list(n._bound_kwargs.values())):
                    if isinstance(a, (DAGNode, ObjectRef)):
                        raise _Ineligible(
                            "actor constructor takes a DAG value")
            if not isinstance(n, (FunctionNode, ClassMethodNode)):
                continue
            n_stages += 1
            nr = self._num_returns_of(n) or 1
            if nr != 1 and n is not root:
                raise _Ineligible(
                    "intermediate stage with num_returns != 1")
            if isinstance(n, FunctionNode):
                opts = n._remote_fn._opts
                if opts.get("num_gpus") or opts.get("resources") \
                        or opts.get("max_calls"):
                    raise _Ineligible(
                        "stage needs TPU/custom resources or max_calls")
                if opts.get("placement_group") is not None or (
                        opts.get("scheduling_strategy")
                        not in (None, "DEFAULT")):
                    raise _Ineligible(
                        "stage has placement constraints")
                proto = {"sid": n._node_id, "kind": "func",
                         "fn": n._remote_fn._fn,
                         "name": getattr(n._remote_fn._fn, "__name__",
                                         "dag_stage"),
                         "num_cpus": opts.get("num_cpus") or 1}
            else:
                proto = {"sid": n._node_id, "kind": "method",
                         "method": n._method_name,
                         "name": n._method_name, "num_cpus": 0}
                self._stage_class_node[n._node_id] = n._class_node
            proto["args"] = [entry_of(a) for a in n._bound_args]
            proto["kwargs"] = {k: entry_of(v)
                               for k, v in n._bound_kwargs.items()}
            proto["deps"] = [a._node_id for a in
                             (list(n._bound_args)
                              + list(n._bound_kwargs.values()))
                             if isinstance(a, (FunctionNode,
                                               ClassMethodNode))]
            self._stage_proto[n._node_id] = proto
        if not n_stages:
            raise _Ineligible("no task/method stages to pipeline")
        self._check_no_reentry()
        # output descriptor: what execute() hands back
        if isinstance(root, MultiOutputNode):
            slots = []
            for c in root._bound_args:
                if isinstance(c, (FunctionNode, ClassMethodNode)):
                    if (self._num_returns_of(c) or 1) != 1:
                        raise _Ineligible(
                            "multi-output child with num_returns != 1")
                    slots.append(("stage", c._node_id, None))
                elif isinstance(c, (InputNode, InputAttributeNode)):
                    self._drv_exprs.append(expr_of(c))
                    slots.append(("drv", len(self._drv_exprs) - 1))
                else:
                    raise _Ineligible(
                        "multi-output child is not a stage or input")
            self._out_desc = ("list", slots)
        elif isinstance(root, (FunctionNode, ClassMethodNode)):
            nr = int(self._num_returns_of(root) or 1)
            if nr == 1:
                self._out_desc = ("single",
                                  [("stage", root._node_id, None)])
            else:
                self._out_desc = ("list",
                                  [("stage", root._node_id, i)
                                   for i in range(nr)])
        else:
            raise _Ineligible(
                "root is not a task, method, or MultiOutputNode")

    def _check_no_reentry(self) -> None:
        """Co-located stages (same actor) whose dependency path leaves
        the worker and comes back would deadlock the worker's per-seq
        read barrier — fall back instead."""
        owner: Dict[int, Any] = {}
        for sid in self._stage_proto:
            owner[sid] = self._stage_class_node[sid]._node_id \
                if sid in self._stage_class_node else ("f", sid)
        deps_of = {sid: p["deps"]
                   for sid, p in self._stage_proto.items()}
        groups: Dict[Any, List[int]] = {}
        for sid, own in owner.items():
            if not isinstance(own, tuple):
                groups.setdefault(own, []).append(sid)
        for own, sids in groups.items():
            targets = set(sids)
            for v in sids:
                # DFS upward from v; flag = passed a foreign stage
                stack = [(d, False) for d in deps_of[v]]
                seen = set()
                while stack:
                    s, foreign = stack.pop()
                    if (s, foreign) in seen:
                        continue
                    seen.add((s, foreign))
                    if foreign and s in targets:
                        raise _Ineligible(
                            "actor pipeline re-enters its worker "
                            "through a foreign stage")
                    nxt = foreign or owner[s] != own
                    for d in deps_of[s]:
                        stack.append((d, nxt))

    def _ensure_actors(self, rt) -> None:
        from .util import knobs  # noqa: PLC0415
        timeout = knobs.get_float("RAY_TPU_DAG_COMPILE_TIMEOUT_S")
        for n in self._order:
            if not isinstance(n, ClassNode):
                continue
            if n._handle is not None and rt.actor_state(
                    n._handle.actor_id) in (None, "DEAD"):
                n._handle = None
            if n._handle is None:
                n._handle = n._actor_cls.remote(*n._bound_args,
                                                **n._bound_kwargs)
            rt.wait_actor_alive(n._handle.actor_id, timeout=timeout)

    def _make_cplan(self) -> dict:
        stages = []
        for n in self._order:
            sid = n._node_id
            proto = self._stage_proto.get(sid)
            if proto is None:
                continue
            st = dict(proto)
            if st["kind"] == "method":
                st["actor_id"] = \
                    self._stage_class_node[sid]._handle.actor_id
            stages.append(st)
        return {"stages": stages, "output_slots": self._out_desc[1],
                "drv_exprs": list(self._drv_exprs)}

    def _ensure_controller(self):
        from .core import runtime as runtime_mod  # noqa: PLC0415
        from .core.dag_runtime import DriverDagController  # noqa: PLC0415
        from .exceptions import CompiledDagError  # noqa: PLC0415
        rt = runtime_mod.get_runtime()
        if self._ctl is not None and not self._ctl.dead:
            return self._ctl
        if self._ctl is not None:
            self._ctl = None
            self.stats["recompiles"] += 1
        last_err: Optional[CompiledDagError] = None
        for attempt in (0, 1):
            self._ensure_actors(rt)
            try:
                self._ctl = DriverDagController(rt, self._make_cplan())
                return self._ctl
            except CompiledDagError as e:
                last_err = e
                # a pinned actor died between compiles: reset its
                # handle (restart) and retry once
                cause = getattr(e, "cause", "") or ""
                if attempt == 0 and cause.startswith("actor:") \
                        and cause.endswith(":dead"):
                    aid = cause.split(":")[1]
                    for n in self._order:
                        if isinstance(n, ClassNode) \
                                and n._handle is not None \
                                and n._handle.actor_id == aid:
                            n._handle = None
                    continue
                raise
        raise last_err

    def close(self) -> None:
        """Tear down the pipeline (channels + pinned workers). The
        next execute() re-compiles."""
        ctl, self._ctl = self._ctl, None
        if ctl is not None:
            ctl.close()

    teardown = close

    def __del__(self):
        try:
            if self._ctl is not None and not self._ctl.dead:
                self._ctl.close()
        except Exception:
            pass

    @staticmethod
    def _num_returns_of(n: DAGNode):
        """num_returns a node's .remote() would use — @method(...)
        declarations on the actor class included (the lazy path applies
        them via ActorMethod; the compiled path must match)."""
        if isinstance(n, FunctionNode):
            return n._remote_fn._opts.get("num_returns", 1)
        cls = getattr(n._class_node._actor_cls, "_cls", None)
        fn = getattr(cls, n._method_name, None)
        opts = getattr(fn, "__ray_tpu_method_opts__", None) or {}
        return opts.get("num_returns", 1)

    def execute(self, *input_args, **input_kwargs):
        """Run the compiled plan; same result contract as
        DAGNode.execute(). Pipelined mode returns CompiledDagRef(s)
        (resolved by ray_tpu_torch.get / .get()); batched mode returns
        ObjectRef(s)."""
        self.stats["execs"] += 1
        if self._mode == "pipelined":
            ctl = self._ensure_controller()
            seq = ctl.execute(input_args, input_kwargs)
            kind, slots = self._out_desc
            if kind == "single":
                return ctl.make_ref(seq, slots[0])
            return [ctl.make_ref(seq, s) for s in slots]
        return self._execute_batched(*input_args, **input_kwargs)

    def _execute_batched(self, *input_args, **input_kwargs):
        from .core import runtime as runtime_mod
        rt = runtime_mod.get_runtime()
        if not self._fallback_emitted:
            self._fallback_emitted = True
            try:
                rt._emit("dag.exec.fallback",
                         reason=self._fallback_reason or "explicit")
            except Exception:
                pass
        try:
            from .util import metrics_catalog  # noqa: PLC0415
            metrics_catalog.get("ray_tpu_dag_execs_total").inc(
                tags={"mode": "batched"})
        except Exception:
            pass
        values: Dict[int, Any] = {}
        ctx = _CompiledCtx(values, input_args, input_kwargs)
        self.stats["submit_calls"] = 0
        for in_level in self._levels:
            batch: List[tuple] = []
            deferred: List[DAGNode] = []
            for n in in_level:
                if isinstance(n, (FunctionNode, ClassMethodNode)):
                    args = tuple(values[a._node_id]
                                 if isinstance(a, DAGNode) else a
                                 for a in n._bound_args)
                    kwargs = {k: values[v._node_id]
                              if isinstance(v, DAGNode) else v
                              for k, v in n._bound_kwargs.items()}
                    if isinstance(n, FunctionNode):
                        spec, _s = n._remote_fn._make_spec(rt, args,
                                                           kwargs)
                    else:
                        handle = values[n._class_node._node_id]
                        spec, _s = handle._make_task_spec(
                            n._method_name, args, kwargs,
                            self._num_returns_of(n))
                    batch.append((n, spec))
                elif all(c._node_id in values for c in n._children()):
                    values[n._node_id] = n._exec(ctx)
                else:
                    # inline node fed by this level's batch (e.g.
                    # MultiOutputNode): run after submission
                    deferred.append(n)
            if batch:
                ref_lists = rt.submit_many([s for _, s in batch])
                self.stats["submit_calls"] += 1
                for (n, spec), refs in zip(batch, ref_lists):
                    values[n._node_id] = (refs[0] if len(refs) == 1
                                          else refs)
            for n in deferred:
                values[n._node_id] = n._exec(ctx)
        return values[self._root._node_id]


__all__ = ["DAGNode", "InputNode", "InputAttributeNode", "FunctionNode",
           "ClassNode", "ClassMethodNode", "MultiOutputNode",
           "CompiledDAG", "CompiledDagRef"]


def __getattr__(name):
    # CompiledDagRef re-export without importing core at module load
    # (ray_tpu/__init__ imports this module before core is ready)
    if name == "CompiledDagRef":
        from .core.dag_runtime import CompiledDagRef
        return CompiledDagRef
    raise AttributeError(name)
