"""Durable workflows: run a DAG with a persistent step log + resume
(counterpart of ray_tpu/workflow.py).

Reference parity: python/ray/workflow (workflow.run over a ray.dag,
checkpointed step results, resume by workflow_id, list/status APIs).
Every FunctionNode / ClassMethodNode result is stored under
  <storage>/<workflow_id>/steps/<step_key>.bin
keyed by a deterministic hash of the node's position in the DAG, so a
re-run (or a resume after a crash) skips completed steps and re-executes
only what's missing.

Values are stored by the runtime's own rule (`core/serialization`'s
`pack` / `unpack`), where the reference pickles them: a tensor from a
card is saved as its bytes and rebuilt on the reader's card, or on its
CPU in a process that holds no GPU, which then never initialises CUDA.
Plain pickle would need CUDA to load it. A tensor bound as a literal
argument is keyed by its dtype, shape and bytes (the reference keys
every literal by `repr`, which elides a large array's middle, so two
such arrays that differ there replay each other's step).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core.serialization import pack, unpack
from .dag import (ClassMethodNode, ClassNode, DAGNode, FunctionNode,
                  InputAttributeNode, InputNode, MultiOutputNode)

_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_torch/workflows")
_storage = _DEFAULT_STORAGE


def init(storage: Optional[str] = None) -> None:
    global _storage
    _storage = storage or _DEFAULT_STORAGE
    os.makedirs(_storage, exist_ok=True)


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage, workflow_id)


def _save(path: str, value: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(pack(value))
    os.replace(tmp, path)          # atomic: crash never half-writes


def _load(path: str) -> Any:
    with open(path, "rb") as f:
        return unpack(f.read())


def _literal_bytes(a: Any) -> bytes:
    """What identifies a literal argument in a step key: a tensor's or
    an array's dtype, shape and bytes, a container's items, any other
    value's repr."""
    if isinstance(a, torch.Tensor):
        raw = a.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return (f"tensor:{a.dtype}:{tuple(a.shape)}:".encode()
                + raw.numpy().tobytes())
    if isinstance(a, np.ndarray):
        return (f"ndarray:{a.dtype}:{a.shape}:".encode()
                + np.ascontiguousarray(a).tobytes())
    if isinstance(a, (list, tuple)):
        return (type(a).__name__.encode() + b"["
                + b",".join(_literal_bytes(x) for x in a) + b"]")
    if isinstance(a, dict):
        return b"dict{" + b",".join(
            _literal_bytes(k) + b":" + _literal_bytes(v)
            for k, v in a.items()) + b"}"
    return repr(a).encode()


def _step_key(node: DAGNode, child_keys: List[str],
              salt: str = "") -> str:
    """Deterministic key: node kind + callable name + child keys. Bound
    positions (not live ids) so re-built DAGs of the same shape match.
    `salt` carries the run-input digest for nodes downstream of an
    InputNode, so cached results computed from different execute()-time
    inputs are never replayed."""
    if isinstance(node, FunctionNode):
        name = getattr(node._remote_fn, "__name__", "fn")
    elif isinstance(node, ClassMethodNode):
        name = f"{node._class_node._actor_cls._cls.__name__}.{node._method_name}"
    else:
        name = type(node).__name__
    h = hashlib.sha1()
    h.update(name.encode())
    h.update(salt.encode())
    for ck in child_keys:
        h.update(ck.encode())
    # literal (non-node) args participate so different bindings differ
    for a in node._bound_args:
        if not isinstance(a, DAGNode):
            h.update(_literal_bytes(a))
    for k, v in sorted(node._bound_kwargs.items()):
        if not isinstance(v, DAGNode):
            h.update(k.encode() + b"=" + _literal_bytes(v))
    return f"{name}-{h.hexdigest()[:12]}"


def _input_digest(input_args, input_kwargs) -> str:
    """The run-input salt: equal inputs, tensors included, give equal
    digests (the runtime's serialization writes a tensor as its dtype,
    shape and bytes; repr would elide a large one's middle)."""
    return hashlib.sha1(pack(
        (input_args, sorted((input_kwargs or {}).items())))
    ).hexdigest()[:12]


class _DurableExec:
    """Executes a DAG bottom-up, checkpointing durable-node results."""

    def __init__(self, workflow_id: str, input_args, input_kwargs):
        self.wf_dir = _wf_dir(workflow_id)
        self.steps_dir = os.path.join(self.wf_dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        self.input_args = input_args
        self.input_kwargs = input_kwargs
        self.input_salt = f"inputs:{_input_digest(input_args, input_kwargs)}"
        self._memo: Dict[int, Any] = {}
        self._keys: Dict[int, str] = {}
        self._uses_input_memo: Dict[int, bool] = {}
        self._base_counts: Dict[str, int] = {}
        self.steps_run = 0
        self.steps_skipped = 0

    def _ckpt_path(self, key: str) -> str:
        return os.path.join(self.steps_dir, key + ".bin")

    def resolve(self, node: DAGNode) -> Any:
        if node._node_id in self._memo:
            return self._memo[node._node_id]
        value = self._eval(node)
        self._memo[node._node_id] = value
        return value

    def _eval(self, node: DAGNode) -> Any:
        from . import api
        if isinstance(node, InputNode):
            if self.input_kwargs or len(self.input_args) != 1:
                return (self.input_args, self.input_kwargs)
            return self.input_args[0]
        if isinstance(node, InputAttributeNode):
            base = self.resolve(node._bound_args[0])
            return (getattr(base, node._key) if node._kind == "attr"
                    else base[node._key])
        if isinstance(node, MultiOutputNode):
            return [self.resolve(n) for n in node._bound_args]
        if isinstance(node, ClassNode):
            args, kwargs = self._resolved_args(node)
            if node._handle is None:
                node._handle = node._actor_cls.remote(*args, **kwargs)
            return node._handle

        # durable step: FunctionNode / ClassMethodNode
        key = self._key_of(node)
        path = self._ckpt_path(key)
        if os.path.exists(path):
            self.steps_skipped += 1
            return _load(path)
        args, kwargs = self._resolved_args(node)
        if isinstance(node, FunctionNode):
            ref = node._remote_fn.remote(*args, **kwargs)
        else:
            handle = self.resolve(node._class_node)
            ref = getattr(handle, node._method_name).remote(*args, **kwargs)
        value = api.get(ref)
        _save(path, value)
        self.steps_run += 1
        return value

    def _uses_input(self, node: DAGNode) -> bool:
        nid = node._node_id
        if nid not in self._uses_input_memo:
            self._uses_input_memo[nid] = (
                isinstance(node, (InputNode, InputAttributeNode))
                or any(self._uses_input(c) for c in node._children()))
        return self._uses_input_memo[nid]

    def _key_of(self, node: DAGNode) -> str:
        if node._node_id not in self._keys:
            salt = self.input_salt if self._uses_input(node) else ""
            base = _step_key(node, [self._key_of(c) for c in node._children()],
                             salt)
            # identical sibling subtrees (e.g. two sample.bind(cfg) calls)
            # must be distinct steps: suffix by occurrence. DFS resolution
            # order is deterministic for a given DAG shape, so a rebuilt
            # DAG assigns the same suffixes.
            n = self._base_counts.get(base, 0)
            self._base_counts[base] = n + 1
            self._keys[node._node_id] = base if n == 0 else f"{base}-{n}"
        return self._keys[node._node_id]

    def _resolved_args(self, node: DAGNode):
        args = tuple(self.resolve(a) if isinstance(a, DAGNode) else a
                     for a in node._bound_args)
        kwargs = {k: self.resolve(v) if isinstance(v, DAGNode) else v
                  for k, v in node._bound_kwargs.items()}
        return args, kwargs


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        args: tuple = (), kwargs: Optional[dict] = None) -> Any:
    """Execute durably; returns the DAG output VALUE (not a ref)."""
    os.makedirs(_storage, exist_ok=True)
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    meta_path = os.path.join(wf_dir, "meta.json")
    meta = {"workflow_id": workflow_id, "status": "RUNNING",
            "started_at": time.time()}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    ex = _DurableExec(workflow_id, args, kwargs or {})
    try:
        result = ex.resolve(dag)
    except BaseException as e:
        meta.update(status="FAILED", error=repr(e),
                    finished_at=time.time())
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        raise
    _save(os.path.join(wf_dir, "output.bin"), result)
    meta.update(status="SUCCEEDED", finished_at=time.time(),
                steps_run=ex.steps_run, steps_skipped=ex.steps_skipped)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return result


def resume(workflow_id: str, dag: DAGNode, *, args: tuple = (),
           kwargs: Optional[dict] = None) -> Any:
    """Re-run by id: completed steps load from the log, the rest execute."""
    if not os.path.isdir(_wf_dir(workflow_id)):
        raise ValueError(f"no workflow {workflow_id!r} under {_storage}")
    return run(dag, workflow_id=workflow_id, args=args, kwargs=kwargs)


def get_status(workflow_id: str) -> Optional[str]:
    try:
        with open(os.path.join(_wf_dir(workflow_id), "meta.json")) as f:
            return json.load(f)["status"]
    except (OSError, KeyError, ValueError):
        return None


def get_output(workflow_id: str) -> Any:
    path = os.path.join(_wf_dir(workflow_id), "output.bin")
    if not os.path.exists(path):
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status={get_status(workflow_id)})")
    return _load(path)


def list_all() -> List[Dict[str, Any]]:
    if not os.path.isdir(_storage):
        return []
    out = []
    for wid in sorted(os.listdir(_storage)):
        meta_path = os.path.join(_storage, wid, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                out.append(json.load(f))
    return out


def delete(workflow_id: str) -> None:
    import shutil
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
