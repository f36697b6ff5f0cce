"""Serializability inspection (reference parity:
python/ray/util/check_serialize.py inspect_serializability): walk an
object that fails cloudpickle and report WHICH nested members are the
problem, instead of one opaque pickling error."""
from __future__ import annotations

import inspect
from typing import Any, Set, Tuple

from ..core import serialization


class FailureTuple:
    """One unserializable leaf: the object, its name, and its parent."""

    def __init__(self, obj: Any, name: str, parent: Any):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple(obj={self.obj!r}, name={self.name})"


def _serializable(obj: Any) -> bool:
    try:
        serialization.dumps_call(obj)
        return True
    except Exception:
        return False


def inspect_serializability(
        base_obj: Any, name: str = None,
        depth: int = 3) -> Tuple[bool, Set[FailureTuple]]:
    """Returns (serializable, failures). failures holds the deepest
    reachable unserializable members (closures, attributes, globals)."""
    name = name or getattr(base_obj, "__name__", repr(base_obj)[:40])
    failures: Set[FailureTuple] = set()
    _inspect(base_obj, name, None, depth, failures, seen=set())
    return (not failures), failures


def _inspect(obj, name, parent, depth, failures, seen):
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if _serializable(obj):
        return
    n_before = len(failures)
    if depth > 0:
        for child_name, child in _children(obj):
            if not _serializable(child):
                _inspect(child, f"{name}.{child_name}", obj, depth - 1,
                         failures, seen)
    # Blame this object unless a descendant was blamed: counting actual
    # recorded failures (not merely "recursed") keeps reference cycles of
    # unserializable members from escaping blame entirely.
    if len(failures) == n_before:
        failures.add(FailureTuple(obj, name, parent))


def _children(obj):
    if inspect.isfunction(obj):
        if obj.__closure__:
            for var, cell in zip(obj.__code__.co_freevars, obj.__closure__):
                try:
                    yield var, cell.cell_contents
                except ValueError:
                    pass
        for gname in obj.__code__.co_names:
            if gname in (obj.__globals__ or {}):
                yield gname, obj.__globals__[gname]
    elif hasattr(obj, "__dict__"):
        yield from list(vars(obj).items())


__all__ = ["inspect_serializability", "FailureTuple"]
