"""runtime_env: per-task/actor environment propagation.

Reference counterpart: python/ray/runtime_env (RuntimeEnv with env_vars,
working_dir, py_modules, conda/pip). In-image scope (SURVEY.md §2.1
C20): env_vars, working_dir, and py_modules path injection — no conda/
pip installers. Applied inside the worker: permanently for dedicated
actor workers, scoped (set/restore) for shared task workers.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, Dict, Iterator, List, Optional

_SUPPORTED = ("env_vars", "working_dir", "py_modules")


def validate(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if not runtime_env:
        return {}
    unknown = set(runtime_env) - set(_SUPPORTED)
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)}; "
            f"supported: {_SUPPORTED} (conda/pip are documented scope "
            "cuts — no installers in-image)")
    ev = runtime_env.get("env_vars", {})
    if ev and not all(isinstance(k, str) and isinstance(v, str)
                      for k, v in ev.items()):
        raise ValueError("env_vars must be Dict[str, str]")
    wd = runtime_env.get("working_dir")
    if wd is not None and not isinstance(wd, str):
        raise ValueError("working_dir must be a path string")
    return dict(runtime_env)


def apply_permanent(runtime_env: Optional[Dict[str, Any]]) -> None:
    """Apply to this process for good — dedicated actor workers."""
    if not runtime_env:
        return
    for k, v in runtime_env.get("env_vars", {}).items():
        os.environ[k] = v
    wd = runtime_env.get("working_dir")
    if wd:
        os.chdir(wd)
    for p in runtime_env.get("py_modules", []) or []:
        if p not in sys.path:
            sys.path.insert(0, p)


@contextlib.contextmanager
def applied(runtime_env: Optional[Dict[str, Any]]) -> Iterator[None]:
    """Scoped apply/restore — shared task workers run many tasks, each
    task's env must not leak into the next."""
    if not runtime_env:
        yield
        return
    saved_env: Dict[str, Optional[str]] = {}
    saved_cwd = os.getcwd()
    added_paths: List[str] = []
    try:
        for k, v in runtime_env.get("env_vars", {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        wd = runtime_env.get("working_dir")
        if wd:
            os.chdir(wd)
        for p in runtime_env.get("py_modules", []) or []:
            if p not in sys.path:
                sys.path.insert(0, p)
                added_paths.append(p)
        yield
    finally:
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        os.chdir(saved_cwd)
        for p in added_paths:
            with contextlib.suppress(ValueError):
                sys.path.remove(p)
