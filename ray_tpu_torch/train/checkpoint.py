"""Checkpointing: a directory-based Checkpoint handle and an atomic save
of a tree of tensors (counterpart of ray_tpu/train/checkpoint.py).

Storage is one `torch.save` file of the tree (a dict of tensors, e.g. a
state_dict or `TrainState.state_dict()`) in place of orbax's sharded
arrays; the commit protocol is the JAX package's: the state is written
into a `tmp-` sibling, the meta sidecar is fsynced there, and one atomic
rename publishes the checkpoint. A previous checkpoint at the same path
slides aside first and is reclaimed only after the commit; a crash
between the two renames is undone by `_recover_slide_aside`.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional

import torch

from ..util.device import DeviceLike, resolve_device


class Checkpoint:
    """A handle to a checkpoint directory (metrics sidecar + state)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @staticmethod
    def from_directory(path: str) -> "Checkpoint":
        return Checkpoint(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: str) -> str:
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def metadata(self) -> Dict[str, Any]:
        meta = os.path.join(self.path, META_NAME)
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint({self.path})"


#: committed checkpoints carry this meta sidecar; it is written INSIDE
#: the tmp- staging dir before the atomic rename, so its presence in a
#: `checkpoint_*` directory == the save committed. Torn saves leave only
#: an uncommitted `tmp-*` sibling (or a meta-less directory) that
#: latest()/_prune() never select.
META_NAME = "ckpt_meta.json"
STATE_NAME = "state.pt"
_TMP_PREFIX = "tmp-"
_OLD_PREFIX = _TMP_PREFIX + "old-"


def is_committed(path: str) -> bool:
    """True when `path` is a fully committed checkpoint directory."""
    return (os.path.isdir(path)
            and not os.path.basename(path).startswith(_TMP_PREFIX)
            and os.path.exists(os.path.join(path, META_NAME)))


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _write_state(directory: str, state: Any) -> None:
    os.makedirs(directory, exist_ok=True)
    _fsync_write(os.path.join(directory, STATE_NAME),
                 lambda f: torch.save(state, f))


def save_pytree(state: Any, path: str, *, step: Optional[int] = None,
                metadata: Optional[Dict[str, Any]] = None) -> Checkpoint:
    """Save a tree of tensors; blocking. A crash at any instant leaves
    either the previous committed checkpoint intact or the new one
    committed, never a torn directory that latest() would select."""
    path = os.path.abspath(path)
    parent, base = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"{_TMP_PREFIX}{base}-{uuid.uuid4().hex[:8]}")
    _write_state(tmp, state)
    meta = dict(metadata or {})
    meta.update({"step": step, "saved_at": time.time()})
    _fsync_write(os.path.join(tmp, META_NAME),
                 lambda f: f.write(json.dumps(meta).encode()))
    old = None
    if os.path.exists(path):
        # rename over a non-empty dir is not atomic: the previous
        # checkpoint slides aside and is reclaimed after the commit
        old = os.path.join(parent,
                           f"{_OLD_PREFIX}{base}-{uuid.uuid4().hex[:8]}")
        os.rename(path, old)
    os.rename(tmp, path)                       # the commit point
    _fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return Checkpoint(path)


def _recover_slide_aside(root: str) -> None:
    """Undo a crash caught between save_pytree's two overwrite renames:
    the previously committed checkpoint sits under tmp-old-<base>-<id>
    (meta intact) with nothing at <base>; promote it back. Only safe from
    the committing process or once the saver is known dead."""
    try:
        entries = os.listdir(root)
    except OSError:
        return
    for d in entries:
        if not d.startswith(_OLD_PREFIX):
            continue
        base = d[len(_OLD_PREFIX):].rsplit("-", 1)[0]
        target = os.path.join(root, base)
        src = os.path.join(root, d)
        if not os.path.exists(target) \
                and os.path.exists(os.path.join(src, META_NAME)):
            try:
                os.rename(src, target)
            except OSError:
                pass    # a concurrent promote/save won the race


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def restore_pytree(path: str, *, map_location: DeviceLike = "cuda") -> Any:
    """Load a saved tree with every tensor on `map_location` (the GPU
    unless the caller names another device)."""
    dev = resolve_device(map_location)
    return torch.load(os.path.join(path, STATE_NAME), map_location=dev,
                      weights_only=True)


class CheckpointManager:
    """Rotating checkpoint directory (num_to_keep)."""

    def __init__(self, root: str, num_to_keep: Optional[int] = 2):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep

    def save(self, state: Any, step: int,
             metadata: Optional[Dict[str, Any]] = None) -> Checkpoint:
        path = os.path.join(self.root, f"checkpoint_{step:09d}")
        ckpt = save_pytree(state, path, step=step, metadata=metadata)
        self._prune()
        return ckpt

    def _committed(self):
        return sorted(d for d in os.listdir(self.root)
                      if d.startswith("checkpoint_")
                      and is_committed(os.path.join(self.root, d)))

    def latest(self) -> Optional[Checkpoint]:
        """Newest committed checkpoint; torn saves are never selected. A
        checkpoint caught mid-overwrite by a crash is promoted back from
        its slide-aside name first."""
        _recover_slide_aside(self.root)
        entries = self._committed()
        if not entries:
            return None
        return Checkpoint(os.path.join(self.root, entries[-1]))

    # staging dirs older than this are crash leftovers; younger ones may
    # be a concurrent save still writing, so they are left alone
    TMP_TTL_S = 3600.0

    def _prune(self):
        _recover_slide_aside(self.root)
        now = time.time()
        for d in os.listdir(self.root):
            p = os.path.join(self.root, d)
            if d.startswith(_TMP_PREFIX):
                try:
                    age = now - os.path.getmtime(p)
                except OSError:
                    continue
                if age > self.TMP_TTL_S:
                    shutil.rmtree(p, ignore_errors=True)
        if self.num_to_keep is None:
            return
        for d in self._committed()[:-self.num_to_keep]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
