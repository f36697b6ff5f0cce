"""Checkpointing: a directory-based Checkpoint handle and an atomic save
of a tree of tensors (counterpart of ray_tpu/train/checkpoint.py).

Storage is one `torch.save` file of the tree (a dict of tensors, e.g. a
state_dict or `TrainState.state_dict()`) in place of orbax's sharded
arrays; a sharded tree (DTensor leaves) is gathered whole to rank 0,
and `restore_pytree` reshards it onto any mesh or loads it onto one
device. The commit protocol is the JAX package's: the state is written
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
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _gather(tree: Any, keep: bool) -> Any:
    """The tree with every DTensor gathered whole (a collective: every
    rank walks the same tree in the same order), on the CPU where `keep`
    and dropped (None) elsewhere; other leaves as they are."""
    if isinstance(tree, DTensor):
        from ..parallel.sharding import full_tensor  # noqa: PLC0415
        full = full_tensor(tree)
        return full.cpu() if keep else None
    if isinstance(tree, Mapping):
        return {k: _gather(v, keep) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather(v, keep) for v in tree)
    return tree


def save_pytree(state: Any, path: str, *, step: Optional[int] = None,
                metadata: Optional[Dict[str, Any]] = None) -> Checkpoint:
    """Save a tree of tensors; blocking. A crash at any instant leaves
    either the previous committed checkpoint intact or the new one
    committed, never a torn directory that latest() would select.

    In a world of several ranks every rank calls it with its part of the
    same tree: DTensor leaves (a sharded model's or optimizer's state)
    are gathered whole to rank 0, which writes and commits after a
    barrier; no rank returns before the commit."""
    if _world() > 1:
        full = _gather(state, dist.get_rank() == 0)
        dist.barrier()
        if dist.get_rank() == 0:
            _commit(full, path, step, metadata)
        dist.barrier()
        return Checkpoint(path)
    return _commit(_gather(state, True), path, step, metadata)


def _commit(state: Any, path: str, step: Optional[int],
            metadata: Optional[Dict[str, Any]]) -> Checkpoint:
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


def restore_pytree(path: str, *, target: Any = None, shardings: Any = None,
                   map_location: DeviceLike = "cuda") -> Any:
    """Load a saved tree with every tensor on `map_location` (the GPU
    unless the caller names another device): whole tensors, on one
    device. With `target`, an object with `load_state_dict` (a module,
    a `TrainState`), the values are loaded into it and it is returned.

    With `shardings`, a tree of the same keys whose leaves are DTensors
    (e.g. the `state_dict()` of a model sharded on another mesh, or
    `SpmdStep.state_shardings`), the file is mapped into host memory
    (`mmap`), never loaded whole onto a card: each DTensor leaf becomes
    a DTensor of that leaf's mesh and placements built from this rank's
    shard alone, cut from the host tensor and then moved to the card.
    A DTensor standing for a subtree lays out every tensor of the
    subtree (an optimizer's moments, keyed by their parameter's index):
    each must have its shape, 0-d tensors (a step count) apart, which go
    to `map_location`; another shape raises. A plain tensor leaf (or
    subtree) goes whole to that tensor's device, and a leaf `shardings`
    does not name to `map_location`. Each tensor is copied: nothing
    restored keeps the file's mapping."""
    dev = resolve_device(map_location)
    file = os.path.join(path, STATE_NAME)
    if shardings is None:
        tree = torch.load(file, map_location=dev, weights_only=True)
    else:
        tree = _place(torch.load(file, map_location="cpu", mmap=True,
                                 weights_only=True), shardings, dev)
    if target is None:
        return tree
    target.load_state_dict(tree)
    return target


def _place(tree: Any, like: Any, dev: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _place(v, like.get(k) if isinstance(like, Mapping)
                          else like, dev) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    if isinstance(like, DTensor):
        if tree.dim() == 0:
            return tree.to(dev, copy=True)
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(
                f"restore_pytree: a saved tensor of shape "
                f"{tuple(tree.shape)} against a layout of shape "
                f"{tuple(like.shape)}")
        return DTensor.from_local(
            _local_shard(tree, like.device_mesh, like.placements)
            .to(like.device, copy=True), like.device_mesh, like.placements,
            run_check=False, shape=like.shape, stride=like.stride())
    if isinstance(like, torch.Tensor):
        return tree.to(like.device, copy=True)
    return tree.to(dev, copy=True)


def _local_shard(whole: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of `whole` (the same on every rank) under
    `placements` on `mesh`, cut on the tensor's own device, as
    `distribute_tensor` or a redistribute from `Replicate` would lay it
    out: the placements apply in mesh-dim order; `Shard(d)` keeps chunk
    c of `torch.chunk` over dim d, c this rank's coordinate on that mesh
    dim; FSDP2's `_StridedShard(d, split_factor=f)` (fsdp over a dim tp
    already split f ways) cuts dim d into f pieces, each piece into the
    mesh dim's chunks, and keeps chunk c of every piece, concatenated."""
    coord = mesh.get_coordinate()
    out = whole
    for i, p in enumerate(placements):
        if isinstance(p, Replicate):
            continue
        if not (isinstance(p, Shard) or hasattr(p, "split_factor")):
            raise NotImplementedError(
                f"restore onto placement {p!r} (mesh dim {i})")
        n, c = mesh.size(i), coord[i]
        # torch 2.13's _StridedShard is no Shard; 2.11's subclasses it
        pieces = torch.chunk(out, getattr(p, "split_factor", 1), dim=p.dim)
        out = torch.cat([_chunk(x, n, c, p.dim) for x in pieces], dim=p.dim)
    return out.contiguous()


def _chunk(x: torch.Tensor, n: int, c: int, dim: int) -> torch.Tensor:
    """Chunk c of torch.chunk(x, n, dim), empty past the last chunk."""
    parts = torch.chunk(x, n, dim=dim)
    return parts[c] if c < len(parts) else x.narrow(dim, 0, 0)


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
