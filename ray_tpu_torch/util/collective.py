"""Host-level collectives: barrier / broadcast / allreduce / allgather.

Reference counterpart: python/ray/util/collective (NCCL/GLOO process
groups). TPU-first split: ON-MESH tensor collectives are XLA's job
(psum/all_gather over ICI inside jit — see ray_tpu/parallel); this
module covers the CONTROL-PLANE case — host numpy arrays synchronized
across worker processes (e.g. data-loader coordination, eval metric
reduction) — via a named rendezvous actor, no NCCL.

NOT a training-step data path: every round funnels all ranks' payloads
through one actor (O(world) serialized hops + full copies of each
payload). Gradient/parameter tensors belong inside jit on the mesh;
allreduce() warns once past _PAYLOAD_WARN_BYTES to catch misuse.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..exceptions import (CollectiveRankDiedError,
                          CollectiveStaleGenerationError, TaskError,
                          error_cause_is)


def _driver_path_cm():
    """Rendezvous verbs must ride the DRIVER dispatch path, not the
    direct worker->worker channel: the driver lends a worker's CPU
    while it parks in get() (and reclaims leased slots), which is what
    lets the remaining ranks of a gang schedule when the cluster is at
    capacity. A rank polling over fast direct calls never parks past
    the dwait grace, so its slot would stay held and the gang would
    deadlock until the round timed out (WorkerRuntime.force_driver_path)."""
    from ray_tpu_torch.core import runtime as runtime_mod
    rt = runtime_mod.get_runtime()
    fn = getattr(rt, "force_driver_path", None)
    return fn() if fn is not None else contextlib.nullcontext()

_OPS = {
    "sum": lambda xs: np.sum(xs, axis=0),
    "mean": lambda xs: np.mean(xs, axis=0),
    "max": lambda xs: np.max(xs, axis=0),
    "min": lambda xs: np.min(xs, axis=0),
    "product": lambda xs: np.prod(xs, axis=0),
}


class _CollectiveActor:
    """Rendezvous state per (group, sequence-number round).

    Gang-aware: the elastic layer (train/elastic.py) reports member
    deaths via `mark_rank_dead`, which fails every parked poller of an
    incomplete round with a typed CollectiveRankDiedError instead of
    letting it spin out the round timeout; gang reforms advance a
    GENERATION number that fences contributions/polls from ranks of
    the superseded world (CollectiveStaleGenerationError)."""

    def __init__(self, world_size: int):
        self.world = world_size
        self._rounds: Dict[tuple, Dict[int, Any]] = {}
        self._results: Dict[tuple, Any] = {}
        self._fetched: Dict[tuple, set] = {}
        self._epochs: Dict[int, int] = {}
        self._dead: Dict[int, str] = {}        # rank -> death cause
        self._members: Dict[int, str] = {}     # rank -> actor id (info)
        self._generation = 0

    def _sync_generation(self, generation: Optional[int],
                         world_size: Optional[int] = None) -> None:
        """Fence OLD generations; ADOPT newer ones. A rank arriving
        with a newer generation than this actor knows means the gang
        reformed but the advance never landed here — e.g. the previous
        rendezvous actor died with the preempted host and this is its
        fresh (generation-0) replacement. Fencing that rank would lock
        the NEW world out forever; adopting (and clearing the dead
        world's rounds) is always safe because a newer generation is
        authoritative by construction."""
        if generation is None:
            return
        if generation > self._generation:
            self.advance_generation(generation, world_size)
        elif generation != self._generation:
            raise CollectiveStaleGenerationError(
                f"collective generation {generation} superseded by "
                f"{self._generation}: the gang reformed; this rank "
                "belongs to a dead world")

    def join(self, rank: int, world_size: int,
             actor_id: Optional[str] = None,
             generation: Optional[int] = None) -> int:
        """Per-rank init counter. Each CollectiveGroup handle gets its own
        epoch, namespacing its round keys so a re-created group for the
        same name never collides with cached results of the previous one.
        Symmetric usage (every rank re-inits together) keeps epochs equal."""
        self._sync_generation(generation, world_size)
        if world_size != self.world:
            raise ValueError(
                f"collective group has world_size={self.world}, "
                f"got {world_size}")
        if actor_id:
            self._members[rank] = actor_id
        self._dead.pop(rank, None)   # a re-joined rank is alive again
        e = self._epochs.get(rank, 0)
        self._epochs[rank] = e + 1
        return e

    def mark_rank_dead(self, rank: int, cause: str = "") -> None:
        """Driver-side supervision reports a member death. Every parked
        poller of a round still missing this rank fails fast on its next
        poll (sub-poll-interval, not the 60 s round timeout)."""
        self._dead[rank] = cause or "rank actor died"

    def advance_generation(self, generation: int,
                           world_size: Optional[int] = None) -> None:
        """The gang reformed (possibly resharded to a smaller world):
        fence the old world's rounds and accept the new membership."""
        if generation <= self._generation:
            return
        self._generation = generation
        if world_size is not None:
            self.world = world_size
        self._rounds.clear()
        self._results.clear()
        self._fetched.clear()
        self._dead.clear()
        self._members.clear()

    def members(self) -> Dict[str, Any]:
        return {"world": self.world, "generation": self._generation,
                "members": dict(self._members), "dead": dict(self._dead)}

    def contribute(self, key: tuple, rank: int, payload,
                   generation: Optional[int] = None) -> None:
        self._sync_generation(generation)
        self._rounds.setdefault(key, {})[rank] = payload

    def poll(self, key: tuple, op: Optional[str], rank: int = -1,
             generation: Optional[int] = None):
        """Returns (ready, result). Result computed once per round, then
        retained until every rank has fetched it (a result evicted before
        a slow rank polls would strand that rank in a timeout spin)."""
        self._sync_generation(generation)
        if key in self._results:
            result = self._results[key]
            self._mark_fetched(key, rank)
            return True, result
        room = self._rounds.get(key, {})
        if len(room) < self.world:
            missing_dead = [r for r in range(self.world)
                            if r not in room and r in self._dead]
            if missing_dead:
                r = missing_dead[0]
                raise CollectiveRankDiedError(
                    f"rank {r} died during collective round {key}: "
                    f"{self._dead[r]}", rank=r, round_key=key)
            return False, None
        ordered = [room[r] for r in sorted(room)]
        if op is None:                     # allgather
            result = ordered
        elif op == "broadcast":
            # payloads are (is_src, value): select by src flag, so
            # broadcasting None works and stray non-src values are ignored
            result = next(v for flag, v in ordered if flag)
        elif op == "barrier":
            result = True
        else:
            result = _OPS[op]([np.asarray(v) for v in ordered])
        self._results[key] = result
        self._rounds.pop(key, None)
        self._mark_fetched(key, rank)
        return True, result

    def _mark_fetched(self, key: tuple, rank: int) -> None:
        fetched = self._fetched.setdefault(key, set())
        fetched.add(rank)
        if len(fetched - {-1}) >= self.world:
            self._results.pop(key, None)
            self._fetched.pop(key, None)
            return
        # Size cap only as a fallback for abandoned rounds (a rank died
        # between contribute and poll): evict the oldest fully-computed
        # result, preferring ones nobody is still waiting on is
        # impossible to know, so cap generously.
        if len(self._results) > 1024:
            oldest = next(iter(self._results))
            self._results.pop(oldest)
            self._fetched.pop(oldest, None)


def _raise_typed(exc: BaseException):
    """Re-raise actor-boundary-wrapped gang failures as their typed
    forms (TaskError carries only the repr; error_cause_is matches by
    class name like the serve plane does)."""
    if isinstance(exc, (CollectiveRankDiedError,
                        CollectiveStaleGenerationError)):
        raise exc
    if error_cause_is(exc, "CollectiveRankDiedError"):
        raise CollectiveRankDiedError(
            getattr(exc, "cause_repr", "") or str(exc)) from exc
    if error_cause_is(exc, "CollectiveStaleGenerationError"):
        raise CollectiveStaleGenerationError(
            getattr(exc, "cause_repr", "") or str(exc)) from exc
    raise exc


class CollectiveGroup:
    """One rank's handle; ranks coordinate via the shared named actor.

    `generation` (optional) stamps every verb with the elastic gang
    generation: after a reform, verbs from ranks of the old world fail
    with CollectiveStaleGenerationError instead of corrupting the new
    world's rounds. A rank whose gang-mate dies mid-round gets
    CollectiveRankDiedError from the parked verb within the poll
    interval (the elastic supervisor calls mark_rank_dead)."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 *, generation: Optional[int] = None):
        import ray_tpu_torch
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.generation = generation
        self._seq: Dict[str, int] = {}
        name = f"rtpu_collective:{group_name}"
        try:
            self.actor = ray_tpu_torch.get_actor(name, timeout=0.0)
        except ValueError:
            cls = ray_tpu_torch.remote(_CollectiveActor).options(
                name=name, get_if_exists=True)
            cls.remote(world_size)
            # canonicalize through the name registry: if two ranks raced,
            # the loser's actor died on the name collision and lookup
            # returns the winner for everyone.
            self.actor = ray_tpu_torch.get_actor(name)
        try:
            actor_id = ray_tpu_torch.get_runtime_context().get_actor_id()
        except Exception:  # noqa: BLE001 — plain-task ranks have none
            actor_id = None
        with _driver_path_cm():
            try:
                self.epoch = ray_tpu_torch.get(
                    self.actor.join.remote(rank, world_size, actor_id,
                                           generation))
            except TaskError as e:
                _raise_typed(e)

    def _round(self, kind: str, payload, op: Optional[str],
               timeout: float = 60.0):
        import ray_tpu_torch
        seq = self._seq.get(kind, 0)
        self._seq[kind] = seq + 1
        key = (self.epoch, kind, seq)
        # one park spans the whole round (contribute + poll loop): a
        # stuck round surfaces as an aged "collective-round" record
        # carrying group/rank/world/seq — the straggler detector
        # compares these across ranks and names the missing ones
        from . import waits as waits_mod  # noqa: PLC0415
        wtok = waits_mod.park(
            "collective-round", f"{self.group_name}:{kind}:{seq}",
            group=self.group_name, rank=self.rank,
            world=self.world_size, round=kind, seq=seq,
            epoch=self.epoch, generation=self.generation)
        try:
            with _driver_path_cm():
                try:
                    ray_tpu_torch.get(
                        self.actor.contribute.remote(
                            key, self.rank, payload, self.generation))
                    deadline = time.monotonic() + timeout
                    delay = 0.001
                    while True:
                        ready, result = ray_tpu_torch.get(
                            self.actor.poll.remote(key, op, self.rank,
                                                   self.generation))
                        if ready:
                            return result
                        if time.monotonic() >= deadline:
                            raise TimeoutError(
                                f"collective {kind}#{seq} timed out "
                                f"({self.world_size} ranks expected)")
                        time.sleep(delay)
                        delay = min(delay * 2, 0.02)
                except TaskError as e:
                    _raise_typed(e)
        finally:
            waits_mod.unpark(wtok)

    def barrier(self, timeout: float = 60.0) -> None:
        self._round("barrier", None, "barrier", timeout)

    # beyond this, the single-actor rendezvous is the wrong tool — the
    # tensor belongs on the mesh where XLA reduces it over ICI
    _PAYLOAD_WARN_BYTES = 16 * 1024 * 1024
    _size_warned = False

    def allreduce(self, array, op: str = "sum", timeout: float = 60.0):
        array = np.asarray(array)
        if (array.nbytes > self._PAYLOAD_WARN_BYTES
                and not CollectiveGroup._size_warned):
            CollectiveGroup._size_warned = True
            import warnings
            warnings.warn(
                f"collective.allreduce of {array.nbytes >> 20} MiB "
                f"through the control-plane rendezvous actor (O(world) "
                f"serialized hops); large tensors belong in jitted "
                f"mesh collectives (ray_tpu_torch.parallel)", stacklevel=2)
        return self._round("allreduce", array, op, timeout)

    def allgather(self, value, timeout: float = 60.0) -> List[Any]:
        return self._round("allgather", value, None, timeout)

    def broadcast(self, value=None, src: int = 0, timeout: float = 60.0):
        return self._round("broadcast", (self.rank == src, value),
                           "broadcast", timeout)


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> CollectiveGroup:
    """Reference: ray.util.collective.init_collective_group."""
    return CollectiveGroup(group_name, world_size, rank)


def notify_rank_death(group_name: str, rank: int, cause: str = "",
                      timeout: float = 10.0) -> bool:
    """Tell a group's rendezvous actor that a member rank died, failing
    its parked pollers fast with CollectiveRankDiedError. Called by the
    gang supervisor (train/elastic.py) from its death watch; best-effort
    (False when the group doesn't exist or the actor itself is gone —
    e.g. it lived on the dead node, in which case pollers already get
    ActorDiedError)."""
    import ray_tpu_torch
    try:
        actor = ray_tpu_torch.get_actor(f"rtpu_collective:{group_name}",
                                  timeout=0.0)
        ray_tpu_torch.get(actor.mark_rank_dead.remote(rank, cause),
                    timeout=timeout)
        return True
    except Exception:  # noqa: BLE001 — supervision must not fail on this
        return False


def advance_group_generation(group_name: str, generation: int,
                             world_size: Optional[int] = None,
                             timeout: float = 10.0) -> bool:
    """Fence a group's previous world after a gang reform: rounds from
    generations < `generation` fail with CollectiveStaleGenerationError
    and the (possibly resharded) world size takes effect. Best-effort,
    same contract as notify_rank_death."""
    import ray_tpu_torch
    try:
        actor = ray_tpu_torch.get_actor(f"rtpu_collective:{group_name}",
                                  timeout=0.0)
        ray_tpu_torch.get(actor.advance_generation.remote(generation, world_size),
                    timeout=timeout)
        return True
    except Exception:  # noqa: BLE001
        return False


def destroy_collective_group(group_name: str = "default") -> None:
    """Kill the rendezvous actor (reference:
    ray.util.collective.destroy_collective_group)."""
    import ray_tpu_torch
    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(f"rtpu_collective:{group_name}",
                                       timeout=0.0))
    except ValueError:
        pass
