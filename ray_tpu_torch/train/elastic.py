"""Elastic gang layer: supervision, death detection, and mesh resharding
(counterpart of ray_tpu/train/elastic.py).

A `GangSupervisor` on the driver watches every rank actor's GCS state,
flags a lost rank within ~a poll interval, fails the gang's parked
collective rounds fast (util/collective.py `notify_rank_death` ->
CollectiveRankDiedError), and hands `MultiHostSpmd.reform()` the signal
to tear down the doomed torch.distributed world (NCCL on cards, gloo on
the CPU) and re-gang — with a replacement rank when the cluster has
capacity, otherwise RESHARDED onto the surviving world
(`reshard_mesh_spec` shrinks the dp axis). Generations fence zombie
ranks of the old world.

The supervisor runs where the gang handle lives — the driver process —
because the GCS actor/node tables ARE the death signal in this
single-controller design.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..parallel.mesh import MeshSpec
from ..util import knobs

#: seconds between supervisor scans of the rank actors' GCS state
ENV_PROBE_S = "RAY_TPU_GANG_PROBE_S"
#: total budget for one reform (capacity wait + re-gang + join)
ENV_REFORM_TIMEOUT_S = "RAY_TPU_GANG_REFORM_TIMEOUT_S"
#: how long reform waits for FULL replacement capacity before it
#: settles for a resharded (smaller) world
ENV_REPLACE_WAIT_S = "RAY_TPU_GANG_REPLACE_WAIT_S"


def _probe_s() -> float:
    return knobs.get_float(ENV_PROBE_S)


def reform_timeout_s() -> float:
    return knobs.get_float(ENV_REFORM_TIMEOUT_S)


def replace_wait_s() -> float:
    return knobs.get_float(ENV_REPLACE_WAIT_S)


@dataclasses.dataclass
class RankDeath:
    """One lost gang member, as seen by the supervisor."""
    rank: int
    actor_id: str
    cause: str
    generation: int
    detected_at: float


class GangSupervisor:
    """Driver-side death watch over a gang's rank actors.

    Polls the GCS actor table (every RAY_TPU_GANG_PROBE_S, default
    0.25 s) for each member reaching DEAD — which the runtime already
    determines from worker-socket close, node-socket close, or the
    heartbeat chain — and on the first death:

      * emits `train.gang.rank_death` (cause, rank, generation),
      * calls `mark_rank_dead` on every registered collective group so
        parked rounds fail with CollectiveRankDiedError in seconds,
      * sets `failed` and invokes `on_death` (once per dead rank).

    The supervisor never tears anything down itself — that is
    `MultiHostSpmd.reform()`'s job — so it can also watch bare
    collective gangs that have no MultiHostSpmd around them.
    """

    def __init__(self, members: Dict[int, str], *, generation: int = 0,
                 collective_groups: Sequence[str] = (),
                 on_death: Optional[Callable[[RankDeath], None]] = None,
                 poll_s: Optional[float] = None):
        from ..core import runtime as runtime_mod
        rt = runtime_mod.get_runtime()
        if not getattr(rt, "is_driver", False) \
                or not hasattr(rt, "gcs"):
            raise RuntimeError(
                "gang supervision reads the GCS actor table and must "
                "run in the driver process (where the gang handle "
                "lives)")
        self._rt = rt
        self._members = dict(members)          # rank -> actor_id
        self.generation = generation
        self._groups = tuple(collective_groups)
        self._on_death = on_death
        self._poll_s = poll_s if poll_s is not None else _probe_s()
        self.deaths: List[RankDeath] = []
        self.failed = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name="gang-supervisor", daemon=True)
        self._thread.start()

    # ---- signal surface -------------------------------------------------
    @property
    def first_death(self) -> Optional[RankDeath]:
        return self.deaths[0] if self.deaths else None

    def wait(self, timeout: Optional[float] = None) -> Optional[RankDeath]:
        """Block until a member dies (or timeout); returns the death."""
        self.failed.wait(timeout)
        return self.first_death

    def survivors(self) -> Dict[int, str]:
        dead = {d.rank for d in self.deaths}
        return {r: a for r, a in self._members.items() if r not in dead}

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # ---- watch loop -----------------------------------------------------
    def _watch(self) -> None:
        from ..util import events
        from ..util.collective import notify_rank_death
        seen: set = set()
        while not self._stop.is_set():
            for rank, aid in self._members.items():
                if rank in seen:
                    continue
                ae = self._rt.gcs.actors.get(aid)
                state = ae.state if ae is not None else None
                if state is not None and state != "DEAD":
                    continue
                cause = (ae.death_cause if ae is not None else None) \
                    or "actor entry gone"
                seen.add(rank)
                death = RankDeath(rank=rank, actor_id=aid,
                                  cause=str(cause),
                                  generation=self.generation,
                                  detected_at=time.time())
                self.deaths.append(death)
                events.emit_safe(
                    "train.gang.rank_death",
                    f"gang rank {rank} died: {death.cause}",
                    rank=str(rank), actor_id=aid,
                    generation=str(self.generation))
                for g in self._groups:
                    notify_rank_death(
                        g, rank,
                        f"gang generation {self.generation}: "
                        f"{death.cause}")
                self.failed.set()
                if self._on_death is not None:
                    try:
                        self._on_death(death)
                    except Exception:  # noqa: BLE001 — watch must live on
                        pass
            self._stop.wait(self._poll_s)




def reshard_mesh_spec(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """Scale a MeshSpec onto a different global device count by scaling
    the dp axis: mesh layout is a re-derivable FUNCTION of the surviving
    world, not fixed job state. Model-parallel axes (tp/sp/fsdp/ep/pp)
    keep their shape; only data parallelism stretches or shrinks."""
    if spec.size == n_devices:
        return spec
    per_dp = spec.size // spec.dp       # devices consumed by other axes
    if per_dp <= 0 or n_devices % per_dp != 0 or n_devices < per_dp:
        raise ValueError(
            f"cannot reshard MeshSpec {spec.axis_sizes()} onto "
            f"{n_devices} devices: non-dp axes need multiples of "
            f"{per_dp} devices")
    return dataclasses.replace(spec, dp=n_devices // per_dp)


__all__ = ["GangSupervisor", "RankDeath", "reshard_mesh_spec",
           "reform_timeout_s", "replace_wait_s"]
