"""Multi-host SPMD: one torch.distributed process per rank, placed by
the runtime (counterpart of ray_tpu/train/multihost.py).

The reference's world is `jax.distributed`: one process a host, every
host's chips in one global mesh. Here the world is torch.distributed,
one process a rank: each `_SpmdHost` actor joins the process group
through `train.backend.setup_worker` (NCCL when the rank holds a GPU,
gloo on the CPU), and each rank drives its own card — under the runtime
a rank sees only the cards it was granted, so its card is `cuda:0`.

The runtime provides the process fabric: one `_SpmdHost` actor per rank
(gang-placed via STRICT_SPREAD when `spread=True`); rank 0 picks a
`tcp://` rendezvous on its own host, every rank joins the world, then
the gang runs the user's function.

Elastic mode (`supervised=True`, train/elastic.py): a GangSupervisor
watches every rank's GCS actor state; when a rank dies, `reform()` tears
down the doomed world — killing the remaining rank processes is the
clean teardown: a rank parked in an NCCL collective never returns — and
re-gangs under a bumped GENERATION: at full size when the cluster has
replacement capacity, otherwise resharded onto the surviving world.
Stale ranks of the old generation are fenced out of collectives.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


# what a rank's actor reserves unless the caller says otherwise: its own
# card, as ScalingConfig(use_gpu=True) asks for a TorchTrainer's rank
RANK_RESOURCES: Dict[str, float] = {"CPU": 1, "GPU": 1}


class _SpmdHost:
    """Actor hosting one rank of the torch.distributed world."""

    def __init__(self, rank: int, world: int, generation: int = 0):
        self.rank = rank
        self.world = world
        self.generation = generation

    def ping(self) -> Dict[str, int]:
        return {"rank": self.rank, "world": self.world,
                "generation": self.generation, "pid": os.getpid()}

    def pick_coordinator(self) -> str:
        """Rank 0 chooses the rendezvous endpoint ON ITS OWN HOST — the
        TCP store runs inside rank 0's process, which with gang placement
        is NOT the driver's host."""
        from ..util.netutil import free_port, routable_ip
        return f"tcp://{routable_ip()}:{free_port()}"

    def join(self, coordinator: str) -> Dict[str, int]:
        """Blocks until every rank has joined the world. Called on all
        ranks concurrently (each actor has its own process). A rank that
        holds a GPU joins over NCCL on its card, any other over gloo."""
        import torch
        from ..api import get_gpu_ids
        from .backend import TorchBackendConfig, setup_worker
        device = "cuda" if get_gpu_ids() else "cpu"
        setup_worker(TorchBackendConfig(init_method=coordinator,
                                        world_size=self.world),
                     rank=self.rank, world_size=self.world, device=device)
        local = torch.cuda.device_count() if device == "cuda" else 1
        return {"rank": self.rank, "world": self.world,
                "local_devices": local, "global_devices": self.world,
                "pid": os.getpid()}

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        return fn(self.rank, self.world, *args, **kwargs)


class MultiHostSpmd:
    """A gang of rank processes forming one torch.distributed world.

    num_hosts: requested rank processes (the reference's name: one
        process a host there, one a card or a CPU rank here). `world_size` is the CURRENT gang size — it equals
        num_hosts until a supervised gang reforms resharded.
    resources_per_host: what each rank's actor reserves; by default
        {"CPU": 1, "GPU": 1}, so each rank owns one card and joins over
        NCCL. {"CPU": 1} asks for a CPU world over gloo.
    env_per_host: env applied in each rank's process before it runs.
    spread: gang the ranks one-per-node via a STRICT_SPREAD placement
        group (requires that many alive nodes).
    supervised: start a GangSupervisor (train/elastic.py) that detects
        a dead rank within ~RAY_TPU_GANG_PROBE_S and arms `reform()`.
    collective_groups: names of util.collective groups whose rendezvous
        actors should learn about rank deaths (parked rounds then fail
        with CollectiveRankDiedError) and generation bumps.
    """

    def __init__(self, num_hosts: int, *,
                 resources_per_host: Optional[Dict[str, float]] = None,
                 env_per_host: Optional[Dict[str, str]] = None,
                 spread: bool = False,
                 supervised: bool = False,
                 collective_groups: Sequence[str] = (),
                 pg_timeout: float = 60.0,
                 _host_cls: Optional[type] = None):
        import ray_tpu_torch
        self._ray = ray_tpu_torch
        self.num_hosts = num_hosts
        self.world_size = 0
        self.generation = 0
        self._resources_per_host = dict(
            RANK_RESOURCES if resources_per_host is None
            else resources_per_host)
        self._env_per_host = dict(env_per_host or {})
        self._spread = spread
        self._supervised = supervised
        self._collective_groups = tuple(collective_groups)
        self._pg_timeout = pg_timeout
        self._host_cls = _host_cls or _SpmdHost
        self._pg = None
        self._supervisor = None
        self.hosts: List[Any] = []
        self._gang_up(num_hosts)
        if supervised:
            self._start_supervisor()

    # ------------------------------------------------------------------
    # construction / teardown
    # ------------------------------------------------------------------
    def _actor_cls(self):
        from ..api import remote
        opts: Dict[str, Any] = {}
        res = dict(self._resources_per_host)
        opts["num_cpus"] = res.pop("CPU", 1)
        gpus = res.pop("GPU", 0)
        if gpus:
            opts["num_gpus"] = gpus
        if res:
            opts["resources"] = res
        if self._env_per_host:
            opts["runtime_env"] = {"env_vars": dict(self._env_per_host)}
        return remote(**opts)(self._host_cls)

    def _gang_up(self, world: int) -> None:
        """Spawn `world` rank actors, gang-place them, and join the
        torch.distributed world. Failure anywhere (placement timeout, a
        rank crashing in join) kills every already-spawned actor and
        removes the placement group — a failed gang must not leak its
        partially-built world."""
        actor_cls = self._actor_cls()
        pg = None
        hosts: List[Any] = []
        try:
            if self._spread:
                from ..util.placement_group import placement_group
                pg = placement_group(
                    [dict(self._resources_per_host or {"CPU": 1})] * world,
                    strategy="STRICT_SPREAD")
                if not pg.wait(self._pg_timeout):
                    raise RuntimeError(
                        f"could not gang {world} hosts (placement group "
                        "not ready)")
            for rank in range(world):
                a = actor_cls
                if pg is not None:
                    a = actor_cls.options(placement_group=pg,
                                          bundle_index=rank)
                hosts.append(a.remote(rank, world, self.generation))
            # Rank 0 picks the coordinator endpoint on its own host, then
            # every rank joins concurrently (the join barrier resolves once
            # all are in). Failures surface through these gets.
            coordinator = self._ray.get(
                hosts[0].pick_coordinator.remote(), timeout=120)
            descs = self._ray.get(
                [h.join.remote(coordinator) for h in hosts],
                timeout=180)
        except BaseException:
            self._teardown_actors(hosts, pg)
            raise
        self.hosts = hosts
        self._pg = pg
        self.coordinator = coordinator
        self.world_size = world
        self.world_devices = descs[0]["global_devices"]
        self._pids = [d["pid"] for d in descs]

    def _teardown_actors(self, hosts, pg) -> None:
        for h in hosts:
            try:
                self._ray.kill(h)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        if pg is not None:
            from ..util.placement_group import remove_placement_group
            try:
                remove_placement_group(pg)
            except Exception:  # noqa: BLE001
                pass

    def _start_supervisor(self) -> None:
        from .elastic import GangSupervisor
        members = {rank: h.actor_id for rank, h in enumerate(self.hosts)}
        self._supervisor = GangSupervisor(
            members, generation=self.generation,
            collective_groups=self._collective_groups)

    # ------------------------------------------------------------------
    # supervision surface
    # ------------------------------------------------------------------
    @property
    def failure(self):
        """First RankDeath seen by the supervisor (None while healthy)."""
        return self._supervisor.first_death if self._supervisor else None

    def wait_failure(self, timeout: Optional[float] = None):
        """Block until a rank dies (or timeout); returns the RankDeath."""
        if self._supervisor is None:
            raise RuntimeError("gang is not supervised "
                               "(pass supervised=True)")
        return self._supervisor.wait(timeout)

    # ------------------------------------------------------------------
    # reform
    # ------------------------------------------------------------------
    def _fits(self, world: int, need: Dict[str, float]) -> bool:
        avail = self._ray.available_resources()
        for r, v in need.items():
            if v and avail.get(r, 0.0) + 1e-9 < v * world:
                return False
        if self._spread:
            alive = sum(1 for n in self._ray.nodes() if n.get("alive"))
            if alive < world:
                return False
        return True

    def _feasible_world(self, target: int, replace_deadline: float,
                        deadline: float) -> int:
        """Largest world the cluster can hold: wait up to the replace
        window for FULL capacity (a replacement host may be seconds from
        freeing/rejoining), then settle for the largest feasible size,
        polling until the reform deadline before giving up."""
        need = dict(self._resources_per_host)
        need.setdefault("CPU", 1)
        while time.monotonic() < replace_deadline:
            if self._fits(target, need):
                return target
            time.sleep(0.1)
        while time.monotonic() < deadline:
            for k in range(target, 0, -1):
                if self._fits(k, need):
                    return k
            time.sleep(0.25)
        return 0

    def reform(self, *, timeout: Optional[float] = None,
               min_hosts: int = 1) -> Dict[str, Any]:
        """Tear down the current (doomed) world and re-gang.

        Killing every rank process IS the clean teardown of the
        torch.distributed world: surviving ranks are parked inside
        collectives that can never complete (an NCCL rank never
        returns), and a fresh world needs fresh processes anyway. The
        new gang starts once the old rank processes of this host have
        exited, so their card memory is free. The gang comes back at full size when the cluster has
        capacity for `num_hosts` ranks within RAY_TPU_GANG_REPLACE_WAIT_S,
        otherwise RESHARDED onto the largest feasible world (>=
        min_hosts). Collective groups are advanced to the new
        generation first, so zombie ranks of the old world fence out
        instead of corrupting the new world's rounds.

        Returns {"world_size", "generation", "resharded", "deaths"}.
        Raises GangReformError when nothing >= min_hosts fits within
        RAY_TPU_GANG_REFORM_TIMEOUT_S (or `timeout`).
        """
        from ..exceptions import GangReformError
        from ..util import events
        from ..util.collective import advance_group_generation
        from .elastic import reform_timeout_s, replace_wait_s

        t0 = time.monotonic()
        budget = timeout if timeout is not None else reform_timeout_s()
        deadline = t0 + budget
        deaths = []
        if self._supervisor is not None:
            deaths = list(self._supervisor.deaths)
            self._supervisor.stop()
            self._supervisor = None
        old_world = self.world_size
        self._teardown_actors(self.hosts, self._pg)
        self.hosts = []
        self._pg = None
        self.generation += 1
        _wait_exited(self._pids, deadline)

        replace_deadline = min(deadline, t0 + replace_wait_s())
        world = self._feasible_world(self.num_hosts, replace_deadline,
                                     deadline)
        if world < max(min_hosts, 1):
            raise GangReformError(
                f"gang reform failed: no feasible world >= "
                f"{max(min_hosts, 1)} hosts within {budget:.0f}s "
                f"(requested {self.num_hosts}, last world {old_world})")
        resharded = world < self.num_hosts
        for g in self._collective_groups:
            advance_group_generation(g, self.generation, world)
        try:
            self._gang_up(world)
        except BaseException as e:
            raise GangReformError(
                f"gang reform failed re-ganging {world} hosts "
                f"(generation {self.generation}): {e!r}") from e
        if self._supervised:
            self._start_supervisor()
        took = time.monotonic() - t0
        kind = "resharded" if resharded else "replaced"
        events.emit_safe(
            "train.gang.reform",
            f"gang reformed ({kind}) {old_world} -> {world} ranks in "
            f"{took:.2f}s", counter="ray_tpu_train_gang_reforms_total",
            counter_tags={"kind": kind},
            old_world=str(old_world), world=str(world),
            generation=str(self.generation), seconds=f"{took:.3f}")
        if resharded:
            events.emit_safe(
                "train.gang.reshard",
                f"no replacement capacity for {self.num_hosts} ranks; "
                f"gang resharded onto the surviving world ({world} "
                "ranks, dp axis shrunk)",
                world=str(world), requested=str(self.num_hosts),
                generation=str(self.generation))
        return {"world_size": world, "generation": self.generation,
                "resharded": resharded, "seconds": took,
                "deaths": [(d.rank, d.cause) for d in deaths]}

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Execute fn(rank, world, *args) on every rank; returns results
        ordered by rank."""
        return self._ray.get(self.run_async(fn, *args, **kwargs),
                             timeout=600)

    def run_async(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Submit fn(rank, world, *args) on every rank; returns the
        per-rank refs (the elastic fit loop waits on these alongside
        the supervisor's failure signal)."""
        return [h.run.remote(fn, *args, **kwargs) for h in self.hosts]

    def run_sharded(self, fn: Callable, per_rank_args: List[Any],
                    timeout: float = 600.0) -> List[Any]:
        """Execute fn(rank, world, shard) with a DIFFERENT payload per
        rank (multihost data loading: each host gets its batch shard).
        Shards ship as object refs, so each rank's worker pulls its
        share straight from the holding node over the transfer plane
        (core/object_transfer.py) — the driver only brokers locations,
        and per-step input bandwidth scales with the number of hosts
        instead of the single controller socket."""
        if len(per_rank_args) != self.world_size:
            raise ValueError(
                f"need one shard per rank: got {len(per_rank_args)} "
                f"for {self.world_size} hosts")
        refs = [self._ray.put(a) for a in per_rank_args]
        try:
            return self._ray.get(
                [h.run.remote(fn, r) for h, r in zip(self.hosts, refs)],
                timeout=timeout)
        finally:
            try:
                self._ray.free(refs)
            except Exception:
                pass

    def shutdown(self) -> None:
        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        self._teardown_actors(self.hosts, self._pg)
        self.hosts = []
        self._pg = None


def _wait_exited(pids: Sequence[int], deadline: float) -> None:
    """Wait (until `deadline`, monotonic) for the given local processes
    to exit; an exited child not yet reaped (a zombie) holds no memory
    and counts as exited. A pid of another host is simply not found."""
    for pid in pids:
        while time.monotonic() < deadline and _running(pid):
            time.sleep(0.05)


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            # the state follows the parenthesised command name
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


__all__ = ["MultiHostSpmd"]
