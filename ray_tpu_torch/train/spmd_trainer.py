"""SpmdTrainer: declarative model+mesh trainer (counterpart of
ray_tpu/train/spmd_trainer.py; the TorchTrainer analogue for the common
LLM case).

Instead of wrapping user torch code, the common case is declared:
model (name or module), mesh spec, optimizer, data iterator. The
trainer owns the step, the device loader, logging, checkpointing and
restore. It needs no runtime: `fit` runs in each rank of
`train.backend.launch` (every rank calls it with the same config and a
model holding the same weights), or in a world of one.
`ElasticSpmdTrainer` runs it on a supervised `MultiHostSpmd` gang of
rank actors and reforms the gang when a rank dies.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import MeshSpec, build_mesh
from ..util.device import resolve_device
from .checkpoint import CheckpointManager, _world, restore_pytree
from .config import RunConfig
from .multihost import RANK_RESOURCES
from .optim import make_optimizer, warmup_cosine
from ..util import knobs
from .result import Result
from .spmd import make_train_step


@dataclasses.dataclass
class SpmdTrainerConfig:
    model: Any                          # nn.Module or registry name
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    log_every: int = 10
    checkpoint_every: int = 0
    grad_clip: float = 1.0
    seed: int = 0                       # a registry model's init
    device: str = "cuda"


class SpmdTrainer:
    def __init__(self, config: SpmdTrainerConfig,
                 data_iter_fn: Callable[[], Iterator[Dict[str, Any]]],
                 run_config: Optional[RunConfig] = None,
                 report_fn: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.cfg = config
        self.data_iter_fn = data_iter_fn
        self.run_config = run_config or RunConfig(name="spmd_trainer")
        self.report_fn = report_fn

    def fit(self, resume_from: Optional[str] = None) -> Result:
        """Train from step 0, or from the step of the checkpoint at
        `resume_from`, to `total_steps`; step i trains on batch i of
        `data_iter_fn()` (a new iterator when one runs out).

        The mesh is `cfg.mesh` over the world; a spec that does not fit
        the world falls back to dp over every rank (the reference's
        dp over every device). A world of one with a spec of size 1
        takes the plain step, on the module as it is: the reference's
        mesh of one device adds nothing, where FSDP2 over a mesh of one
        would copy every block's weights in and out of its buffers.

        Batches reach the card through `data.device_put_iterator`. On a
        mesh it copies this rank's rows only, and the step takes that
        `LocalBatch` as this rank's share; without a mesh the batch is
        the global one. The first host batch only sets the step up (the
        port's init runs nothing on it) and is also batch 0."""
        from ..data.device_loader import device_put_iterator
        cfg = self.cfg
        dev = resolve_device(cfg.device)
        model = cfg.model
        if isinstance(model, str):
            from ..models import get_model
            model = get_model(model, device=dev, seed=cfg.seed)
        world = _world()
        spec = cfg.mesh
        if spec.size != world:
            spec = MeshSpec(dp=world) if world > 1 else MeshSpec()
        mesh = build_mesh(spec, device=dev.type) if spec.size > 1 else None

        schedule = warmup_cosine(cfg.learning_rate, cfg.warmup_steps,
                                 cfg.total_steps)
        tx = make_optimizer(cfg.optimizer, schedule=schedule,
                            grad_clip=cfg.grad_clip)

        data = self.data_iter_fn()
        first = next(data)
        example = {k: torch.from_numpy(np.asarray(v))
                   for k, v in first.items()}
        state, step_fn = make_train_step(model, tx, mesh)(example)
        sharding = step_fn.batch_shardings if mesh is not None else None

        manager = CheckpointManager(
            self.run_config.run_dir() + "/checkpoints",
            self.run_config.checkpoint_config.num_to_keep)
        start_step = 0
        if resume_from:
            state = restore_pytree(
                resume_from, target=state, map_location=dev,
                shardings=(step_fn.state_shardings if mesh is not None
                           else None))
            start_step = int(state.step)
            first, data = _fast_forward_batches(
                data, {k: np.asarray(v) for k, v in first.items()},
                start_step, self.data_iter_fn)

        def loader(host):
            return device_put_iterator(host, sharding=sharding, device=dev)

        feed = loader(itertools.chain([first], data))
        history = []
        try:
            batch = next(feed)
            tokens_acc, t_last = 0, time.time()
            for i in range(start_step, cfg.total_steps):
                state, metrics = step_fn(state, batch)
                tokens_acc += _global_tokens(batch)
                if (i + 1) % cfg.log_every == 0 or i + 1 == cfg.total_steps:
                    # the float conversion waits for the step: the sync
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    m.update(step=i + 1,
                             tokens_per_s=tokens_acc / max(now - t_last,
                                                           1e-9))
                    tokens_acc, t_last = 0, now
                    history.append(m)
                    if self.report_fn:
                        self.report_fn(m)
                if cfg.checkpoint_every and (i + 1) % cfg.checkpoint_every == 0:
                    manager.save(state.state_dict(), i + 1)
                # only draw ahead if another step will run: a finite
                # stream ending at total_steps must not be restarted
                if i + 1 < cfg.total_steps:
                    try:
                        batch = next(feed)
                    except StopIteration:
                        feed.close()
                        feed = loader(self.data_iter_fn())
                        batch = next(feed)
        finally:
            feed.close()

        final_ckpt = None
        if cfg.checkpoint_every:
            final_ckpt = manager.save(state.state_dict(), cfg.total_steps)
        return Result(metrics=history[-1] if history else {},
                      checkpoint=final_ckpt or manager.latest(),
                      metrics_history=history,
                      path=self.run_config.run_dir())


def _global_tokens(batch) -> int:
    """B x S of the global batch: a LocalBatch's rows and sequence times
    its sharding's parts."""
    shape = next(iter(batch.values())).shape
    n = int(np.prod(shape[:2]))
    sharding = getattr(batch, "sharding", None)
    return n if sharding is None else n * sharding.n_rows * sharding.n_seq


def _fast_forward_batches(data: Iterator, first_np: Dict[str, Any],
                          start_step: int, data_iter_fn: Callable):
    """Resume semantics: step i always trains on batch i, so a resumed
    run SKIPS the `start_step` batches the crashed run already consumed
    instead of silently re-training on them. An iterator exposing
    `fast_forward(n)` (stateful loaders: seekable shards, a data-service
    snapshot hook) is asked to seek; absolute: the next batch drawn is
    batch index n. Otherwise batches are drawn and discarded, restarting
    the iterator on exhaustion exactly like the training loop's
    wrap-around (short repeating iterators keep their pre-resume
    alignment only per epoch). `first_np` is batch 0, which the caller
    already drew for init. Returns (batch_for_start_step, iterator); the
    iterator may have been replaced by a restart."""
    if start_step <= 0:
        return first_np, data
    ff = getattr(data, "fast_forward", None)
    if callable(ff):
        ff(start_step)
        nxt = next(data)
        return {k: np.asarray(v) for k, v in nxt.items()}, data
    out = first_np
    for _ in range(start_step):
        try:
            nxt = next(data)
        except StopIteration:
            data = data_iter_fn()
            nxt = next(data)
        out = {k: np.asarray(v) for k, v in nxt.items()}
    return out, data


def _elastic_rank_fn(rank: int, world: int, payload: Dict[str, Any]):
    """One rank's training loop for ElasticSpmdTrainer (runs inside an
    _SpmdHost actor after the rank joined the world): `SpmdTrainer.fit`
    on this world's mesh (the configured one with its dp axis resharded
    onto `world`), resumed from the last committed checkpoint when there
    is one; every rank takes part in each commit (save_pytree gathers a
    sharded state to rank 0).

    With RAY_TPU_ELASTIC_TRACE set, the rank appends its trace to
    `<path>.r<rank>`, one `<time> g<generation> <event>` line each, as the
    reference's rank does: `enter world=<n> pid=<pid>`, `init start`,
    `step <i>` for each step the trainer logs (`log_every`) and `done`."""
    from ..util import events
    from ..util import metrics_catalog as mcat
    from .checkpoint import CheckpointManager
    from .elastic import reshard_mesh_spec

    generation = payload["generation"]
    trace_path = knobs.get_raw("RAY_TPU_ELASTIC_TRACE")

    def _trace(msg: str) -> None:
        if trace_path:
            with open(f"{trace_path}.r{rank}", "a") as f:
                f.write(f"{time.time():.3f} g{generation} {msg}\n")

    _trace(f"enter world={world} pid={os.getpid()}")
    run_config: RunConfig = payload["run_config"]
    cfg = dataclasses.replace(
        payload["config"], mesh=reshard_mesh_spec(payload["config"].mesh,
                                                  world))
    manager = CheckpointManager(
        os.path.join(run_config.run_dir(), "checkpoints"),
        run_config.checkpoint_config.num_to_keep)
    latest = manager.latest()
    start_step = 0
    if latest is not None:
        start_step = int(latest.metadata().get("step") or 0)
        if rank == 0:
            events.emit_safe(
                "train.restore",
                f"restoring committed checkpoint step {start_step} onto a "
                f"{world}-rank world (generation {generation})",
                step=str(start_step), generation=str(generation),
                world=str(world))
    t0 = time.monotonic()
    _trace("init start")
    trainer = SpmdTrainer(cfg, payload["data_iter_fn"], run_config=run_config,
                          report_fn=lambda m: _trace(f"step {m['step'] - 1}"))
    result = trainer.fit(resume_from=latest.path if latest else None)
    _trace("done")
    if latest is not None and rank == 0:
        try:
            mcat.get("ray_tpu_train_restore_seconds").observe(
                time.monotonic() - t0)
        except Exception:  # noqa: BLE001 — telemetry never fails work
            pass
    history = [dict(m, generation=generation, world=world)
               for m in result.metrics_history]
    # an already-complete restore (death raced the final commit) yields
    # an empty history; the metrics still name the terminal step
    last = history[-1] if history else {
        "step": start_step, "world": world, "generation": generation}
    ckpt = result.checkpoint
    return {"rank": rank, "world": world, "generation": generation,
            "start_step": start_step, "history": history,
            "metrics": last, "checkpoint": ckpt.path if ckpt else None}


class ElasticSpmdTrainer:
    """Gang-supervised SpmdTrainer over rank actors with checkpoint-resume
    (counterpart of ray_tpu/train/spmd_trainer.py's ElasticSpmdTrainer).

    fit() runs the recover cycle end-to-end: train on a supervised
    MultiHostSpmd gang; on a rank death (a killed worker, a lost host)
    the supervisor flags it in ~RAY_TPU_GANG_PROBE_S, the gang reforms
    — killing the survivors' processes tears the old NCCL world down;
    replaced at full size when the cluster has capacity, otherwise
    RESHARDED onto the surviving world — and every new rank restores the
    last COMMITTED checkpoint (`restore_pytree`) and continues from its
    step. Emits the `train.gang.rank_death` -> `train.gang.reform`
    (/`train.gang.reshard`) -> `train.restore` event chain.

    `data_iter_fn` must be deterministic per process (every rank draws
    the same global batch stream); resume skips batches consumed before
    the last committed checkpoint. `config.model` is a registry name or
    a module (each rank gets a copy through the object store).
    `resources_per_host` is what each rank's actor reserves, as in
    MultiHostSpmd: one CPU and one GPU by default, so each rank trains
    on its own card; {"CPU": 1} with `config.device="cpu"` asks for a
    CPU world over gloo.
    """

    def __init__(self, config: SpmdTrainerConfig,
                 data_iter_fn: Callable[[], Iterator[Dict[str, Any]]],
                 *, num_hosts: int,
                 resources_per_host: Optional[Dict[str, float]] = None,
                 env_per_host: Optional[Dict[str, str]] = None,
                 spread: bool = False,
                 run_config: Optional[RunConfig] = None,
                 max_failures: Optional[int] = None,
                 collective_groups: Sequence[str] = ()):
        self.cfg = config
        self.data_iter_fn = data_iter_fn
        self.num_hosts = num_hosts
        self.resources_per_host = dict(
            RANK_RESOURCES if resources_per_host is None
            else resources_per_host)
        self.env_per_host = env_per_host
        self.spread = spread
        self.run_config = run_config or RunConfig(name="elastic_spmd")
        if max_failures is None:
            mf = self.run_config.failure_config.max_failures
            max_failures = mf if mf > 0 \
                else knobs.get_int("RAY_TPU_TRAIN_MAX_FAILURES")
        self.max_failures = max_failures
        self.collective_groups = tuple(collective_groups)

    def _payload(self, gang) -> Dict[str, Any]:
        return {"config": self.cfg, "run_config": self.run_config,
                "generation": gang.generation,
                "data_iter_fn": self.data_iter_fn}

    def _await_round(self, gang, refs) -> bool:
        """True when every rank finished; False the moment the
        supervisor flags a death (the refs then belong to a doomed
        world and are abandoned)."""
        import ray_tpu_torch
        pending = list(refs)
        while True:
            if gang.failure is not None:
                return False
            _done, pending = ray_tpu_torch.wait(
                pending, num_returns=len(pending), timeout=0.5)
            if not pending:
                # all refs settled (a just-dead rank's ref settles as an
                # error); the get() in fit() decides success vs reform
                return True

    def fit(self) -> Result:
        import ray_tpu_torch
        from ..exceptions import ActorDiedError, TaskError, error_cause_is
        from .checkpoint import Checkpoint, CheckpointManager
        from .multihost import MultiHostSpmd

        cfg = self.cfg
        if not cfg.checkpoint_every:
            raise ValueError(
                "ElasticSpmdTrainer needs checkpoint_every > 0: without "
                "committed checkpoints a reform would restart from "
                "step 0")
        run_dir = self.run_config.run_dir()
        gang = MultiHostSpmd(
            self.num_hosts, resources_per_host=self.resources_per_host,
            env_per_host=self.env_per_host, spread=self.spread,
            supervised=True, collective_groups=self.collective_groups)
        failures = 0
        try:
            while True:
                refs = gang.run_async(_elastic_rank_fn,
                                      self._payload(gang))
                if self._await_round(gang, refs):
                    try:
                        results = ray_tpu_torch.get(refs, timeout=120)
                        break
                    except (ActorDiedError, TaskError) as e:
                        # A survivor's collateral failure (its collective
                        # died under it) can settle BEFORE the supervisor
                        # flags the rank death — give the watch a grace
                        # before calling it a training bug.
                        if isinstance(e, TaskError) \
                                and not error_cause_is(
                                    e, "CollectiveRankDiedError",
                                    "CollectiveStaleGenerationError") \
                                and gang.wait_failure(timeout=3.0) is None:
                            raise   # a training error, not elasticity
                failures += 1
                if failures > self.max_failures:
                    death = gang.failure
                    raise RuntimeError(
                        f"elastic training exceeded max_failures="
                        f"{self.max_failures}; last death: "
                        f"{death and death.cause}")
                gang.reform()
        finally:
            gang.shutdown()
        r0 = results[0]
        manager = CheckpointManager(
            os.path.join(run_dir, "checkpoints"),
            self.run_config.checkpoint_config.num_to_keep)
        ckpt = (Checkpoint(r0["checkpoint"]) if r0.get("checkpoint")
                else manager.latest())
        return Result(metrics=r0["metrics"], checkpoint=ckpt,
                      metrics_history=r0["history"], path=run_dir,
                      config={"num_hosts": self.num_hosts,
                              "final_world": r0["world"],
                              "generations": gang.generation,
                              "failures": failures})


__all__ = ["SpmdTrainerConfig", "SpmdTrainer", "ElasticSpmdTrainer"]
