"""TorchTrainer: distributed training driver over rank actors
(counterpart of ray_tpu/train/trainer.py's JaxTrainer).

Reference parity: python/ray/train/base_trainer.py +
data_parallel_trainer.py + torch/torch_trainer.py. Each of
`ScalingConfig.num_workers` ranks is an actor placed with
`ScalingConfig.worker_resources()` (a GPU each unless `use_gpu=False`),
so under the runtime a rank sees only its own card (`cuda:0`). Where the
reference runs one worker a host and leaves the collectives to XLA, a
world of more than one rank here joins one torch.distributed process
group before the loop runs (`train.backend.setup_worker`: NCCL on cards,
gloo on the CPU), rendezvousing at a `tcp://` address rank 0 picks on
its own host; a world of one runs the loop with no group.

Fault tolerance (reference FailureConfig semantics): if a worker dies and
failure budget remains, the whole group restarts from the latest checkpoint
(passed to the loop as `config["resume_from_checkpoint"]`).
"""
from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core import runtime as runtime_mod
from ..exceptions import ActorDiedError, RayTpuError, WorkerCrashedError
from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig
from .result import Result
from .session import TrainContext, init_session, clear_session

_trainer_ids = itertools.count()


class _TrainWorker:
    """Actor hosting one rank's training loop."""

    def __init__(self, ctx: TrainContext, channel: str):
        self.ctx = ctx
        self.channel = channel

    def pick_rendezvous(self) -> str:
        """Rank 0's `tcp://` rendezvous, on its own host."""
        from ..util.netutil import free_port, routable_ip
        return f"tcp://{routable_ip()}:{free_port()}"

    def run(self, fn: Callable, config: Dict[str, Any],
            resume_from: Optional[str],
            init_method: Optional[str] = None) -> str:
        import torch.distributed as dist
        rt = runtime_mod.get_runtime()

        def report_fn(payload):
            rt.report(self.channel, payload)

        ctx = self.ctx
        if ctx.world_size > 1:
            from .backend import TorchBackendConfig, setup_worker
            setup_worker(TorchBackendConfig(init_method=init_method),
                         rank=ctx.world_rank, world_size=ctx.world_size,
                         device="cuda" if api.get_gpu_ids() else "cpu")
        session = init_session(ctx, report_fn)
        session.resume_from = resume_from
        try:
            if resume_from is not None:
                config = dict(config or {})
                config.setdefault("resume_from_checkpoint", resume_from)
            fn(config) if config is not None else fn({})
            return "done"
        finally:
            clear_session()
            if ctx.world_size > 1 and dist.is_initialized():
                dist.destroy_process_group()

    def ping(self):
        return "pong"


class TorchTrainer:
    """Runs `train_loop_per_worker(config)` on `scaling_config.num_workers`
    rank actors (the reference's JaxTrainer, whose arguments it takes).
    Each rank holds a GPU unless `ScalingConfig(use_gpu=False)`; on a
    cluster without GPUs such a request stays infeasible, as a TPU
    request does in the reference. Inside the loop `train.report` /
    `train.get_context` reach this run; the loop finds
    `config["resume_from_checkpoint"]` after a restart."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self._fn = train_loop_per_worker
        self._config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self._resume = resume_from_checkpoint
        self._tid = next(_trainer_ids)
        self.channel = f"train:{self._tid}"

    # -- internals ----------------------------------------------------------
    def _spawn_group(self, resume_from: Optional[str]):
        workers = []
        refs = []
        res = self.scaling.worker_resources()
        n = self.scaling.num_workers
        for rank in range(n):
            ctx = TrainContext(world_size=n, world_rank=rank,
                               local_rank=rank,
                               experiment_name=self.run_config.name)
            actor_cls = api.remote(
                num_cpus=res.get("CPU", 1),
                num_gpus=res.get("GPU", 0),
                resources={k: v for k, v in res.items()
                           if k not in ("CPU", "GPU")},
            )(_TrainWorker)
            w = actor_cls.remote(ctx, self.channel)
            workers.append(w)
        init = (api.get(workers[0].pick_rendezvous.remote())
                if n > 1 else None)
        for rank, w in enumerate(workers):
            cfg = dict(self._config)
            if self.datasets:
                cfg["datasets"] = {
                    k: self._shard_dataset(ds, rank)
                    for k, ds in self.datasets.items()}
            refs.append(w.run.remote(self._fn, cfg, resume_from, init))
        return workers, refs

    def _shard_dataset(self, ds, rank):
        split = getattr(ds, "split_for_worker", None)
        if split is not None:
            return split(rank, self.scaling.num_workers)
        return ds

    def fit(self) -> Result:
        if not api.is_initialized():
            api.init()
        rt = runtime_mod.get_runtime()
        history: List[Dict[str, Any]] = []
        run_dir = self.run_config.run_dir()
        ckpt_root = os.path.join(run_dir, "checkpoints")
        manager = CheckpointManager(
            ckpt_root, self.run_config.checkpoint_config.num_to_keep)

        def on_report(worker_id, payload):
            history.append(payload)

        rt.register_report_handler(self.channel, on_report)

        failures_left = self.run_config.failure_config.max_failures
        resume_from = self._resume.path if self._resume else None
        error: Optional[BaseException] = None

        while True:
            workers, refs = self._spawn_group(resume_from)
            try:
                api.get(refs)
                error = None
                break
            except (ActorDiedError, WorkerCrashedError, RayTpuError) as e:
                error = e
                for w in workers:
                    try:
                        api.kill(w)
                    except Exception:
                        pass
                if failures_left > 0:
                    failures_left -= 1
                    latest = manager.latest()
                    resume_from = latest.path if latest else resume_from
                    continue
                break
            finally:
                for w in workers:
                    try:
                        api.kill(w)
                    except Exception:
                        pass

        final_metrics = history[-1]["metrics"] if history else {}
        ckpt = manager.latest()
        # Also honor checkpoints reported via session.report(path)
        reported = [h.get("checkpoint") for h in history
                    if h.get("checkpoint")]
        if ckpt is None and reported:
            ckpt = Checkpoint(reported[-1])
        return Result(metrics=final_metrics, checkpoint=ckpt, error=error,
                      metrics_history=[h["metrics"] for h in history
                                       if "metrics" in h],
                      path=run_dir)


__all__ = ["TorchTrainer"]
