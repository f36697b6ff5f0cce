"""SpmdTrainer: declarative model+mesh trainer (counterpart of
ray_tpu/train/spmd_trainer.py; the TorchTrainer analogue for the common
LLM case).

Instead of wrapping user torch code, the common case is declared:
model (name or module), mesh spec, optimizer, data iterator. The
trainer owns the step, the device loader, logging, checkpointing and
restore. It needs no runtime: `fit` runs in each rank of
`train.backend.launch` (every rank calls it with the same config and a
model holding the same weights), or in a world of one. The elastic,
gang-supervised variant needs the runtime's actors and waits for a
later slice.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import MeshSpec, build_mesh
from ..util.device import resolve_device
from .checkpoint import CheckpointManager, _world, restore_pytree
from .config import RunConfig
from .optim import make_optimizer, warmup_cosine
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


__all__ = ["SpmdTrainerConfig", "SpmdTrainer"]
