"""Training loops and rank functions for the trainers over rank actors.

The runtime pickles a function of an importable module by reference into
its worker processes, so the bodies the rank actors run in the tests
live here, in the port, where importing them loads neither JAX nor the
JAX package. They take plain data (numpy weights and batches made by the
caller from a seed) and run on the CPU.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch


def llama_loop(config: Dict[str, Any]) -> None:
    """A TorchTrainer loop: a Llama of `config["widths"]` in fp32 holding
    `config["state_dict"]`, trained by the port's `make_train_step` with
    `config["optimizer"]` at `config["lr"]`, one step a batch of
    `config["batches"]`. Each step commits a checkpoint under
    `config["ckpt_root"]` and reports its loss and grad_norm. A restart
    resumes from `config["resume_from_checkpoint"]`. With
    `config["crash_at"]` = n the process exits before step n the first
    time (`config["crash_marker"]` records that it did)."""
    from ..models import Llama, LlamaConfig
    from . import get_context, report
    from .checkpoint import CheckpointManager, restore_pytree
    from .optim import make_optimizer
    from .spmd import make_train_step

    model = Llama(LlamaConfig(**config["widths"], dtype=torch.float32,
                              param_dtype=torch.float32), device="cpu")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in config["state_dict"].items()})
    tx = make_optimizer(config["optimizer"], learning_rate=config["lr"])
    batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
               for b in config["batches"]]
    state, step = make_train_step(model, tx)(batches[0])
    start = 0
    resume = config.get("resume_from_checkpoint")
    if resume:
        state = restore_pytree(resume, target=state, map_location="cpu")
        start = int(state.step)
    manager = CheckpointManager(config["ckpt_root"], None)
    marker = config.get("crash_marker")
    for i in range(start, len(batches)):
        if i + 1 == config.get("crash_at") and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        state, m = step(state, batches[i])
        ckpt = manager.save(state.state_dict(), i + 1)
        report({"step": i + 1, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "rank": get_context().get_world_rank()}, checkpoint=ckpt)


def debug_batches(rows: int = 4, seq: int = 17, vocab: int = 256,
                  seed: int = 0, delay_s: float = 0.0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """The same endless stream of token batches in every process, each
    after `delay_s` seconds (a test paces a fit with it)."""
    rng = np.random.RandomState(seed)
    while True:
        time.sleep(delay_s)
        yield {"tokens": rng.randint(0, vocab, (rows, seq)).astype(np.int64)}


def allreduce_rank(rank: int, world: int) -> Dict[str, Any]:
    """One all-reduce over the rank's world: each rank gives rank + 1."""
    import torch.distributed as dist
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "sum": float(x.item()),
            "pid": os.getpid()}


def allreduce_loop(config: Dict[str, Any]) -> None:
    """A TorchTrainer loop over its world's process group: each rank
    all-reduces rank + 1 and reports the sum."""
    import torch.distributed as dist
    from . import get_context, report
    ctx = get_context()
    x = torch.tensor([float(ctx.get_world_rank() + 1)])
    dist.all_reduce(x)
    report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size(),
            "group": dist.get_world_size(), "sum": float(x.item())})


def shard_sum(rank: int, world: int, shard) -> float:
    return float(np.asarray(shard).sum())


__all__ = ["llama_loop", "allreduce_loop", "debug_batches",
           "allreduce_rank", "shard_sum"]
