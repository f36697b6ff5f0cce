"""Backend setup: the per-rank process group, mesh formation and a local
launcher (counterpart of ray_tpu/train/backend.py).

JAX is single-controller: one process sees every device and
`jax.distributed.initialize` joins hosts. PyTorch runs one process per
rank, so here `setup_worker` joins this process to the world with
`torch.distributed.init_process_group` (NCCL for CUDA, gloo for the
CPU) and `launch` is the counterpart of "one process sees every
device": it starts `world` rank processes on this host, runs one
function in each and returns their results.

`launch` rendezvouses through a `file://` in a fresh temporary
directory, so parallel launches (test workers) never race for a port.
Every group has a timeout, the launcher a deadline: a rank that fails
or outlives it takes its whole world down and `launch` raises with the
rank's traceback.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

from ..util import knobs


@dataclasses.dataclass
class TorchBackendConfig:
    """Reference analogue: JaxBackendConfig. `init_method` is the
    rendezvous ("tcp://host:port" of rank 0, or "file://<path>");
    `backend` None picks NCCL for CUDA and gloo for the CPU."""
    init_method: Optional[str] = None
    world_size: Optional[int] = None
    backend: Optional[str] = None
    timeout_s: float = 100.0


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def setup_worker(config: TorchBackendConfig, *, rank: int,
                 world_size: Optional[int] = None,
                 device="cuda", create_group: bool = True) -> None:
    """Join this process to the world as `rank` (reference:
    setup_worker's jax.distributed.initialize). A CUDA rank takes
    `cuda:<rank % device_count>`. At world 1 a group of one is still
    made, so a mesh can form over it, unless the caller passes
    `create_group=False`; an initialized group is left as it is."""
    import torch.distributed as dist
    world = world_size or config.world_size or knobs.train_world()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if dist.is_initialized() or (world <= 1 and not create_group):
        return
    init = config.init_method or knobs.coordinator()
    if init is None:
        raise ValueError("setup_worker needs config.init_method (or "
                         f"{knobs.COORDINATOR}) for the rendezvous")
    kw = {}
    if dev.type == "cuda":
        # bind the communicator to this rank's card up front
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        config.backend or _backend_for(dev), init_method=init,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=config.timeout_s), **kw)


def form_mesh(spec=None, device="cuda"):
    """Build the world's device mesh; every rank passes the same spec
    (default: dp over the world)."""
    import torch.distributed as dist

    from ..parallel.mesh import MeshSpec, build_mesh
    spec = spec or MeshSpec(dp=dist.get_world_size())
    return build_mesh(spec, device=device)


def worker_env(rank: int, world_size: int,
               coordinator_address: Optional[str]) -> dict:
    """Env block a launcher gives each rank process (reference: the
    RANK / WORLD_SIZE / MASTER_ADDR block of torch's backend)."""
    env = {knobs.TRAIN_RANK: str(rank), knobs.TRAIN_WORLD: str(world_size)}
    if coordinator_address:
        env[knobs.COORDINATOR] = coordinator_address
    return env


def detect_rank() -> int:
    return knobs.train_rank()


def detect_world_size() -> int:
    return knobs.train_world()


def _rank_main(fn, rank, world, device, init, timeout_s, results, args):
    """Body of one rank process: join the world, run fn, post
    (rank, ok, result or traceback)."""
    import torch.distributed as dist
    try:
        os.environ.update(worker_env(rank, world, init))
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)     # `world` ranks share the cores
        setup_worker(TorchBackendConfig(init_method=init,
                                        timeout_s=timeout_s),
                     rank=rank, world_size=world, device=device)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the launcher
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_in_process(fn, device, timeout_s, args):
    """A world of one in this process (no spawn), torn down after."""
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="rtpu_rdv_")
    try:
        setup_worker(TorchBackendConfig(
            init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            timeout_s=timeout_s), rank=0, world_size=1, device=device)
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launch(fn: Callable, world: int, device, *args,
           timeout_s: float = 300.0, spawn: bool = True) -> List[Any]:
    """Run `fn(*args)` in `world` rank processes joined into one process
    group, and return the ranks' results in rank order.

    `fn` must be importable from the port (it is pickled by reference
    into freshly spawned interpreters) and return picklable values; a
    calling script guards its top level with `if __name__ ==
    "__main__"`, as every spawning program must. A
    CUDA world takes cards 0..world-1 and may not exceed
    `torch.cuda.device_count()`. Each group has a `timeout_s` timeout;
    the ranks must all finish within `timeout_s` of the launch, or every
    rank still running is killed and RuntimeError raised; so is it when
    any rank fails, with that rank's traceback. `spawn=False` at world 1
    runs fn in this process on a world of one."""
    import torch.multiprocessing as mp
    dev = torch.device(device)
    if world < 1:
        raise ValueError(f"world={world}")
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n:
            raise RuntimeError(f"a CUDA world of {world} ranks needs "
                               f"{world} cards; this machine has {n}")
    if not spawn:
        if world != 1:
            raise ValueError("spawn=False runs a world of one only")
        return _run_in_process(fn, device, timeout_s, args)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rtpu_rdv_")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(device), init, timeout_s,
                               results, args))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    failure = None
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"deadline of {timeout_s:.0f} s passed with "
                           f"ranks {sorted(set(range(world)) - set(out))} "
                           f"unfinished")
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failure = (f"rank {dead[0]} died with exit code "
                               f"{procs[dead[0]].exitcode}")
                continue
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
        if failure is None:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, "
                           f"world={world}, {device}): {failure}")
    return [out[r] for r in range(world)]


__all__ = ["TorchBackendConfig", "setup_worker", "form_mesh", "worker_env",
           "detect_rank", "detect_world_size", "launch"]
