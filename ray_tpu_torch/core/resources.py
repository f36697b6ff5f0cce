"""Resource model with the GPU as the accelerator (counterpart of
ray_tpu/core/resources.py).

Reference parity: python/ray/_private/resource_spec.py and
python/ray/_private/accelerators/nvidia_gpu.py. GPUs are native
schedulable resources ("GPU"); a task or actor that asks for
`num_gpus=k` is granted k specific card indices (`get_gpu_ids`) and runs
with `CUDA_VISIBLE_DEVICES` set to them. A request below one card (Ray's
fractional GPUs, e.g. 0.5) holds that share of one card and is granted
that card's index; holders share the card until their shares reach 1.
The card's memory is not partitioned between them, as in Ray.

Deliberate difference from the reference: its TPU pod labels and the
"TPU-<pod_type>-head" gang resource have no GPU counterpart, and none is
invented; node labels are empty here.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from ..util import knobs


def detect_node_resources(num_cpus: Optional[int] = None,
                          num_gpus: Optional[int] = None) -> Dict[str, float]:
    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
        # The runtime itself needs headroom; still expose at least 4 virtual
        # CPU slots so task-parallel libraries (data/tune) can overlap work —
        # CPUs in ray (and here) are scheduling tokens, not pinned cores.
        num_cpus = max(num_cpus, 4)
    res: Dict[str, float] = {"CPU": float(num_cpus)}
    if num_gpus is None:
        num_gpus = detect_gpus()
    if num_gpus:
        res["GPU"] = float(num_gpus)
    res["memory"] = float(_detect_memory_bytes())
    return res


def detect_gpus() -> int:
    """This host's GPU count: RAY_TPU_GPUS when set (0 is a real override:
    force a node without GPUs), else `torch.cuda.device_count()`, which
    counts only the cards CUDA_VISIBLE_DEVICES shows. Counting does not
    create a CUDA context in the calling process (the driver's cards stay
    free for its workers)."""
    env = knobs.get_int("RAY_TPU_GPUS")
    if env is not None:
        return env
    try:
        import torch  # noqa: PLC0415
    except ImportError:
        return 0
    return int(torch.cuda.device_count())


def _detect_memory_bytes() -> int:
    try:
        import psutil  # noqa: PLC0415
        return int(psutil.virtual_memory().total * 0.7)
    except Exception:
        return 8 << 30


def fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items() if v > 0)


def acquire(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) - v


def release(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) + v


def check_gpu_request(req: Dict[str, float]) -> None:
    """A GPU request is a share of one card (below 1) or a whole number
    of cards, as in Ray: 1.5 names neither and raises."""
    gpus = float(req.get("GPU", 0) or 0)
    if gpus >= 1 and gpus != int(gpus):
        raise ValueError(f"a GPU request must be a share of one card "
                         f"(below 1) or a whole number of cards, got "
                         f"{gpus:g}")


def normalize_task_resources(num_cpus=None, num_gpus=None, resources=None,
                             memory=None, default_cpus: float = 1.0) -> Dict[str, float]:
    req: Dict[str, float] = dict(resources or {})
    req["CPU"] = float(default_cpus if num_cpus is None else num_cpus)
    if num_gpus:
        req["GPU"] = float(num_gpus)
    if memory:
        req["memory"] = float(memory)
    check_gpu_request(req)
    return {k: v for k, v in req.items() if v > 0}
