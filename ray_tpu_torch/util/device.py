"""Device selection for the port's entry points.

Entry points default to the GPU. Asking for CUDA on a machine without
one raises: nothing carries on silently on the CPU unless the caller
passed `device="cpu"`.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "to run the plain PyTorch path")
    return dev
