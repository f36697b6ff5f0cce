"""Build and load the port's CUDA kernels.

Each `ray_tpu_torch/csrc/<name>.cu` exposes a plain C interface and is
compiled by `nvcc` for Hopper (`sm_90a`) into its own shared library,
loaded with `ctypes`. No PyTorch headers are involved, so a source
builds in seconds. The build runs on first use, into
`ray_tpu_torch/_build/` (listed in `.gitignore`); libraries are named by
a hash of their source and flags, so an edit rebuilds and an unchanged
source is reused. `build_all()` starts one `nvcc` per source, all at
once.

Nothing here runs at import time: this module imports on machines with
no `nvcc` and no GPU, where only the plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source under csrc/ (without `.cu`)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "on this machine")


def _target(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    for hdr in sorted(os.listdir(CSRC_DIR)):
        if hdr.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, hdr), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """The nvcc / `-Xptxas -v` log of the library `_target(name)`."""
    return _target(name)[:-len(".so")] + ".log"


def _compile(names: List[str]) -> None:
    """Run one nvcc per missing library, all started together."""
    todo = [(n, _target(n)) for n in names
            if not os.path.exists(_target(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(out[:-len(".so")] + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            # the first errors are the informative ones
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          + log.decode(errors="replace")[:4000])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build every csrc/*.cu (one nvcc each, in parallel) and load them."""
    names = sources()
    with _lock:
        _compile([n for n in names if n not in _libs])
    return {n: load(n) for n in names}


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
