"""Build-on-first-use for the native components (counterpart of
ray_tpu/_native/build.py).

Compiles <name>.cc, the copy beside this file, into
ray_tpu_torch/_build/native/lib<name>.so with g++ (cached by source
mtime; atomic rename so concurrently-importing worker processes never see
a half-written library). The build directory is the port's own, outside
the package sources, so a checkout builds it afresh.
"""
from __future__ import annotations

import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")


def build_library(name: str) -> str:
    """Return the path to lib<name>.so, compiling if stale or missing."""
    src = os.path.join(_HERE, f"{name}.cc")
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
             src, "-lpthread", "-lrt"],
            check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)   # atomic: racers overwrite with identical .so
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return out
