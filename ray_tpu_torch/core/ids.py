"""Unique identifiers for tasks / actors / objects / nodes.

Reference parity: src/ray/common/id.h defines binary TaskID/ObjectID/ActorID
with lineage encoded in the bytes. We keep ids opaque 16-byte hex strings —
lineage lives in the GCS tables instead, which is simpler and sufficient for
a single-controller runtime.
"""
from __future__ import annotations

import os
import random
import threading

_lock = threading.Lock()
_counter = 0
# Fast per-process PRNG seeded once from the OS: os.urandom per id cost
# more than the rest of spec creation combined (~200us/task of a 1k-task
# fan-out was urandom syscalls). Uniqueness comes from the pid+counter
# prefix; the random suffix only guards against pid reuse, so a seeded
# Mersenne twister is plenty. Re-seeded on fork (pid check).
_rng: random.Random = random.Random()
_rng_pid = 0
_FMT: dict = {}


def rand_hex(nhex: int) -> str:
    """nhex random hex chars from the per-process fast PRNG (also the
    backing generator for trace/span ids in util/tracing.py)."""
    global _rng, _rng_pid
    pid = os.getpid()
    if _rng_pid != pid:
        _rng = random.Random(int.from_bytes(os.urandom(16), "little"))
        _rng_pid = pid
    fmt = _FMT.get(nhex)
    if fmt is None:
        fmt = _FMT[nhex] = "%0" + str(nhex) + "x"
    return fmt % _rng.getrandbits(nhex * 4)


def _rand_hex(nbytes: int = 12) -> str:
    global _counter
    with _lock:
        _counter += 1
        c = _counter
        # pid + counter prefix keeps ids unique across forked workers
        # without coordination; random suffix guards against pid reuse.
        suffix = rand_hex((nbytes - 8) * 2)
    return f"{os.getpid():08x}{c:08x}{suffix}"


def new_object_id() -> str:
    return "obj-" + _rand_hex()


def new_task_id() -> str:
    return "tsk-" + _rand_hex()


def new_actor_id() -> str:
    return "act-" + _rand_hex()


def new_node_id() -> str:
    return "nod-" + _rand_hex()


def new_placement_group_id() -> str:
    return "pgr-" + _rand_hex()
