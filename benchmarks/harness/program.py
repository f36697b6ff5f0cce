"""What the program under test counted in a run's traced slice.

The port's counters (`ray_tpu_torch.observability.profiler.count`) are
kept only while a torch.profiler capture runs on the counting thread,
and the only capture of a run is its traced slice, started and stopped
on the program's own thread; a run is one process. So after the run
the counters hold the slice's counts. A program that keeps no counters
gives None, and so does every reader of them.
"""
from __future__ import annotations

from typing import Dict, Optional


def counters() -> Optional[Dict[str, int]]:
    try:
        from ray_tpu_torch.observability import profiler
    except ImportError:
        return None
    read = getattr(profiler, "counters", None)
    if read is None:
        return None
    return read() or None


def k1_launches(counts: Dict[str, int]):
    """[(count, (B, S, Hq, Hkv, D, causal))] of the K1 launches counted
    by shape (`k1.launch:B,S,Hq,Hkv,D,causal`)."""
    out = []
    for key, n in counts.items():
        if key.startswith("k1.launch:"):
            b, s, hq, hkv, d, causal = map(int, key.split(":", 1)[1]
                                           .split(","))
            out.append((n, (b, s, hq, hkv, d, bool(causal))))
    return out
