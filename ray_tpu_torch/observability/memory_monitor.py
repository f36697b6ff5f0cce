"""Memory accounting: store quota + worker RSS watchdog.

Reference counterpart: python/ray/_private/memory_monitor.py and the
raylet OOM killer (src/ray/raylet worker_killing_policy). The store
already enforces its byte quota via LRU eviction (C++ arena); this adds
(a) usage reporting and (b) an optional RSS watchdog that kills the
fattest killable worker before the host OOMs.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..util import knobs


def _rss_bytes(pid: int) -> Optional[int]:
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def _host_memory() -> Dict[str, int]:
    info = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0]) * 1024
    except OSError:
        pass
    return {"total": info.get("MemTotal", 0),
            "available": info.get("MemAvailable", 0)}


def memory_summary() -> Dict[str, Any]:
    """Snapshot: host memory, store usage, per-worker RSS."""
    from ..core.runtime import get_runtime
    rt = get_runtime()
    workers: List[Dict[str, Any]] = []
    for w in list(rt.workers.values()):
        if w.pid is None or w.state == "dead":
            continue
        workers.append({"worker_id": w.worker_id, "pid": w.pid,
                        "state": w.state, "rss_bytes": _rss_bytes(w.pid)})
    host = _host_memory()
    return {
        "host_total_bytes": host["total"],
        "host_available_bytes": host["available"],
        "store_used_bytes": rt.store.used_bytes(),
        "store_capacity_bytes": getattr(rt.store, "capacity", None),
        "workers": workers,
        "driver_rss_bytes": _rss_bytes(os.getpid()),
    }


class MemoryMonitor:
    """Background watchdog: when host available memory drops below
    `min_available_frac`, terminate the highest-RSS busy worker (its task
    retries per max_retries — same contract as the reference OOM killer).
    """

    def __init__(self, *, min_available_frac: float = 0.05,
                 poll_interval_s: float = 1.0, kill: bool = True):
        self.min_available_frac = min_available_frac
        self.poll_interval_s = poll_interval_s
        self.kill = kill
        self.events: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-memmon")
        self._thread.start()

    def _gauge(self, frac: float) -> None:
        """Publish host memory headroom so pressure is visible on the
        dashboard BEFORE the watchdog kills anything (cataloged gauge:
        1 - available/total, i.e. rises toward 1.0 under pressure)."""
        try:
            from ..util import metrics_catalog as mcat
            mcat.get("ray_tpu_node_memory_pressure").set(
                round(1.0 - frac, 6))
        except Exception:
            pass

    def _loop(self) -> None:
        from ..core.runtime import get_runtime
        from ..util import events as events_mod
        pressured = False
        while not self._stop.wait(self.poll_interval_s):
            host = _host_memory()
            if not host["total"]:
                continue
            frac = host["available"] / host["total"]
            self._gauge(frac)
            if frac >= self.min_available_frac:
                pressured = False
                continue
            if not pressured:
                # one event per pressure episode, emitted whether or
                # not a kill follows (there may be nothing to kill)
                pressured = True
                try:
                    events_mod.emit(
                        "node.memory_pressure",
                        f"host available memory {frac:.1%} below "
                        f"threshold {self.min_available_frac:.1%}",
                        node_id=knobs.get_raw("RAY_TPU_NODE_ID"),
                        available_frac=round(frac, 4),
                        threshold=self.min_available_frac)
                except Exception:
                    pass
            try:
                rt = get_runtime()
            except Exception:
                continue
            victims = [(w, _rss_bytes(w.pid) or 0)
                       for w in list(rt.workers.values())
                       if w.state == "busy" and w.pid]
            if not victims:
                continue
            victim, rss = max(victims, key=lambda t: t[1])
            self.events.append({"time": time.time(),
                                "worker_id": victim.worker_id,
                                "rss_bytes": rss,
                                "available_frac": frac,
                                "killed": self.kill})
            if self.kill:
                rt.inbox.put(("worker_dead", victim.worker_id))
                try:
                    victim.proc.terminate()
                except Exception:
                    pass

    def stop(self) -> None:
        self._stop.set()
