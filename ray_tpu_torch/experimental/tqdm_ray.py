"""Distributed-safe progress bars (reference parity:
python/ray/experimental/tqdm_ray.py).

Workers' stdout is captured and line-streamed to the driver, so real
tqdm's in-place carriage returns turn into log spam. This shim batches
progress into rate-limited single lines that survive the worker->driver
log relay; API-compatible with the tqdm calls the libraries use
(update/set_description/close, iterable wrapping).
"""
from __future__ import annotations

import sys
import time
from typing import Iterable, Optional

_MIN_INTERVAL_S = 0.5


class tqdm:  # noqa: N801  (tqdm-compatible name)
    def __init__(self, iterable: Optional[Iterable] = None,
                 desc: str = "", total: Optional[int] = None,
                 unit: str = "it", **_ignored):
        self._iterable = iterable
        self.desc = desc
        self.total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        self.unit = unit
        self.n = 0
        self._start = time.time()
        self._last_print = 0.0
        self._closed = False

    def __iter__(self):
        for x in self._iterable:
            yield x
            self.update(1)
        self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.time()
        if now - self._last_print >= _MIN_INTERVAL_S:
            self._last_print = now
            self._emit()

    def set_description(self, desc: str, refresh: bool = True) -> None:
        self.desc = desc
        if refresh:
            self._emit()

    def _emit(self) -> None:
        elapsed = max(time.time() - self._start, 1e-9)
        rate = self.n / elapsed
        frac = f"{self.n}/{self.total}" if self.total else str(self.n)
        pct = (f" {100.0 * self.n / self.total:.0f}%"
               if self.total else "")
        print(f"[{self.desc or 'progress'}] {frac}{pct} "
              f"({rate:.1f} {self.unit}/s)", file=sys.stderr, flush=True)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._emit()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def safe_print(*args, **kwargs) -> None:
    """print() replacement that cooperates with the bars (parity shim —
    our bars are plain lines, so this is just print)."""
    print(*args, **kwargs)


__all__ = ["tqdm", "safe_print"]
