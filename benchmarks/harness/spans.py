"""Readings of the program's spans in a traced slice's Chrome events,
beside `harness/trace.py`'s reduction: each span's host time, and the
device's idle time inside each span's instances.

A span is a `record_function` range (`user_annotation`); the port opens
them on its own threads (observability/profiler.py `annotate`), on the
clock of the CUPTI kernels. The slice is the extent of its other events:
a span still open when the capture stopped (the capture is stopped from
inside the program's step) ends in the trace when the program left it,
after the stop, and is cut at the slice's end. `idle_under` takes the
device idle where no kernel, copy or fill runs within the slice, and
for each span name the part of that idle time its instances cover:
where the program's thread was while the card waited.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from harness.trace import DEVICE_CATS, _union


def _interval(e: Dict) -> tuple:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def _is_span(e: Dict) -> bool:
    return str(e.get("cat", "")).lower() == "user_annotation"


def extent(events: List[Dict]):
    """(first start, last end) in us of the slice's events other than
    spans; None for an empty slice."""
    xs = [_interval(e) for e in events
          if e.get("ph") == "X" and not _is_span(e)]
    if not xs:
        return None
    return min(a for a, _ in xs), max(b for _, b in xs)


def _instances(events: List[Dict]) -> Dict[str, List[tuple]]:
    """{span name: [(start, end)]}, each cut to the slice."""
    out: Dict[str, List[tuple]] = defaultdict(list)
    span = extent(events)
    if span is None:
        return out
    lo, hi = span
    for e in events:
        if e.get("ph") == "X" and _is_span(e):
            s, t = _interval(e)
            if t > lo and s < hi:
                out[e["name"]].append((max(s, lo), min(t, hi)))
    return out


def host_spans(events: List[Dict]) -> Dict[str, List]:
    """{span name: [instances, host seconds]}; nested instances of one
    name count once each, their time once."""
    return {name: [len(iv), sum(e - s for s, e in _union(iv)) * 1e-6]
            for name, iv in _instances(events).items()}


def _overlap(a: List[List[float]], b: List[List[float]]) -> float:
    """Length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(events: List[Dict]) -> List[List[float]]:
    """The device's idle intervals (us): the complement of the union of
    its operations within the slice."""
    span = extent(events)
    if span is None:
        return []
    lo, hi = span
    busy = _union([_interval(e) for e in events if e.get("ph") == "X"
                   and str(e.get("cat", "")).lower() in DEVICE_CATS])
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append([at, s])
        at = max(at, e)
    if hi > at:
        out.append([at, hi])
    return out


def idle_under(events: List[Dict]) -> Dict[str, float]:
    """{span name: device-idle seconds inside that span's instances}."""
    gaps = idle(events)
    return {name: _overlap(_union(iv), gaps) * 1e-6
            for name, iv in _instances(events).items()}
