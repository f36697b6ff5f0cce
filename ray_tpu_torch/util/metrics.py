"""Application metrics: Counter / Gauge / Histogram + registry.

Reference counterpart: python/ray/util/metrics.py (user-facing metric
objects) and python/ray/_private/metrics_agent.py (export). Metrics live
in an in-process registry; `exposition()` renders the Prometheus text
format the dashboard serves at /metrics.

Cluster-wide plane: each worker / node-agent process periodically ships a
DELTA snapshot of its local registry to the driver (DeltaExporter in this
module + the telemetry pusher in core/worker.py / core/node.py); the
driver merges them into a ClusterMetricsStore — counters and histogram
buckets sum, gauges are last-write — with every remote series tagged
node_id/worker_id. `cluster_exposition()` renders local + merged remote
series as one Prometheus document (what the dashboard's /metrics serves),
so worker-side recordings are visible from one scrape.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None and existing.kind != self.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing.kind}")
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return merged

    def _series(self):  # -> iterable of (tags, value-ish)
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_tags_key(self._merged(tags)), 0.0)

    def _series(self):
        with self._lock:
            return list(self._values.items())


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_tags_key(self._merged(tags))] = float(value)

    def inc(self, value: float = 1.0, tags=None) -> None:
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, tags=None) -> None:
        self.inc(-value, tags)

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_tags_key(self._merged(tags)), 0.0)

    def _series(self):
        with self._lock:
            return list(self._values.items())


DEFAULT_BOUNDARIES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="",
                 boundaries: Sequence[float] = DEFAULT_BOUNDARIES,
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(sorted(boundaries))
        self._buckets: Dict[tuple, List[int]] = {}
        self._sum: Dict[tuple, float] = {}
        self._count: Dict[tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = _tags_key(self._merged(tags))
        with self._lock:
            if key not in self._buckets:
                self._buckets[key] = [0] * (len(self.boundaries) + 1)
                self._sum[key] = 0.0
                self._count[key] = 0
            idx = bisect.bisect_left(self.boundaries, value)
            self._buckets[key][idx] += 1
            self._sum[key] += value
            self._count[key] += 1

    def observe_many(self, values: Sequence[float],
                     tags: Optional[Dict[str, str]] = None) -> None:
        """Bulk observe: one key computation and one lock acquisition
        for the whole batch — flush-cadence consumers (flight-recorder
        ring drains) record hundreds of samples per call."""
        if not values:
            return
        key = _tags_key(self._merged(tags))
        with self._lock:
            if key not in self._buckets:
                self._buckets[key] = [0] * (len(self.boundaries) + 1)
                self._sum[key] = 0.0
                self._count[key] = 0
            buckets = self._buckets[key]
            total = 0.0
            for v in values:
                buckets[bisect.bisect_left(self.boundaries, v)] += 1
                total += v
            self._sum[key] += total
            self._count[key] += len(values)

    def percentile(self, p: float,
                   tags: Optional[Dict[str, str]] = None) -> float:
        """Linear-interpolated percentile estimate from bucket counts."""
        key = _tags_key(self._merged(tags))
        with self._lock:
            counts = list(self._buckets.get(key) or ())
            total = self._count.get(key, 0)
        if not counts or total == 0:
            return 0.0
        target = total * p / 100.0
        acc = 0.0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = (self.boundaries[i] if i < len(self.boundaries)
                  else self.boundaries[-1])
            if acc + c >= target and c > 0:
                frac = (target - acc) / c
                return lo + frac * (hi - lo)
            acc += c
            lo = hi
        return self.boundaries[-1]

    def _series(self):
        with self._lock:
            return [(k, (list(self._buckets[k]), self._sum[k],
                         self._count[k]))
                    for k in self._buckets]


class _Timer:
    def __init__(self, hist: Histogram, tags=None):
        self.hist, self.tags = hist, tags

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0, self.tags)
        return False


def timer(hist: Histogram, tags: Optional[Dict[str, str]] = None) -> _Timer:
    return _Timer(hist, tags)


def _escape_label(v: str) -> str:
    """Prometheus text-format escaping: \\ " and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def exposition() -> str:
    """Prometheus text exposition of every registered metric."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        if m.description:
            lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key, (buckets, total, count) in m._series():
                _render_histogram_series(lines, m.name, key, m.boundaries,
                                         buckets, total, count)
        else:
            for key, v in m._series():
                lines.append(f"{m.name}{_fmt_tags(key)} {v}")
    return "\n".join(lines) + "\n"


def get_metric(name: str) -> Optional[Metric]:
    with _registry_lock:
        return _registry.get(name)


def clear_registry() -> None:
    with _registry_lock:
        _registry.clear()


# ---------------------------------------------------------------------------
# Worker -> driver shipping: delta snapshots + driver-side merge store.
# ---------------------------------------------------------------------------

def _snapshot_registry() -> List[tuple]:
    """[(name, kind, help, boundaries|None, {tags_key: value})] of every
    local metric. Histogram values are (buckets, sum, count)."""
    with _registry_lock:
        metrics = list(_registry.values())
    out = []
    for m in metrics:
        boundaries = m.boundaries if isinstance(m, Histogram) else None
        out.append((m.name, m.kind, m.description, boundaries,
                    dict(m._series())))
    return out


class DeltaExporter:
    """Diffs the local registry against the last collect() so repeated
    pushes ship only increments (counters / histograms) or current values
    (gauges). A registry clear (tests) resets the baseline: a counter
    that shrank is treated as restarted and its full value re-ships."""

    def __init__(self):
        self._last: Dict[tuple, Any] = {}   # (name, tags_key) -> value

    def collect(self) -> Optional[dict]:
        """A payload for ClusterMetricsStore.ingest, or None when
        nothing changed since the previous collect."""
        shipped = []
        for name, kind, help_, boundaries, series in _snapshot_registry():
            rows = []
            for key, val in series.items():
                lk = (name, key)
                if kind == "gauge":
                    if self._last.get(lk) != val:
                        self._last[lk] = val
                        rows.append((key, val))
                    continue
                if kind == "histogram":
                    buckets, total, count = val
                    lb, lt, lc = self._last.get(lk) or \
                        ([0] * len(buckets), 0.0, 0)
                    if count < lc or len(lb) != len(buckets):
                        lb, lt, lc = [0] * len(buckets), 0.0, 0  # restart
                    if count == lc:
                        continue
                    rows.append((key, ([b - p for b, p in
                                        zip(buckets, lb)],
                                       total - lt, count - lc)))
                    self._last[lk] = (list(buckets), total, count)
                    continue
                # counter (and any future monotonic kind)
                last = self._last.get(lk, 0.0)
                if val < last:
                    last = 0.0                    # restarted
                if val == last:
                    continue
                rows.append((key, val - last))
                self._last[lk] = val
            if rows:
                shipped.append({"name": name, "kind": kind, "help": help_,
                                "boundaries": boundaries, "series": rows})
        return {"metrics": shipped} if shipped else None


class ClusterMetricsStore:
    """Driver-side merge of remote delta snapshots. Counters and
    histogram buckets accumulate; gauges keep the last write. Every
    remote series is re-keyed with the source's node_id/worker_id tags
    (which win over any same-named tag the remote set).

    Lifecycle: when a source dies, drop_source() removes its GAUGE
    series (a dead worker's "current state" is a lie) while counters/
    histograms stay (they are historical facts). A per-metric series
    cap bounds memory under sustained worker churn — oldest series
    drop first."""

    _SERIES_CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"kind", "help", "series": {tags_key: value},
        #          "boundaries": {tags_key: tuple}}
        self._metrics: Dict[str, dict] = {}

    def drop_source(self, source_tags: Dict[str, str]) -> None:
        """Remove gauge series carrying ALL of source_tags (called when
        the worker/node that shipped them dies)."""
        items = tuple(source_tags.items())
        with self._lock:
            for ent in self._metrics.values():
                if ent["kind"] != "gauge":
                    continue
                doomed = [k for k in ent["series"]
                          if all(pair in k for pair in items)]
                for k in doomed:
                    del ent["series"][k]

    def ingest(self, source_tags: Dict[str, str], payload: dict) -> None:
        if not payload:
            return
        with self._lock:
            for m in payload.get("metrics", ()):
                ent = self._metrics.setdefault(
                    m["name"], {"kind": m["kind"],
                                "help": m.get("help", ""),
                                "series": {}, "boundaries": {}})
                if ent["kind"] != m["kind"]:
                    continue  # conflicting registration; drop
                for key, val in m["series"]:
                    tags = dict(key)
                    tags.update(source_tags)
                    skey = tuple(sorted(tags.items()))
                    while (skey not in ent["series"]
                           and len(ent["series"]) >= self._SERIES_CAP):
                        oldest = next(iter(ent["series"]))
                        del ent["series"][oldest]
                        ent["boundaries"].pop(oldest, None)
                    if m["kind"] == "gauge":
                        ent["series"][skey] = val
                    elif m["kind"] == "histogram":
                        buckets, total, count = val
                        pb, pt, pc = ent["series"].get(skey) or \
                            ([0] * len(buckets), 0.0, 0)
                        if len(pb) != len(buckets):
                            pb, pt, pc = [0] * len(buckets), 0.0, 0
                        ent["series"][skey] = (
                            [a + b for a, b in zip(pb, buckets)],
                            pt + total, pc + count)
                        ent["boundaries"][skey] = tuple(
                            m.get("boundaries") or ())
                    else:
                        ent["series"][skey] = \
                            ent["series"].get(skey, 0.0) + val

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {name: {"kind": e["kind"], "help": e["help"],
                           "series": dict(e["series"]),
                           "boundaries": dict(e["boundaries"])}
                    for name, e in self._metrics.items()}


def _render_histogram_series(lines: List[str], name: str, key: tuple,
                             boundaries, buckets, total, count) -> None:
    acc = 0
    for i, b in enumerate(boundaries):
        acc += buckets[i]
        tk = key + (("le", str(b)),)
        lines.append(f"{name}_bucket{_fmt_tags(tk)} {acc}")
    tk = key + (("le", "+Inf"),)
    lines.append(f"{name}_bucket{_fmt_tags(tk)} {count}")
    lines.append(f"{name}_sum{_fmt_tags(key)} {total}")
    lines.append(f"{name}_count{_fmt_tags(key)} {count}")


def cluster_exposition(remote: Optional[ClusterMetricsStore] = None) -> str:
    """Prometheus text exposition of the local registry MERGED with the
    remote series shipped to this process's driver runtime (all of a
    metric's series stay grouped under one # TYPE header, as the format
    requires). Falls back to the local registry alone when no runtime —
    or no store — is up."""
    if remote is None:
        try:
            from ..core import runtime as runtime_mod  # noqa: PLC0415
            if runtime_mod.runtime_initialized():
                remote = getattr(runtime_mod.get_runtime(),
                                 "cluster_metrics", None)
        except Exception:
            remote = None
    remote_snap = remote.snapshot() if remote is not None else {}

    lines: List[str] = []
    seen: set = set()
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        seen.add(m.name)
        help_ = m.description
        rm = remote_snap.get(m.name)
        if not help_ and rm:
            help_ = rm["help"]
        if help_:
            lines.append(f"# HELP {m.name} {help_}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key, (buckets, total, count) in m._series():
                _render_histogram_series(lines, m.name, key, m.boundaries,
                                         buckets, total, count)
        else:
            for key, v in m._series():
                lines.append(f"{m.name}{_fmt_tags(key)} {v}")
        if rm is not None and rm["kind"] == m.kind:
            for key, val in rm["series"].items():
                if m.kind == "histogram":
                    buckets, total, count = val
                    bnd = rm["boundaries"].get(key) or m.boundaries
                    _render_histogram_series(lines, m.name, key, bnd,
                                             buckets, total, count)
                else:
                    lines.append(f"{m.name}{_fmt_tags(key)} {val}")
    for name, rm in remote_snap.items():
        if name in seen:
            continue
        if rm["help"]:
            lines.append(f"# HELP {name} {rm['help']}")
        lines.append(f"# TYPE {name} {rm['kind']}")
        for key, val in rm["series"].items():
            if rm["kind"] == "histogram":
                buckets, total, count = val
                bnd = rm["boundaries"].get(key) or DEFAULT_BOUNDARIES
                _render_histogram_series(lines, name, key, bnd,
                                         buckets, total, count)
            else:
                lines.append(f"{name}{_fmt_tags(key)} {val}")
    return "\n".join(lines) + "\n"
