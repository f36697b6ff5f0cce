"""Scale-out request router: load-aware replica selection with
session/prefix affinity (counterpart of ray_tpu/serve/router.py).

Reference counterpart: python/ray/serve/_private/replica_scheduler/
pow_2_scheduler.py (least-loaded power-of-two-choices) plus the
consistent-hash-with-bounded-load scheme from "Consistent Hashing with
Bounded Loads" (Mirrokni et al.) that fronting LLM routers use to keep
shared-prompt traffic on a warm KV prefix cache.

Two cooperating policies, both stateless across processes:

* **Least-loaded p2c** — the default for keyless traffic: sample two
  replicas that still have request slots and take the one with fewer
  in-flight requests. Used by every `DeploymentHandle` (proxies
  included).
* **Affinity** — requests carrying an affinity key (an explicit
  `__serve_affinity_key` kwarg, a `session_id`/`user` field in a dict
  body, or a prompt that starts with a controller-registered prefix)
  are sticky-routed. The preferred replica is the key's previous
  binding, else its consistent-hash ring owner — the SAME deterministic
  ring the controller uses to pick which replica to pre-warm with a
  registered prefix, so the first request of a prefix-keyed session
  already lands on a warm KV cache. A preferred replica that is
  suspect, draining, or above the bounded-load cap is skipped (the key
  re-binds elsewhere — a cold prefill, never an error), which preserves
  the handle's failover guarantees.

The ring is derived from the RUNNING replica-id set only — every
handle, every proxy, and the controller compute identical ownership
without coordination.
"""
from __future__ import annotations

import bisect
import collections
import hashlib
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..util import knobs

# virtual points per replica on the hash ring: enough to spread keys
# evenly across small replica sets without making ring builds costly
_VNODES = 64
# bounded-load factor c: a preferred replica is skipped when its load
# exceeds c * (average load + 1). c=2 tolerates bursty sessions while
# still shedding a pathological hot key onto the rest of the fleet.
_BOUND_FACTOR = knobs.get_float("RAY_TPU_SERVE_AFFINITY_BOUND")
# bindings kept per handle (LRU); beyond this the oldest sessions
# silently fall back to ring ownership (which is where they were bound
# anyway unless they were diverted)
_SESSION_CAP = knobs.get_int("RAY_TPU_SERVE_AFFINITY_SESSIONS")


def _hash64(s: str) -> int:
    """Stable cross-process 64-bit hash (builtin hash() is salted)."""
    return int.from_bytes(
        hashlib.md5(s.encode("utf-8", "surrogatepass")).digest()[:8],
        "big")


# ring points are a pure function of the replica-id set — cache them
# so the routing hot path pays one md5 + a binary search per request
# instead of rebuilding and sorting replicas x _VNODES points
_RING_CACHE_CAP = 32
_ring_cache: "collections.OrderedDict[tuple, List[Tuple[int, str]]]" = \
    collections.OrderedDict()
_ring_cache_lock = threading.Lock()


def _ring_points(replica_ids: Sequence[str],
                 vnodes: int) -> List[Tuple[int, str]]:
    cache_key = (tuple(sorted(set(replica_ids))), vnodes)
    with _ring_cache_lock:
        points = _ring_cache.get(cache_key)
        if points is not None:
            _ring_cache.move_to_end(cache_key)
            return points
    points = sorted(
        (_hash64(f"{rid}#{v}"), rid)
        for rid in cache_key[0] for v in range(vnodes))
    with _ring_cache_lock:
        _ring_cache[cache_key] = points
        while len(_ring_cache) > _RING_CACHE_CAP:
            _ring_cache.popitem(last=False)
    return points


def ring_order(key: str, replica_ids: Sequence[str],
               vnodes: int = _VNODES) -> List[str]:
    """Replica ids in consistent-hash preference order for `key`.

    Deterministic in (key, replica-id set): handles, proxies, and the
    controller all agree on the owner (the first entry) without talking
    to each other. Adding/removing one replica remaps only the keys it
    owned — established sessions elsewhere keep their replica.
    """
    if not replica_ids:
        return []
    points = _ring_points(replica_ids, vnodes)
    n_distinct = len(set(replica_ids))
    idx = bisect.bisect_left(points, (_hash64(key), ""))
    order: List[str] = []
    seen = set()
    for i in range(len(points)):
        rid = points[(idx + i) % len(points)][1]
        if rid not in seen:
            seen.add(rid)
            order.append(rid)
            if len(order) == n_distinct:
                break
    return order


def ring_owner(key: str, replica_ids: Sequence[str]) -> Optional[str]:
    """The replica that owns `key` on the ring (None when empty)."""
    order = ring_order(key, replica_ids)
    return order[0] if order else None


def extract_affinity_key(args: tuple,
                         registered_prefixes: Sequence[dict]
                         ) -> Optional[str]:
    """Affinity key from a request body (first positional arg when it
    is a dict): an explicit session id, else the key of the longest
    controller-registered prompt prefix the prompt starts with."""
    if not args or not isinstance(args[0], dict):
        return None
    body = args[0]
    sid = body.get("session_id") or body.get("user")
    if sid:
        return str(sid)
    prompt = body.get("prompt")
    if prompt is None or not registered_prefixes:
        return None
    best_key, best_len = None, -1
    for row in registered_prefixes:
        pfx = row.get("prefix")
        try:
            if isinstance(prompt, str) and isinstance(pfx, str):
                ok = prompt.startswith(pfx)
                n = len(pfx)
            elif not isinstance(prompt, str) and not isinstance(pfx, str):
                p = list(pfx)
                n = len(p)
                ok = len(prompt) > n and list(prompt[:n]) == p
            else:
                continue   # mixed str/token forms cannot match
        except TypeError:
            continue
        if ok and n > best_len:
            best_key, best_len = row.get("key"), n
    return best_key


def prefix_key(prefix) -> str:
    """Canonical key for a registered prefix payload (shared by the
    controller registry and callers that precompute keys)."""
    if isinstance(prefix, str):
        raw = prefix.encode()
    else:
        raw = repr([int(t) for t in prefix]).encode()
    return "pfx-" + hashlib.sha1(raw).hexdigest()[:12]


class AffinityRouter:
    """Sticky routing state for one (app, deployment) handle.

    `pick` returns the replica a keyed request should go to, or None
    when every affinity-preferred replica is over the bounded-load cap
    (the caller falls back to least-loaded p2c). Bindings live in a
    bounded LRU; hit/miss telemetry is emitted here so every routing
    surface (handles, both proxies) counts identically. Caller holds
    the router-state lock.
    """

    _NOTE_CAP = 64

    def __init__(self, deployment: str = "", app: str = "default"):
        self.deployment = deployment
        self.app = app
        self.bindings: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        # binding transitions awaiting delivery to the controller's
        # router table: (key, replica_id, outcome). Appended under the
        # caller's lock, drained by DeploymentHandle AFTER it releases
        # the lock — notification is a driver/controller round trip
        # and must never run on the locked routing path.
        self.pending_notes: List[tuple] = []

    # ---- policy -----------------------------------------------------------
    def _bound(self, loads: Dict[str, int], max_ongoing: int) -> int:
        """Bounded-load cap: c * (mean load + 1), never above the
        per-replica max_ongoing_requests slot count."""
        if not loads:
            return max_ongoing
        mean = sum(loads.values()) / len(loads)
        cap = max(1, math.ceil(_BOUND_FACTOR * (mean + 1.0)))
        return min(cap, max_ongoing) if max_ongoing > 0 else cap

    def pick(self, key: str, candidates: List[tuple],
             load: Callable[[str], int], max_ongoing: int
             ) -> Optional[tuple]:
        """Choose a candidate for an affinity-keyed request.

        Preference order: the key's current binding, then consistent-
        hash ring order. The first preference under the bounded-load
        cap wins; staying on the bound replica is a *hit*, landing
        anywhere else re-binds the key (*miss* — its KV prefix must be
        re-warmed there). Returns None when nothing is under the cap.
        """
        by_id = {c[0]: c for c in candidates}
        ids = list(by_id)
        loads = {rid: load(rid) for rid in ids}
        cap = self._bound(loads, max_ongoing)
        bound = self.bindings.get(key)
        prefs: List[str] = []
        if bound in by_id:
            prefs.append(bound)
        prefs.extend(r for r in ring_order(key, ids) if r not in prefs)
        for rid in prefs:
            if loads[rid] >= cap:
                continue
            # staying on the binding is a hit; a fresh key landing on
            # its ring owner is too (that's where a registered prefix
            # was pre-warmed by the controller)
            hit = rid == (bound if bound is not None else prefs[0])
            self._record(key, rid, hit=hit)
            return by_id[rid]
        return None

    # ---- bookkeeping / telemetry ------------------------------------------
    def _record(self, key: str, rid: str, hit: bool) -> None:
        from ..util import events as events_mod
        prev = self.bindings.get(key)
        rebind = prev != rid
        self.bindings[key] = rid
        self.bindings.move_to_end(key)
        while len(self.bindings) > _SESSION_CAP:
            self.bindings.popitem(last=False)
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        outcome = "affinity_hit" if hit else "affinity_miss"
        # counters every request; events only at binding transitions
        # (first hit of a fresh binding / every divert-rebind) so the
        # event plane sees routing *changes*, not per-request noise
        events_mod.emit_safe(
            ("serve.router.affinity_hit" if hit and rebind else
             "serve.router.affinity_miss" if not hit else None),
            f"key {key[:64]!r} -> {rid}"
            + (f" (was {prev})" if rebind and prev else ""),
            counter="ray_tpu_serve_router_requests_total",
            counter_tags={"deployment": self.deployment,
                          "outcome": outcome},
            deployment=self.deployment, app=self.app,
            affinity_key=str(key)[:128], replica_id=rid,
            previous=prev if rebind else None)
        try:
            from ..util import metrics_catalog as mcat
            mcat.get("ray_tpu_serve_router_sessions").set(
                float(len(self.bindings)),
                tags={"deployment": self.deployment})
        except Exception:  # noqa: BLE001  telemetry never fails routing
            pass
        if rebind and len(self.pending_notes) < self._NOTE_CAP:
            self.pending_notes.append((key, rid, outcome))

    def take_notes(self) -> List[tuple]:
        """Drain queued binding transitions (caller holds the lock)."""
        notes, self.pending_notes = self.pending_notes, []
        return notes

    def forget(self, replica_id: str) -> None:
        """Drop every binding to a replica that just failed — the next
        request per key re-binds (and re-warms) elsewhere."""
        for k in [k for k, v in self.bindings.items() if v == replica_id]:
            del self.bindings[k]

    def snapshot(self) -> Dict:
        return {"deployment": self.deployment, "app": self.app,
                "bindings": dict(self.bindings),
                "hits": self.hits, "misses": self.misses,
                "ts": time.time()}


def pick_least_loaded(candidates: List[tuple],
                      load: Callable[[str], int],
                      max_ongoing: int) -> Optional[tuple]:
    """Power-of-two-choices over in-flight counts, restricted to
    replicas that still have request slots. Returns None when every
    replica is saturated (caller backs off and re-polls).

    Replaces the old "sample 2 of everything, then check the winner's
    cap" scan: that version could sample two saturated replicas while a
    free one sat idle, burning a backoff round per miss (replica
    hot-spotting under skewed load).
    """
    import random
    if len(candidates) == 1:           # hot path: single replica
        c = candidates[0]
        return c if max_ongoing <= 0 or load(c[0]) < max_ongoing \
            else None
    open_c = [c for c in candidates
              if max_ongoing <= 0 or load(c[0]) < max_ongoing]
    if not open_c:
        return None
    if len(open_c) == 1:
        return open_c[0]
    a, b = random.sample(open_c, 2)
    return a if load(a[0]) <= load(b[0]) else b


__all__ = ["AffinityRouter", "ring_order", "ring_owner",
           "extract_affinity_key", "prefix_key", "pick_least_loaded"]
