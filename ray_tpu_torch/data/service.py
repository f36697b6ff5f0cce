"""Disaggregated data service: one shared, fault-tolerant data plane
(counterpart of ray_tpu/data/service.py).

Reference counterpart: the tf.data service (PAPERS.md) dispatcher /
worker split, mapped onto the port's runtime primitives. A named
**DataServiceDispatcher** actor owns registered dataset plans and a
pool of **data-worker** actors (autoscaled with the synthetic
NodeType pattern from `core/autoscaler.py`). Jobs register a dataset
plan once; any number of consumers then draw *shard grants* (one block
per grant) through per-consumer iterators.

Design invariants (docs/DATA_SERVICE.md holds the long form):

  * **Produce once, feed many.** A dataset plan is keyed by its
    serialized bytes; every JOB registered against that key shares one
    production run per epoch (a key collision with a DIFFERENT plan is
    rejected, never silently shared). Within a job, consumers split
    the job's view: `fcfs` (dynamic first-come-first-served, tune
    sweeps) or `round_robin` (deterministic by block index modulo
    world, SPMD ranks). A job may register LATE: blocks already
    retired by earlier jobs are revived (retired flag cleared, owning
    slices re-pended) and re-produced under their deterministic ids.
  * **Deterministic block identity.** A block produced by slice `s`
    of epoch `e` at position `q` is ALWAYS `e{e}-s{s}-b{q}`, with
    canonical global index `q * n_slices + s`. Re-producing a slice
    after a worker death yields the same ids, so at-most-once handout
    and the census tests are exact under chaos.
  * **Non-blocking dispatcher.** Every dispatcher verb returns
    immediately ({"status": "wait"} when the caller must poll): the
    epoch barrier, production lag, and reconcile gates never park an
    actor call, so `checkpoint_interval_s=0` checkpoints land after
    every completed call.
  * **Lease-fenced grants.** A grant is a lease: if the
    consumer's lease expires (death, wedged step) its outstanding
    grants are revoked back to the pending pool and the consumer is
    fenced; a fenced consumer's next call gets "stale" and must
    re-attach + reconcile. Generations stamp jobs (reshard) and
    consumers (re-attach) so stale acks/grants/refetches are
    rejected. `next_shard` is idempotent per client request nonce —
    an RPC retry after a lost reply replays the original grant
    instead of stranding it.
  * **Restore closes the grant/checkpoint race.** The checkpoint
    ships AFTER the reply, so a SIGKILL between reply and checkpoint
    can lose a grant record. `__ray_restore__` therefore flags every
    consumer `needs_reconcile`; no new grants flow for a job until
    each live consumer reported its consumed block ids (dead ones age
    out via the lease). Zero lost, zero duplicated blocks.
  * **Peer-plane delivery.** Workers `put()` blocks into their own
    store and pass only the ref id; consumers re-materialize
    `ObjectRef(id)` and pull holder->consumer over the peer
    transfer plane. Iterators account `relay_bytes` deltas the same
    way `exchange.py` does, and drive them to zero.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

SERVICE_ACTOR_NAME = "_ray_tpu_data_service"
_WORKER_NAME_FMT = "_rtpu_data_worker_{}"

# slice-local execution only: these stage kinds need a cross-slice
# barrier (exchange) or whole-stream view (shuffle/limit), which a
# per-slice producer cannot honor
_REJECTED_STAGE_KINDS = ("exchange", "shuffle")


def _api():
    from .. import api  # noqa: PLC0415 (lazy: avoid import cycles)
    return api


def _knob_float(name: str) -> float:
    from ..util import knobs  # noqa: PLC0415
    return knobs.get_float(name)


def _knob_int(name: str) -> int:
    from ..util import knobs  # noqa: PLC0415
    return knobs.get_int(name)


def _emit(event_type: str, message: str, **fields) -> None:
    try:
        from ..util import events as events_mod  # noqa: PLC0415
        events_mod.emit_safe(event_type, message, **fields)
    except Exception:  # noqa: BLE001 — telemetry never breaks data flow
        pass


def _mcat_get(name: str):
    try:
        from ..util import metrics_catalog as mcat  # noqa: PLC0415
        return mcat.get(name)
    except Exception:  # noqa: BLE001
        return None


def _bid(epoch: int, slice_idx: int, seq: int) -> str:
    return f"e{epoch}-s{slice_idx}-b{seq}"


def plan_bytes_of(ds) -> bytes:
    """Serialized (source, stages) plan; the dataset's identity key is
    sha1 of these bytes unless the caller names the dataset."""
    import cloudpickle  # noqa: PLC0415
    for st in ds._stages:
        if st.kind in _REJECTED_STAGE_KINDS:
            raise ValueError(
                f"data service plans must be slice-local; stage "
                f"{st.name!r} (kind={st.kind!r}) needs a cross-slice "
                f"barrier — materialize it before register()")
    return cloudpickle.dumps((ds._source, ds._stages))


# ---------------------------------------------------------------------------
# data worker
# ---------------------------------------------------------------------------

class _DataWorkerImpl:
    """Executes one plan slice inline and streams block OFFERS (ref ids,
    not values) to the dispatcher. max_concurrency=2 so the
    dispatcher's liveness ping answers while produce_slice runs."""

    def __init__(self, service_name: str, worker_name: str):
        self._service_name = service_name
        self._name = worker_name
        self._disp = None

    def ping(self) -> bool:
        return True

    def pid(self) -> int:
        import os  # noqa: PLC0415
        return os.getpid()

    def _dispatcher(self):
        if self._disp is None:
            api = _api()
            self._disp = api.get_actor(self._service_name,
                                       timeout=10.0)
        return self._disp

    def _call(self, method: str, *args, timeout: float = 30.0):
        """Dispatcher call with retry: the dispatcher may be mid-restart
        (SIGKILL chaos) — same actor id comes back, so retry the handle."""
        api = _api()
        deadline = time.time() + timeout
        last: Optional[BaseException] = None
        while time.time() < deadline:
            try:
                disp = self._dispatcher()
                ref = getattr(disp, method).remote(*args)
                return api.get(ref, timeout=10.0)
            except Exception as e:  # noqa: BLE001 — restart window
                last = e
                self._disp = None
                time.sleep(0.2)
        raise RuntimeError(
            f"data worker {self._name}: dispatcher unreachable for "
            f"{method} ({last!r})")

    def produce_slice(self, plan_blob: bytes, dataset_key: str,
                      epoch: int, slice_idx: int, n_slices: int,
                      skip_seqs: Optional[List[int]] = None) -> int:
        """Run the plan over source blocks i with i % n_slices ==
        slice_idx, inline (no nested distributed execution), offering
        each output block to the dispatcher. skip_seqs: seqs whose
        blocks are already globally acked (re-production after a
        worker death skips the put+offer but still iterates, keeping
        seq numbering deterministic)."""
        import cloudpickle  # noqa: PLC0415
        from .block import block_size_bytes  # noqa: PLC0415
        from .executor import DatasetStats, execute_plan  # noqa: PLC0415

        api = _api()
        source, stages = cloudpickle.loads(plan_blob)
        skip = set(skip_seqs or ())
        ahead = _knob_int("RAY_TPU_DATA_SERVICE_PRODUCE_AHEAD")

        def sliced():
            for i, b in enumerate(source.make_blocks()):
                if i % n_slices == slice_idx:
                    yield b

        produced = 0
        stream = execute_plan(sliced(), stages, DatasetStats(),
                              local=True)
        for seq, block in enumerate(stream):
            if seq in skip:
                continue
            ref = api.put(block)
            out = self._call(
                "offer_block", dataset_key, epoch, slice_idx, seq,
                ref.id, int(block_size_bytes(block)), self._name)
            produced += 1
            # produce-ahead backpressure: the dispatcher reports how
            # many produced blocks sit unretired; pause while over
            # budget so a slow consumer bounds producer memory
            while isinstance(out, dict) \
                    and out.get("outstanding", 0) > ahead:
                time.sleep(0.05)
                out = self._call("queue_depth", dataset_key)
        self._call("slice_done", dataset_key, epoch, slice_idx,
                   self._name)
        return produced

    def stop(self):
        api = _api()
        api.actor_exit()


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

class DataServiceDispatcher:
    """Named actor owning dataset plans, the per-job grant ledgers, and
    the data-worker pool. All state mutation happens under self._lock
    with NO blocking calls inside it (raylint RT001); worker actor
    calls happen from the tick thread outside the lock."""

    def __init__(self, min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None):
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._incarnation = 0
        self._worker_seq = 0
        self._min_workers = (min_workers if min_workers is not None
                             else _knob_int(
                                 "RAY_TPU_DATA_SERVICE_MIN_WORKERS"))
        self._max_workers = (max_workers if max_workers is not None
                             else _knob_int(
                                 "RAY_TPU_DATA_SERVICE_MAX_WORKERS"))
        # datasets: key -> {"plan": bytes, "n_slices": int}
        self._datasets: Dict[str, Dict[str, Any]] = {}
        # production: key -> epoch -> {"bids": {bid: meta}, "slices":
        # {idx: {"state", "worker"}}, "complete": bool, "jobs": [names]}
        # meta = {"ref": str|None, "nbytes": int, "worker": str,
        #         "idx": int, "acked_by": set}
        self._prod: Dict[str, Dict[int, Dict[str, Any]]] = {}
        # jobs: name -> {"dataset", "mode", "world", "epochs",
        # "generation", "epoch", "consumers": {cid: {...}},
        # "granted": {bid: cid}, "acked": set, "needs_reconcile": set}
        self._jobs: Dict[str, Dict[str, Any]] = {}
        # runtime-only (NOT checkpointed)
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._restored_worker_names: List[str] = []
        self._tick = threading.Thread(target=self._tick_loop,
                                      daemon=True,
                                      name="rtpu-data-service-tick")
        self._tick.start()

    # ---- plumbing ----------------------------------------------------------

    def ping(self) -> bool:
        return True

    def pid(self) -> int:
        import os  # noqa: PLC0415
        return os.getpid()

    def incarnation(self) -> int:
        return self._incarnation

    # ---- registration ------------------------------------------------------

    def register_dataset(self, key: str, plan_blob: bytes,
                         n_slices: int) -> Dict[str, Any]:
        with self._lock:
            ds = self._datasets.get(key)
            if ds is None:
                self._datasets[key] = {"plan": plan_blob,
                                       "n_slices": int(n_slices)}
            elif ds["plan"] != plan_blob:
                # sharing a key across jobs means sharing PRODUCTION;
                # silently keeping the first plan would feed the
                # second job someone else's data
                return {"error":
                        f"dataset {key!r} is already registered "
                        f"with a different plan; use a distinct "
                        f"dataset_name (or the same plan) to share"}
            return {"ok": True, "n_slices":
                    self._datasets[key]["n_slices"]}

    def register_job(self, job_name: str, key: str, mode: str,
                     world: int, epochs: int) -> Dict[str, Any]:
        """Idempotent per (job_name, world); a different world is a
        RESHARD: generation bumps, outstanding grants revoke back to
        pending, consumers drop (they re-attach under the new
        generation), acked blocks stay acked."""
        assert mode in ("fcfs", "round_robin"), mode
        revoked: List[Tuple[str, str]] = []
        with self._lock:
            if key not in self._datasets:
                return {"error": f"unknown dataset {key!r}"}
            job = self._jobs.get(job_name)
            if job is None:
                self._jobs[job_name] = {
                    "dataset": key, "mode": mode, "world": int(world),
                    "epochs": int(epochs), "generation": 0,
                    "epoch": 0, "consumers": {}, "granted": {},
                    "acked": set(), "needs_reconcile": set()}
                for e, ep in (self._prod.get(key) or {}).items():
                    if e < int(epochs) and job_name not in ep["jobs"]:
                        ep["jobs"].append(job_name)
                        self._revive_retired_locked(key, ep, job_name)
                gen = 0
            elif job["world"] != int(world) or job["mode"] != mode:
                job["generation"] += 1
                job["world"] = int(world)
                job["mode"] = mode
                job["epochs"] = max(job["epochs"], int(epochs))
                revoked = [(b, c) for b, c in job["granted"].items()]
                job["granted"] = {}
                job["consumers"] = {}
                job["needs_reconcile"] = set()
                gen = job["generation"]
            else:
                job["epochs"] = max(job["epochs"], int(epochs))
                gen = job["generation"]
        for b, c in revoked:
            _emit("data.service.shard.revoke",
                  f"shard {b} revoked from {c} (job {job_name} "
                  f"resharded to world={world})",
                  job=job_name, bid=b, consumer=c, cause="reshard")
        _emit("data.service.register",
              f"job {job_name!r} registered on dataset {key[:12]} "
              f"(mode={mode}, world={world}, epochs={epochs}, "
              f"generation={gen})",
              job=job_name, dataset=key[:12], mode=mode,
              world=str(world), generation=str(gen))
        return {"generation": gen}

    def _revive_retired_locked(self, key: str, ep: Dict[str, Any],
                               job_name: str) -> None:
        """A job joined an epoch late: blocks retired (ref dropped)
        before it registered were only acked by the PREVIOUS jobs and
        must be re-produced for the newcomer. Clear their retired flag
        (so re-offers are accepted and dispatch stops skip-listing
        their seqs) and re-pend the done slices that own them; slices
        still running converge through slice_done's missing-bid check.
        Double production is harmless — offers dedup by deterministic
        block id."""
        ds = self._datasets.get(key)
        if ds is None:
            return
        n_slices = ds["n_slices"]
        stale_slices: Set[int] = set()
        for m in ep["bids"].values():
            if m.get("retired") and job_name not in m["acked_by"]:
                m["retired"] = False
                stale_slices.add(m["idx"] % n_slices)
        for i in stale_slices:
            sl = ep["slices"].get(i)
            if sl is not None and sl["state"] == "done":
                sl["state"] = "pending"
                sl["worker"] = None
        if stale_slices:
            ep["complete"] = False

    def attach_consumer(self, job_name: str, cid: str,
                        rank: Optional[int] = None) -> Dict[str, Any]:
        """Attach (or re-attach) a consumer. Re-attaching an existing
        cid bumps its generation and requires a reconcile (the
        fencing idiom: the old incarnation's grants are revoked; its
        acks with the old generation are rejected)."""
        revoked: List[str] = []
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return {"error": f"unknown job {job_name!r}"}
            if job["mode"] == "round_robin":
                if rank is None or not 0 <= rank < job["world"]:
                    return {"error": f"round_robin consumers need "
                            f"rank in [0, {job['world']})"}
            cons = job["consumers"].get(cid)
            lease = time.time() + _knob_float(
                "RAY_TPU_DATA_SERVICE_LEASE_S")
            if cons is None:
                job["consumers"][cid] = {
                    "rank": rank, "generation": 0, "lease": lease,
                    "consumed": 0, "fenced": False}
                gen = 0
            else:
                cons["generation"] += 1
                cons["fenced"] = False
                cons["lease"] = lease
                cons["rank"] = rank
                # the old incarnation's grants are about to revoke:
                # its cached next_shard reply must not replay
                cons.pop("last_req", None)
                cons.pop("last_reply", None)
                gen = cons["generation"]
                revoked = [b for b, c in job["granted"].items()
                           if c == cid]
                for b in revoked:
                    del job["granted"][b]
                job["needs_reconcile"].add(cid)
        for b in revoked:
            _emit("data.service.shard.revoke",
                  f"shard {b} revoked: consumer {cid} re-attached",
                  job=job_name, bid=b, consumer=cid, cause="reattach")
        return {"generation": gen,
                "job_generation": self._jobs[job_name]["generation"],
                "epoch": self._jobs[job_name]["epoch"]}

    # ---- grants ------------------------------------------------------------

    def _eligible(self, job: Dict[str, Any], ep: Dict[str, Any],
                  rank: Optional[int]) -> List[Tuple[int, str]]:
        """(idx, bid) candidates for one consumer, idx-ascending:
        produced (live ref), not granted, not acked, rank-matched."""
        world = job["world"]
        out = []
        for b, m in ep["bids"].items():
            if m["ref"] is None or b in job["granted"] \
                    or b in job["acked"]:
                continue
            if job["mode"] == "round_robin" \
                    and m["idx"] % world != rank:
                continue
            out.append((m["idx"], b))
        out.sort()
        return out

    def _epoch_fully_granted(self, job: Dict[str, Any],
                             ep: Dict[str, Any]) -> bool:
        return ep["complete"] and all(
            b in job["granted"] or b in job["acked"]
            for b in ep["bids"])

    def _apply_acks(self, job_name: str, job: Dict[str, Any],
                    cid: str, acks: List[str]) -> None:
        key = job["dataset"]
        for b in acks or ():
            if job["granted"].get(b) == cid:
                del job["granted"][b]
            if b in job["acked"]:
                continue
            job["acked"].add(b)
            cons = job["consumers"].get(cid)
            if cons is not None:
                cons["consumed"] += 1
            for ep in (self._prod.get(key) or {}).values():
                m = ep["bids"].get(b)
                if m is not None:
                    m["acked_by"].add(job_name)
                    self._maybe_retire(ep, b, m)

    def _maybe_retire(self, ep: Dict[str, Any], b: str,
                      m: Dict[str, Any]) -> None:
        if all(j in m["acked_by"] for j in ep["jobs"]
               if j in self._jobs):
            m["ref"] = None          # every job consumed it: drop ref
            m["retired"] = True

    def next_shard(self, job_name: str, cid: str, gen: int,
                   acks: Optional[List[str]] = None,
                   req: Optional[str] = None) -> Dict[str, Any]:
        """The consumer verb: piggybacked acks + one grant attempt.
        Never blocks — barrier / production lag / reconcile gates
        return {"status": "wait"|"reconcile"|...} for the client to
        poll. `req` is the client's per-request nonce: a retried call
        (RPC reply lost in transit) replays the cached grant instead
        of handing out a second block, so the verb is idempotent and
        no grant is ever stranded on a timed-out reply."""
        reply: Optional[Dict[str, Any]] = None
        advanced: Optional[int] = None
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return {"status": "stale",
                        "why": f"unknown job {job_name!r}"}
            cons = job["consumers"].get(cid)
            if cons is None or cons["fenced"] \
                    or gen != cons["generation"]:
                return {"status": "stale", "why": "fenced or stale "
                        "generation; re-attach and reconcile"}
            cons["lease"] = time.time() + _knob_float(
                "RAY_TPU_DATA_SERVICE_LEASE_S")
            self._apply_acks(job_name, job, cid, acks or [])
            if cid in job["needs_reconcile"]:
                return {"status": "reconcile"}
            if job["needs_reconcile"]:
                return {"status": "wait", "why": "peers reconciling"}
            if req is not None and cons.get("last_req") == req:
                # retry of a request whose reply we already computed:
                # replay it (the cached grant is still in job
                # ["granted"] for this cid)
                return dict(cons["last_reply"])
            e = job["epoch"]
            if e >= job["epochs"]:
                return {"status": "end"}
            ep = (self._prod.get(job["dataset"]) or {}).get(e)
            if ep is None:
                return {"status": "wait", "why": "epoch not started"}
            cands = self._eligible(job, ep, cons["rank"])
            if not cands:
                # epoch barrier: advance only when EVERY shard of this
                # epoch has been handed out (granted or acked)
                if self._epoch_fully_granted(job, ep):
                    job["epoch"] = e + 1
                    advanced = e + 1
            else:
                idx, b = cands[0]
                m = ep["bids"][b]
                job["granted"][b] = cid
                reply = {"status": "grant", "bid": b,
                         "ref": m["ref"], "nbytes": m["nbytes"],
                         "epoch": e, "idx": m["idx"]}
                if req is not None:
                    cons["last_req"] = req
                    cons["last_reply"] = dict(reply)
        if advanced is not None:
            _emit("data.service.epoch",
                  f"job {job_name} advanced to epoch {advanced}",
                  job=job_name, epoch=str(advanced))
            return {"status": "wait", "why": "epoch advanced",
                    "epoch": advanced}
        if reply is None:
            return {"status": "wait",
                    "why": "barrier or production lag"}
        _emit("data.service.shard.grant",
              f"shard {reply['bid']} granted to {cid} "
              f"(job {job_name})",
              job=job_name, bid=reply["bid"], consumer=cid,
              epoch=str(reply["epoch"]))
        c = _mcat_get("ray_tpu_data_service_shards_granted_total")
        if c is not None:
            c.inc(tags={"job": job_name,
                        "mode": self._jobs[job_name]["mode"]})
        return reply

    def ack(self, job_name: str, cid: str, gen: int,
            acks: List[str]) -> Dict[str, Any]:
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return {"ok": False}
            cons = job["consumers"].get(cid)
            if cons is None or gen != cons["generation"]:
                return {"ok": False, "status": "stale"}
            self._apply_acks(job_name, job, cid, acks)
            return {"ok": True}

    def reconcile(self, job_name: str, cid: str, gen: int,
                  consumed: List[str]) -> Dict[str, Any]:
        """Post-restore / post-re-attach dedup: the consumer reports
        every block id it already consumed; those become acks (idempo-
        tent), anything it was granted but did not consume returns to
        the pending pool."""
        dropped: List[str] = []
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return {"ok": False}
            cons = job["consumers"].get(cid)
            if cons is None or gen != cons["generation"]:
                return {"ok": False, "status": "stale"}
            self._apply_acks(job_name, job, cid, consumed)
            # a re-attached consumer's seek position must reflect what
            # it consumed in its previous incarnation (fast_forward
            # compares against this count)
            cons["consumed"] = max(cons["consumed"],
                                   len(set(consumed)))
            dropped = [b for b, c in job["granted"].items()
                       if c == cid]
            for b in dropped:
                del job["granted"][b]
            # dropped grants must not replay out of the nonce cache
            cons.pop("last_req", None)
            cons.pop("last_reply", None)
            job["needs_reconcile"].discard(cid)
        for b in dropped:
            _emit("data.service.shard.revoke",
                  f"shard {b} returned to pending on reconcile of "
                  f"{cid}", job=job_name, bid=b, consumer=cid,
                  cause="reconcile")
        return {"ok": True}

    def refetch(self, job_name: str, cid: str, gen: int, bid: str
                ) -> Dict[str, Any]:
        """A consumer's get() on a granted ref failed (holder worker
        died): return the re-produced ref once available. Fenced the
        same way as next_shard/ack — a stale consumer must not keep
        pulling refs for a block that was revoked and re-granted
        elsewhere (that would double-deliver the value)."""
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return {"status": "stale",
                        "why": f"unknown job {job_name!r}"}
            cons = job["consumers"].get(cid)
            if cons is None or cons["fenced"] \
                    or gen != cons["generation"]:
                return {"status": "stale", "why": "fenced or stale "
                        "generation; re-attach and reconcile"}
            if job["granted"].get(bid) != cid:
                return {"status": "stale",
                        "why": f"{bid} is not granted to {cid}"}
            for ep in (self._prod.get(job["dataset"]) or {}).values():
                m = ep["bids"].get(bid)
                if m is not None:
                    if m["ref"] is not None:
                        return {"status": "grant", "bid": bid,
                                "ref": m["ref"],
                                "nbytes": m["nbytes"]}
                    return {"status": "wait", "why": "re-producing"}
        return {"status": "wait", "why": "unknown bid"}

    def _seek_prefix(self, job: Dict[str, Any], ep: Dict[str, Any],
                     rank: Optional[int], want: int
                     ) -> Tuple[List[str], bool]:
        """The next `want` block indices of this consumer's class (every
        index under fcfs, those of its rank under round_robin), in index
        order, that no consumer of the job holds or acked: (the bids of
        those already produced, whether one of them is still to come).
        An index counts while its slice may still produce it, so a
        lagging slice's block keeps its place in the prefix and a later
        block never takes it."""
        n_slices = self._datasets[job["dataset"]]["n_slices"]
        step, idx = 1, 0
        if job["mode"] == "round_robin":
            step, idx = job["world"], rank
        by_idx = {m["idx"]: b for b, m in ep["bids"].items()}
        # past the highest offered index, each slice still running has
        # an index of this class within n_slices * step
        last = max(by_idx, default=-1) + n_slices * step
        ready: List[str] = []
        missing = False
        slots = 0
        while slots < want and idx <= last:
            b = by_idx.get(idx)
            if b is None:
                if ep["slices"][idx % n_slices]["state"] != "done":
                    missing = True         # not produced yet
                    slots += 1
            elif b not in job["granted"] and b not in job["acked"]:
                if ep["bids"][b]["ref"] is None:
                    missing = True         # lost, being produced again
                else:
                    ready.append(b)
                slots += 1
            idx += step
        return ready, missing

    def fast_forward(self, job_name: str, cid: str, gen: int,
                     n: int) -> Dict[str, Any]:
        """Resume hook: grant-and-auto-ack the index-order prefix of
        this consumer's blocks until its consumed count reaches n — an
        absolute seek, cheap because nothing is fetched. A block of the
        prefix that is not produced yet is waited for (the reply comes
        back short and the client polls), never replaced by a later
        one; the prefix's produced blocks are acked meanwhile, so they
        free the produce-ahead budget the lagging slice waits on.
        Returns how many were skipped."""
        skipped = 0
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return {"skipped": 0, "status": "stale"}
            cons = job["consumers"].get(cid)
            if cons is None or gen != cons["generation"]:
                return {"skipped": 0, "status": "stale"}
            while cons["consumed"] < n and job["epoch"] < job["epochs"]:
                ep = (self._prod.get(job["dataset"]) or {}).get(
                    job["epoch"])
                if ep is None:
                    break
                ready, missing = self._seek_prefix(
                    job, ep, cons["rank"], n - cons["consumed"])
                for b in ready:
                    job["granted"][b] = cid
                    self._apply_acks(job_name, job, cid, [b])
                    skipped += 1
                if missing or cons["consumed"] >= n:
                    break
                # this epoch holds no more of the consumer's blocks:
                # absolute seeks may span epochs, so cross the barrier
                # the same way next_shard does
                if self._epoch_fully_granted(job, ep):
                    job["epoch"] += 1
                    continue
                break
            consumed = cons["consumed"]
            done = job["epoch"] >= job["epochs"]
        return {"skipped": skipped, "consumed": consumed, "done": done}

    # ---- producer verbs ----------------------------------------------------

    def offer_block(self, key: str, epoch: int, slice_idx: int,
                    seq: int, ref_id: str, nbytes: int,
                    worker: str) -> Dict[str, Any]:
        b = _bid(epoch, slice_idx, seq)
        with self._lock:
            ds = self._datasets.get(key)
            eps = self._prod.setdefault(key, {})
            ep = eps.get(epoch)
            if ds is None or ep is None:
                return {"outstanding": 0, "ignored": True}
            m = ep["bids"].get(b)
            if m is not None and m.get("retired"):
                return {"outstanding": self._queue_depth_locked(key)}
            if m is not None and m["ref"] is not None:
                alive = self._workers.get(m["worker"], {})
                if alive.get("state") == "alive":
                    # duplicate offer (re-produced race): keep first
                    return {"outstanding":
                            self._queue_depth_locked(key)}
            idx = seq * ds["n_slices"] + slice_idx
            prev = m or {"acked_by": set()}
            ep["bids"][b] = {"ref": ref_id, "nbytes": int(nbytes),
                             "worker": worker, "idx": idx,
                             "acked_by": prev["acked_by"],
                             "retired": False}
            out = self._queue_depth_locked(key)
        return {"outstanding": out}

    def slice_done(self, key: str, epoch: int, slice_idx: int,
                   worker: str) -> Dict[str, Any]:
        with self._lock:
            ep = (self._prod.get(key) or {}).get(epoch)
            ds = self._datasets.get(key)
            if ep is None or ds is None:
                return {"ok": False}
            sl = ep["slices"].get(slice_idx)
            if sl is not None:
                # a bid with no ref that is NOT retired was revived
                # mid-run (late job registration) or lost: this run's
                # skip list predates it, so the slice must go around
                # again with a fresh skip list
                missing = any(
                    m["ref"] is None and not m.get("retired")
                    and m["idx"] % ds["n_slices"] == slice_idx
                    for m in ep["bids"].values())
                if missing:
                    sl["state"] = "pending"
                    sl["worker"] = None
                else:
                    sl["state"] = "done"
            w = self._workers.get(worker)
            if w is not None and w.get("busy") == (key, epoch,
                                                  slice_idx):
                w["busy"] = None
                w["idle_since"] = time.time()
            ep["complete"] = all(s["state"] == "done"
                                 for s in ep["slices"].values())
            complete = ep["complete"]
        if complete:
            _emit("data.service.epoch",
                  f"epoch {epoch} production complete for dataset "
                  f"{key[:12]}", dataset=key[:12], epoch=str(epoch),
                  phase="produced")
        return {"ok": True}

    def _queue_depth_locked(self, key: str) -> int:
        n = 0
        for ep in (self._prod.get(key) or {}).values():
            n += sum(1 for m in ep["bids"].values()
                     if m["ref"] is not None)
        return n

    def queue_depth(self, key: str) -> Dict[str, Any]:
        with self._lock:
            return {"outstanding": self._queue_depth_locked(key)}

    # ---- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            jobs = {}
            for name, j in self._jobs.items():
                jobs[name] = {
                    "mode": j["mode"], "world": j["world"],
                    "epoch": j["epoch"], "epochs": j["epochs"],
                    "generation": j["generation"],
                    "granted": len(j["granted"]),
                    "acked": len(j["acked"]),
                    "consumers": {
                        c: {"rank": v["rank"],
                            "generation": v["generation"],
                            "consumed": v["consumed"],
                            "fenced": v["fenced"]}
                        for c, v in j["consumers"].items()},
                    "needs_reconcile":
                        sorted(j["needs_reconcile"])}
            prod = {}
            for key, eps in self._prod.items():
                prod[key] = {
                    str(e): {"jobs": sorted(ep["jobs"]),
                             "n_bids": len(ep["bids"]),
                             "complete": ep["complete"]}
                    for e, ep in eps.items()}
            return {
                "incarnation": self._incarnation,
                "workers": {n: {"state": w["state"],
                                "busy": w.get("busy")}
                            for n, w in self._workers.items()},
                "queue_depth": {k: self._queue_depth_locked(k)
                                for k in self._datasets},
                "datasets": {k: d["n_slices"]
                             for k, d in self._datasets.items()},
                "prod": prod,
                "jobs": jobs}

    # ---- persistence (the actor WAL) ---------------------------------------

    def __ray_save__(self) -> Dict[str, Any]:
        with self._lock:
            prod = {}
            for key, eps in self._prod.items():
                prod[key] = {}
                for e, ep in eps.items():
                    prod[key][e] = {
                        "bids": {b: {"ref": m["ref"],
                                     "nbytes": m["nbytes"],
                                     "worker": m["worker"],
                                     "idx": m["idx"],
                                     "acked_by":
                                         sorted(m["acked_by"]),
                                     "retired":
                                         m.get("retired", False)}
                                 for b, m in ep["bids"].items()},
                        "slices": {i: {"state": s["state"],
                                       "worker": s.get("worker")}
                                   for i, s in ep["slices"].items()},
                        "complete": ep["complete"],
                        "jobs": list(ep["jobs"])}
            jobs = {}
            for name, j in self._jobs.items():
                jobs[name] = {
                    "dataset": j["dataset"], "mode": j["mode"],
                    "world": j["world"], "epochs": j["epochs"],
                    "generation": j["generation"],
                    "epoch": j["epoch"],
                    "granted": dict(j["granted"]),
                    "acked": sorted(j["acked"]),
                    "consumers": {c: dict(v) for c, v
                                  in j["consumers"].items()}}
            return {"v": 1, "incarnation": self._incarnation,
                    "worker_seq": self._worker_seq,
                    "worker_names": [n for n, w
                                     in self._workers.items()
                                     if w["state"] == "alive"],
                    "datasets": {k: dict(v) for k, v
                                 in self._datasets.items()},
                    "prod": prod, "jobs": jobs}

    def __ray_restore__(self, saved: Dict[str, Any]) -> None:
        with self._lock:
            self._incarnation = int(saved.get("incarnation", 0)) + 1
            self._worker_seq = int(saved.get("worker_seq", 0))
            self._datasets = {k: dict(v) for k, v
                              in (saved.get("datasets") or {}).items()}
            self._prod = {}
            for key, eps in (saved.get("prod") or {}).items():
                self._prod[key] = {}
                for e, ep in eps.items():
                    self._prod[key][int(e)] = {
                        "bids": {b: {"ref": m["ref"],
                                     "nbytes": m["nbytes"],
                                     "worker": m["worker"],
                                     "idx": m["idx"],
                                     "acked_by":
                                         set(m["acked_by"]),
                                     "retired": m["retired"]}
                                 for b, m in ep["bids"].items()},
                        # running slices re-verify in the first tick
                        "slices": {int(i): {"state": s["state"],
                                            "worker":
                                                s.get("worker")}
                                   for i, s in ep["slices"].items()},
                        "complete": ep["complete"],
                        "jobs": list(ep["jobs"])}
            self._jobs = {}
            for name, j in (saved.get("jobs") or {}).items():
                self._jobs[name] = {
                    "dataset": j["dataset"], "mode": j["mode"],
                    "world": j["world"], "epochs": j["epochs"],
                    "generation": j["generation"],
                    "epoch": j["epoch"],
                    "granted": dict(j["granted"]),
                    "acked": set(j["acked"]),
                    "consumers": {c: dict(v) for c, v
                                  in j["consumers"].items()},
                    # the grant/checkpoint race: every consumer must
                    # reconcile before new grants flow for this job
                    "needs_reconcile":
                        set(j["consumers"].keys())}
            self._restored_worker_names = list(
                saved.get("worker_names") or [])
        _emit("data.service.register",
              f"dispatcher restored (incarnation "
              f"{self._incarnation}); {len(self._jobs)} job(s) "
              f"gated on consumer reconcile",
              incarnation=str(self._incarnation), phase="restore")

    # ---- tick: autoscale + production + leases + metrics -------------------

    def _tick_loop(self) -> None:
        tick_s = _knob_float("RAY_TPU_DATA_SERVICE_TICK_S")
        while not self._shutdown.is_set():
            try:
                self._reattach_restored_workers()
                self._check_worker_liveness()
                self._expire_leases()
                self._scale_workers()
                self._dispatch_slices()
                self._update_metrics()
            except Exception:  # noqa: BLE001 — the loop must survive
                import traceback  # noqa: PLC0415
                traceback.print_exc()
            self._shutdown.wait(tick_s)

    def _reattach_restored_workers(self) -> None:
        with self._lock:
            names = list(self._restored_worker_names)
            self._restored_worker_names = []
        if not names:
            return
        api = _api()
        for name in names:
            try:
                h = api.get_actor(name, timeout=1.0)
                api.get(h.ping.remote(), timeout=5.0)
                with self._lock:
                    self._workers[name] = {
                        "handle": h, "state": "alive", "busy": None,
                        "idle_since": time.time()}
            except Exception:  # noqa: BLE001 — worker died with us
                self._on_worker_dead(name)
        # EVERY slice checkpointed as "running" is re-queued — even on a
        # worker that came back alive: its in-flight produce_slice may
        # have died retrying offer_block against the restarting
        # dispatcher, and slice_done would then never arrive. If the old
        # task IS still running, double production is harmless — offers
        # dedup by deterministic block id and retired seqs are skipped.
        with self._lock:
            for eps in self._prod.values():
                for ep in eps.values():
                    for sl in ep["slices"].values():
                        if sl["state"] == "running":
                            sl["state"] = "pending"
                            sl["worker"] = None

    def _check_worker_liveness(self) -> None:
        with self._lock:
            busy = [(n, w["handle"]) for n, w in self._workers.items()
                    if w["state"] == "alive" and w.get("busy")]
        api = _api()
        for name, h in busy:
            try:
                api.get(h.ping.remote(), timeout=10.0)
            except Exception:  # noqa: BLE001 — died or wedged
                self._on_worker_dead(name)

    def _on_worker_dead(self, name: str) -> None:
        """Re-queue the dead worker's slices and invalidate every
        unretired ref it held (its store died with it); grants stay
        outstanding — consumers refetch after re-production."""
        requeued: List[Tuple[str, int, int]] = []
        with self._lock:
            w = self._workers.get(name)
            if w is not None:
                w["state"] = "dead"
                w["busy"] = None
            for key, eps in self._prod.items():
                for e, ep in eps.items():
                    lost = False
                    for b, m in ep["bids"].items():
                        if m["worker"] == name \
                                and not m.get("retired") \
                                and m["ref"] is not None:
                            m["ref"] = None
                            lost = True
                    for i, sl in ep["slices"].items():
                        if sl.get("worker") == name \
                                and sl["state"] != "pending":
                            sl["state"] = "pending"
                            sl["worker"] = None
                            requeued.append((key, e, i))
                        elif lost and sl["state"] == "done" and any(
                                m["worker"] == name
                                and m["ref"] is None
                                and not m.get("retired")
                                for b, m in ep["bids"].items()
                                if b.startswith(_bid(e, i, 0)[:-2])):
                            sl["state"] = "pending"
                            sl["worker"] = None
                            ep["complete"] = False
                            requeued.append((key, e, i))
        for key, e, i in requeued:
            _emit("data.service.shard.revoke",
                  f"slice s{i} of epoch {e} re-queued: worker "
                  f"{name} died", dataset=key[:12], epoch=str(e),
                  slice=str(i), consumer=name, cause="worker_death")

    def _expire_leases(self) -> None:
        now = time.time()
        revoked: List[Tuple[str, str, str]] = []
        with self._lock:
            for job_name, job in self._jobs.items():
                for cid, cons in job["consumers"].items():
                    if cons["fenced"] or cons["lease"] >= now:
                        continue
                    cons["fenced"] = True
                    job["needs_reconcile"].discard(cid)
                    for b in [b for b, c in job["granted"].items()
                              if c == cid]:
                        del job["granted"][b]
                        revoked.append((job_name, cid, b))
        for job_name, cid, b in revoked:
            _emit("data.service.shard.revoke",
                  f"shard {b} revoked: consumer {cid} lease expired",
                  job=job_name, bid=b, consumer=cid,
                  cause="lease_expired")

    def _scale_workers(self) -> None:
        """Synthetic node-type autoscaling: the pool is one
        NodeType; pending slices are the demand; upscale_step clamps
        the launch rate."""
        from ..core.autoscaler import NodeType, upscale_step  # noqa: PLC0415
        nt = NodeType("data_worker", {"CPU": 1.0},
                      min_workers=self._min_workers,
                      max_workers=self._max_workers)
        now = time.time()
        with self._lock:
            if self._shutdown.is_set():
                return
            alive = [n for n, w in self._workers.items()
                     if w["state"] == "alive"]
            pending = sum(
                1 for eps in self._prod.values()
                for ep in eps.values()
                for sl in ep["slices"].values()
                if sl["state"] == "pending")
            busy = sum(1 for n in alive
                       if self._workers[n].get("busy"))
            want = min(max(nt.min_workers, pending + busy),
                       nt.max_workers)
            have = len(alive)
            to_spawn = 0
            if want > have:
                to_spawn = upscale_step(have, want - have, 1.0)
            victims: List[str] = []
            if want < have:
                idle_cut = now - 4 * _knob_float(
                    "RAY_TPU_DATA_SERVICE_TICK_S")
                for n in alive:
                    if have - len(victims) <= want:
                        break
                    w = self._workers[n]
                    if not w.get("busy") \
                            and w.get("idle_since", now) < idle_cut:
                        victims.append(n)
            names = []
            for _ in range(to_spawn):
                names.append(_WORKER_NAME_FMT.format(
                    self._worker_seq))
                self._worker_seq += 1
        api = _api()
        for name in names:
            try:
                cls = api.remote(num_cpus=1, max_concurrency=2)(
                    _DataWorkerImpl)
                h = cls.options(name=name).remote(
                    SERVICE_ACTOR_NAME, name)
                with self._lock:
                    # graceful_shutdown sets the event before it takes
                    # the lock: a worker spawned across it is killed
                    late = self._shutdown.is_set()
                    if not late:
                        self._workers[name] = {
                            "handle": h, "state": "alive", "busy": None,
                            "idle_since": time.time()}
                if late:
                    api.kill(h)
            except Exception:  # noqa: BLE001 — retried next tick
                import traceback  # noqa: PLC0415
                traceback.print_exc()
        for name in victims:
            with self._lock:
                w = self._workers.pop(name, None)
            if w is None:
                continue
            try:
                api.kill(w["handle"])
            except Exception:  # noqa: BLE001
                pass
        if names or victims:
            _emit("data.service.worker.scale",
                  f"data-worker pool scaled: +{len(names)} "
                  f"-{len(victims)} (want {want}, min "
                  f"{nt.min_workers}, max {nt.max_workers})",
                  spawned=str(len(names)), killed=str(len(victims)),
                  want=str(want))

    def _dispatch_slices(self) -> None:
        # start production for any epoch some registered job needs
        assignments: List[Tuple[Any, bytes, str, int, int, int,
                                List[int], str]] = []
        with self._lock:
            for job in self._jobs.values():
                key, e = job["dataset"], job["epoch"]
                if e >= job["epochs"]:
                    continue
                ds = self._datasets.get(key)
                if ds is None:
                    continue
                eps = self._prod.setdefault(key, {})
                if e not in eps:
                    eps[e] = {
                        "bids": {},
                        "slices": {i: {"state": "pending",
                                       "worker": None}
                                   for i in range(ds["n_slices"])},
                        "complete": False,
                        "jobs": [n for n, j in self._jobs.items()
                                 if j["dataset"] == key
                                 and j["epoch"] <= e < j["epochs"]]}
            idle = [n for n, w in self._workers.items()
                    if w["state"] == "alive" and not w.get("busy")]
            for key, eps in self._prod.items():
                ds = self._datasets.get(key)
                if ds is None:
                    continue
                for e, ep in eps.items():
                    for i, sl in ep["slices"].items():
                        if sl["state"] != "pending" or not idle:
                            continue
                        name = idle.pop()
                        w = self._workers[name]
                        sl["state"] = "running"
                        sl["worker"] = name
                        w["busy"] = (key, e, i)
                        skip = [int(b.split("-b")[1])
                                for b, m in ep["bids"].items()
                                if m.get("retired")
                                and b.startswith(f"e{e}-s{i}-")]
                        assignments.append(
                            (w["handle"], ds["plan"], key, e, i,
                             ds["n_slices"], skip, name))
        for h, plan, key, e, i, n_slices, skip, name in assignments:
            try:
                h.produce_slice.remote(plan, key, e, i, n_slices,
                                       skip)
            except Exception:  # noqa: BLE001 — liveness check requeues
                self._on_worker_dead(name)

    def _update_metrics(self) -> None:
        g_depth = _mcat_get("ray_tpu_data_service_queue_depth")
        g_out = _mcat_get("ray_tpu_data_service_outstanding_shards")
        g_lag = _mcat_get("ray_tpu_data_service_consumer_lag")
        if g_depth is None:
            return
        with self._lock:
            for key in self._datasets:
                g_depth.set(float(self._queue_depth_locked(key)),
                            tags={"dataset": key[:12]})
            for name, job in self._jobs.items():
                g_out.set(float(len(job["granted"])),
                          tags={"job": name})
                ep = (self._prod.get(job["dataset"]) or {}).get(
                    job["epoch"])
                for cid, cons in job["consumers"].items():
                    if ep is None:
                        lag = 0
                    else:
                        world = job["world"]
                        eligible = sum(
                            1 for m in ep["bids"].values()
                            if job["mode"] != "round_robin"
                            or m["idx"] % world == cons["rank"])
                        lag = max(0, eligible - cons["consumed"])
                    g_lag.set(float(lag), tags={"job": name,
                                                "consumer": cid})

    def graceful_shutdown(self) -> Dict[str, Any]:
        self._shutdown.set()
        with self._lock:
            # a worker marked dead after a missed ping may only have
            # been wedged (a cold import) and is still up: kill it too
            handles = [w["handle"] for w in self._workers.values()]
            self._workers = {}
        api = _api()
        for h in handles:
            try:
                api.kill(h)
            except Exception:  # noqa: BLE001
                pass
        return {"ok": True}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class StaleConsumerError(RuntimeError):
    """The dispatcher fenced this consumer and automatic re-attach +
    reconcile could not recover it."""


class _GrantRevoked(Exception):
    """A granted shard was revoked mid-fetch (lease expiry / reshard):
    the value must not be consumed — re-attach and re-request."""


def start_service(*, min_workers: Optional[int] = None,
                  max_workers: Optional[int] = None,
                  name: str = SERVICE_ACTOR_NAME):
    """Get-or-create the named dispatcher actor. Restart-capable
    (max_restarts) with checkpoint-after-every-call so a SIGKILL'd
    dispatcher resumes mid-epoch from its WAL checkpoint."""
    api = _api()
    cls = api.remote(num_cpus=0.1, max_restarts=4,
                     checkpoint_interval_s=0)(DataServiceDispatcher)
    return cls.options(name=name, get_if_exists=True).remote(
        min_workers, max_workers)


def _dispatcher(name: str = SERVICE_ACTOR_NAME, timeout: float = 5.0):
    api = _api()
    try:
        return api.get_actor(name, timeout=timeout)
    except ValueError:
        return start_service(name=name)


def _call(method: str, *args, name: str = SERVICE_ACTOR_NAME,
          timeout: float = 60.0):
    """Dispatcher call that rides out a dispatcher restart (same actor
    id comes back; the handle stays valid — retry until it answers)."""
    api = _api()
    deadline = time.time() + timeout
    last: Optional[BaseException] = None
    while time.time() < deadline:
        try:
            disp = _dispatcher(name)
            ref = getattr(disp, method).remote(*args)
            return api.get(ref, timeout=15.0)
        except Exception as e:  # noqa: BLE001 — restart window
            last = e
            time.sleep(0.2)
    raise RuntimeError(f"data service unreachable for {method} "
                       f"({last!r})")


def register(ds, job_name: str, *, mode: str = "fcfs",
             world_size: int = 1, epochs: int = 1,
             dataset_name: Optional[str] = None,
             n_slices: Optional[int] = None) -> str:
    """Register a dataset plan + a job against the shared service.
    Jobs passing the same `dataset_name` (or byte-identical plans)
    SHARE production: each block is produced once and granted once per
    job. Returns the dataset key. Idempotent per (job_name, world) —
    re-registering with a different world_size is a reshard."""
    mode = {"rr": "round_robin"}.get(mode, mode)
    if mode not in ("fcfs", "round_robin"):
        raise ValueError(f"mode must be fcfs|round_robin, got {mode!r}")
    blob = plan_bytes_of(ds)
    key = dataset_name or hashlib.sha1(blob).hexdigest()[:16]
    if n_slices is None:
        n_slices = _knob_int("RAY_TPU_DATA_SERVICE_MAX_WORKERS")
    start_service()
    out = _call("register_dataset", key, blob, int(n_slices))
    if "error" in out:
        raise ValueError(out["error"])
    out = _call("register_job", job_name, key, mode, int(world_size),
                int(epochs))
    if "error" in out:
        raise ValueError(out["error"])
    return key


def iterator(job_name: str, *, rank: Optional[int] = None,
             consumer_id: Optional[str] = None
             ) -> "DataServiceIterator":
    """Per-consumer block iterator for a registered job."""
    return DataServiceIterator(job_name, rank=rank,
                               consumer_id=consumer_id)


class DataServiceIterator:
    """Client-side shard iterator: polls the dispatcher for grants,
    pulls block values over the peer transfer plane, piggybacks acks
    on the next grant request, and self-heals through dispatcher
    restarts (reconcile) and its own lease expiry (re-attach).

    `stats` carries {"blocks", "bytes", "relay_bytes"}: relay_bytes is
    the exchange.py-style driver-relay fallback delta observed across
    this iterator's fetches — the acceptance bar is zero.
    """

    def __init__(self, job_name: str, *, rank: Optional[int] = None,
                 consumer_id: Optional[str] = None,
                 service_name: str = SERVICE_ACTOR_NAME):
        import uuid  # noqa: PLC0415
        self._job = job_name
        self._rank = rank
        self._name = service_name
        self._cid = consumer_id or f"c-{uuid.uuid4().hex[:8]}"
        self._pending_acks: List[str] = []
        self._consumed: List[str] = []      # bids, in consumption order
        self._done = False
        self.stats: Dict[str, int] = {"blocks": 0, "bytes": 0,
                                      "relay_bytes": 0}
        out = _call("attach_consumer", self._job, self._cid, rank,
                    name=service_name)
        if "error" in out:
            raise ValueError(out["error"])
        self._gen = out["generation"]

    # -- internals ----------------------------------------------------------

    def _runtime(self):
        from ..core import runtime as runtime_mod  # noqa: PLC0415
        if runtime_mod.runtime_initialized():
            return runtime_mod.get_runtime()
        return None

    def _reattach(self) -> None:
        out = _call("attach_consumer", self._job, self._cid,
                    self._rank, name=self._name)
        if "error" in out:
            raise StaleConsumerError(out["error"])
        self._gen = out["generation"]
        self._reconcile()

    def _reconcile(self) -> None:
        _call("reconcile", self._job, self._cid, self._gen,
              list(self._consumed), name=self._name)
        self._pending_acks = []

    def _fetch(self, grant: Dict[str, Any]):
        """Pull the block value; if the holder died mid-flight, poll
        refetch until the re-produced copy lands. Raises _GrantRevoked
        if the dispatcher fenced us meanwhile (the block may already
        be re-granted to another consumer — consuming it here would
        double-deliver)."""
        from ..core.object_ref import ObjectRef  # noqa: PLC0415
        api = _api()
        rt = self._runtime()
        relay0 = getattr(rt, "relay_bytes", 0)
        ref_id = grant["ref"]
        deadline = time.time() + 120.0
        while True:
            try:
                value = api.get(ObjectRef(ref_id), timeout=15.0)
                break
            except Exception:  # noqa: BLE001 — holder likely died
                if time.time() > deadline:
                    raise
                out = _call("refetch", self._job, self._cid,
                            self._gen, grant["bid"], name=self._name)
                if out.get("status") == "grant":
                    ref_id = out["ref"]
                elif out.get("status") == "stale":
                    raise _GrantRevoked(out.get("why", "stale"))
                else:
                    time.sleep(_knob_float(
                        "RAY_TPU_DATA_SERVICE_POLL_S"))
        self.stats["blocks"] += 1
        self.stats["bytes"] += int(grant.get("nbytes", 0))
        self.stats["relay_bytes"] += int(
            getattr(rt, "relay_bytes", 0) - relay0)
        return value

    # -- iterator protocol --------------------------------------------------

    def __iter__(self) -> "DataServiceIterator":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        import uuid  # noqa: PLC0415
        from ..util import waits as waits_mod  # noqa: PLC0415
        poll_s = _knob_float("RAY_TPU_DATA_SERVICE_POLL_S")
        stale_retries = 3
        # one park spans consecutive "wait" polls (registered lazily on
        # the first wait status): a starved consumer surfaces as one
        # aged "data-grant" record naming job/consumer, which the wait
        # graph chains to the wedged producer via the dispatcher tables
        wtok = 0
        try:
            while True:
                # per-request nonce: _call may retry the RPC after a
                # lost reply — the same nonce makes the dispatcher
                # replay the original grant instead of handing out a
                # second block
                req = uuid.uuid4().hex[:12]
                out = _call("next_shard", self._job, self._cid,
                            self._gen, self._pending_acks, req,
                            name=self._name)
                status = out.get("status")
                if status == "grant":
                    self._pending_acks = []
                    try:
                        value = self._fetch(out)
                    except _GrantRevoked:
                        # revoked mid-fetch: nothing consumed —
                        # reconcile returns the shard to pending and
                        # we re-request
                        stale_retries -= 1
                        if stale_retries < 0:
                            raise StaleConsumerError(
                                f"consumer {self._cid} fenced "
                                f"mid-fetch")
                        self._reattach()
                        continue
                    b = out["bid"]
                    self._consumed.append(b)
                    self._pending_acks = [b]
                    return value
                if status == "wait":
                    self._pending_acks = []
                    if not wtok:
                        wtok = waits_mod.park(
                            "data-grant", self._job, job=self._job,
                            consumer=self._cid, gen=self._gen)
                    time.sleep(poll_s)
                    continue
                if status == "reconcile":
                    self._reconcile()
                    continue
                if status == "stale":
                    stale_retries -= 1
                    if stale_retries < 0:
                        raise StaleConsumerError(
                            f"consumer {self._cid} fenced: "
                            f"{out.get('why')}")
                    self._reattach()
                    continue
                if status == "end":
                    self._pending_acks = []
                    self._done = True
                    raise StopIteration
                raise RuntimeError(
                    f"unexpected dispatcher reply {out!r}")
        finally:
            waits_mod.unpark(wtok)

    # -- resume hook ---------------------------------------------------------

    def fast_forward(self, n: int) -> int:
        """Absolute seek: the next block drawn is this consumer's n-th
        (grant-and-auto-ack on the dispatcher, nothing fetched). The
        `_fast_forward_batches` hook in train/spmd_trainer.py calls
        this on resume/reform so a restarted trainer skips consumed
        batches instead of re-training on them."""
        self.flush_acks()
        poll_s = _knob_float("RAY_TPU_DATA_SERVICE_POLL_S")
        skipped = 0
        deadline = time.time() + 60.0
        while True:
            out = _call("fast_forward", self._job, self._cid,
                        self._gen, int(n), name=self._name)
            if out.get("status") == "stale":
                self._reattach()
                continue
            skipped += int(out.get("skipped", 0))
            # production may still be warming up: keep seeking until
            # the cursor reaches n (or nothing is left to skip)
            if int(out.get("consumed", n)) >= n \
                    or out.get("done") \
                    or time.time() > deadline:
                return skipped
            time.sleep(poll_s)

    # -- lifecycle ----------------------------------------------------------

    def flush_acks(self) -> None:
        if self._pending_acks:
            _call("ack", self._job, self._cid, self._gen,
                  list(self._pending_acks), name=self._name)
            self._pending_acks = []

    def close(self) -> None:
        try:
            self.flush_acks()
        except Exception:  # noqa: BLE001 — best-effort on teardown
            pass

    @property
    def consumed_bids(self) -> List[str]:
        return list(self._consumed)

    def iter_device_batches(self, *, sharding=None,
                            prefetch: Optional[int] = None, dtypes=None,
                            device="cuda"):
        """Consumer-side prefetch into device memory: blocks flow
        through data/device_loader.py's double-buffered
        device_put_iterator (the reference's iter_jax_batches; see
        dataset.py on the rename)."""
        from .device_loader import device_put_iterator  # noqa: PLC0415
        return device_put_iterator(self, sharding=sharding,
                                   prefetch=prefetch, dtypes=dtypes,
                                   device=device)


def shutdown_service(name: str = SERVICE_ACTOR_NAME) -> None:
    """Tear down the dispatcher + worker pool (tests / bench)."""
    api = _api()
    try:
        disp = api.get_actor(name, timeout=0.5)
    except ValueError:
        return
    try:
        api.get(disp.graceful_shutdown.remote(), timeout=15.0)
    except Exception:  # noqa: BLE001
        pass
    try:
        api.kill(disp)
    except Exception:  # noqa: BLE001
        pass
