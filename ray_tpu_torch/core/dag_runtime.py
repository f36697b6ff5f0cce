"""Compiled-DAG execution engine (docs/DAG.md).

Two halves of the tentpole live here:

* `WorkerDagContext` — worker-side. `dag_install` builds the worker's
  stage list and channel endpoints once; `dag_start` launches a runner
  thread that loops forever: read one seqno from every in-channel, run
  this worker's stages in topo order (same-worker edges are plain
  in-memory handoffs — no serialization at all), write every
  out-channel. Zero driver messages in steady state.

* `DriverDagController` — driver-side. Compiles the graph plan
  produced by `dag.CompiledDAG` into placement (one pinned worker per
  function stage via `runtime.dag_acquire`, dependency-local), per-
  worker install plans, and channels; `execute()` just stamps a seqno
  and pushes the input tuples into the root channels. Terminal values
  arrive on the controller's own ChannelHost — never the control
  socket, so `ctrl_msgs` stays flat (counter-asserted in
  tests/test_dag_compiled.py).

Failure semantics: user exceptions ride the channels as TaskError
payloads and re-raise at `CompiledDagRef.get()` without disturbing the
pipeline. Infrastructure failures (participant death, channel socket
loss, install timeout) fail every in-flight execution with
`CompiledDagError`, tear the channels down, and leave the controller
dead — `CompiledDAG.execute()` then transparently re-compiles.
"""
from __future__ import annotations

import collections
import os
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..exceptions import CompiledDagError, GetTimeoutError, TaskError
from ..util import knobs
from ..util import tracing
from ..util import waits as waits_mod
from .dag_channel import (ChannelClosed, ChannelHost, ChannelReader,
                          ChannelWriter)
from .protocol import ConnectionClosed

# Bounded buffer of delivered-but-unretrieved execution results; oldest
# evict first. Refs are expected to be consumed promptly (the depth-1
# channel handshake already bounds UNdelivered executions to the
# pipeline depth).
_RESULT_BUFFER_CAP = 1024

# Flight-recorder ring capacity (per dag per process). Spans recorded
# beyond this between two telemetry flushes are dropped oldest-first
# and counted in ray_tpu_trace_spans_dropped_total — the recorder is
# always-on, so its worst case must be a bounded window, not a queue.
_SPAN_RING_CAP = 4096


def _mcat():
    from ..util import metrics_catalog  # noqa: PLC0415
    return metrics_catalog


def eval_input_expr(expr: Tuple, input_args: Tuple,
                    input_kwargs: Dict[str, Any]) -> Any:
    """Resolve an InputNode/InputAttributeNode expression against one
    execute() call's arguments (same contract as InputNode._exec)."""
    if input_kwargs or len(input_args) != 1:
        if not input_args and not input_kwargs:
            raise TypeError("DAG has an InputNode; execute() needs an "
                            "argument")
        base: Any = (input_args, input_kwargs)
    else:
        base = input_args[0]
    if expr[0] == "whole":
        return base
    if expr[0] == "attr":
        return getattr(base, expr[1])
    return base[expr[1]]


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

class _WorkerDag:
    __slots__ = ("dag_id", "stages", "readers", "in_order", "input_ch",
                 "writers", "thread", "stop", "span_ring", "span_drops")

    def __init__(self, dag_id: str):
        self.dag_id = dag_id
        self.stages: List[dict] = []
        self.readers: Dict[str, ChannelReader] = {}
        self.in_order: List[str] = []
        self.input_ch: Optional[str] = None
        self.writers: Dict[str, ChannelWriter] = {}
        self.thread: Optional[threading.Thread] = None
        self.stop = False
        # flight-recorder ring: (sid, seq, t0, t1, stall) tuples. The
        # exec loop only pays this append; span dicts, derived ids and
        # histogram observes happen at telemetry-flush cadence
        # (drain_stage_spans). Bounded so a stalled flusher can never
        # grow memory — overflow counts into
        # ray_tpu_trace_spans_dropped_total.
        self.span_ring: collections.deque = collections.deque(
            maxlen=_SPAN_RING_CAP)
        self.span_drops = 0


class WorkerDagContext:
    """Installed compiled-DAG state of one worker process."""

    def __init__(self, loop):
        self._loop = loop
        self._host: Optional[ChannelHost] = None
        self._dags: Dict[str, _WorkerDag] = {}
        self._lock = threading.Lock()

    def _ensure_host(self) -> ChannelHost:
        if self._host is None:
            prefer_tcp = str(self._loop.socket_path).startswith("tcp://")
            self._host = ChannelHost(prefer_tcp,
                                     label=self._loop.worker_id)
        return self._host

    # -- driver messages ----------------------------------------------------
    def install(self, plan: dict) -> None:
        dag_id = plan["dag_id"]
        try:
            host = self._ensure_host()
            d = _WorkerDag(dag_id)
            d.stages = plan["stages"]
            for st in d.stages:
                # static flight-recorder parent of this stage's spans:
                # first upstream-stage arg (local or channel) wins;
                # input-fed / dependency-free stages parent to the
                # driver's exec-submit span. Resolved once here so the
                # per-seqno path derives ids from a plain key.
                pkey = "drv"
                for ent in (list(st["args"])
                            + list(st["kwargs"].values())):
                    if ent[0] == "lo":
                        pkey = ent[1]
                        break
                    if ent[0] == "ch":
                        # ch_id format: "<dag_id>.<sid>.<consumer_wid>"
                        pkey = ent[1].split(".")[1]
                        break
                st["_span_parent"] = pkey
            d.in_order = list(plan["in_chans"])
            d.input_ch = plan.get("input_ch")
            for ch_id in d.in_order:
                d.readers[ch_id] = host.register(ch_id)
            for desc in plan["out_chans"]:
                d.writers[desc["ch_id"]] = ChannelWriter(
                    dag_id, desc["ch_id"], addr="",
                    same_node=desc["same_node"])
            with self._lock:
                self._dags[dag_id] = d
            self._loop.conn.send(("dag_ready", dag_id,
                                  self._loop.worker_id, host.address))
        except Exception as e:  # noqa: BLE001 — driver owns the verdict
            try:
                self._loop.conn.send(("dag_error", dag_id,
                                      self._loop.worker_id, repr(e)))
            except ConnectionClosed:
                pass

    def start(self, dag_id: str, addr_map: Dict[str, str]) -> None:
        d = self._dags.get(dag_id)
        if d is None or d.thread is not None:
            return
        for ch_id, w in d.writers.items():
            w.addr = addr_map[ch_id]
        d.thread = threading.Thread(target=self._run, args=(d,),
                                    daemon=True,
                                    name=f"dag-run-{dag_id}")
        d.thread.start()

    def teardown(self, dag_id: str) -> None:
        with self._lock:
            d = self._dags.pop(dag_id, None)
        if d is None:
            return
        d.stop = True
        for ch_id in d.in_order:
            if self._host is not None:
                self._host.unregister(ch_id)
        for w in d.writers.values():
            w.close()
        try:
            # the dag left the registry above — convert whatever its
            # ring still holds so teardown never loses recorded spans
            leftover: List[dict] = []
            self._drain_dag_spans(d, leftover)
            for sp in leftover:
                self._loop.record_span(sp)
        except Exception:
            pass

    def teardown_all(self) -> None:
        for dag_id in list(self._dags):
            self.teardown(dag_id)

    # -- stage runner -------------------------------------------------------
    def _report_down(self, d: _WorkerDag, reason: str) -> None:
        if d.stop:
            return  # orderly teardown, not a failure
        d.stop = True
        try:
            self._loop.conn.send(("dag_down", d.dag_id,
                                  self._loop.worker_id, reason))
        except ConnectionClosed:
            pass

    def _run(self, d: _WorkerDag) -> None:
        try:
            for w in d.writers.values():
                w.open()
        except CompiledDagError as e:
            self._report_down(d, repr(e))
            return
        seq = 0
        while not d.stop:
            seq += 1
            vals: Dict[Tuple, Any] = {}
            try:
                for ch_id in d.in_order:
                    s, v = d.readers[ch_id].read_value()
                    if s != seq:
                        raise ChannelClosed(
                            f"seqno skew on {ch_id}: got {s}, "
                            f"expected {seq}")
                    vals[("ch", ch_id)] = v
            except ChannelClosed as e:
                self._report_down(d, repr(e))
                return
            spans_on = knobs.get_bool("RAY_TPU_FASTPATH_SPANS")
            stage_t: Dict[int, Tuple[float, float]] = {}
            for st in d.stages:
                t0 = time.time()
                vals[("lo", st["sid"])] = self._run_stage(d, st, vals)
                stage_t[st["sid"]] = (t0, time.time())
            # per-writer stall baselines: the write loop below may block
            # on ack windows, and each stage's span attributes exactly
            # the stall its own out-channels paid this seqno
            stall0 = {ch_id: w.stall_s for ch_id, w in d.writers.items()}
            try:
                for st in d.stages:
                    for ch_id in st["outs"]:
                        d.writers[ch_id].write_value(
                            seq, vals[("lo", st["sid"])])
            except CompiledDagError as e:
                self._report_down(d, repr(e))
                return
            if spans_on:
                try:
                    # hot path records a tuple per stage, nothing more;
                    # drain_stage_spans does the expensive conversion
                    # at telemetry-flush cadence
                    ring = d.span_ring
                    for st in d.stages:
                        sid = st["sid"]
                        t0, t1 = stage_t[sid]
                        stall = sum(
                            d.writers[ch].stall_s - stall0.get(ch, 0.0)
                            for ch in st["outs"] if ch in d.writers)
                        if len(ring) == ring.maxlen:
                            d.span_drops += 1
                        ring.append((sid, seq, t0, t1, stall))
                except Exception:
                    pass   # flight recorder must never fail the pipeline

    def drain_stage_spans(self) -> List[dict]:
        """Convert buffered (sid, seq, t0, t1, stall) ring entries into
        full span dicts — OFF the per-seqno hot path, at telemetry-flush
        cadence. Span ids are DERIVED from (dag_id, sid, seqno), so the
        upstream stage — in a different process — produced the exact
        parent id this side derives locally: the cross-worker tree needs
        zero coordination and zero extra wire traffic (spans ride the
        telemetry heartbeat, keeping the steady-state ctrl counters
        flat)."""
        with self._lock:
            dags = list(self._dags.values())
        out: List[dict] = []
        for d in dags:
            self._drain_dag_spans(d, out)
        return out

    def _drain_dag_spans(self, d: _WorkerDag, out: List[dict]) -> None:
        ring = d.span_ring
        if not ring and not d.span_drops:
            return
        drops, d.span_drops = d.span_drops, 0
        if drops:
            try:
                _mcat().get(
                    "ray_tpu_trace_spans_dropped_total").inc(drops)
            except Exception:
                pass
        wid = self._loop.worker_id
        pid = os.getpid()
        node_id = knobs.get_raw("RAY_TPU_NODE_ID")
        by_sid = {st["sid"]: st for st in d.stages}
        durs: Dict[int, List[float]] = {}
        tid_cache: Dict[int, str] = {}
        while True:
            try:
                sid, seq, t0, t1, stall = ring.popleft()
            except IndexError:
                break
            st = by_sid.get(sid) or {}
            trace_id = tid_cache.get(seq)
            if trace_id is None:
                trace_id = tracing.derived_trace_id(d.dag_id, seq)
                tid_cache[seq] = trace_id
            span = {
                "trace_id": trace_id,
                "span_id": tracing.derived_span_id(
                    d.dag_id, sid, seq),
                "parent_span_id": tracing.derived_span_id(
                    d.dag_id, st.get("_span_parent", "drv"), seq),
                "task_id": f"{d.dag_id}.{sid}",
                "name": st.get("name") or f"dag_stage:{sid}",
                "cat": "dag_stage",
                "dag_id": d.dag_id, "sid": sid, "seqno": seq,
                "start": t0, "end": t1, "status": "ok",
                "pid": pid, "worker_id": wid,
                "node_id": node_id,
            }
            if stall > 0:
                span["ack_stall_s"] = stall
            out.append(span)
            durs.setdefault(sid, []).append(t1 - t0)
        for sid, vals in durs.items():
            try:
                _mcat().get(
                    "ray_tpu_dag_stage_exec_seconds").observe_many(
                    vals, tags={"dag_id": d.dag_id, "sid": str(sid)})
            except Exception:
                pass

    def _run_stage(self, d: _WorkerDag, st: dict,
                   vals: Dict[Tuple, Any]) -> Any:
        def resolve(entry):
            k = entry[0]
            if k == "c":
                return entry[1]
            if k == "in":
                return vals[("ch", d.input_ch)][entry[1]]
            if k == "ch":
                return vals[("ch", entry[1])]
            return vals[("lo", entry[1])]

        args = [resolve(e) for e in st["args"]]
        kwargs = {k: resolve(e) for k, e in st["kwargs"].items()}
        # upstream error: propagate it downstream instead of running
        for a in args:
            if isinstance(a, BaseException):
                return a
        for a in kwargs.values():
            if isinstance(a, BaseException):
                return a
        try:
            if st["kind"] == "method":
                inst = self._loop._actor_instance
                if inst is None:
                    raise RuntimeError("actor instance not constructed")
                return getattr(inst, st["method"])(*args, **kwargs)
            return st["fn"](*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — becomes a TaskError
            return TaskError(repr(e), traceback.format_exc(),
                             task_name=st.get("name", "dag_stage"))


# ---------------------------------------------------------------------------
# Driver side
# ---------------------------------------------------------------------------

class CompiledDagRef:
    """Future for one output slot of one compiled execute(). Resolved
    by `ray_tpu_torch.get(ref)` or `.get(timeout=...)` — never convertible to
    an ObjectRef (the value lives in the controller's result buffer,
    not the object store)."""

    _is_dag_ref = True
    __slots__ = ("_ctl", "_seq", "_slot")

    def __init__(self, ctl: "DriverDagController", seq: int, slot: Tuple):
        self._ctl = ctl
        self._seq = seq
        self._slot = slot

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._ctl.get_slot(self._seq, self._slot, timeout)

    def __reduce__(self):
        raise TypeError(
            "CompiledDagRef is driver-local and cannot be serialized "
            "or passed to tasks; get() it first")

    def __repr__(self):
        return f"CompiledDagRef(dag={self._ctl.dag_id}, seq={self._seq})"


class _InputWriter:
    __slots__ = ("writer", "exprs")

    def __init__(self, writer: ChannelWriter, exprs: List[Tuple]):
        self.writer = writer
        self.exprs = exprs


class DriverDagController:
    """One compiled pipeline: placement, channels, in-flight results."""

    def __init__(self, rt, cplan: dict):
        self.rt = rt
        self.dag_id = f"dag-{uuid.uuid4().hex[:8]}"
        self.dead = False
        self._failure: Optional[CompiledDagError] = None
        self._seq = 0
        self._exec_lock = threading.Lock()
        self._cond = threading.Condition()
        self._inflight: "Dict[int, dict]" = {}
        self._participants: Dict[str, dict] = {}   # wid -> {"conn","pinned"}
        self._ready: Dict[str, Optional[str]] = {}  # wid -> host addr
        self._ready_evt = threading.Event()
        self._install_err: Optional[str] = None
        self._input_writers: List[_InputWriter] = []
        self._terminal_chs: List[str] = []
        self._host: Optional[ChannelHost] = None
        self._torn_down = False
        self._drv_exprs: List[Tuple] = list(cplan.get("drv_exprs") or ())
        self._term_by_sid: Dict[int, str] = {}
        self.stats = {"execs": 0, "channels": 0, "workers": 0}
        # driver-side flight-recorder ring: execute()/_collect() append
        # bare tuples; _drain_spans converts to span dicts off the hot
        # path (on worker-span ingest and timeline export)
        self._span_ring: collections.deque = collections.deque(
            maxlen=_SPAN_RING_CAP)
        self._span_drops = 0
        timeout = knobs.get_float("RAY_TPU_DAG_COMPILE_TIMEOUT_S")
        try:
            self._compile(cplan, timeout)
        except BaseException:
            self._teardown("compile failed")
            raise
        try:
            rt._span_drains.append(self._drain_spans)
        except Exception:
            pass

    # -- compile ------------------------------------------------------------
    def _compile(self, cplan: dict, timeout: float) -> None:
        rt = self.rt
        stages = cplan["stages"]           # topo order
        reqs = [{"sid": s["sid"], "kind": s["kind"],
                 "actor_id": s.get("actor_id"),
                 "num_cpus": s.get("num_cpus") or 1,
                 "deps": s["deps"]} for s in stages]
        placement = rt.dag_acquire(self.dag_id, reqs, timeout)
        by_sid = {s["sid"]: s for s in stages}
        wid_of = {sid: p["wid"] for sid, p in placement.items()}
        node_of = {sid: p["node_id"] for sid, p in placement.items()}
        for sid, p in placement.items():
            self._participants.setdefault(
                p["wid"], {"conn": p["conn"], "pinned": p["pinned"],
                           "node_id": p["node_id"]})
        # worker partition, topo order preserved
        worker_sids: Dict[str, List[int]] = {}
        for s in stages:
            worker_sids.setdefault(wid_of[s["sid"]], []).append(s["sid"])
        # cross-worker channels: one per (producer stage, consumer worker)
        chans: Dict[Tuple[int, str], dict] = {}

        def edge_ch(sid: int, consumer_wid: str) -> str:
            key = (sid, consumer_wid)
            if key not in chans:
                chans[key] = {
                    "ch_id": f"{self.dag_id}.{sid}.{consumer_wid}",
                    "same_node": node_of[sid] == self._participants[
                        consumer_wid]["node_id"]}
            return chans[key]["ch_id"]

        # driver host first: terminal channels need its address
        prefer_tcp = any(p["node_id"] != rt.node_id
                         for p in self._participants.values())
        self._host = ChannelHost(prefer_tcp, label=self.dag_id)

        # per-worker install plans
        plans: Dict[str, dict] = {}
        input_exprs: Dict[str, List[Tuple]] = {}   # wid -> expr list
        for wid, sids in worker_sids.items():
            wstages = []
            in_chans: List[str] = []
            for sid in sids:
                s = by_sid[sid]
                entries = {"args": [], "kwargs": {}}
                for tgt, src in (("args", s["args"]),
                                 ("kwargs", s["kwargs"].items())):
                    it = src if tgt == "args" else src
                    for item in it:
                        k, aentry = (None, item) if tgt == "args" \
                            else (item[0], item[1])
                        kind = aentry[0]
                        if kind == "const":
                            ent = ("c", aentry[1])
                        elif kind == "input":
                            exprs = input_exprs.setdefault(wid, [])
                            if aentry[1] not in exprs:
                                exprs.append(aentry[1])
                            ent = ("in", exprs.index(aentry[1]))
                        else:  # ("stage", sid)
                            up = aentry[1]
                            if wid_of[up] == wid:
                                ent = ("lo", up)
                            else:
                                ch = edge_ch(up, wid)
                                if ch not in in_chans:
                                    in_chans.append(ch)
                                ent = ("ch", ch)
                        if tgt == "args":
                            entries["args"].append(ent)
                        else:
                            entries["kwargs"][k] = ent
                wstages.append({
                    "sid": sid, "kind": s["kind"], "fn": s.get("fn"),
                    "method": s.get("method"), "name": s.get("name", ""),
                    "args": entries["args"],
                    "kwargs": entries["kwargs"], "outs": []})
            plans[wid] = {"dag_id": self.dag_id, "worker_id": wid,
                          "stages": wstages, "in_chans": in_chans,
                          "input_ch": None, "out_chans": []}
        # a worker with no inbound channels still needs a per-execute
        # tick; any worker consuming the input gets its channel too
        for wid, plan in plans.items():
            if wid in input_exprs or not plan["in_chans"]:
                ch_id = f"{self.dag_id}.in.{wid}"
                plan["input_ch"] = ch_id
                plan["in_chans"].insert(0, ch_id)
                w = ChannelWriter(
                    self.dag_id, ch_id, addr="",
                    same_node=self._participants[wid]["node_id"]
                    == rt.node_id)
                self._input_writers.append(
                    _InputWriter(w, input_exprs.get(wid, [])))
        # wire producer stages to their out-channels
        consumer_wid_of_ch: Dict[str, str] = {}
        for (sid, cwid), desc in chans.items():
            ch_id = desc["ch_id"]
            consumer_wid_of_ch[ch_id] = cwid
            wid = wid_of[sid]
            for st in plans[wid]["stages"]:
                if st["sid"] == sid:
                    st["outs"].append(ch_id)
            plans[wid]["out_chans"].append(desc)
        # terminal channels: producer stage -> driver
        term_by_sid: Dict[int, str] = {}
        for slot in cplan["output_slots"]:
            if slot[0] != "stage":
                continue
            sid = slot[1]
            if sid in term_by_sid:
                continue
            ch_id = f"{self.dag_id}.{sid}.drv"
            term_by_sid[sid] = ch_id
            wid = wid_of[sid]
            for st in plans[wid]["stages"]:
                if st["sid"] == sid:
                    st["outs"].append(ch_id)
            plans[wid]["out_chans"].append(
                {"ch_id": ch_id,
                 "same_node": node_of[sid] == rt.node_id})
            self._terminal_chs.append(ch_id)
        self._term_by_sid = term_by_sid
        self.stats["channels"] = (len(chans) + len(self._terminal_chs)
                                  + len(self._input_writers))
        self.stats["workers"] = len(self._participants)

        # register terminal readers BEFORE installs (writers may
        # connect as soon as dag_start lands)
        term_readers = {ch: self._host.register(ch)
                        for ch in self._terminal_chs}
        # route dag_ready/dag_down to this controller
        rt.compiled_dags[self.dag_id] = self
        deadline = time.time() + timeout
        for wid, plan in plans.items():
            try:
                self._participants[wid]["conn"].send(("dag_install", plan))
            except ConnectionClosed as e:
                raise CompiledDagError(
                    f"participant {wid} unreachable at install",
                    cause=repr(e)) from e
        while len(self._ready) < len(plans):
            if self._install_err is not None:
                raise CompiledDagError("install failed",
                                       cause=self._install_err)
            if self.dead:
                raise self._failure
            if not self._ready_evt.wait(max(0.0, deadline - time.time())):
                raise CompiledDagError(
                    "install handshake timed out",
                    cause=f"{len(self._ready)}/{len(plans)} ready")
            self._ready_evt.clear()
        # address map: each channel's reader address
        addr_map: Dict[str, str] = {}
        for ch_id, cwid in consumer_wid_of_ch.items():
            addr_map[ch_id] = self._ready[cwid]
        for ch_id in self._terminal_chs:
            addr_map[ch_id] = self._host.address
        for wid in plans:
            self._participants[wid]["conn"].send(
                ("dag_start", self.dag_id, addr_map))
        for iw in self._input_writers:
            wid = iw.writer.ch_id.rsplit(".", 1)[1]
            iw.writer.addr = self._ready[wid]
            iw.writer.open()
        for ch_id, reader in term_readers.items():
            threading.Thread(target=self._collect,
                             args=(ch_id, reader), daemon=True,
                             name=f"dag-collect-{ch_id}").start()
        rt._emit("dag.compile", dag_id=self.dag_id,
                 stages=len(stages), workers=len(self._participants),
                 channels=self.stats["channels"])
        for ch_id in addr_map:
            rt._emit("dag.channel.open", dag_id=self.dag_id,
                     channel=ch_id)

    # -- dispatcher-thread callbacks ---------------------------------------
    def on_ready(self, wid: str, addr: Optional[str]) -> None:
        self._ready[wid] = addr
        self._ready_evt.set()

    def on_install_error(self, wid: str, reason: str) -> None:
        self._install_err = f"{wid}: {reason}"
        self._ready_evt.set()

    def on_down(self, wid: str, reason: str) -> None:
        self._fail_async(f"participant {wid} reported failure: {reason}")

    def on_worker_dead(self, wid: str) -> None:
        if wid in self._participants:
            self._fail_async(f"participant worker {wid} died")

    # -- failure / teardown -------------------------------------------------
    def _fail_async(self, cause: str) -> None:
        """Fail from the dispatcher thread without blocking it."""
        if self.dead:
            return
        threading.Thread(target=self._fail,
                         args=(CompiledDagError(
                             "compiled DAG pipeline failed", cause=cause),),
                         daemon=True, name="dag-fail").start()

    def _fail(self, err: CompiledDagError) -> None:
        with self._cond:
            if self.dead:
                return
            self.dead = True
            self._failure = err
            self._cond.notify_all()
        self._ready_evt.set()
        try:
            self.rt._emit("dag.fail", dag_id=self.dag_id,
                          cause=err.cause or str(err))
        except Exception:
            pass
        self._teardown(err.cause or "failure")

    def _drain_spans(self) -> None:
        """Convert buffered driver-side ring entries (exec submits,
        result arrivals) into span dicts on rt.trace_spans. Runs on
        worker-span ingest / timeline export — never on the execute()
        hot path."""
        ring = self._span_ring
        if not ring and not self._span_drops:
            return
        drops, self._span_drops = self._span_drops, 0
        if drops:
            try:
                _mcat().get(
                    "ray_tpu_trace_spans_dropped_total").inc(drops)
            except Exception:
                pass
        pid = os.getpid()
        node_id = getattr(self.rt, "node_id", "")
        while True:
            try:
                kind, sid, seq, t0, t1 = ring.popleft()
            except IndexError:
                break
            if kind == "drv":
                span = {
                    "trace_id": tracing.derived_trace_id(
                        self.dag_id, seq),
                    "span_id": tracing.derived_span_id(
                        self.dag_id, "drv", seq),
                    "parent_span_id": "",
                    "task_id": f"{self.dag_id}.exec",
                    "name": f"dag_exec:{self.dag_id}",
                    "cat": "dag_submit",
                    "dag_id": self.dag_id, "seqno": seq,
                    "start": t0, "end": t1,
                    "status": "ok", "pid": pid,
                    "worker_id": "driver", "node_id": node_id,
                }
            else:
                span = {
                    "trace_id": tracing.derived_trace_id(
                        self.dag_id, seq),
                    "span_id": tracing.derived_span_id(
                        self.dag_id, "res", sid, seq),
                    "parent_span_id": tracing.derived_span_id(
                        self.dag_id, sid, seq),
                    "task_id": f"{self.dag_id}.{sid}",
                    "name": f"dag_result:{sid}",
                    "cat": "dag_result",
                    "dag_id": self.dag_id, "sid": sid, "seqno": seq,
                    "start": t0, "end": t1, "status": "ok",
                    "pid": pid, "worker_id": "driver",
                    "node_id": node_id,
                }
            self.rt.trace_spans.append(span)

    def _teardown(self, reason: str) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        self.dead = True
        try:
            self._drain_spans()
            self.rt._span_drains.remove(self._drain_spans)
        except Exception:
            pass
        if self._failure is None:
            self._failure = CompiledDagError("compiled DAG torn down",
                                             cause=reason)
        for iw in self._input_writers:
            iw.writer.close()
        for wid, p in self._participants.items():
            try:
                p["conn"].send(("dag_teardown", self.dag_id))
            except (ConnectionClosed, OSError):
                pass
        if self._host is not None:
            self._host.close()
        self.rt.compiled_dags.pop(self.dag_id, None)
        self.rt.dag_release(
            self.dag_id,
            [wid for wid, p in self._participants.items()
             if p["pinned"]],
            channels=self.stats["channels"], reason=reason)
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self.dead = True
            if self._failure is None:
                self._failure = CompiledDagError(
                    "compiled DAG closed", cause="close()")
            self._cond.notify_all()
        self._teardown("close()")

    # -- execute ------------------------------------------------------------
    def execute(self, input_args: Tuple,
                input_kwargs: Dict[str, Any]) -> int:
        t_submit = time.time()
        with self._exec_lock:
            if self.dead:
                raise self._failure
            seq = self._seq + 1
            ent = {"ch": {}, "drv": {}}
            with self._cond:
                self._inflight[seq] = ent
                if len(self._inflight) > _RESULT_BUFFER_CAP:
                    self._inflight.pop(next(iter(self._inflight)))
            for idx, expr in enumerate(self._drv_exprs):
                ent["drv"][idx] = eval_input_expr(expr, input_args,
                                                  input_kwargs)
            try:
                for iw in self._input_writers:
                    vals = tuple(
                        eval_input_expr(e, input_args, input_kwargs)
                        for e in iw.exprs)
                    iw.writer.write_value(seq, vals)
            except CompiledDagError as e:
                self._fail(e)
                raise self._failure from e
            self._seq = seq
        self.stats["execs"] += 1
        try:
            _mcat().get("ray_tpu_dag_execs_total").inc(
                tags={"mode": "pipelined"})
        except Exception:
            pass
        if knobs.get_bool("RAY_TPU_FASTPATH_SPANS"):
            try:
                # driver-local root span of this execution: input-fed
                # stages derive this exact id as their parent. Only a
                # tuple append here — _drain_spans builds the dict off
                # the submit path
                ring = self._span_ring
                if len(ring) == ring.maxlen:
                    self._span_drops += 1
                ring.append(("drv", None, seq, t_submit, time.time()))
            except Exception:
                pass
        return seq

    def make_ref(self, seq: int, slot: Tuple) -> CompiledDagRef:
        """slot: ("stage", sid, idx|None) or ("drv", idx) — mapped to
        the internal (channel / driver-slot) address."""
        if slot[0] == "drv":
            return CompiledDagRef(self, seq, ("drv", slot[1]))
        return CompiledDagRef(
            self, seq, ("ch", self._term_by_sid[slot[1]], slot[2]))

    def _collect(self, ch_id: str, reader: ChannelReader) -> None:
        while True:
            try:
                seq, value = reader.read_value()
            except ChannelClosed:
                return
            now = time.time()
            with self._cond:
                ent = self._inflight.get(seq)
                if ent is not None:
                    ent["ch"][ch_id] = value
                    self._cond.notify_all()
            if knobs.get_bool("RAY_TPU_FASTPATH_SPANS"):
                try:
                    # instant span marking the result's arrival at the
                    # driver, parented to the terminal stage's derived
                    # span (ch_id: "<dag_id>.<sid>.drv"). Tuple append
                    # only — converted by _drain_spans
                    ring = self._span_ring
                    if len(ring) == ring.maxlen:
                        self._span_drops += 1
                    ring.append(("res", ch_id.split(".")[1], seq,
                                 now, now))
                except Exception:
                    pass

    def get_slot(self, seq: int, slot: Tuple,
                 timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.time() + timeout
        # wtok is a one-slot holder so the wait loop can park lazily —
        # only when the slot is actually absent and we are about to
        # sleep, not on the (common) already-settled fast path.
        wtok = [0]
        try:
            return self._get_slot_locked(seq, slot, timeout, deadline,
                                         wtok)
        finally:
            waits_mod.unpark(wtok[0])

    def _get_slot_locked(self, seq, slot, timeout, deadline,
                         wtok=None):
        graced = False
        with self._cond:
            while True:
                ent = self._inflight.get(seq)
                if ent is None:
                    raise self._failure or CompiledDagError(
                        "result expired from the compiled DAG buffer",
                        cause="buffer eviction")
                if slot[0] == "drv":
                    if slot[1] in ent["drv"]:
                        value, idx = ent["drv"][slot[1]], None
                        break
                else:
                    ch_id = slot[1]
                    if ch_id in ent["ch"]:
                        value, idx = ent["ch"][ch_id], slot[2]
                        break
                if self.dead:
                    raise self._failure
                remaining = None if deadline is None \
                    else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"compiled DAG result (seq {seq}) not ready "
                        f"within {timeout}s")
                if wtok is not None and not wtok[0]:
                    # First sleep slice goes un-parked (grace): the
                    # common case is a pipelined result that settles
                    # within microseconds of the fetch.
                    if not graced:
                        graced = True
                        self._cond.wait(
                            timeout=waits_mod.PARK_GRACE_S
                            if remaining is None
                            else min(waits_mod.PARK_GRACE_S,
                                     remaining))
                        continue
                    wtok[0] = waits_mod.park(
                        "dag-channel", self.dag_id, op="slot",
                        seq=seq, waiter="driver")
                self._cond.wait(timeout=remaining
                                if remaining is not None else 1.0)
        if isinstance(value, BaseException):
            raise value
        if idx is not None:
            try:
                return value[idx]
            except (TypeError, IndexError, KeyError) as e:
                raise TaskError(
                    f"terminal stage declared num_returns but returned "
                    f"a non-indexable value: {e!r}") from e
        return value
