"""Reusable object channels for compiled DAGs (docs/DAG.md).

A channel is a fixed (writer process -> reader process) edge resolved
once at compile time. The writer owns one socket to the reader's
ChannelHost and, for same-node edges above the inline threshold, one
shared-memory ChannelSegment that every execution REWRITES in place —
no allocate/seal/free per call, which is the entire point: the dynamic
path pays an object-table seal plus a store segment per intermediate
value, a compiled channel pays one memcpy and one small notify frame.

Frame protocol (all frames ride the compact binary wire,
`protocol.WIRE_KINDS`):

  writer -> reader   ("ch_open", dag_id, ch_id)          once per socket
  writer -> reader   ("ch_notify", ch_id, seq, kind, size, ref)
                     kind "s": ref = shm segment name, payload at [0:size]
                     kind "b": ref = payload bytes inline in the frame
                     kind "e": ref = cloudpickled exception (TaskError)
  reader -> writer   ("ch_ack", ch_id, seq)              after consume
  reader -> writer   ("ch_err", ch_id, seq, reason)      fatal reject

The handshake is an ack window: for inline payloads (kinds "b"/"e")
the writer may run RAY_TPU_DAG_CHANNEL_DEPTH seqnos ahead of the
reader — that slack is what lets pipeline stages overlap instead of
lock-stepping on every hop. A shared-memory payload (kind "s") gates
at depth 1: the segment is rewritten in place, so the writer drains
every outstanding ack before touching it again. Error payloads keep
the seqno cadence: every writer emits every seqno on every
out-channel, value or error, so readers never have to reason about
gaps.
"""
from __future__ import annotations

import pickle
import queue
import select
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

import cloudpickle

from ..exceptions import CompiledDagError
from ..util import knobs
from ..util import waits as waits_mod
from . import serialization
from .object_store import INLINE_MAX, ChannelSegment, ChannelSegmentReader
from .protocol import Connection, ConnectionClosed, connect_address


class ChannelClosed(Exception):
    """Reader-side: the channel's writer socket closed (teardown or a
    dead upstream participant)."""


def _mcat():
    from ..util import metrics_catalog  # noqa: PLC0415
    return metrics_catalog


class ChannelWriter:
    """Writer end of one compiled-DAG channel edge."""

    def __init__(self, dag_id: str, ch_id: str, addr: str,
                 same_node: bool, capacity: Optional[int] = None):
        self.dag_id = dag_id
        self.ch_id = ch_id
        self.addr = addr
        self.same_node = same_node
        self._conn: Optional[Connection] = None
        self._seg: Optional[ChannelSegment] = None
        self._capacity = capacity or knobs.get_int(
            "RAY_TPU_DAG_CHANNEL_BYTES")
        self._depth = max(1, knobs.get_int("RAY_TPU_DAG_CHANNEL_DEPTH"))
        self._outstanding: "deque[int]" = deque()
        self._closed = False
        # cumulative seconds this writer spent BLOCKED on the consumer
        # ack window (only time where the window actually forced a
        # wait): the per-stage spans read deltas off it so backpressure
        # stalls are attributed to the stage that paid them
        self.stall_s = 0.0

    def open(self) -> None:
        try:
            self._conn = connect_address(self.addr)
            self._conn.send(("ch_open", self.dag_id, self.ch_id))
        except (ConnectionClosed, OSError) as e:
            raise CompiledDagError(
                f"channel {self.ch_id} failed to open", cause=repr(e)
            ) from e

    def _drain_acks(self, max_outstanding: int) -> None:
        """Block until at most `max_outstanding` seqnos await acks.
        Acks arrive strictly in seqno order (the reader consumes in
        order), so each recv must match the oldest outstanding."""
        if len(self._outstanding) <= max_outstanding:
            return
        t0 = time.monotonic()
        wtok = [0]
        try:
            self._drain_acks_blocking(max_outstanding, wtok)
        finally:
            waits_mod.unpark(wtok[0])
            dt = time.monotonic() - t0
            self.stall_s += dt
            try:
                _mcat().get("ray_tpu_dag_channel_stall_seconds").inc(dt)
            except Exception:
                pass

    def _drain_acks_blocking(self, max_outstanding: int,
                             wtok=None) -> None:
        while len(self._outstanding) > max_outstanding:
            expect = self._outstanding[0]
            if wtok is not None and not wtok[0]:
                # Park only once the ack is genuinely late: in a
                # healthy pipeline it has already arrived (or does
                # within the grace), and a park per windowed send
                # would tax every execution.
                try:
                    r, _, _ = select.select(
                        [self._conn.fileno()], [], [],
                        waits_mod.PARK_GRACE_S)
                except (OSError, ValueError):
                    r = [True]
                if not r:
                    wtok[0] = waits_mod.park(
                        "dag-channel", self.ch_id, op="ack",
                        dag_id=self.dag_id, seq=expect)
            try:
                # raylint: disable=RT003 ack socket: a dead reader
                # closes it (ConnectionClosed below) and teardown
                # closes it from our side; either way the blocked
                # writer unblocks with an error
                m = self._conn.recv()
            except ConnectionClosed as e:
                raise CompiledDagError(
                    f"channel {self.ch_id} reader went away awaiting "
                    f"ack {expect}", cause=repr(e)) from e
            if m[0] == "ch_ack" and m[2] == expect:
                self._outstanding.popleft()
                continue
            raise CompiledDagError(
                f"channel {self.ch_id} protocol error awaiting ack "
                f"{expect}", cause=repr(m[:3]))

    def write_value(self, seq: int, value: Any) -> None:
        """Ship one execution's payload (ack-window gated). `value`
        may be a BaseException — it rides as kind "e" and re-raises at
        the consumer (user errors propagate without killing the
        pipeline)."""
        if self._closed or self._conn is None:
            raise CompiledDagError(
                f"channel {self.ch_id} is closed", cause="teardown")
        if isinstance(value, BaseException):
            kind, data = "e", cloudpickle.dumps(value, protocol=5)
        else:
            try:
                kind, data = "b", serialization.pack(value)
            except Exception as e:  # unpicklable stage result
                from ..exceptions import TaskError  # noqa: PLC0415
                kind = "e"
                data = cloudpickle.dumps(TaskError(
                    f"result not serializable: {e!r}"), protocol=5)
        if kind == "b" and self.same_node and len(data) > INLINE_MAX:
            # the segment is about to be rewritten in place: every
            # in-flight payload (inline or previous segment write)
            # must be consumed first
            self._drain_acks(0)
            if self._seg is None:
                self._seg = ChannelSegment(
                    f"rtpt_dagch_{self.ch_id}", self._capacity)
            ref: Any = self._seg.write(data)
            kind = "s"
        else:
            self._drain_acks(self._depth - 1)
            ref = data
        try:
            self._conn.send(("ch_notify", self.ch_id, seq, kind,
                             len(data), ref))
        except ConnectionClosed as e:
            raise CompiledDagError(
                f"channel {self.ch_id} reader went away", cause=repr(e)
            ) from e
        self._outstanding.append(seq)
        if seq > 1:
            try:
                _mcat().get("ray_tpu_dag_channel_reuse_total").inc()
            except Exception:
                pass

    def close(self) -> None:
        self._closed = True
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None
        if self._seg is not None:
            self._seg.close()
            self._seg = None


class ChannelReader:
    """Reader end: a queue fed by the host's per-connection pump."""

    def __init__(self, ch_id: str):
        self.ch_id = ch_id
        self.q: "queue.Queue" = queue.Queue()
        self._segr = ChannelSegmentReader()

    def read_value(self, timeout: Optional[float] = None
                   ) -> Tuple[int, Any]:
        """(seq, value) of the next execution; value is the exception
        instance itself for kind-"e" payloads. Consuming acks the seqno
        (the copy out of the shm window happens first, so the writer is
        free to overwrite)."""
        # Park lazily: in a full pipeline the next item arrives within
        # microseconds, and a park/unpark pair would tax every stage
        # hop. Only a read still empty after the grace gets a record.
        grace = waits_mod.PARK_GRACE_S if timeout is None \
            else min(waits_mod.PARK_GRACE_S, timeout)
        tok = 0
        try:
            try:
                item = self.q.get(timeout=grace)
            except queue.Empty:
                if timeout is not None and timeout <= grace:
                    raise
                tok = waits_mod.park("dag-channel", self.ch_id,
                                     op="read")
                item = self.q.get(
                    timeout=None if timeout is None
                    else timeout - grace)
        except queue.Empty:
            raise ChannelClosed(f"channel {self.ch_id} read timeout") \
                from None
        finally:
            waits_mod.unpark(tok)
        if item[0] is None:
            raise ChannelClosed(
                f"channel {self.ch_id}: {item[1]}")
        conn, seq, kind, size, ref = item
        if kind == "s":
            data: Any = bytes(self._segr.view(ref, size))
        else:
            data = ref
        if kind == "e":
            value: Any = pickle.loads(data)
        else:
            value = serialization.unpack(data)
        try:
            conn.send(("ch_ack", self.ch_id, seq))
        except ConnectionClosed:
            pass  # writer died; its driver-side death handling owns this
        return seq, value

    def close(self) -> None:
        self._segr.close()
        self.q.put((None, "channel torn down"))


class ChannelHost:
    """Per-process listener that demuxes inbound channel sockets to
    registered ChannelReaders. One host serves every compiled DAG in
    the process (channel ids are globally unique)."""

    def __init__(self, prefer_tcp: bool, label: str):
        import os  # noqa: PLC0415
        import tempfile  # noqa: PLC0415
        self._readers: Dict[str, ChannelReader] = {}
        self._lock = threading.Lock()
        self._conns: list = []
        self._sock_path = None
        if prefer_tcp:
            from ..util.netutil import routable_ip  # noqa: PLC0415
            from .protocol import tcp_listener  # noqa: PLC0415
            self._listener = tcp_listener("0.0.0.0", 0)
            port = self._listener.getsockname()[1]
            self.address = f"tcp://{routable_ip()}:{port}"
        else:
            from .protocol import unix_listener  # noqa: PLC0415
            base = knobs.get_raw("RAY_TPU_LOG_DIR")
            if not base or not os.path.isdir(base):
                base = tempfile.mkdtemp(prefix="ray_tpu_dagch_")
            self._sock_path = os.path.join(
                base, f"dagch-{label}-{os.getpid()}.sock")
            self._listener = unix_listener(self._sock_path)
            self.address = self._sock_path
        threading.Thread(target=self._accept, daemon=True,
                         name="dagch-accept").start()

    def register(self, ch_id: str) -> ChannelReader:
        r = ChannelReader(ch_id)
        with self._lock:
            self._readers[ch_id] = r
        return r

    def unregister(self, ch_id: str) -> None:
        with self._lock:
            r = self._readers.pop(ch_id, None)
        if r is not None:
            r.close()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = Connection(sock)
            self._conns.append(conn)
            threading.Thread(target=self._pump, args=(conn,),
                             daemon=True, name="dagch-pump").start()

    def _pump(self, conn: Connection) -> None:
        reader: Optional[ChannelReader] = None
        while True:
            try:
                # raylint: disable=RT003 inbound channel socket: the
                # writer's teardown/death closes it, unblocking here
                m = conn.recv()
            except ConnectionClosed:
                if reader is not None:
                    reader.q.put((None, "writer socket closed"))
                return
            if m[0] == "ch_open":
                with self._lock:
                    reader = self._readers.get(m[2])
                if reader is None:
                    try:
                        conn.send(("ch_err", m[2], 0,
                                   "unknown channel (torn down?)"))
                        conn.close()
                    except ConnectionClosed:
                        pass
                    return
            elif m[0] == "ch_notify" and reader is not None:
                reader.q.put((conn, m[2], m[3], m[4], m[5]))

    def close(self) -> None:
        import os  # noqa: PLC0415
        try:
            self._listener.close()
        except Exception:
            pass
        if self._sock_path:
            try:
                os.unlink(self._sock_path)
            except OSError:
                pass
        for c in self._conns:
            try:
                c.close()
            except Exception:
                pass
        with self._lock:
            readers = list(self._readers.values())
            self._readers.clear()
        for r in readers:
            r.close()
