"""Length-prefixed pickle message framing over sockets.

Reference parity: src/ray/rpc (gRPC services between core_worker and raylet).
A single-host, single-controller runtime doesn't need gRPC; a Unix-domain
socket with framed pickles gives lower latency and zero deps. The Connection
class is transport-agnostic (works over TCP for multi-host drivers).

Large values never travel through these messages — only ids and small
metadata; payloads go through the shared-memory object store.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
import traceback
from typing import Any, Optional

import cloudpickle

from ..util import knobs

try:
    import msgpack
except ImportError:  # pragma: no cover - image always ships msgpack
    msgpack = None

_HDR = struct.Struct("<I")
MAX_MSG = 1 << 30

# Marker message returned when a frame arrives intact but fails to
# deserialize (e.g. a by-reference pickle whose module only exists on the
# sender). Receivers log and continue instead of killing the read loop.
RECV_ERROR = "__recv_error__"


class ConnectionClosed(Exception):
    pass


class WireVersionError(Exception):
    """A frame carried the binary-wire marker family but a version this
    build does not speak. Surfaced as a RECV_ERROR drop (the connection
    survives), never silently misparsed as pickle."""


# ---------------------------------------------------------------------------
# Compact binary wire codec (v1).
#
# Control-plane frames used to be one cloudpickle per message. The hot
# kinds (task submit/finish batches, seals, heartbeats) are
# framework-pure — strings, ints, locations — so they now ride a
# versioned msgpack body: first body byte 0xB0|version discriminates
# from pickle (every pickle protocol>=2 stream starts with 0x80), the
# rest is msgpack with three extension types. User payloads (task args,
# exceptions) stay pickled, but INSIDE the envelope — mirroring the
# WAL's split between framework-pure records and pickled payloads.
# RAY_TPU_WIRE=0 forces the legacy all-pickle framing.

WIRE_VERSION = 1
_WIRE_LO, _WIRE_HI = 0xB0, 0xBF          # marker family
_WIRE_BYTE = bytes([_WIRE_LO | WIRE_VERSION])

_EXT_LOC = 1      # ObjectLocation (struct of pure fields)
_EXT_PICKLE = 2   # self-contained cloudpickled object (exceptions only)
_EXT_SPEC = 3     # TaskSpec: pure fields msgpack'd + one user-arg blob

# Message kinds eligible for binary framing. A kind outside this set —
# or any payload the codec cannot express — falls back to one
# cloudpickle frame, exactly the old wire.
WIRE_KINDS = frozenset({
    # worker/agent -> driver
    "task_done", "put", "gen_item", "heartbeat", "object_unreachable",
    "get_request", "wait_request", "gen_next_request", "gen_abandon",
    "submit", "submit_many", "actor_ckpt", "batch", "actor_exit",
    "dwait",
    # driver -> worker/agent
    "exec_task", "exec_actor_task", "exec_task_many",
    "exec_actor_task_many", "cancel", "materialize", "drop_device",
    "revoke_tasks", "shutdown", "get_reply", "heartbeat_ack",
    # worker <-> worker (direct actor calls)
    "dcall", "dresult",
    # two-level scheduling (docs/SCHEDULING.md): driver <-> node agent
    # bulk lease plane, and the agent-local worker dispatch plane
    "nlease_grant", "nlease_extend", "nlease_close", "nlease_done",
    "nlease_spill", "nlease_want", "nlease_release",
    "aregister", "aexec", "adone", "asubmit", "aresult", "aspill",
    # compiled-DAG channel plane (writer -> reader data sockets)
    "ch_open", "ch_notify", "ch_ack", "ch_err",
    # telemetry reports: the sys.metrics / sys.spans / sys.events
    # payloads are framework-pure in the delta format
    # (tuple-keyed series ride msgpack maps); report channels carrying
    # arbitrary user payloads fall back per-frame like any other kind
    "report",
    # on-demand profiler control (driver -> worker) and its reply
    "profile_ctl", "profile_reply",
})

# Per-kind count of frames that attempted binary framing and fell back
# to cloudpickle (payload not wire-pure). Steady-state telemetry tests
# assert the hot kinds stay at zero; also exported as the
# ray_tpu_wire_fallbacks_total metric so worker-side fallbacks surface
# in the driver's cluster view.
import collections as _collections  # noqa: E402

wire_fallbacks: "_collections.Counter" = _collections.Counter()


def _record_fallback(kind) -> None:
    try:
        wire_fallbacks[kind] += 1
        from ..util import metrics_catalog as _mcat  # noqa: PLC0415
        _mcat.get("ray_tpu_wire_fallbacks_total").inc(
            tags={"kind": str(kind)})
    except Exception:
        pass

_wire_enabled = (msgpack is not None
                 and knobs.get_bool("RAY_TPU_WIRE"))


def set_wire_enabled(on: bool) -> None:
    """Flip binary framing process-wide (bench A/B; receivers always
    understand both framings, so mixed clusters are fine)."""
    global _wire_enabled
    _wire_enabled = bool(on) and msgpack is not None


def wire_enabled() -> bool:
    return _wire_enabled


# TaskSpec fields carried as msgpack values, in envelope order. args /
# kwargs / scheduling_strategy / runtime_env are the user-payload blob.
_SPEC_PURE_FIELDS = (
    "task_id", "name", "num_returns", "return_ids", "resources",
    "max_retries", "retry_exceptions", "max_calls", "streaming",
    "actor_id", "method_name", "concurrency_group",
    "placement_group_id", "bundle_index", "func_id", "dep_object_ids",
    "reconstructions", "trace_id", "span_id", "parent_span_id",
    "gpu_ids", "lease_id",
)

_LOC_FIELDS = ("kind", "size", "data", "name", "node_id", "spill_path",
               "seal_seq")


def _loc_cls():
    from .object_store import ObjectLocation  # noqa: PLC0415
    return ObjectLocation


def _spec_cls():
    from .task import TaskSpec  # noqa: PLC0415
    return TaskSpec


def _pack_default(obj):
    """msgpack fallback hook: locations and specs get compact envelopes,
    exceptions a self-contained pickle; anything else aborts the binary
    attempt (the whole frame then ships as legacy cloudpickle)."""
    cls_name = type(obj).__name__
    if cls_name == "ObjectLocation" and isinstance(obj, _loc_cls()):
        return msgpack.ExtType(_EXT_LOC, msgpack.packb(
            [getattr(obj, f) for f in _LOC_FIELDS], use_bin_type=True))
    if cls_name == "TaskSpec" and isinstance(obj, _spec_cls()):
        if getattr(obj, "wire_error", None):
            # a poisoned spec (payload failed to unpickle on a hop) must
            # keep its error across re-encodes: the compact envelope
            # would re-ship empty args and run silently wrong — the
            # cloudpickle fallback round-trips the attribute instead
            raise TypeError("spec carries wire_error; not wire-pure")
        pure = [getattr(obj, f) for f in _SPEC_PURE_FIELDS]
        if not obj.args and not obj.kwargs \
                and obj.scheduling_strategy is None \
                and obj.runtime_env is None:
            blob = b""    # no user payload: skip the pickle entirely
        else:
            blob = cloudpickle.dumps(
                (obj.args, obj.kwargs, obj.scheduling_strategy,
                 obj.runtime_env), protocol=5)
        return msgpack.ExtType(_EXT_SPEC, msgpack.packb(
            [pure, obj.func_bytes or b"", blob],
            use_bin_type=True, default=_pack_default))
    if isinstance(obj, BaseException):
        try:
            return msgpack.ExtType(_EXT_PICKLE,
                                   cloudpickle.dumps(obj, protocol=5))
        except Exception:
            raise TypeError(f"unpicklable exception {cls_name}") from None
    raise TypeError(f"not wire-pure: {cls_name}")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_LOC:
        fields = msgpack.unpackb(data, raw=False, use_list=True)
        loc = _loc_cls()(*fields[:2])
        for f, v in zip(_LOC_FIELDS, fields):
            setattr(loc, f, v)
        return loc
    if code == _EXT_SPEC:
        pure, func_bytes, blob = msgpack.unpackb(
            data, raw=False, use_list=True, strict_map_key=False,
            ext_hook=_ext_hook, object_pairs_hook=_map_hook)
        spec = _spec_cls()(**dict(zip(_SPEC_PURE_FIELDS, pure)),
                           func_bytes=func_bytes)
        spec.args, spec.kwargs = (), {}
        spec.scheduling_strategy = spec.runtime_env = None
        if blob:
            try:
                (spec.args, spec.kwargs, spec.scheduling_strategy,
                 spec.runtime_env) = pickle.loads(blob)
            except BaseException as e:  # noqa: BLE001
                # The user payload references something only importable
                # on the submitter (e.g. a driver-only module). Failing
                # the DECODE would drop the whole frame and park the
                # caller forever; instead the spec carries the error and
                # the worker fails the task with it (worker.py
                # _check_spec_payload).
                spec.wire_error = f"{type(e).__name__}: {e}"
        return spec
    if code == _EXT_PICKLE:
        return pickle.loads(data)
    raise WireVersionError(f"unknown wire extension {code}")


def _map_hook(pairs):
    """Restore tuple dict keys (msgpack arrays are unhashable lists)."""
    return {tuple(k) if isinstance(k, list) else k: v for k, v in pairs}


def encode_message(msg) -> Optional[bytes]:
    """Binary body for a hot-kind control message, or None when the
    payload is not expressible (caller falls back to cloudpickle)."""
    if not _wire_enabled or not isinstance(msg, tuple) or not msg \
            or msg[0] not in WIRE_KINDS:
        return None
    try:
        return _WIRE_BYTE + msgpack.packb(list(msg), use_bin_type=True,
                                          default=_pack_default)
    except Exception:
        _record_fallback(msg[0])
        return None


def decode_message(data) -> Any:
    """Inverse of the framing: binary-marked bodies decode through the
    codec (raising WireVersionError on a foreign version), everything
    else is a pickle frame."""
    first = data[0] if data else 0
    if _WIRE_LO <= first <= _WIRE_HI:
        if first != _WIRE_BYTE[0]:
            raise WireVersionError(
                f"wire version {first & 0x0F} not supported "
                f"(this build speaks v{WIRE_VERSION})")
        if msgpack is None:
            raise WireVersionError("binary frame but msgpack unavailable")
        out = msgpack.unpackb(bytes(data[1:]), raw=False, use_list=True,
                              strict_map_key=False, ext_hook=_ext_hook,
                              object_pairs_hook=_map_hook)
        return tuple(out) if isinstance(out, list) else out
    return pickle.loads(data)


class Connection:
    """Thread-safe framed-message duplex connection."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # unix sockets

    def send(self, msg: Any) -> None:
        # Hot framework-pure kinds ride the compact binary codec; all
        # else is cloudpickle, not pickle: messages carry user callables
        # (actor task args, data-stage fns) that plain pickle serializes
        # by reference — unpicklable in a worker that can't import the
        # sender's __main__.
        data = encode_message(msg)
        if data is None:
            data = cloudpickle.dumps(msg, protocol=5)
        with self._send_lock:
            try:
                # raylint: disable=RT001 the send lock exists solely to
                # serialize this socket write; no other state is
                # guarded by it
                self.sock.sendall(_HDR.pack(len(data)) + data)
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                raise ConnectionClosed(str(e)) from e

    def _recv_exact(self, n: int) -> bytes:
        return read_exact(self.sock, n)

    def recv(self) -> Any:
        with self._recv_lock:
            hdr = self._recv_exact(_HDR.size)
            (length,) = _HDR.unpack(hdr)
            if length > MAX_MSG:
                raise ConnectionClosed(f"oversized frame: {length}")
            data = self._recv_exact(length)
        try:
            return decode_message(data)
        except BaseException:  # noqa: BLE001 — framing is intact; keep going
            return (RECV_ERROR, traceback.format_exc())

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def fileno(self) -> int:
        return self.sock.fileno()


# ---------------------------------------------------------------------------
# Raw byte-frame helpers — the data-plane framing used by the peer-to-peer
# object transfer protocol (core/object_transfer.py). Unlike Connection
# messages these frames carry opaque bytes (no pickling on the payload
# path), so a multi-MB chunk costs one memcpy, not a serialize.

def read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            # raylint: disable=RT003 transport helper: callers own the
            # timeout discipline (settimeout/select before calling)
            chunk = sock.recv(min(n - got, 1 << 20))
        except (ConnectionResetError, OSError) as e:
            raise ConnectionClosed(str(e)) from e
        if not chunk:
            raise ConnectionClosed("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def write_frame(sock: socket.socket, payload) -> None:
    """Length-prefixed raw frame; payload is bytes or any buffer."""
    try:
        sock.sendall(_HDR.pack(len(payload)))
        sock.sendall(payload)
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        raise ConnectionClosed(str(e)) from e


def read_frame(sock: socket.socket, max_len: int = MAX_MSG) -> bytes:
    (length,) = _HDR.unpack(read_exact(sock, _HDR.size))
    if length > max_len:
        raise ConnectionClosed(f"oversized frame: {length}")
    return read_exact(sock, length)


def write_obj(sock: socket.socket, obj: Any) -> None:
    """Small pickled control frame (transfer-plane handshakes only)."""
    write_frame(sock, cloudpickle.dumps(obj, protocol=5))


def read_obj(sock: socket.socket, max_len: int = 1 << 20) -> Any:
    return pickle.loads(read_frame(sock, max_len))


def unix_listener(path: str) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.listen(128)
    return s


def unix_connect(path: str, timeout: Optional[float] = 10.0) -> Connection:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect(path)
    s.settimeout(None)
    return Connection(s)


def tcp_listener(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """Multi-host transport: remote node agents and their workers speak
    the same framed protocol over TCP (reference parity: the gRPC
    services of src/ray/gcs/gcs_server/gcs_node_manager.cc — here one
    listener serves workers AND node agents, demuxed by the first
    message)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(128)
    return s


def tcp_connect(host: str, port: int,
                timeout: Optional[float] = 10.0) -> Connection:
    s = socket.create_connection((host, port), timeout=timeout)
    if s.getsockname() == s.getpeername():
        # TCP self-connect: connecting to a loopback port in the
        # ephemeral range while nothing listens can "succeed" against
        # OURSELVES (the kernel picked source port == dest port). A
        # node agent retrying a dead driver's address would then talk
        # to its own echo and believe it rejoined — refuse, so the
        # caller's retry loop keeps waiting for the real listener
        # (observed during driver crash-restart reattach tests).
        s.close()
        raise ConnectionRefusedError(
            f"self-connect to {host}:{port} (no listener yet)")
    s.settimeout(None)
    return Connection(s)


def connect_address(address: str,
                    timeout: Optional[float] = 10.0) -> Connection:
    """Connect to "tcp://host:port" or a unix-socket path (optionally
    "unix://path")."""
    if address.startswith("tcp://"):
        host, _, port = address[len("tcp://"):].rpartition(":")
        return tcp_connect(host, int(port), timeout=timeout)
    if address.startswith("unix://"):
        address = address[len("unix://"):]
    return unix_connect(address, timeout=timeout)
