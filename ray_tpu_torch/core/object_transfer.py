"""Peer-to-peer object transfer plane: direct node-to-node pulls.

Reference parity: src/ray/object_manager/ — the push/pull protocol that
moves sealed plasma objects directly between nodes, with the GCS acting
only as a location directory. In ray_tpu every cross-node payload used
to relay through the driver's control connections, making the
single-controller socket the cluster's bandwidth ceiling; this module
gives each node agent (and the driver) a dedicated data-plane listener
so the HOLDER of an object streams its bytes straight to the REQUESTER:

    requester                driver                holder
        | -- locate(oid) ------> |                    |
        | <----- [(loc, addr)] - |                    |
        | ------------- pull(oid, loc) over TCP ----> |
        | <=== chunk / ack / chunk / ack (data) ===== |

The driver only brokers locations (GCS object table + per-node transfer
addresses); object bytes never touch its sockets except on the
instrumented relay FALLBACK path (ray_tpu_transfer_relay_bytes_total).

Protocol (core/protocol.py raw frames, no pickling on the data path):
    requester -> holder:  pickled ("pull", oid, loc, chunk_size)
    holder -> requester:  pickled ("ok", total_size) | ("err", repr)
    then per chunk:       raw frame (u32 length + bytes), requester
                          answers each with a 1-byte ack before the
                          next chunk is sent (flow control + liveness:
                          a dead requester stalls the holder's sender
                          within one chunk, not one object)

Failure handling: per-pull socket timeouts, retry with exponential
backoff rotating across ALTERNATE holders (ObjectEntry.copies), a
location re-resolve between rounds (stale directory entries after
spill/eviction/node death), and per-node concurrent-pull dedup — one
in-flight pull per object, later requesters block on the first and then
read the local copy.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..util import knobs
from .protocol import (ConnectionClosed, read_exact, read_frame, read_obj,
                       tcp_listener, write_frame, write_obj)

ACK = b"\x01"


def chunk_size_default() -> int:
    return knobs.get_int("RAY_TPU_TRANSFER_CHUNK")


def _retries() -> int:
    return knobs.get_int("RAY_TPU_TRANSFER_RETRIES")


def _timeout_s() -> float:
    return knobs.get_float("RAY_TPU_TRANSFER_TIMEOUT_S")


def _backoff_s() -> float:
    return knobs.get_float("RAY_TPU_TRANSFER_BACKOFF_S")


def _deadline_s() -> float:
    """Total wall-clock cap across ALL pull retry rounds: a dead holder
    must not stall a reader for the full retry budget before lineage
    reconstruction can kick in (0 disables the cap)."""
    return knobs.get_float("RAY_TPU_PULL_DEADLINE_S")


def _mcat():
    from ..util import metrics_catalog  # noqa: PLC0415
    return metrics_catalog


def _record(fn: Callable[[Any], None]) -> None:
    """Run a metrics mutation; telemetry must never fail a transfer."""
    try:
        fn(_mcat())
    except Exception:
        pass


class TransferError(Exception):
    """A pull failed against every candidate holder."""


def get_buffer(store, loc):
    """The packed payload of `loc` as a buffer, zero-copy when the
    backing store supports it (shm segment / pinned native-arena view —
    the holder then streams straight out of shared memory), falling
    back to a bytes copy (inline / spill / evicted-with-spill-copy).
    Raises (e.g. ObjectLostError) when the payload is gone — the
    server forwards that as an "err" reply so the requester can retry
    against a fresh directory entry."""
    fn = getattr(store, "get_buffer", None)
    if fn is not None:
        return fn(loc)
    return store.get_bytes(loc)


# ---------------------------------------------------------------------------
# holder side


class TransferServer:
    """Per-node data-plane listener serving pull requests out of the
    local object store. One thread per connection; Connection-free (raw
    frames) so a multi-GB stream never pays pickling."""

    def __init__(self, store, host: str = "0.0.0.0", port: int = 0,
                 advertise_host: Optional[str] = None,
                 on_chunk: Optional[Callable[[int], None]] = None,
                 spill_dirs: Optional[List[str]] = None):
        self.store = store
        # spill reads are confined to this node's own spill directory:
        # the requester's loc comes off the wire, and an unvalidated
        # spill_path would be an arbitrary-file-read primitive
        dirs = spill_dirs if spill_dirs is not None else \
            [d for d in (knobs.get_raw("RAY_TPU_SPILL_DIR"),) if d]
        self._spill_dirs = [os.path.realpath(d) for d in dirs]
        self._listener = tcp_listener(host, port)
        lh, lp = self._listener.getsockname()[:2]
        if advertise_host is None and lh in ("0.0.0.0", "::"):
            from ..util.netutil import routable_ip  # noqa: PLC0415
            advertise_host = routable_ip()
        self.address = f"{advertise_host or lh}:{lp}"
        self.stats = {"serves": 0, "bytes": 0, "chunks": 0, "errors": 0}
        # test hook: called with the chunk offset before each chunk send
        # (failure-injection: a holder dying mid-stream)
        self._on_chunk = on_chunk
        self._closed = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="rtpu-xfer-server").start()

    def _spill_path_allowed(self, loc) -> bool:
        """Wire-supplied locations may only name spill files under this
        node's own spill dirs (shm/arena names can't traverse; file
        paths can)."""
        paths = [p for p in (getattr(loc, "spill_path", None),
                             loc.name if getattr(loc, "kind", None)
                             == "spill" else None) if p]
        for p in paths:
            rp = os.path.realpath(p)
            if not any(rp == d or rp.startswith(d + os.sep)
                       for d in self._spill_dirs):
                return False
        return True

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                if self._closed.is_set():
                    return
                # transient accept failure (e.g. EMFILE under load) must
                # not kill the node's whole transfer plane — back off and
                # keep serving
                self.stats["errors"] += 1
                time.sleep(0.05)
                continue
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True).start()

    def _serve_conn(self, sock) -> None:
        try:
            sock.settimeout(_timeout_s())
            req = read_obj(sock)
            if not (isinstance(req, tuple) and req[0] == "pull"):
                write_obj(sock, ("err", f"bad request {req!r}"))
                return
            _, oid, loc, chunk = req
            if not self._spill_path_allowed(loc):
                write_obj(sock, ("err", "spill path outside this "
                                        "node's spill directory"))
                return
            try:
                buf = get_buffer(self.store, loc)
            except BaseException as e:  # noqa: BLE001
                self.stats["errors"] += 1
                write_obj(sock, ("err", repr(e)))
                return
            view = memoryview(buf)
            total = view.nbytes
            write_obj(sock, ("ok", total))
            sent = 0
            while sent < total:
                if self._on_chunk is not None:
                    self._on_chunk(sent)
                n = min(chunk, total - sent)
                write_frame(sock, view[sent:sent + n])
                if read_exact(sock, 1) != ACK:
                    raise ConnectionClosed("bad chunk ack")
                sent += n
                self.stats["chunks"] += 1
                _record(lambda m, n=n: (
                    m.get("ray_tpu_transfer_chunks_total").inc(
                        tags={"dir": "out"})))
            self.stats["serves"] += 1
            self.stats["bytes"] += total
            _record(lambda m, total=total: m.get(
                "ray_tpu_transfer_bytes_served_total").inc(total))
        except (ConnectionClosed, OSError):
            self.stats["errors"] += 1
        except BaseException:  # noqa: BLE001
            self.stats["errors"] += 1
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# requester side


def pull_bytes(address: str, oid: str, loc, *,
               chunk_size: Optional[int] = None,
               timeout: Optional[float] = None) -> bytearray:
    """One pull attempt against one holder: returns the packed payload
    (a bytearray — every consumer takes a buffer). Raises TransferError
    / ConnectionClosed / OSError on any failure — retry policy lives in
    PullManager."""
    import socket  # noqa: PLC0415
    chunk_size = chunk_size or chunk_size_default()
    timeout = timeout or _timeout_s()
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.settimeout(timeout)
        write_obj(sock, ("pull", oid, loc, chunk_size))
        hdr = read_obj(sock)
        if hdr[0] != "ok":
            raise TransferError(
                f"holder {address} refused pull of {oid}: {hdr[1]}")
        total = hdr[1]
        buf = bytearray(total)
        got = 0
        while got < total:
            chunk = read_frame(sock, max_len=chunk_size + 1024)
            buf[got:got + len(chunk)] = chunk
            got += len(chunk)
            sock.sendall(ACK)
            _record(lambda m: m.get(
                "ray_tpu_transfer_chunks_total").inc(tags={"dir": "in"}))
        # the bytearray goes straight to put_packed/unpack — a bytes()
        # copy here would double the memcpy on the bandwidth hot path
        return buf
    finally:
        try:
            sock.close()
        except OSError:
            pass


class _Inflight:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class PullManager:
    """Per-node puller: resolves candidates to a local copy with retry,
    alternate-holder failover, and concurrent-pull dedup.

    candidates: [(ObjectLocation, transfer_address|None), ...] — the
    driver-brokered location directory entries for the object, primary
    location first. locate(oid) (optional) re-resolves fresh candidates
    between retry rounds, closing the stale-directory window after a
    spill or holder death."""

    def __init__(self, store, node_id: Optional[str] = None,
                 locate: Optional[Callable[[str], list]] = None,
                 span_sink: Optional[Callable[[dict], None]] = None):
        self.store = store
        self.node_id = node_id
        self._locate = locate
        self._span_sink = span_sink
        self._lock = threading.Lock()
        self._inflight: Dict[str, _Inflight] = {}
        self.stats = {"pulls": 0, "dedup_waits": 0, "local_hits": 0,
                      "retries": 0, "failures": 0, "bytes": 0}

    # -- public ------------------------------------------------------------
    def pull(self, oid: str, candidates: List[Tuple[Any, Optional[str]]],
             *, chunk_size: Optional[int] = None):
        """Make `oid`'s payload local; returns its LOCAL ObjectLocation
        (an existing local copy, or a fresh put_packed of pulled bytes).
        Raises TransferError when every candidate/retry is exhausted."""
        local = self._local_candidate(candidates)
        if local is not None:
            self.stats["local_hits"] += 1
            _record(lambda m: m.get("ray_tpu_transfer_pulls_total").inc(
                tags={"result": "local"}))
            return local
        with self._lock:
            fl = self._inflight.get(oid)
            if fl is None:
                fl = self._inflight[oid] = _Inflight()
                winner = True
            else:
                winner = False
        if not winner:
            # one in-flight pull per object per node: wait for the
            # winner, then serve from its local copy
            self.stats["dedup_waits"] += 1
            _record(lambda m: m.get("ray_tpu_transfer_pulls_total").inc(
                tags={"result": "dedup"}))
            fl.event.wait()
            if fl.error is not None:
                raise fl.error
            return fl.result
        try:
            loc = self._pull_with_retry(oid, candidates, chunk_size)
            fl.result = loc
            return loc
        except BaseException as e:
            fl.error = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(oid, None)
            fl.event.set()

    # -- internals ---------------------------------------------------------
    def _local_candidate(self, candidates):
        for loc, _addr in candidates or ():
            if getattr(loc, "kind", None) == "inline":
                return loc
            if getattr(loc, "node_id", None) == self.node_id \
                    and self.node_id is not None:
                return loc
        return None

    def _pull_with_retry(self, oid, candidates, chunk_size):
        last_err: Optional[BaseException] = None
        t0 = time.monotonic()
        cap = _deadline_s()
        deadline = t0 + cap if cap > 0 else float("inf")
        rounds = 0
        for attempt in range(_retries() + 1):
            if attempt > 0:
                if time.monotonic() >= deadline:
                    break  # total-deadline cap: stop retrying early
                self.stats["retries"] += 1
                _record(lambda m: m.get(
                    "ray_tpu_transfer_pull_retries_total").inc())
                # jittered exponential backoff (retrying peers must not
                # thundering-herd one recovering holder), clipped so the
                # sleep never overruns the deadline
                delay = _backoff_s() * (2 ** (attempt - 1)) \
                    * (0.5 + random.random())
                time.sleep(min(delay,
                               max(0.0, deadline - time.monotonic())))
                if self._locate is not None:
                    try:
                        fresh = self._locate(oid)
                    except Exception as e:  # directory unreachable
                        fresh = None
                        last_err = e
                    if fresh is not None:
                        candidates = fresh
                        local = self._local_candidate(candidates)
                        if local is not None:
                            self.stats["local_hits"] += 1
                            return local
            rounds = attempt + 1
            for loc, addr in candidates or ():
                if addr is None:
                    continue
                # enforce the deadline WITHIN a round too, and clip the
                # socket timeout to the remaining budget — several
                # black-holed holders in one round must not stack full
                # socket timeouts past the cap
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                start = time.monotonic()
                try:
                    data = pull_bytes(
                        addr, oid, loc, chunk_size=chunk_size,
                        timeout=min(_timeout_s(), max(0.5, remaining))
                        if cap > 0 else None)
                except BaseException as e:  # noqa: BLE001
                    last_err = e
                    continue
                newloc = self._host_locally(oid, data)
                dt = time.monotonic() - start
                self.stats["pulls"] += 1
                self.stats["bytes"] += len(data)
                _record(lambda m, n=len(data), dt=dt: (
                    m.get("ray_tpu_transfer_bytes_pulled_total").inc(n),
                    m.get("ray_tpu_transfer_pulls_total").inc(
                        tags={"result": "ok"}),
                    m.get("ray_tpu_transfer_pull_latency_s").observe(dt)))
                self._span(oid, addr, len(data), start, "ok")
                return newloc
        self.stats["failures"] += 1
        _record(lambda m: m.get("ray_tpu_transfer_pulls_total").inc(
            tags={"result": "error"}))
        self._span(oid, None, 0, t0, "error")
        raise TransferError(
            f"pull of {oid} failed against every holder "
            f"({len(candidates or ())} candidates, {rounds} rounds, "
            f"{time.monotonic() - t0:.1f}s elapsed, deadline "
            f"{cap:.0f}s): {last_err!r}")

    def _host_locally(self, oid: str, data):
        """Re-host pulled bytes in the local store so sibling readers on
        this node get zero-copy shm. A full store fails the pull (the
        caller's relay fallback then moves the bytes over the counted
        path) — returning a multi-MB inline location here would smuggle
        the payload through control-plane messages and pin it in the
        directory forever. Tiny payloads stay inline (put_packed's own
        threshold)."""
        from .object_store import INLINE_MAX  # noqa: PLC0415
        try:
            loc = self.store.put_packed(oid, bytes(data)
                                        if len(data) <= INLINE_MAX
                                        else data)
        except BaseException as e:  # noqa: BLE001
            raise TransferError(
                f"pulled {len(data)} B for {oid} but could not re-host "
                f"locally: {e!r}") from e
        if loc.node_id is None:
            # env-less processes (unit tests) still need the directory
            # to know which node this copy lives on
            loc.node_id = self.node_id
        return loc

    def _span(self, oid, addr, nbytes, start, status) -> None:
        if self._span_sink is None:
            return
        from ..util import tracing  # noqa: PLC0415
        try:
            self._span_sink({
                "trace_id": "", "span_id": tracing.new_span_id(),
                "parent_span_id": "", "task_id": "",
                "name": f"transfer.pull {oid}",
                "start": time.time() - (time.monotonic() - start),
                "end": time.time(), "status": status,
                "node_id": self.node_id, "bytes": nbytes,
                "holder": addr})
        except Exception:
            pass
