"""Ray-Client-style server: remote drivers over the framed protocol.

Reference parity: python/ray/util/client (ray.init("ray://host:port") —
a gRPC proxy next to the driver replays client API calls onto the real
core worker).  ray_tpu_torch's redesign: the hosting process owns a normal
`DriverRuntime`; this server accepts framed-pickle connections
(core/protocol.py — the same transport workers and node agents use) and
replays each client verb onto the runtime's public API.  No dispatcher
changes: the client is just another caller of `submit/put/get/wait/...`,
so scheduling, placement groups, named actors, retries and lineage all
behave exactly as for a local driver.

Host side::

    import ray_tpu_torch
    from ray_tpu_torch.client.server import ClientServer
    ray_tpu_torch.init(num_cpus=8)
    srv = ClientServer(host="0.0.0.0", port=10001)
    print(srv.address)          # ray://0.0.0.0:10001

or standalone (starts its own runtime, serves until killed)::

    python -m ray_tpu_torch.client.server --listen 127.0.0.1:10001 \
        --num-cpus 8 --num-gpus 1

Client side::

    ray_tpu_torch.init(address="ray://host:10001")

Values (task args, put payloads, results) ride inside the framed
messages as payloads of the port's object serialization
(core/serialization.py), so a tensor from a card is rebuilt where the
reader may use one and on the CPU elsewhere; single values are capped
by the protocol frame limit (1 GB).  Blocking verbs
(get/wait/gen_next/report_sync) each run on their own server thread so
one stalled get never blocks the same client's other calls; replies are
matched by request id.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import threading
import traceback
from typing import Any, Dict

from ..core import runtime as runtime_mod
from ..core import serialization
from ..core.protocol import (Connection, ConnectionClosed, RECV_ERROR,
                             tcp_listener)

PROTOCOL_VERSION = 1

# Verbs that may block for a long time get a thread per request so they
# don't head-of-line-block the connection's other traffic.
_BLOCKING_OPS = {"get", "wait", "gen_next", "report_sync"}
# Verbs whose values the host only passes on (to the client, or into the
# store): a tensor from a card crosses the host without touching its CUDA.
_RELAY_OPS = {"get", "put"}


class ClientServer:
    """Serve remote ray_tpu_torch clients on top of an initialized runtime."""

    def __init__(self, rt=None, host: str = "127.0.0.1", port: int = 0):
        self.rt = rt or runtime_mod.get_runtime()
        self._listener = tcp_listener(host, port)
        self.host, self.port = self._listener.getsockname()[:2]
        self.address = f"ray://{self.host}:{self.port}"
        self._shutdown = threading.Event()
        self._conns: Dict[int, Connection] = {}
        self._next_conn = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="client-accept")
        self._accept_thread.start()

    # ------------------------------------------------------------- accept

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = Connection(sock)
            cid = self._next_conn = self._next_conn + 1
            self._conns[cid] = conn
            threading.Thread(target=self._serve_conn, args=(cid, conn),
                             daemon=True, name=f"client-conn-{cid}").start()

    def _serve_conn(self, cid: int, conn: Connection) -> None:
        try:
            hello = conn.recv()
            if not (isinstance(hello, tuple) and hello
                    and hello[0] == "client_hello"):
                conn.close()
                return
            conn.send(("client_welcome", {
                "protocol": PROTOCOL_VERSION,
                "job_id": getattr(self.rt, "job_id", "job-default"),
                "node_id": getattr(self.rt, "node_id", "node-local"),
                "namespace": getattr(self.rt, "namespace", "default"),
            }))
            while True:
                msg = conn.recv()
                if msg[0] == RECV_ERROR:
                    sys.stderr.write(
                        f"[ray_tpu_torch client-server] dropped bad frame "
                        f"from client {cid}:\n{msg[1]}")
                    continue
                if msg[0] == "bye":
                    break
                _, rid, op, payload = msg
                if op in _BLOCKING_OPS:
                    threading.Thread(
                        target=self._run_op, args=(conn, rid, op, payload),
                        daemon=True).start()
                else:
                    self._run_op(conn, rid, op, payload)
        except ConnectionClosed:
            pass
        finally:
            self._conns.pop(cid, None)
            conn.close()

    # -------------------------------------------------------------- verbs

    def _run_op(self, conn: Connection, rid: str, op: str,
                payload: bytes) -> None:
        # The payload is pickled SEPARATELY from the reply frame: the
        # outer message is primitives-only so it always (de)serializes,
        # and a payload that won't pickle (or won't unpickle client-side,
        # e.g. a host-only exception class) degrades into a per-request
        # error instead of a silently-hung client.
        relay = (serialization.relaying() if op in _RELAY_OPS
                 else contextlib.nullcontext())
        with relay:
            try:
                result = self._dispatch(op, serialization.unpack(payload))
                ok = True
            except BaseException as e:  # noqa: BLE001 — ship to the client
                result, ok = e, False
            try:
                blob = serialization.pack(result)
            except Exception:
                ok = False
                blob = serialization.pack(RuntimeError(
                    f"client op {op}: result of type "
                    f"{type(result).__name__} failed to serialize:\n"
                    + traceback.format_exc()[-1500:]))
        try:
            conn.send(("reply", rid, ok, blob))
        except ConnectionClosed:
            pass  # client gone; nothing to deliver to

    def _dispatch(self, op: str, p: tuple) -> Any:
        rt = self.rt
        if op == "put":
            return rt.put(p[0])
        if op == "get":
            return rt.get(list(p[0]), timeout=p[1])
        if op == "wait":
            ready, pending = rt.wait(list(p[0]), num_returns=p[1],
                                     timeout=p[2])
            return (ready, pending)
        if op == "submit":
            return rt.submit(p[0])
        if op == "submit_many":
            return rt.submit_many(list(p[0]))
        if op == "submit_actor_task":
            return rt.submit_actor_task(p[0])
        if op == "create_actor":
            return rt.create_actor(p[0])
        if op == "kill_actor":
            return rt.kill_actor(p[0], no_restart=p[1])
        if op == "cancel":
            return rt.cancel(p[0], force=p[1])
        if op == "cancel_task":
            return rt.cancel_task(p[0], force=p[1])
        if op == "free":
            return rt.free(list(p[0]))
        if op == "gen_next":
            return rt.gen_next(p[0], timeout=p[1])
        if op == "get_resources":
            return rt.get_resources()
        if op == "available_resources":
            return rt.available_resources()
        if op == "placement_group":
            return rt.placement_group(p[0], strategy=p[1], name=p[2])
        if op == "remove_placement_group":
            return rt.remove_placement_group(p[0])
        if op == "placement_groups":
            return {pid: st for pid, st in
                    list(getattr(rt, "placement_groups", {}).items())}
        if op == "report_sync":
            channel, data = p
            handler = rt.report_handlers.get(channel)
            if handler is None:
                return None
            return handler("client", data)
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown client op {op!r}")

    # ----------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in list(self._conns.values()):
            conn.close()


def main(argv=None) -> None:
    """Standalone host: start a runtime + client server, serve forever.
    Prints the ray:// address on the first stdout line (machine-readable
    for tests/tooling)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="host:port to serve clients on (port 0=ephemeral)")
    ap.add_argument("--num-cpus", type=float, default=None)
    ap.add_argument("--num-gpus", type=int, default=None,
                    help="whole cards (default: the host's, as init counts)")
    args = ap.parse_args(argv)

    from .. import api
    api.init(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
    host, _, port = args.listen.rpartition(":")
    srv = ClientServer(host=host or "127.0.0.1", port=int(port))
    print(srv.address, flush=True)
    threading.Event().wait()  # serve until killed


if __name__ == "__main__":
    main()
