"""Ray-Client mode: a thin remote driver (reference: ray.init("ray://...")).

Reference parity: python/ray/util/client — `ray.init("ray://host:port")`
turns the local process into a thin client whose API calls replay on a
remote cluster.  Here `ray_tpu_torch.init(address="ray://host:port")`
installs a `ClientRuntime` as the process's global runtime: it duck-types the
`DriverRuntime` verb surface (`submit/put/get/wait/create_actor/...`), so
`@ray_tpu_torch.remote`, ActorHandles, ObjectRefs, named actors, placement
groups, streaming generators and the rest of the public API work
unchanged — each verb is one framed-pickle RPC to the
`ray_tpu_torch.client.server.ClientServer` attached to the real driver.

Differences from a local driver (documented, Ray-Client-like):
- Values cross the wire (no shared-memory zero-copy on the client side);
  a single value is capped by the 1 GB protocol frame.
- Values cross it through the port's object serialization
  (core/serialization.py `pack`/`unpack`), so a client follows the rule
  a worker follows: a tensor that came from a card is rebuilt on this
  process's card when it may use one, and on the CPU when
  CUDA_VISIBLE_DEVICES is empty, which then never initialises CUDA. A
  client's `put` of a CUDA tensor crosses the same way.
- `get_gpu_ids()` raises: a client holds no granted cards.
- `shutdown()` disconnects the client; the remote cluster stays up.
- Report handlers / dashboards run on the host, not the client.
"""
from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ..core import serialization
from ..core.protocol import ConnectionClosed, tcp_connect
from ..exceptions import RayTpuError

__all__ = ["ClientRuntime", "connect"]


class ClientDisconnected(RayTpuError):
    pass


class ClientRuntime:
    """Global-runtime stand-in that proxies every verb to a ClientServer."""

    is_driver = False
    is_client = True

    def __init__(self, address: str, namespace: str = "default",
                 timeout: float = 10.0):
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        host, _, port = address.rpartition(":")
        self.conn = tcp_connect(host or "127.0.0.1", int(port),
                                timeout=timeout)
        self.conn.send(("client_hello", {"protocol": 1,
                                         "namespace": namespace}))
        kind, info = self.conn.recv()
        if kind != "client_welcome":
            raise ClientDisconnected(f"bad server handshake: {kind!r}")
        self.job_id = info.get("job_id", "job-default")
        self.node_id = info.get("node_id", "node-remote")
        self.namespace = namespace or info.get("namespace", "default")
        self.address = f"ray://{host}:{port}"
        self._lock = threading.Lock()
        self._replies: Dict[str, tuple] = {}
        self._events: Dict[str, threading.Event] = {}
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="client-reader")
        self._reader.start()

    # ---------------------------------------------------------------- rpc

    def _read_loop(self) -> None:
        import sys
        from ..core.protocol import RECV_ERROR
        try:
            while True:
                msg = self.conn.recv()
                if msg[0] == RECV_ERROR:
                    # outer frames are primitives-only, so this is a
                    # transport-level anomaly; one reply is lost and we
                    # can't know whose — fail every in-flight request
                    # loudly rather than hang one caller forever
                    sys.stderr.write(
                        f"[ray_tpu_torch client] undecodable reply frame; "
                        f"failing in-flight rpcs:\n{msg[1][-500:]}\n")
                    with self._lock:
                        for rid, ev in list(self._events.items()):
                            self._replies[rid] = (False, ClientDisconnected(
                                "a server reply frame was undecodable; "
                                "this rpc's reply may have been lost"))
                            ev.set()
                        self._events.clear()
                    continue
                if msg[0] != "reply":
                    continue
                _, rid, ok, payload = msg
                with self._lock:
                    self._replies[rid] = (ok, payload)
                    ev = self._events.pop(rid, None)
                if ev is not None:
                    ev.set()
        except (ConnectionClosed, OSError):
            self._closed = True
            with self._lock:
                events = list(self._events.values())
                self._events.clear()
            for ev in events:
                ev.set()

    def _call(self, op: str, *payload: Any,
              timeout: Optional[float] = None) -> Any:
        if self._closed:
            raise ClientDisconnected(
                f"client connection to {self.address} is closed")
        rid = uuid.uuid4().hex[:16]
        ev = threading.Event()
        with self._lock:
            self._events[rid] = ev
            # re-check under the lock: a disconnect between the check
            # above and this registration would otherwise strand the
            # event (the reader's fail-all already ran without us)
            if self._closed:
                self._events.pop(rid, None)
                raise ClientDisconnected(
                    f"client connection to {self.address} is closed")
        self.conn.send(("req", rid, op, serialization.pack(tuple(payload))))
        ev.wait(timeout)
        with self._lock:
            reply = self._replies.pop(rid, None)
            self._events.pop(rid, None)
        if reply is None:
            if self._closed:
                raise ClientDisconnected(
                    f"server {self.address} disconnected mid-call ({op})")
            raise TimeoutError(f"client rpc {op} timed out")
        ok, blob = reply
        if isinstance(blob, (bytes, bytearray)):
            try:
                result = serialization.unpack(blob)
            except BaseException as e:  # noqa: BLE001
                raise RayTpuError(
                    f"client rpc {op}: reply payload failed to decode "
                    f"(class only importable on the host?): {e!r}") from e
        else:  # locally-generated failure (reader fail-all path)
            result = blob
        if not ok:
            if isinstance(result, BaseException):
                raise result
            raise RayTpuError(str(result))
        return result

    # ----------------------------------------------------- runtime verbs
    # (duck-typed DriverRuntime surface used by ray_tpu_torch/api.py and the
    # util layers; blocking verbs pass timeout=None so the server's own
    # timeout semantics apply)

    def put(self, value: Any):
        return self._call("put", value)

    def get(self, refs: List, timeout: Optional[float] = None):
        return self._call("get", list(refs), timeout)

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        return self._call("wait", list(refs), num_returns, timeout)

    def submit(self, spec):
        return self._call("submit", spec)

    def submit_many(self, specs):
        return self._call("submit_many", list(specs))

    def submit_actor_task(self, spec):
        return self._call("submit_actor_task", spec)

    def create_actor(self, acspec):
        return self._call("create_actor", acspec)

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        return self._call("kill_actor", actor_id, no_restart)

    def cancel(self, ref, force: bool = False):
        return self._call("cancel", ref, force)

    def cancel_task(self, task_id: str, force: bool = False):
        return self._call("cancel_task", task_id, force)

    def free(self, refs: List):
        return self._call("free", list(refs))

    def gen_next(self, task_id: str, timeout: Optional[float] = None):
        return self._call("gen_next", task_id, timeout)

    def get_resources(self) -> Dict[str, float]:
        return self._call("get_resources")

    def available_resources(self) -> Dict[str, float]:
        return self._call("available_resources")

    def placement_group(self, bundles, strategy="PACK", name=""):
        return self._call("placement_group", bundles, strategy, name)

    def remove_placement_group(self, pg_id: str):
        return self._call("remove_placement_group", pg_id)

    @property
    def placement_groups(self) -> Dict[str, Any]:
        """Snapshot of the host's PG table (get_placement_group /
        placement_group_table iterate this)."""
        return self._call("placement_groups")

    def report_sync(self, channel: str, payload: Any,
                    timeout: Optional[float] = None) -> Any:
        return self._call("report_sync", channel, payload, timeout=timeout)

    def ping(self) -> str:
        return self._call("ping")

    @property
    def current_gpu_ids(self):
        """`get_gpu_ids()` reads this: the cards granted to the calling
        task or actor, which a client process is not."""
        raise RuntimeError(
            "get_gpu_ids() in a ray:// client: the client holds no granted "
            "cards; call it inside a task or actor that reserved num_gpus")

    # ------------------------------------------------------------- extras

    def shutdown(self) -> None:
        """Disconnect this client; the remote cluster stays up
        (reference semantics: ray.shutdown() on a client connection)."""
        if not self._closed:
            try:
                self.conn.send(("bye",))
            except ConnectionClosed:
                pass
            self._closed = True
            self.conn.close()
        from ..core import runtime as runtime_mod
        with runtime_mod._runtime_lock:
            if runtime_mod._runtime is self:
                runtime_mod._runtime = None


def connect(address: str, namespace: str = "default") -> ClientRuntime:
    """Connect to a ray:// client server and install the resulting
    ClientRuntime as this process's global runtime."""
    from ..core import runtime as runtime_mod
    rt = ClientRuntime(address, namespace=namespace)
    runtime_mod.set_runtime(rt)
    return rt
