"""gRPC ingress actor (counterpart of ray_tpu/serve/grpc_proxy.py).

Reference parity: python/ray/serve/_private/proxy.py gRPC path +
grpc_util.py — the reference proxy serves user-defined gRPC services
next to HTTP, selecting the target application from the `application`
request metadata. TPU-first simplification: one generic byte-level
service (no protoc step),

    /ray_tpu.serve.ServeAPI/Predict        unary   -> unary
    /ray_tpu.serve.ServeAPI/PredictStream  unary   -> server stream

with JSON payloads in/out. The target application comes from the
`application` metadata key (same convention as the reference); with a
single running application the metadata may be omitted. The service keeps
the reference's wire name, so a client of one package's proxy talks to
the other's unchanged. `grpc` is imported inside the actor only: a
runtime without it never loads this module's dependency.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Optional

from .handle import DeploymentHandle

GRPC_PROXY_NAME = "_SERVE_GRPC_PROXY"
_SERVICE = "ray_tpu.serve.ServeAPI"


class GrpcProxy:
    """Actor: owns the grpc.server; refreshes routes from the controller."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import grpc

        self._routes: Dict[str, DeploymentHandle] = {}   # app -> handle
        self._routes_lock = threading.Lock()
        proxy = self

        def _resolve(context) -> DeploymentHandle:
            md = dict(context.invocation_metadata())
            app = md.get("application")
            with proxy._routes_lock:
                routes = dict(proxy._routes)
            if app is not None:
                handle = routes.get(app)
                if handle is None:
                    context.abort(grpc.StatusCode.NOT_FOUND,
                                  f"no application {app!r}; running: "
                                  f"{sorted(routes)}")
                return handle
            if len(routes) == 1:
                return next(iter(routes.values()))
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"{len(routes)} applications running; pass "
                          f"'application' metadata to pick one")

        def _decode(request: bytes):
            return json.loads(request) if request else None

        def _encode(result) -> bytes:
            if isinstance(result, bytes):
                return result
            if isinstance(result, str):
                return result.encode()
            return json.dumps(result).encode()

        def _status_for(e):
            """Typed serve-FT failures map to retriable gRPC codes —
            one shared classifier with the HTTP ingress, per-protocol
            code table here."""
            from ..exceptions import classify_request_failure
            return {
                "backpressure": grpc.StatusCode.RESOURCE_EXHAUSTED,
                "no_capacity": grpc.StatusCode.RESOURCE_EXHAUSTED,
                "shed": grpc.StatusCode.UNAVAILABLE,        # retriable
                "interrupted": grpc.StatusCode.UNAVAILABLE,  # retriable
                "timeout": grpc.StatusCode.DEADLINE_EXCEEDED,
                "error": grpc.StatusCode.INTERNAL,
            }[classify_request_failure(e)]

        def _deadline(context):
            """Absolute deadline from the client's gRPC timeout, else
            the proxy default (shared with the HTTP ingress)."""
            import time as _time

            from .config import default_request_timeout_s as \
                _default_timeout_s
            budget = context.time_remaining()
            if budget is None or budget > 86400:
                # no client deadline: grpc reports None or a huge
                # sentinel (which would overflow downstream waits).
                # Only the OPERATOR default may disable the bound.
                budget = _default_timeout_s()
                if budget <= 0:
                    return None
            elif budget <= 0:
                # client deadline ALREADY expired at read time: stamp
                # a now-deadline so the request is shed downstream, not
                # executed unbounded for a caller that is already gone
                budget = 1e-4
            return _time.time() + budget

        def _affinity_kw(context):
            """Session affinity from `session-id` request metadata —
            the gRPC twin of the HTTP X-Serve-Session-Id header."""
            sid = dict(context.invocation_metadata()).get("session-id")
            return {"__serve_affinity_key": sid} if sid else {}

        def predict(request: bytes, context) -> bytes:
            import time as _time
            handle = _resolve(context)
            try:
                # ValueError covers JSONDecodeError AND the
                # UnicodeDecodeError non-UTF-8 bytes raise first
                body = _decode(request)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, repr(e))
            deadline_ts = _deadline(context)
            try:
                return _encode(handle.remote(
                    body, __serve_deadline_ts=deadline_ts,
                    **_affinity_kw(context)).result(
                    timeout_s=(None if deadline_ts is None
                               else max(0.1,
                                        deadline_ts - _time.time()))))
            except Exception as e:  # noqa: BLE001
                context.abort(_status_for(e), repr(e))

        def predict_stream(request: bytes, context):
            handle = _resolve(context)
            try:
                body = _decode(request)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, repr(e))
            gen = handle.options(stream=True).remote(
                body, __serve_deadline_ts=_deadline(context),
                **_affinity_kw(context))
            try:
                for chunk in gen:
                    yield _encode(chunk)
            except Exception as e:  # noqa: BLE001
                context.abort(_status_for(e), repr(e))
            finally:
                # client cancellation raises GeneratorExit here (not
                # Exception): release the stream's replica accounting
                gen.close()

        class Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                if call_details.method == f"/{_SERVICE}/Predict":
                    return grpc.unary_unary_rpc_method_handler(predict)
                if call_details.method == f"/{_SERVICE}/PredictStream":
                    return grpc.unary_stream_rpc_method_handler(
                        predict_stream)
                return None

        from concurrent import futures
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((Handler(),))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()
        threading.Thread(target=self._route_refresh_loop, daemon=True,
                         name="serve-grpc-routes").start()

    def _route_refresh_loop(self):
        from ._proxy_util import rebuild_handles, refresh_routes_forever

        def apply(targets):
            # get_ingress_targets includes route_prefix=None apps:
            # gRPC routing is by application NAME, no HTTP prefix needed
            with self._routes_lock:
                self._routes = rebuild_handles(
                    self._routes,
                    {app: (app, dep) for app, dep in targets.items()})

        refresh_routes_forever(
            lambda ctrl: ctrl.get_ingress_targets.remote(), apply)

    def ready(self) -> int:
        return self._port

    def ping(self) -> bool:
        return True


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0):
    """Start (or fetch) the gRPC proxy actor; returns (handle, port)."""
    from ._proxy_util import get_or_create_proxy
    return get_or_create_proxy(GRPC_PROXY_NAME, GrpcProxy, host, port)


__all__ = ["GrpcProxy", "start_grpc_proxy", "GRPC_PROXY_NAME"]
