"""HTTP ingress actor (counterpart of ray_tpu/serve/http_proxy.py).

Reference parity: python/ray/serve/_private/proxy.py + http_util.py —
re-based on the stdlib ThreadingHTTPServer (no uvicorn/starlette in-image).
Routes by longest-prefix match against the controller's route table; JSON
in/out; `Accept: text/event-stream` upgrades the call to the streaming
path and emits SSE `data:` events per chunk.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..exceptions import classify_request_failure
from .asgi import START_KEY
from .config import default_request_timeout_s as _default_timeout_s
from .handle import DeploymentHandle

PROXY_NAME = "_SERVE_PROXY"

# symbolic failure class (exceptions.classify_request_failure) ->
# (http_status, retry_after_s | None).
# Shed/no-capacity outcomes are RETRIABLE: 429/503 with Retry-After so
# well-behaved clients back off and resubmit; a deadline that expired
# mid-execution is the client's budget running out: 504.
_STATUS_BY_CLASS = {"backpressure": (429, 1),
                    "no_capacity": (503, 1),
                    "shed": (503, 1),         # never executed
                    "interrupted": (503, 1),  # retriable mid-stream loss
                    "timeout": (504, None),   # executed, budget blown
                    "error": (500, None)}


def _status_for(exc: BaseException):
    return _STATUS_BY_CLASS[classify_request_failure(exc)]


class HTTPProxy:
    """Actor: owns the HTTP server; refreshes routes from the controller."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._routes = {}           # prefix -> DeploymentHandle
        self._asgi = {}             # prefix -> bool (serve.ingress app)
        self._routes_lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence request logging
                pass

            def _match(self):
                """(handle, prefix, is_asgi) for the longest prefix."""
                with proxy._routes_lock:
                    routes = dict(proxy._routes)
                    asgi = dict(proxy._asgi)
                path = self.path.split("?", 1)[0]
                for prefix in sorted(routes, key=len, reverse=True):
                    norm = prefix.rstrip("/") or "/"
                    if path == norm or path.startswith(
                            norm if norm == "/" else norm + "/"):
                        return (routes[prefix], norm,
                                asgi.get(prefix, False))
                return None, None, False

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                ctype = self.headers.get("Content-Type", "")
                if "application/json" in ctype and raw:
                    return json.loads(raw)
                return raw.decode() if raw else None

            def _respond(self, code, body, ctype="application/json",
                         retry_after=None):
                data = body if isinstance(body, bytes) else body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(data)

            def _affinity_kw(self):
                """Session affinity from the X-Serve-Session-Id header:
                requests carrying it are sticky-routed to the session's
                bound replica (warm KV prefix) by the handle's router.
                Dict bodies may carry session_id/a registered prefix
                instead — the handle extracts those itself."""
                sid = self.headers.get("X-Serve-Session-Id")
                return {"__serve_affinity_key": sid} if sid else {}

            def _deadline(self):
                """Absolute deadline for this request: client-supplied
                X-Serve-Timeout-S budget, else the proxy default. It
                propagates proxy -> handle -> replica -> engine
                admission; retries keep the ORIGINAL deadline. Only
                the OPERATOR env knob may disable the bound (<= 0 →
                no deadline); a non-positive client header falls back
                to the default — an untrusted header must not be able
                to pin proxy threads forever."""
                raw = self.headers.get("X-Serve-Timeout-S")
                budget = None
                if raw:
                    try:
                        # cap: an untrusted header may shrink the bound
                        # but never extend it past an hour
                        budget = min(float(raw), 3600.0)
                    except ValueError:
                        budget = None
                if budget is None or budget <= 0:
                    budget = _default_timeout_s()
                return None if budget <= 0 else time.time() + budget

            def _fail(self, e, headers_sent=False, emit=None):
                """Map a request failure to a response (pre-headers) or
                a terminal SSE error event (mid-stream)."""
                code, retry_after = _status_for(e)
                try:
                    if headers_sent:
                        if emit is not None:
                            # mid-stream failure: a second status line
                            # would corrupt the chunked body — emit one
                            # final error event and end the stream
                            emit(json.dumps({"error": repr(e)}).encode())
                            self.wfile.write(b"0\r\n\r\n")
                    else:
                        self._respond(code, json.dumps(
                            {"error": repr(e)}), retry_after=retry_after)
                except Exception:  # noqa: BLE001  client went away
                    pass

            def _serialize(self, result):
                if isinstance(result, bytes):
                    return result, "application/octet-stream"
                if isinstance(result, str):
                    return result, "text/plain"
                return json.dumps(result), "application/json"

            def _handle_asgi(self, handle, prefix):
                """serve.ingress(app) route: ship the RAW request to the
                replica (the ASGI wrapper drives the app there) and
                relay its streamed response — start item first, then
                body chunks — as a chunked HTTP response. SSE and plain
                responses flow through the same path."""
                path = self.path.split("?", 1)[0]
                query = (self.path.split("?", 1)[1]
                         if "?" in self.path else "")
                n = int(self.headers.get("Content-Length") or 0)
                request = {
                    "method": self.command,
                    "path": path,
                    "query": query,
                    "root_path": "" if prefix == "/" else prefix,
                    "headers": list(self.headers.items()),
                    "body": self.rfile.read(n) if n else b"",
                }
                headers_sent = False
                bodiless = False   # 1xx/204/304: no body, no chunking
                gen = None
                try:
                    gen = handle.options(stream=True).remote(
                        request, __serve_deadline_ts=self._deadline(),
                        **self._affinity_kw())
                    for item in gen:
                        if isinstance(item, dict) and item.get(START_KEY):
                            status = item["status"]
                            bodiless = (status in (204, 304)
                                        or 100 <= status < 200)
                            self.send_response(status)
                            for k, v in item["headers"]:
                                if k.lower() in ("content-length",
                                                 "transfer-encoding"):
                                    continue  # we re-frame as chunked
                                self.send_header(k, v)
                            if not bodiless:
                                self.send_header("Transfer-Encoding",
                                                 "chunked")
                            self.end_headers()
                            headers_sent = True
                            continue
                        if bodiless:
                            continue  # RFC: such responses have no body
                        chunk = (item if isinstance(item, bytes)
                                 else bytes(item))
                        self.wfile.write(f"{len(chunk):x}\r\n".encode()
                                         + chunk + b"\r\n")
                        self.wfile.flush()
                    if not headers_sent:
                        raise RuntimeError("ASGI app sent no response")
                    if not bodiless:
                        self.wfile.write(b"0\r\n\r\n")
                except Exception as e:  # noqa: BLE001
                    try:
                        if headers_sent:
                            # mid-stream failure: closing WITHOUT the
                            # chunked terminator signals truncation —
                            # a clean terminator would make the partial
                            # body indistinguishable from success
                            self.close_connection = True
                        else:
                            code, retry_after = _status_for(e)
                            self._respond(code, json.dumps(
                                {"error": repr(e)}),
                                retry_after=retry_after)
                    except Exception:  # noqa: BLE001  client went away
                        pass
                finally:
                    if gen is not None:
                        gen.close()

            def _handle(self):
                handle, prefix, is_asgi = self._match()
                if handle is None:
                    self._respond(404, json.dumps(
                        {"error": f"no route for {self.path}"}))
                    return
                if is_asgi:
                    self._handle_asgi(handle, prefix)
                    return
                try:
                    body = self._body()
                except (ValueError, json.JSONDecodeError) as e:
                    self._respond(400, json.dumps({"error": repr(e)}))
                    return
                # SSE when the client asks via Accept OR via the
                # OpenAI-style {"stream": true} body field
                wants_stream = ("text/event-stream" in (
                    self.headers.get("Accept") or "")
                    or (isinstance(body, dict) and bool(
                        body.get("stream"))))
                deadline_ts = self._deadline()
                headers_sent = False
                gen = None
                emit = None
                try:
                    if wants_stream:
                        gen = handle.options(stream=True).remote(
                            body, __serve_deadline_ts=deadline_ts,
                            **self._affinity_kw())
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/event-stream")
                        self.send_header("Cache-Control", "no-cache")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        headers_sent = True

                        def emit(payload: bytes):
                            event = b"data: " + payload + b"\n\n"
                            self.wfile.write(
                                f"{len(event):x}\r\n".encode()
                                + event + b"\r\n")
                            self.wfile.flush()

                        for chunk in gen:
                            payload, _ = self._serialize(chunk)
                            if isinstance(payload, str):
                                payload = payload.encode()
                            emit(payload)
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        result = handle.remote(
                            body, __serve_deadline_ts=deadline_ts,
                            **self._affinity_kw()
                        ).result(timeout_s=(
                            None if deadline_ts is None
                            else max(0.1, deadline_ts - time.time())))
                        payload, ctype = self._serialize(result)
                        self._respond(200, payload, ctype)
                except Exception as e:  # noqa: BLE001
                    self._fail(e, headers_sent=headers_sent, emit=emit)
                finally:
                    if gen is not None:
                        # abandoned stream (client hung up): release
                        # the replica's manual in-flight count — reused
                        # handles would otherwise leak it forever
                        gen.close()

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        class Server(ThreadingHTTPServer):
            # socketserver's default listen backlog of 5 RSTs excess
            # connections under a concurrent burst (observed: 24
            # simultaneous clients losing 4 to ECONNRESET) — a serve
            # ingress must absorb bursts, not reset them
            request_queue_size = 128

        self._server = Server((host, port), Handler)
        self._port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="serve-http").start()
        threading.Thread(target=self._route_refresh_loop, daemon=True,
                         name="serve-http-routes").start()

    def _route_refresh_loop(self):
        from ._proxy_util import rebuild_handles, refresh_routes_forever

        def apply(routes):
            with self._routes_lock:
                self._routes = rebuild_handles(self._routes, routes)
                self._asgi = {k: bool(len(v) > 2 and v[2])
                              for k, v in routes.items()}

        refresh_routes_forever(lambda ctrl: ctrl.get_routes.remote(),
                               apply)

    def address(self):
        return (self._host, self._port)

    def ready(self) -> int:
        return self._port

    def ping(self) -> bool:
        return True


def start_proxy(host: str = "127.0.0.1", port: int = 8000):
    """Start (or fetch) the proxy actor; returns (handle, bound_port)."""
    from ._proxy_util import get_or_create_proxy
    return get_or_create_proxy(PROXY_NAME, HTTPProxy, host, port)
