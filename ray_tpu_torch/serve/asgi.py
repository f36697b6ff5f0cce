"""Generic ASGI ingress for serve deployments (counterpart of
ray_tpu/serve/asgi.py).

Reference parity: python/ray/serve/api.py:168 `@serve.ingress(app)` —
the reference mounts an ASGI app (typically FastAPI) on the proxy so a
deployment serves arbitrary routes/middleware. fastapi is not a
dependency, so `ray_tpu_torch.serve.ingress` mounts ANY ASGI-3 callable (a
hand-rolled app, starlette-style framework, etc.):

    app = my_asgi_app           # async def app(scope, receive, send)

    @serve.deployment
    @serve.ingress(app)
    class Api:
        pass

    serve.run(Api.bind(), route_prefix="/api")

Requests under the route prefix reach the replica as a raw request dict
(method/path/query/headers/body); the wrapper drives the ASGI app on
the replica's event loop and streams the response back through the
deployment's streaming path — response start first, then raw body
chunks — so plain responses, chunked streaming, and SSE all flow
through one mechanism, with replica routing/autoscaling/batching
unchanged underneath.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

ASGI_ATTR = "__ray_tpu_asgi__"
START_KEY = "__asgi_start__"


def ingress(asgi_app: Callable):
    """Class decorator: route HTTP requests for this deployment through
    `asgi_app` (an ASGI-3 callable). Apply UNDER @serve.deployment."""

    def decorator(cls):
        class ASGIIngress(cls):
            async def __call__(self, request: Dict[str, Any]):
                import asyncio

                scope = {
                    "type": "http",
                    "asgi": {"version": "3.0", "spec_version": "2.3"},
                    "http_version": "1.1",
                    "method": request["method"],
                    "scheme": "http",
                    "path": request["path"],
                    "raw_path": request["path"].encode(),
                    "query_string": (request.get("query") or "").encode(),
                    "root_path": request.get("root_path", ""),
                    "headers": [(str(k).lower().encode("latin-1"),
                                 str(v).encode("latin-1"))
                                for k, v in request.get("headers", [])],
                    "client": ("127.0.0.1", 0),
                    "server": ("127.0.0.1", 0),
                }
                body = request.get("body") or b""
                delivered = False

                async def receive():
                    nonlocal delivered
                    if not delivered:
                        delivered = True
                        return {"type": "http.request", "body": body,
                                "more_body": False}
                    return {"type": "http.disconnect"}

                q: "asyncio.Queue" = asyncio.Queue()

                async def send(msg):
                    await q.put(msg)

                app_err: list = []

                async def run():
                    try:
                        await asgi_app(scope, receive, send)
                    except BaseException as e:  # noqa: BLE001
                        app_err.append(e)
                    finally:
                        await q.put(None)

                task = asyncio.get_running_loop().create_task(run())
                started = False
                try:
                    while True:
                        msg = await q.get()
                        if msg is None:
                            break
                        if msg["type"] == "http.response.start":
                            started = True
                            yield {START_KEY: True,
                                   "status": int(msg["status"]),
                                   "headers": [
                                       (k.decode("latin-1"),
                                        v.decode("latin-1"))
                                       for k, v in msg.get("headers",
                                                           [])]}
                        elif msg["type"] == "http.response.body":
                            chunk = bytes(msg.get("body", b"") or b"")
                            if chunk:
                                yield chunk
                    if app_err:
                        raise app_err[0]
                    if not started:
                        raise RuntimeError(
                            "ASGI app finished without sending "
                            "http.response.start")
                finally:
                    task.cancel()

        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = cls.__qualname__
        ASGIIngress.__module__ = cls.__module__
        setattr(ASGIIngress, ASGI_ATTR, True)
        return ASGIIngress

    return decorator
