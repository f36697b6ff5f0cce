"""The port's serve control plane on its own runtime, on the CPU: the
control-plane cases of tests/test_serve.py and the zero-failure replica
kill of tests/test_serve_fault_tolerance.py, against
`ray_tpu_torch.serve` (deployments, replicas, the router and handles,
the HTTP proxy, ASGI ingress, autoscaling, rolling updates, back
pressure), and the scale-up that counts GPUs.

One runtime for the module, with RAY_TPU_GPUS=1 (one card declared, as
tests/test_torch_gpu_ids.py declares two): CPU deployments take no card,
and a deployment whose replicas ask `num_gpus=1` can place one replica
only. Deployments are defined inside the tests, so the runtime pickles
them by value into the replicas (a function of this module would be
pickled by reference). Every wait has a timeout."""
import asyncio
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve import chaos
from ray_tpu_torch.serve._testing import drain
from ray_tpu_torch.serve.http_proxy import start_proxy
from ray_tpu_torch.util import state as state_mod

T = 60          # seconds any one reply may take


@pytest.fixture(scope="module", autouse=True)
def _serve_instance():
    keys = ("RAY_TPU_GPUS", "CUDA_VISIBLE_DEVICES")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["RAY_TPU_GPUS"] = "1"
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    rt.init(num_cpus=8)
    try:
        yield
    finally:
        serve.shutdown()
        rt.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _cleanup_apps():
    yield
    for app in list(serve.status()["applications"]):
        serve.delete(app)


@pytest.fixture(scope="module")
def proxy_port():
    _proxy, port = start_proxy(port=0)
    return port


def _poll(fn, timeout=30.0, interval=0.1):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        last = fn()
        if last:
            return last
        time.sleep(interval)
    return last


def _post(port, path, body=None, data=None, headers=None, method=None):
    if data is None and body is not None:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {},
                                 method=method)
    return urllib.request.urlopen(req, timeout=T)


def _wait_route(port, path, body):
    """The proxy polls the controller for routes: post until it answers."""
    def ok():
        try:
            with _post(port, path, body) as r:
                return r.status == 200
        except urllib.error.URLError:     # 404 until the routes arrive
            return False
    assert _poll(ok), f"the proxy never routed {path}"


# ---- deployments, composition, user_config -------------------------------

def test_function_deployment_roundtrip():
    @serve.deployment
    def double(x):
        return {"doubled": x["value"] * 2}

    h = serve.run(double.bind(), name="fn-app", route_prefix="/double")
    assert h.remote({"value": 21}).result(timeout_s=T) == {"doubled": 42}
    # the state API finds the running controller
    table = state_mod.serve_router_table()
    assert table["running"]
    assert table["deployments"]["fn-app/double"]["replicas"] == [
        "fn-app#double#1"]
    status = state_mod.serve_autoscaler_status()
    assert status["running"]
    assert status["deployments"]["fn-app/double"]["num_running"] == 1


def test_class_deployment_with_state_and_methods():
    @serve.deployment
    class Counter:
        def __init__(self, start):
            self.count = start

        def incr(self, by):
            self.count += by
            return self.count

        def __call__(self, body):
            return self.count

    h = serve.run(Counter.bind(10), name="counter-app",
                  route_prefix="/counter")
    assert h.incr.remote(5).result(timeout_s=T) == 15
    assert h.incr.remote(1).result(timeout_s=T) == 16
    assert h.remote(None).result(timeout_s=T) == 16


def test_deployment_composition_and_user_config():
    @serve.deployment(user_config={"scale": 10})
    class Adder:
        def __init__(self, amount):
            self.amount = amount
            self.scale = None

        def reconfigure(self, cfg):
            self.scale = cfg["scale"]

        def __call__(self, x):
            return (x + self.amount) * self.scale

    @serve.deployment
    class Pipeline:
        def __init__(self, adder):
            self.adder = adder

        def __call__(self, body):
            return {"result": self.adder.remote(body["value"]).result(
                timeout_s=T)}

    h = serve.run(Pipeline.bind(Adder.bind(5)), name="compose-app",
                  route_prefix="/pipe")
    assert h.remote({"value": 1}).result(timeout_s=T) == {"result": 60}
    assert set(serve.status()["applications"]["compose-app"][
        "deployments"]) == {"Adder", "Pipeline"}


def test_num_replicas_spread_load():
    @serve.deployment(num_replicas=2, max_ongoing_requests=2)
    class WhoAmI:
        def __call__(self, body):
            time.sleep(0.05)
            return os.getpid()

    h = serve.run(WhoAmI.bind(), name="spread-app", route_prefix="/who")
    pids = {r.result(timeout_s=T) for r in [h.remote(None)
                                            for _ in range(8)]}
    assert len(pids) == 2, pids


# ---- @batch, streaming, @multiplexed --------------------------------------

def test_batching_coalesces():
    @serve.deployment(max_ongoing_requests=16)
    class BatchModel:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        async def __call__(self, body):
            return await self.handle(body)

        def seen_batches(self, _body=None):
            return self.batch_sizes

    h = serve.run(BatchModel.bind(), name="batch-app", route_prefix="/b")
    resps = [h.remote(i) for i in range(8)]
    assert sorted(r.result(timeout_s=T) for r in resps) == list(
        range(0, 16, 2))
    sizes = h.seen_batches.remote().result(timeout_s=T)
    assert max(sizes) > 1, f"no coalescing happened: {sizes}"


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_streaming_response(kind):
    if kind == "sync":
        @serve.deployment(name="stream_numbers")
        def stream_numbers(body):
            for i in range(body["n"]):
                yield {"i": i}
    else:
        @serve.deployment(name="stream_numbers")
        async def stream_numbers(body):
            for i in range(body["n"]):
                yield {"i": i}

    h = serve.run(stream_numbers.bind(), name="stream-app",
                  route_prefix="/stream")
    assert drain(h.options(stream=True).remote({"n": 5}), T) == [
        {"i": i} for i in range(5)]


def test_multiplexed_model_loading():
    @serve.deployment
    class MuxModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id}

        async def __call__(self, body):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model["id"]

        def seen_loads(self, _body=None):
            return self.loads

    h = serve.run(MuxModel.bind(), name="mux-app", route_prefix="/mux")
    for mid in ("m1", "m2", "m1", "m3", "m1"):
        assert h.options(multiplexed_model_id=mid).remote(None).result(
            timeout_s=T) == mid
    # m1 stays cached (least recently used: m2, evicted by m3)
    assert h.seen_loads.remote().result(timeout_s=T) == ["m1", "m2", "m3"]


# ---- the HTTP proxy and ASGI ingress --------------------------------------

def test_http_proxy_end_to_end(proxy_port):
    @serve.deployment
    def echo(body):
        return {"echo": body}

    serve.run(echo.bind(), name="http-app", route_prefix="/echo")
    _wait_route(proxy_port, "/echo", {"hi": 0})
    with _post(proxy_port, "/echo", {"hi": 1}) as r:
        assert json.loads(r.read()) == {"echo": {"hi": 1}}
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://127.0.0.1:{proxy_port}/nope",
                               timeout=T)
    assert ei.value.code == 404


async def _toy_asgi_app(scope, receive, send):
    """A hand-rolled ASGI-3 app (tests/test_serve.py's): method + path
    routing, JSON, echo, an SSE endpoint, and one that fails after its
    first chunk."""
    path, method = scope["path"], scope["method"]
    root = scope.get("root_path", "")
    route = path[len(root):] if root and path.startswith(root) else path

    async def respond(status, body, ctype=b"application/json"):
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", ctype)]})
        await send({"type": "http.response.body", "body": body})

    if route == "/hello" and method == "GET":
        q = scope.get("query_string", b"").decode()
        await respond(200, json.dumps({"hello": "world",
                                       "query": q}).encode())
    elif route == "/echo" and method == "POST":
        msg = await receive()
        await respond(200, json.dumps(
            {"method": method, "len": len(msg.get("body", b""))}).encode())
    elif route == "/events" and method == "GET":
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/event-stream")]})
        for i in range(3):
            await send({"type": "http.response.body",
                        "body": f"data: {i}\n\n".encode(),
                        "more_body": True})
        await send({"type": "http.response.body", "body": b""})
    elif route == "/boom" and method == "GET":
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/event-stream")]})
        await send({"type": "http.response.body", "body": b"data: 0\n\n",
                    "more_body": True})
        await asyncio.sleep(0.5)   # the proxy has sent the headers by now
        raise RuntimeError("the app failed mid-stream")
    else:
        await respond(404, json.dumps({"detail": "not found"}).encode())


def test_asgi_ingress_routing_and_sse(proxy_port):
    @serve.deployment
    @serve.ingress(_toy_asgi_app)
    class Api:
        pass

    serve.run(Api.bind(), name="asgi-app", route_prefix="/api")
    base = f"http://127.0.0.1:{proxy_port}/api"

    def hello():
        try:
            with urllib.request.urlopen(base + "/hello?x=1",
                                        timeout=T) as r:
                return r.status, r.headers["Content-Type"], json.loads(
                    r.read())
        except urllib.error.HTTPError:
            return None
    assert _poll(hello) == (200, "application/json",
                            {"hello": "world", "query": "x=1"})
    with _post(proxy_port, "/api/echo", data=b"abcde", method="POST") as r:
        assert json.loads(r.read()) == {"method": "POST", "len": 5}
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/missing", timeout=T)
    assert ei.value.code == 404
    assert json.loads(ei.value.read()) == {"detail": "not found"}
    with urllib.request.urlopen(base + "/events", timeout=T) as r:
        assert "text/event-stream" in r.headers["Content-Type"]
        assert r.read().decode() == "data: 0\n\ndata: 1\n\ndata: 2\n\n"
    # a failure mid-stream closes the connection with no chunked
    # terminator: the client sees a truncated body, not a clean end
    with urllib.request.urlopen(base + "/boom", timeout=T) as r:
        assert r.status == 200
        with pytest.raises(http.client.IncompleteRead) as ei:
            r.read()
    assert ei.value.partial == b"data: 0\n\n"


# ---- autoscaling, rolling update, back pressure ---------------------------

def _hammer(h, n_threads):
    stop = threading.Event()

    def run():
        while not stop.is_set():
            try:
                h.remote(None).result(timeout_s=10)
            except Exception:  # noqa: BLE001  scale churn
                pass
    threads = [threading.Thread(target=run, daemon=True)
               for _ in range(n_threads)]
    for t in threads:
        t.start()

    def halt():
        stop.set()
        for t in threads:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in threads)
    return halt


def test_autoscaling_scales_up_and_down():
    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 2,
                            "target_ongoing_requests": 1.0,
                            "look_back_period_s": 1.0,
                            "metrics_interval_s": 0.2,
                            "upscale_delay_s": 0.1,
                            "downscale_delay_s": 0.5},
        max_ongoing_requests=4)
    def slow(body):
        time.sleep(0.3)
        return "ok"

    h = serve.run(slow.bind(), name="auto-app", route_prefix="/auto")
    halt = _hammer(h, 6)
    try:
        assert _poll(lambda: len(chaos.running_replicas(
            "auto-app", "slow")) >= 2), "never scaled up under load"
    finally:
        halt()
    assert _poll(lambda: len(chaos.running_replicas(
        "auto-app", "slow")) <= 1), "never scaled back down when idle"
    dirs = {d["direction"] for d in state_mod.serve_autoscaler_status()[
        "decisions"] if d["deployment"] == "slow"}
    assert {"scale_up", "scale_down"} <= dirs


def test_rolling_update_changes_version():
    @serve.deployment(version="v1")
    def versioned(body):
        return "v1"

    serve.run(versioned.bind(), name="roll-app", route_prefix="/roll")
    h = serve.get_app_handle("roll-app")
    assert h.remote(None).result(timeout_s=T) == "v1"

    @serve.deployment(name="versioned", version="v2")
    def versioned2(body):
        return "v2"

    serve.run(versioned2.bind(), name="roll-app", route_prefix="/roll")
    assert _poll(lambda: h.remote(None).result(timeout_s=T) == "v2",
                 interval=0.2), "rolling update never served v2"


def test_max_queued_requests_backpressure():
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=1)
    def blocker(body):
        time.sleep(1.0)
        return "done"

    h = serve.run(blocker.bind(), name="bp-app", route_prefix="/bp")
    assert h.remote(None).result(timeout_s=T) == "done"
    first = h.remote(None)          # occupies the single replica slot
    t = threading.Thread(target=lambda: h.remote(None).result(timeout_s=T),
                         daemon=True)
    t.start()                       # waits for capacity, holding the queue
    time.sleep(0.5)
    with pytest.raises(serve.BackPressureError):
        h.remote(None)
    assert first.result(timeout_s=T) == "done"
    t.join(timeout=T)
    assert not t.is_alive()


# ---- a replica killed under HTTP traffic ----------------------------------

def test_replica_kill_under_http_traffic_zero_failures(proxy_port):
    """Killing one of two replicas while 20 HTTP requests are in flight
    loses none: calls on the dead replica fail over to the survivor, and
    the controller replaces the dead one."""
    @serve.deployment(num_replicas=2, max_ongoing_requests=4,
                      health_check_period_s=0.2,
                      health_check_failure_threshold=1)
    def work(body):
        time.sleep(0.15)
        return {"v": body["v"]}

    serve.run(work.bind(), name="kill-app", route_prefix="/kill")
    _wait_route(proxy_port, "/kill", {"v": -1})
    results, errors = [], []
    lock = threading.Lock()

    def one(i):
        try:
            with _post(proxy_port, "/kill", {"v": i}) as r:
                out = json.loads(r.read())
            with lock:
                results.append(out["v"])
        except Exception as e:  # noqa: BLE001  counted below
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(20)]
    for t in threads:
        t.start()
    time.sleep(0.2)                 # requests land on both replicas
    killed = chaos.kill_replica("kill-app", "work")
    for t in threads:
        t.join(timeout=2 * T)
    assert not any(t.is_alive() for t in threads)
    assert not errors, f"HTTP requests failed across the kill: {errors}"
    assert sorted(results) == list(range(20))
    assert killed not in chaos.wait_for_replacement("kill-app", "work",
                                                    killed)


# ---- the scale-up counts GPUs ---------------------------------------------

def test_scale_up_counts_gpus():
    """A deployment whose replicas ask num_gpus=1, on a node of one card,
    scaled up to 2: the decision reports that the added replica does not
    fit (feasible_now 0 of the 1 added: 1 of the 2 in all), the second
    replica stays pending, and the first keeps answering."""
    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 2,
                            "target_ongoing_requests": 1.0,
                            "look_back_period_s": 1.0,
                            "metrics_interval_s": 0.2,
                            "upscale_delay_s": 0.1,
                            "downscale_delay_s": 60.0},
        max_ongoing_requests=4, ray_actor_options={"num_gpus": 1})
    def on_card(body):
        time.sleep(0.3)
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "ids": rt.get_gpu_ids()}

    h = serve.run(on_card.bind(), name="gpu-app", route_prefix="/gpu")
    assert h.remote(None).result(timeout_s=T) == {"visible": "0",
                                                  "ids": [0]}
    halt = _hammer(h, 6)
    try:
        def scale_up():
            return [d for d in state_mod.serve_autoscaler_status()[
                "decisions"] if d["deployment"] == "on_card"
                and d["direction"] == "scale_up"]
        ups = _poll(scale_up)
        assert ups and ups[0]["to"] == 2
        assert ups[0]["feasible_now"] == 0
        time.sleep(1.0)
        states = sorted(r["state"] for r in chaos.list_replicas(
            "gpu-app", "on_card"))
        assert states == ["RUNNING", "STARTING"]
        assert rt.available_resources().get("GPU", 0.0) == 0
        assert h.remote(None).result(timeout_s=T)["ids"] == [0]
    finally:
        halt()
