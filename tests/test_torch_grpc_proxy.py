"""The port's gRPC ingress (ray_tpu_torch/serve/grpc_proxy.py):
tests/test_grpc_proxy.py's seven cases on a port runtime, skipped where
`grpc` is missing, as the reference's are. The service keeps the
reference's wire name (`/ray_tpu.serve.ServeAPI/...`)."""
import json
import time

import pytest

grpc = pytest.importorskip("grpc")

import ray_tpu_torch as ray_tpu                   # noqa: E402
from ray_tpu_torch import serve                   # noqa: E402


@pytest.fixture(scope="module")
def rt():
    handle = ray_tpu.init(num_cpus=8)
    yield handle
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def grpc_port(rt):
    @serve.deployment
    class Echo:
        def __call__(self, body):
            if isinstance(body, dict) and body.get("stream"):
                n = int(body.get("n", 3))
                def gen():
                    for i in range(n):
                        yield f"part{i}"
                return gen()
            return {"echo": body, "app": "echo-app"}

    @serve.deployment
    class Doubler:
        def __call__(self, body):
            return {"doubled": body["x"] * 2}

    serve.run(Echo.bind(), name="echo-app", route_prefix="/echo")
    serve.run(Doubler.bind(), name="doubler", route_prefix="/doubler")
    from ray_tpu_torch.serve.grpc_proxy import start_grpc_proxy
    _proxy, port = start_grpc_proxy(port=0)
    time.sleep(1.5)          # route refresh
    yield port
    serve.shutdown()


def _stub(port, method, stream=False):
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    kind = channel.unary_stream if stream else channel.unary_unary
    return channel, kind(f"/ray_tpu.serve.ServeAPI/{method}")


def test_grpc_predict_routes_by_application_metadata(grpc_port):
    ch, call = _stub(grpc_port, "Predict")
    out = json.loads(call(json.dumps({"x": 21}).encode(),
                          metadata=(("application", "doubler"),)))
    assert out == {"doubled": 42}
    out = json.loads(call(json.dumps({"hi": 1}).encode(),
                          metadata=(("application", "echo-app"),)))
    assert out["app"] == "echo-app"
    ch.close()


def test_grpc_unknown_application_not_found(grpc_port):
    ch, call = _stub(grpc_port, "Predict")
    with pytest.raises(grpc.RpcError) as ei:
        call(b"{}", metadata=(("application", "nope"),))
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND
    # two apps running + no metadata -> INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as ei:
        call(b"{}")
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    ch.close()


def test_grpc_streaming_predict(grpc_port):
    ch, call = _stub(grpc_port, "PredictStream", stream=True)
    chunks = [c.decode() for c in call(
        json.dumps({"stream": True}).encode(),
        metadata=(("application", "echo-app"),))]
    assert chunks == ["part0", "part1", "part2"]
    ch.close()


def test_grpc_unknown_method_unimplemented(grpc_port):
    ch = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
    call = ch.unary_unary("/ray_tpu.serve.ServeAPI/Nope")
    with pytest.raises(grpc.RpcError) as ei:
        call(b"{}")
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
    ch.close()


def test_grpc_only_app_without_route_prefix(grpc_port, rt):
    """Apps deployed with route_prefix=None (no HTTP surface) are still
    reachable over gRPC by application name (review r4)."""
    @serve.deployment
    def only_grpc(body):
        return {"grpc_only": True}

    serve.run(only_grpc.bind(), name="grpc-only", route_prefix=None)
    time.sleep(1.5)     # route refresh
    ch, call = _stub(grpc_port, "Predict")
    out = json.loads(call(b"{}", metadata=(("application",
                                            "grpc-only"),)))
    assert out == {"grpc_only": True}
    ch.close()


def test_grpc_binary_garbage_is_invalid_argument(grpc_port):
    ch, call = _stub(grpc_port, "Predict")
    with pytest.raises(grpc.RpcError) as ei:
        call(b"\xff\xfe\x00garbage",
             metadata=(("application", "echo-app"),))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    ch.close()


def test_abandoned_stream_releases_replica_capacity(grpc_port, rt):
    """A client that hangs up mid-stream must not leak the replica's
    manual in-flight count (review r4): repeated early cancellations
    would otherwise saturate routing forever."""
    from ray_tpu_torch.serve import get_app_handle
    h = get_app_handle("echo-app")
    # stream LONGER than one stream_next batch (64) so the first pull
    # leaves it genuinely mid-stream, and longer than the replica's
    # 1024-item buffer so an un-cancelled drain would park forever
    for _ in range(12):          # > max_ongoing_requests default
        gen = h.options(stream=True).remote({"stream": True,
                                             "n": 5000})
        next(iter(gen))          # take one chunk, then abandon
        gen.close()
    # functional check: unary traffic still flows after 12 abandoned
    # long streams (leaked counts would saturate max_ongoing_requests;
    # un-cancelled replica drains would park on their full buffers)
    out = h.remote({"ping": 1}).result(timeout_s=30)
    assert out["app"] == "echo-app"
    # a fresh full stream still works end-to-end after the cancels
    full = list(h.options(stream=True).remote({"stream": True,
                                               "n": 5}))
    assert full == [f"part{i}" for i in range(5)]
