"""The port's data layer (ray_tpu_torch.data) against the reference's
(ray_tpu.data): the same programs on the same inputs and seeds give the
same outputs, column dtypes included.

* With no runtime, each program below runs in this process through both
  packages (the inline executor and the local exchange).
* With a runtime, one program runs once under each package, each in a
  subprocess of its own (the two runtimes read the same RAY_TPU_*
  environment, so never both in one process): the distributed exchange
  (random_shuffle, sort, repartition, groupby, map_groups), the
  actor-pool map_batches, the task map's backpressure, seeded
  random_sample, streaming_split and split_for_worker. Its outputs must
  equal the reference's and the local exchange's, and the port's run
  leaves no worker behind.
* Device iteration: iter_torch_batches and iter_device_batches
  (device="cpu"; the reference's iter_jax_batches) give the reference's
  batches as tensors, narrowing included; iter_device_batches on a CUDA
  device raises where there is none.
"""
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu import data as ref_data
from ray_tpu_torch import data as port_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain(x):
    """JSON-able form of blocks, rows and scalars: an array keeps its
    dtype beside its values, so a dtype change is a difference."""
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ["object", [plain(v) for v in x.tolist()]]
        return [str(x.dtype), plain(x.tolist())]
    if isinstance(x, np.generic):
        return [str(x.dtype), plain(x.item())]
    if isinstance(x, bytes):
        return ["bytes", x.hex()]
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def _rows(ds):
    return plain(ds.take_all())


def _blocks(ds):
    return plain(list(ds.iter_blocks()))


class AddConst:
    """A stateful map_batches class (the actor-pool stage)."""

    def __init__(self, c=100):
        self.c = c

    def __call__(self, b):
        return {"id": b["id"] + self.c}


def p_range_count_take(rd, tmp):
    ds = rd.range(100, block_rows=32)
    return [ds.count(), _rows(rd.range(5)), plain(ds.take(3)), repr(ds)]


def p_map_filter_flat_map(rd, tmp):
    ds = (rd.range(50, block_rows=16)
          .map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
          .filter(lambda r: r["sq"] % 2 == 0))
    fm = rd.from_items([1, 2, 3]).flat_map(
        lambda r: [{"v": r["item"]}, {"v": -r["item"]}])
    return [_rows(ds), _rows(fm), ds.stats().splitlines()[0]]


def p_map_batches(rd, tmp):
    vec = rd.range(64, block_rows=16).map_batches(
        lambda b: {"id": b["id"], "double": b["id"] * 2})
    rebatched = rd.range(50, block_rows=7).map_batches(
        lambda b: {"n": np.full(len(b["id"]), len(b["id"]))},
        batch_size=16)
    stateful = rd.range(8).map_batches(AddConst, fn_constructor_args=(7,))
    return [_blocks(vec), _blocks(rebatched), _rows(stateful)]


def p_columns(rd, tmp):
    ds = (rd.range(10, block_rows=4)
          .add_column("neg", lambda b: -b["id"])
          .add_column("half", lambda b: b["id"] / 2)
          .rename_columns({"id": "idx"})
          .drop_columns(["half"])
          .select_columns(["neg", "idx"]))
    return [_blocks(ds), ds.columns(),
            {k: str(v) for k, v in ds.schema().items()}]


def p_random_shuffle(rd, tmp):
    a = rd.range(100, block_rows=10).random_shuffle(seed=0)
    b = rd.from_items([{"x": i, "y": str(i)} for i in range(37)],
                      block_rows=5).random_shuffle(seed=123)
    return [_rows(a), _rows(b), _blocks(a)]


def p_sort_limit(rd, tmp):
    rng = np.random.RandomState(0)
    vals = rng.randint(0, 1000, 200)
    ds = rd.from_numpy({"v": vals, "i": np.arange(200)}, block_rows=23)
    return [_blocks(ds.sort("v")), _blocks(ds.sort("v", descending=True)),
            _rows(ds.sort("v").limit(7)), _rows(ds.limit(30))]


def p_repartition(rd, tmp):
    ds = rd.range(103, block_rows=10).repartition(4)
    return [[len(b["id"]) for b in ds.iter_blocks()], _blocks(ds)]


def p_groupby(rd, tmp):
    rng = np.random.RandomState(1)
    ds = rd.from_numpy({"k": rng.randint(0, 5, 120),
                        "v": rng.rand(120),
                        "w": rng.randint(0, 9, 120)}, block_rows=17)
    g = ds.groupby("k")
    return [_rows(g.count()), _rows(g.sum("v")), _rows(g.mean("v")),
            _rows(g.min("w")), _rows(g.max("w")), _rows(g.std("v")),
            _rows(g.aggregate(("sum", "w"), ("mean", "w"), ("count", None)))]


def p_map_groups(rd, tmp):
    ds = rd.from_items([{"k": i % 4, "v": i} for i in range(40)],
                       block_rows=6)
    out = ds.groupby("k").map_groups(
        lambda b: {"k": b["k"][:1], "total": np.asarray([b["v"].sum()]),
                   "n": np.asarray([len(b["v"])])})
    return _blocks(out)


def p_union_zip(rd, tmp):
    a = rd.range(10, block_rows=3)
    b = rd.from_items([{"x": i * 10} for i in range(7)], block_rows=4)
    c = rd.range(12, block_rows=5).filter(lambda r: r["id"] > 6)
    return [_rows(a.union(b.map(lambda r: {"id": r["x"]}))),
            _rows(a.zip(b)), _rows(a.zip(rd.range(10, block_rows=4))),
            _rows(c.zip(a))]


def p_splits(rd, tmp):
    ds = rd.range(50, block_rows=8)
    return [[_rows(s) for s in ds.split(3)],
            [_rows(s) for s in ds.streaming_split(3)],
            [_rows(ds.split_for_worker(r, 2)) for r in range(2)],
            [_rows(s) for s in ds.split_proportionately([0.2, 0.5])]]


def p_train_test_split(rd, tmp):
    ds = rd.range(40, block_rows=6)
    tr, te = ds.train_test_split(0.25)
    str_, ste = ds.train_test_split(0.3, shuffle=True, seed=5)
    return [_rows(tr), _rows(te), _rows(str_), _rows(ste)]


def p_random_sample(rd, tmp):
    ds = rd.range(300, block_rows=20)
    return [_rows(ds.random_sample(0.3, seed=7)),
            _rows(ds.random_sample(1.0, seed=1)),
            _rows(ds.random_sample(0.0, seed=1))]


def p_iter_batches(rd, tmp):
    ds = rd.range(53, block_rows=10)
    return [[len(b["id"]) for b in ds.iter_batches(batch_size=16)],
            [len(b["id"]) for b in ds.iter_batches(batch_size=16,
                                                   drop_last=True)],
            plain(list(ds.iter_batches(batch_size=12,
                                       local_shuffle_buffer_size=20,
                                       local_shuffle_seed=3))),
            plain(list(ds.iter_batches(batch_size=8, drop_last=True,
                                       local_shuffle_buffer_size=16,
                                       local_shuffle_seed=0)))]


def p_global_aggregates(rd, tmp):
    rng = np.random.RandomState(2)
    ds = rd.from_numpy({"a": rng.randint(-50, 50, 90),
                        "b": rng.rand(90)}, block_rows=13)
    return plain([ds.sum("a"), ds.min("a"), ds.max("a"), ds.mean("b"),
                  ds.std("b"), ds.std("a", ddof=0), sorted(ds.unique("a")),
                  ds.count(), ds.size_bytes(), ds.columns(),
                  {k: str(v) for k, v in ds.schema().items()}])


def p_materialize(rd, tmp):
    calls = []

    def f(b):
        calls.append(1)
        return b
    ds = rd.range(30, block_rows=10).map_batches(f).materialize()
    first = _rows(ds)
    second = _rows(ds)
    return [first == second, len(calls), first]


def p_pandas(rd, tmp):
    import pandas as pd
    df = pd.DataFrame({"a": np.arange(7), "s": [f"r{i}" for i in range(7)],
                       "f": np.linspace(0, 1, 7)})
    ds = rd.from_pandas(df, block_rows=3)
    back = ds.to_pandas()
    lim = ds.to_pandas(limit=4)
    return [_blocks(ds), back.to_dict(orient="list"),
            lim.to_dict(orient="list")]


def p_sinks(rd, tmp):
    ds = rd.from_items([{"a": i, "b": float(i) / 4, "s": f"x,\"{i}\""}
                        for i in range(9)], block_rows=4)
    out = {}
    ds.write_csv(os.path.join(tmp, "csv"))
    out["csv"] = sorted(map(str, [r["a"] for r in rd.read_csv(
        os.path.join(tmp, "csv", "part-00000.csv")).take_all()]))
    out["csv_rows"] = _rows(rd.read_csv(
        os.path.join(tmp, "csv", "part-00001.csv")))
    paths = ds.write_jsonl(os.path.join(tmp, "jsonl"))
    out["jsonl"] = [os.path.basename(p) for p in paths]
    out["jsonl_rows"] = _rows(rd.read_jsonl(paths[0]))
    jpaths = ds.write_json(os.path.join(tmp, "json"))
    out["json_rows"] = _rows(rd.read_jsonl(jpaths[-1]))
    npaths = ds.write_npy(os.path.join(tmp, "npy"), column="b")
    out["npy_rows"] = _rows(rd.read_npy(npaths[1], column="b"))
    ds.select_columns(["a", "b"]).write_parquet(os.path.join(tmp, "pq"))
    out["parquet"] = _blocks(rd.read_parquet(os.path.join(tmp, "pq")))
    out["parquet_cols"] = _blocks(rd.read_parquet(
        os.path.join(tmp, "pq"), columns=["b"], block_rows=2))
    return out


def p_readers(rd, tmp):
    from PIL import Image
    txt = os.path.join(tmp, "t.txt")
    with open(txt, "w") as f:
        f.write("alpha\nbeta\n\ngamma\n")
    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(os.path.join(img_dir, "sub"))
    rng = np.random.RandomState(4)
    for i in range(3):
        arr = rng.randint(0, 255, (8 + i, 6, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(
            img_dir, "sub" if i == 2 else "", f"im{i}.png"))
    rec = os.path.join(tmp, "r.tfrecord")
    with open(rec, "wb") as f:
        for payload in (b"one", b"", b"three!"):
            f.write(struct.pack("<Q", len(payload)) + b"\0" * 4 + payload
                    + b"\0" * 4)
    resized = rd.read_images(img_dir, size=(4, 5))
    native = rd.read_images(img_dir, block_rows=2)
    return {"text": _rows(rd.read_text(txt, block_rows=3)),
            "images": plain([b["image"] for b in resized.iter_blocks()]),
            "native_shapes": [list(r["image"].shape)
                              for r in native.take_all()],
            "binary": [[r["bytes"].hex(), os.path.basename(r["path"])]
                       for r in rd.read_binary_files(
                           img_dir, suffixes=[".PNG"]).take_all()],
            "tfrecords": _rows(rd.read_tfrecords(rec)),
            "tfrecords_parsed": _rows(rd.read_tfrecords(
                rec, parse_fn=lambda b: {"n": len(b)}))}


def p_preprocessors(rd, tmp):
    pp = rd.preprocessors
    rng = np.random.RandomState(3)
    ds = rd.from_numpy({"x": rng.rand(40) * 10, "y": rng.randint(0, 7, 40),
                        "lab": np.asarray(list("abcab") * 8)},
                       block_rows=9)
    std = pp.StandardScaler(["x"]).fit(ds)
    mm = pp.MinMaxScaler(["x", "y"]).fit(ds)
    le = pp.LabelEncoder("lab").fit(ds)
    chain = pp.Chain(pp.StandardScaler(["x"]),
                     pp.BatchMapper(lambda b: dict(b, x2=b["x"] * 2)),
                     pp.MinMaxScaler(["x2"])).fit(ds)
    tok = pp.Tokenizer("lab", lambda ts: [[ord(t[0]), len(t)] for t in ts],
                       output_column="ids")
    imgs = rd.from_numpy({"image": rng.randint(0, 255, (6, 8, 8, 3))
                          .astype(np.uint8)}, block_rows=4)
    aug = pp.ImageAugmenter(flip=True, crop_padding=2,
                            mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
                            seed=11)
    try:
        pp.StandardScaler(["x"]).transform(ds)
        unfitted = "no error"
    except RuntimeError as e:
        unfitted = str(e)
    return {"std": [plain(std.stats), _blocks(std.transform(ds))],
            "minmax": [plain(mm.ranges), _blocks(mm.fit_transform(ds))],
            "label": [plain(le.classes_), _blocks(le.transform(ds))],
            "chain": _blocks(chain.transform(ds)),
            "tokenizer": _blocks(tok.transform(ds)),
            "augment": _blocks(aug.transform(imgs)),
            "unfitted": unfitted}


PROGRAMS = {name[2:]: fn for name, fn in sorted(globals().items())
            if name.startswith("p_")}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_same_program_same_output_without_a_runtime(name, tmp_path):
    ref_dir = tmp_path / "ref"
    port_dir = tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    ref = PROGRAMS[name](ref_data, str(ref_dir))
    port = PROGRAMS[name](port_data, str(port_dir))
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))


# ---------------------------------------------------------------- device


def _ref_batches(batch_size, drop_last):
    ds = ref_data.from_numpy(_DEVICE_COLS, block_rows=7)
    return list(ds.iter_batches(batch_size=batch_size, drop_last=drop_last))


_DEVICE_COLS = {"i": np.arange(30, dtype=np.int64),
                "f": np.linspace(0, 3, 30),
                "u": np.arange(30, dtype=np.uint8),
                "s": np.asarray([f"r{i}" for i in range(30)], dtype=object)}


def _same(tensor_batch, ref_batch):
    for k, want in ref_batch.items():
        got = tensor_batch[k]
        if want.dtype == object:
            assert list(got) == list(want)
            continue
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_iter_torch_batches_equal_the_reference_batches():
    ds = port_data.from_numpy(_DEVICE_COLS, block_rows=7)
    got = list(ds.iter_torch_batches(batch_size=8))
    want = _ref_batches(8, False)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)
    ref_t = list(ref_data.from_numpy(_DEVICE_COLS, block_rows=7)
                 .iter_torch_batches(batch_size=8,
                                     dtypes={"i": torch.float32}))
    port_t = list(ds.iter_torch_batches(batch_size=8,
                                        dtypes={"i": torch.float32}))
    for g, w in zip(port_t, ref_t):
        assert g["i"].dtype == w["i"].dtype == torch.float32
        assert torch.equal(g["i"], w["i"])


def test_iter_device_batches_cpu_equal_the_reference_jax_batches():
    """device="cpu": int64 -> int32 and float64 -> float32 as the
    reference's iter_jax_batches narrows them; the object column stays
    on the host; dtypes= overrides the narrowing."""
    ds = port_data.from_numpy(_DEVICE_COLS, block_rows=7)
    ref = ref_data.from_numpy(_DEVICE_COLS, block_rows=7)
    for kw in ({}, {"dtypes": {"i": np.int16, "f": np.float16}}):
        got = list(ds.iter_device_batches(batch_size=8, device="cpu", **kw))
        want = [{k: (v if v.dtype == object else np.asarray(v))
                 for k, v in b.items()}
                for b in ref.iter_jax_batches(batch_size=8, **kw)]
        assert len(got) == len(want) == 3      # drop_last by default
        for g, w in zip(got, want):
            _same(g, w)


def test_iter_device_batches_on_cuda_raises_without_a_card():
    ds = port_data.range(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.iter_device_batches(batch_size=4)


# --------------------------------------------------------------- runtime

RUNTIME_PROGRAM = r'''
import glob, json, os, sys, time
import numpy as np
import psutil
from importlib import import_module
rt = import_module(sys.argv[1])
rd = import_module(sys.argv[1] + ".data")
executor = import_module(sys.argv[1] + ".data.executor")


def plain(x):
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return [str(x.dtype), x.item()]
    return x

class AddConst:
    def __init__(self, c):
        self.c = c
        self.seen = 0
    def __call__(self, b):
        self.seen += 1
        return {"id": b["id"] + self.c, "pid": np.full(len(b["id"]),
                                                       os.getpid())}

def blocks(ds):
    return plain(list(ds.iter_blocks()))

rt.init(num_cpus=4)
out = {}
rng = np.random.RandomState(0)
vals = rng.randint(0, 1000, 200)
base = rd.from_numpy({"v": vals, "i": np.arange(200)}, block_rows=23)
ds = rd.range(100, block_rows=10).random_shuffle(seed=0)
out["random_shuffle"] = blocks(ds)
out["random_shuffle_stats"] = ds.stats_object().exchange["random_shuffle"]
out["sort"] = blocks(base.sort("v"))
out["sort_desc"] = blocks(base.sort("v", descending=True))
out["repartition"] = blocks(rd.range(103, block_rows=10).repartition(4))
g = rd.from_items([{"k": i % 5, "v": float(i)} for i in range(60)],
                  block_rows=7).groupby("k")
out["groupby"] = [plain(g.count().take_all()), plain(g.mean("v").take_all()),
                  plain(g.std("v").take_all())]
out["map_groups"] = blocks(rd.from_items(
    [{"k": i % 4, "v": i} for i in range(40)], block_rows=6)
    .groupby("k").map_groups(lambda b: {"k": b["k"][:1],
                                        "t": np.asarray([b["v"].sum()])}))
pooled = list(rd.range(40, block_rows=5).map_batches(
    AddConst, fn_constructor_args=(3,)).iter_blocks())
out["actor_pool"] = plain([{"id": b["id"]} for b in pooled])
pids = sorted({int(p) for b in pooled for p in b["pid"]})
out["actor_pool_processes"] = len(pids)
out["actor_pool_not_driver"] = os.getpid() not in pids
executor.MAX_IN_FLIGHT_BYTES = 3 * 80
mapped = rd.range(200, block_rows=10).map_batches(
    lambda b: {"id": b["id"] * 2})
out["task_map"] = blocks(mapped)
bp = mapped.stats_object().backpressure
out["backpressure"] = {k: [v["budget_bytes"], v["peak_inflight_bytes"]]
                       for k, v in bp.items()}
out["random_sample"] = plain(rd.range(300, block_rows=20)
                             .random_sample(0.3, seed=7).take_all())
shuffled = rd.range(50, block_rows=8).random_shuffle(seed=4)
out["streaming_split"] = [plain(s.take_all())
                          for s in shuffled.streaming_split(3)]
out["split_for_worker"] = [plain(shuffled.split_for_worker(r, 2).take_all())
                           for r in range(2)]

rt.shutdown()
me = psutil.Process()
deadline = time.time() + 30
while time.time() < deadline:
    kids = [p for p in me.children(recursive=True)
            if "core.worker" in " ".join(p.cmdline())]
    if not kids:
        break
    time.sleep(0.2)
print("RESULT " + json.dumps({"out": out, "workers_left": len(kids)}))
'''


def _run(program, *modules):
    """Run `program` once under each package, the processes side by
    side; their RESULT objects, in order."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", program, m], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for m in modules]
    out = []
    try:
        for module, proc in zip(modules, procs):
            stdout, stderr = proc.communicate(timeout=300)
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("RESULT ")]
            assert proc.returncode == 0 and lines, (
                f"{module} run failed (rc {proc.returncode}):\n"
                f"{stdout[-3000:]}\n{stderr[-3000:]}")
            out.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for proc in procs:   # a failed or timed-out run
            if proc.poll() is None:
                proc.kill()
    return out


@pytest.fixture(scope="module")
def runs():
    return _run(RUNTIME_PROGRAM, "ray_tpu", "ray_tpu_torch")


RUNTIME_KEYS = ["random_shuffle", "random_shuffle_stats", "sort",
                "sort_desc", "repartition", "groupby", "map_groups",
                "actor_pool", "actor_pool_processes",
                "actor_pool_not_driver", "task_map", "backpressure",
                "random_sample", "streaming_split", "split_for_worker"]


@pytest.mark.parametrize("key", RUNTIME_KEYS)
def test_same_program_under_both_runtimes(runs, key):
    ref, port = runs
    assert port["out"][key] == ref["out"][key]


def _local(program):
    """The port's answer with no runtime (the local exchange)."""
    return json.loads(json.dumps(program(port_data)))


def test_distributed_exchange_equals_the_local_one(runs):
    _, port = runs
    out = port["out"]
    rng = np.random.RandomState(0)
    vals = rng.randint(0, 1000, 200)
    base = port_data.from_numpy({"v": vals, "i": np.arange(200)},
                                block_rows=23)
    assert out["random_shuffle"] == _local(lambda rd: plain(list(
        rd.range(100, block_rows=10).random_shuffle(seed=0).iter_blocks())))
    assert out["sort"] == _local(lambda rd: plain(list(
        base.sort("v").iter_blocks())))
    assert out["sort_desc"] == _local(lambda rd: plain(list(
        base.sort("v", descending=True).iter_blocks())))
    assert out["repartition"] == _local(lambda rd: plain(list(
        rd.range(103, block_rows=10).repartition(4).iter_blocks())))
    assert out["random_sample"] == _local(lambda rd: plain(
        rd.range(300, block_rows=20).random_sample(0.3, seed=7).take_all()))
    shuffled = port_data.range(50, block_rows=8).random_shuffle(seed=4)
    assert out["streaming_split"] == json.loads(json.dumps(
        [plain(s.take_all()) for s in shuffled.streaming_split(3)]))


def test_runtime_paths_ran_distributed_and_left_nothing(runs):
    _, port = runs
    out = port["out"]
    # ten map tasks and ten reduce tasks; every piece moved store to
    # store, none through the driver
    stats = out["random_shuffle_stats"]
    assert (stats["map_tasks"], stats["reduce_tasks"],
            stats["relay_bytes"]) == (10, 10, 0)
    # the actor pool's two actors ran every block, in other processes
    assert out["actor_pool_processes"] == 2
    assert out["actor_pool_not_driver"] is True
    # a 240-byte budget holds three 80-byte blocks in flight at most
    (budget, peak), = out["backpressure"].values()
    assert budget == 240 and 80 <= peak <= 240
    assert port["workers_left"] == 0
