"""Training from a Dataset in the port (ray_tpu_torch.train.utils
.prepare_loader, train.adapters.tokenize_dataset / hf_dataset_to_ray, and
TorchTrainer(datasets=)) against the reference's:

* prepare_loader(device="cpu") gives each rank the reference's batches
  (the reference's arrays through np.asarray), int64 narrowed to int32
  as the reference's device put does;
* TorchTrainer on 2 CPU ranks hands each rank the rows JaxTrainer hands
  it, both as the dataset shard the trainer splits and through
  prepare_loader inside the loop (one program under each package, each
  in a subprocess of its own); and a shuffled Dataset, whose exchange
  runs in the rank actor (the shard re-streams its parent there), gives
  each rank the reference's split_for_worker rows. The reference's rank
  cannot run that exchange (its worker has no `free`), and in the port
  it needs the worker's `free` and the re-queue of a reclaimed lease
  slot of a task a worker submitted;
* tokenize_dataset with a plain callable and with an object that has
  `encode` gives the same ids and mask; hf_dataset_to_ray takes any
  object with `column_names` that iterates over row dicts, nothing
  downloaded.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu import data as ref_data
from ray_tpu.train import adapters as ref_adapters
from ray_tpu.train.utils import prepare_loader as ref_prepare_loader
from ray_tpu_torch import data as port_data
from ray_tpu_torch.train import adapters as port_adapters
from ray_tpu_torch.train.utils import prepare_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pipeline(rd):
    return (rd.range(64, block_rows=6).random_shuffle(seed=1)
            .map_batches(lambda b: {"id": b["id"],
                                    "x": b["id"].astype(np.float64) / 3}))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_prepare_loader_gives_the_reference_batches(world):
    for rank in range(world):
        want = [{k: np.asarray(v) for k, v in b.items()}
                for b in ref_prepare_loader(_pipeline(ref_data), rank=rank,
                                            world_size=world, batch_size=5)]
        got = list(prepare_loader(_pipeline(port_data), rank=rank,
                                  world_size=world, batch_size=5,
                                  device="cpu"))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert isinstance(g[k], torch.Tensor)
                assert g[k].numpy().dtype == w[k].dtype
                np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_prepare_loader_on_cuda_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_loader(_pipeline(port_data), rank=0, world_size=1,
                       batch_size=4)


class _Encoder:
    def encode(self, s):
        return [ord(c) for c in s]


@pytest.mark.parametrize("tokenizer", ["callable", "encode"])
def test_tokenize_dataset_matches_the_reference(tokenizer):
    tok = (_Encoder() if tokenizer == "encode"
           else (lambda s: [ord(c) - 90 for c in s]))
    items = [{"text": t} for t in ("ab", "abcd", "", "abcdefghij", "xyz")]
    out = []
    for rd, ad in ((ref_data, ref_adapters), (port_data, port_adapters)):
        ds = ad.tokenize_dataset(rd.from_items(items, block_rows=2), tok,
                                 max_length=6, pad_id=3)
        out.append([{k: [str(v.dtype), v.tolist()] for k, v in b.items()}
                    for b in ds.iter_blocks()])
    assert out[1] == out[0]
    first = out[1][0]
    assert first["input_ids"][0] == "int32"
    assert first["attention_mask"][0] == "int8"
    assert [sum(m) for m in first["attention_mask"][1]] == [2, 4]


class _HFStandIn:
    """What hf_dataset_to_ray reads of a `datasets.Dataset`."""

    column_names = ["text", "label", "extra"]

    def __iter__(self):
        for i in range(7):
            yield {"text": f"row {i}", "label": i % 3, "extra": [i, i]}


@pytest.mark.parametrize("columns", [None, ["label", "text"]])
def test_hf_dataset_to_ray_matches_the_reference(columns):
    got = [ad.hf_dataset_to_ray(_HFStandIn(), columns=columns).take_all()
           for ad in (ref_adapters, port_adapters)]
    norm = [[{k: np.asarray(v).tolist() for k, v in r.items()} for r in rows]
            for rows in got]
    assert norm[1] == norm[0] and len(norm[1]) == 7
    assert sorted(norm[1][0]) == sorted(columns or _HFStandIn.column_names)


PROGRAM = r'''
import json, sys, tempfile
import numpy as np
from importlib import import_module
pkg = sys.argv[1]
rt = import_module(pkg)
rd = import_module(pkg + ".data")
train = import_module(pkg + ".train")
prepare_loader = import_module(pkg + ".train.utils").prepare_loader


def loop(config):
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    out = {"rank": rank}
    for name, ds in config["datasets"].items():
        kw = {"device": "cpu"} if pkg == "ray_tpu_torch" else {}
        batches = [np.asarray(b["id"]) for b in prepare_loader(
            config["full"][name], rank=rank, world_size=world,
            batch_size=4, **kw)]
        out[name] = [[int(r["id"]) for r in ds.iter_rows()],
                     [b.tolist() for b in batches], str(batches[0].dtype)]
    train.report(out)


rt.init(num_cpus=4)
datasets = {"plain": rd.range(40, block_rows=5).map_batches(
    lambda b: {"id": b["id"] * 2})}
if pkg == "ray_tpu_torch":
    # the reference's worker has no free(), so its exchange fails in a
    # rank; the port's runs there
    datasets["shuffled"] = datasets["plain"].random_shuffle(seed=3)
    Trainer, scaling = train.TorchTrainer, train.ScalingConfig(
        num_workers=2, use_gpu=False)
else:
    Trainer, scaling = train.JaxTrainer, train.ScalingConfig(
        num_workers=2, use_tpu=False)
res = Trainer(loop, train_loop_config={"full": datasets}, datasets=datasets,
              scaling_config=scaling,
              run_config=train.RunConfig(name="rows",
                                         storage_path=tempfile.mkdtemp())
              ).fit()
rt.shutdown()
assert res.error is None, res.error
print("RESULT " + json.dumps(sorted(res.metrics_history,
                                    key=lambda m: m["rank"])))
'''


@pytest.fixture(scope="module")
def trainer_runs():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", PROGRAM, m], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for m in ("ray_tpu", "ray_tpu_torch")]
    out = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("RESULT ")]
            assert proc.returncode == 0 and lines, (
                f"rc {proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
            out.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for proc in procs:   # a failed or timed-out run
            if proc.poll() is None:
                proc.kill()
    return out


def test_trainer_ranks_get_the_reference_rows(trainer_runs):
    ref, port = trainer_runs
    assert [m["rank"] for m in port] == [0, 1]
    for r in range(2):
        # the shard the trainer split, and prepare_loader's batches of it
        assert port[r]["plain"] == ref[r]["plain"]
        shard, batches, dtype = port[r]["plain"]
        assert sum(batches, []) == shard and dtype == "int32"
    assert sorted(port[0]["plain"][0] + port[1]["plain"][0]) == list(
        range(0, 80, 2))


def test_trainer_ranks_read_a_shuffled_dataset(trainer_runs):
    """The shard re-streams the parent in the rank, so the exchange runs
    there (tasks fanned out from the rank actor): each rank's rows are
    the reference's split_for_worker rows of the same pipeline."""
    _, port = trainer_runs
    ds = (ref_data.range(40, block_rows=5)
          .map_batches(lambda b: {"id": b["id"] * 2})
          .random_shuffle(seed=3))
    for r in range(2):
        want = [int(x["id"]) for x in ds.split_for_worker(r, 2).iter_rows()]
        shard, batches, dtype = port[r]["shuffled"]
        assert shard == want and sum(batches, []) == want
    assert port[0]["shuffled"][0] + port[1]["shuffled"][0] != sorted(
        port[0]["shuffled"][0] + port[1]["shuffled"][0])
