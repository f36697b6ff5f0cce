"""The port's SpmdTrainer against the JAX package's, on the CPU.

- One device: both trainers run 12 steps (log_every 4, warmup 2,
  checkpoints every 6) of the debug Llama in fp32 from the same params
  (the JAX init's key and example input reproduced, the params converted
  with models/convert.py and handed to the port's config as a module),
  on the same seeded batches; loss and grad_norm of every logged step
  to rtol 1e-4; then each resumes from its own last checkpoint to step
  14 and is held to the other again. (The JAX trainer takes every
  device it sees; it is shown one.)
- A mesh: the reference's tests/test_train.py smoke test (slow there)
  on one world of 4 gloo ranks at fsdp 2 x tp 2 against the JAX trainer
  on 4 of the 8 virtual devices at the same spec, the same way, then
  with optimizer adafactor (4 steps, checkpoints every 2, resumed to 6:
  its moments of a sharded parameter are whole tensors, and the resume
  must restore them so); and one mesh step fed the global batch against
  one fed this rank's LocalBatch from device_put_iterator: the same
  loss.
- Fast-forward: tests/test_train_ft.py's resume test as it is.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import SpmdTrainer as JSpmdTrainer
from ray_tpu.train import SpmdTrainerConfig as JSpmdTrainerConfig
from ray_tpu_torch.models import Llama, LlamaConfig, convert
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel import _testing
from ray_tpu_torch.parallel._testing import SeededBatches
from ray_tpu_torch.train import RunConfig, SpmdTrainer, SpmdTrainerConfig
from ray_tpu_torch.train.backend import launch

ROWS, COLS, SEED = 8, 17, 0
RUN = dict(steps=12, log_every=4, warmup=2, ckpt_every=6, resume_to=14,
           resume_log_every=1, lr=3e-4)
ADAFACTOR = dict(steps=4, log_every=1, ckpt_every=2, resume_to=6,
                 resume_log_every=1)
KEYS = ("loss", "grad_norm")


def _data():
    return SeededBatches(SEED, ROWS, COLS, JConfig.debug().vocab_size)


def _jax_params():
    """The JAX trainer's init: model.init(PRNGKey(seed), tokens[:1, :8])
    of the first batch, with partitionable threefry."""
    model = JLlama(JConfig.debug(dtype=jnp.float32))
    tokens = jnp.asarray(next(_data())["tokens"])
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        params = jax.jit(lambda r: model.init(r, tokens[:1, :8])["params"])(
            jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return {k: v.numpy() for k, v in convert.llama_params_from_flax(
        jax.tree.map(np.asarray, params)).items()}


def _jax_fit(n_devices, spec, root, run=RUN, optimizer="adamw"):
    """The JAX trainer shown `n_devices` devices: the run and its
    resume at the sizes of `run`, (history, resumed history)."""
    real = jax.devices()

    def fit(steps, name, log_every, ckpt_every, resume=None):
        cfg = JSpmdTrainerConfig(
            model=JLlama(JConfig.debug(dtype=jnp.float32)),
            mesh=JMeshSpec(**spec), optimizer=optimizer, total_steps=steps,
            log_every=log_every, warmup_steps=RUN["warmup"],
            checkpoint_every=ckpt_every, learning_rate=RUN["lr"])
        return JSpmdTrainer(cfg, _data, run_config=JRunConfig(
            name=f"{optimizer}_{name}", storage_path=root)).fit(
            resume_from=resume)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: real[:n_devices])
        res = fit(run["steps"], "fit", run["log_every"], run["ckpt_every"])
        res2 = fit(run["resume_to"], "resumed", run["resume_log_every"], 0,
                   res.checkpoint.path)
    return res.metrics_history, res2.metrics_history


def _assert_same(got, want):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"step {w['step']} {k}")


@pytest.fixture(scope="module")
def params():
    return _jax_params()


def test_trainer_matches_jax_on_one_device(params, tmp_path):
    want, want_resumed = _jax_fit(1, {}, str(tmp_path / "jax"))
    cfg = LlamaConfig.debug(dtype=torch.float32, param_dtype=torch.float32)

    def fit(steps, name, log_every, ckpt_every, resume=None):
        model = Llama(cfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
        tcfg = SpmdTrainerConfig(
            model=model, mesh=MeshSpec(), total_steps=steps,
            log_every=log_every, warmup_steps=RUN["warmup"],
            checkpoint_every=ckpt_every, learning_rate=RUN["lr"],
            device="cpu")
        return SpmdTrainer(tcfg, _data, run_config=RunConfig(
            name=name, storage_path=str(tmp_path / "port"))).fit(
            resume_from=resume)

    res = fit(RUN["steps"], "fit", RUN["log_every"], RUN["ckpt_every"])
    _assert_same(res.metrics_history, want)
    assert res.metrics["step"] == 12
    assert os.path.basename(res.checkpoint.path) == "checkpoint_000000012"
    assert res.metrics["loss"] < res.metrics_history[0]["loss"]
    res2 = fit(RUN["resume_to"], "resumed", RUN["resume_log_every"], 0,
               res.checkpoint.path)
    assert [m["step"] for m in res2.metrics_history] == [13, 14]
    _assert_same(res2.metrics_history, want_resumed)


@pytest.fixture(scope="module")
def mesh_runs(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_mesh")
    spec = dict(fsdp=2, tp=2)
    case = dict(RUN, adafactor=ADAFACTOR, spec=spec, cfg=dict(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128), params=params, seed=SEED,
        shape=(ROWS, COLS), path=str(root / "port"))
    port = {}

    def ranks():
        port["out"] = launch(_testing.run_jobs, 4, "cpu",
                             [("trainer_case", case)], timeout_s=240)[0]

    th = threading.Thread(target=ranks)
    th.start()
    want = _jax_fit(4, spec, str(root / "jax"))
    want_ada = _jax_fit(4, spec, str(root / "jax"), ADAFACTOR, "adafactor")
    th.join()
    assert "out" in port, "the 4-rank world did not return"
    return want, port["out"][0], want_ada


def test_trainer_on_a_mesh_matches_jax(mesh_runs):
    (want, want_resumed), got, _ = mesh_runs
    _assert_same(got["history"], want)
    assert got["checkpoint"] == "checkpoint_000000012"
    assert [m["step"] for m in got["resumed"]] == [13, 14]
    _assert_same(got["resumed"], want_resumed)


def test_adafactor_resumes_on_a_mesh_as_jax(mesh_runs):
    _, got, (want, want_resumed) = mesh_runs
    _assert_same(got["adafactor"], want)
    assert [m["step"] for m in got["adafactor_resumed"]] == [5, 6]
    _assert_same(got["adafactor_resumed"], want_resumed)


def test_mesh_step_takes_a_local_batch_as_its_share(mesh_runs):
    got = mesh_runs[1]
    assert got["local_rows"] == ROWS // 2       # fsdp 2: half the rows
    glob, local = got["global_vs_local"]
    assert glob == local


class _RecordingIter:
    """Deterministic batch stream with the optional fast_forward(n)
    iterator-state hook: fast_forward(n) seeks so the NEXT batch is
    batch index n."""

    def __init__(self, log):
        self.i = 0
        self.log = log

    def __iter__(self):
        return self

    def __next__(self):
        i = self.i
        self.i += 1
        self.log.append(i)
        rng = np.random.RandomState(i)
        return {"tokens": rng.randint(0, 255, (8, 16))}

    def fast_forward(self, n):
        self.log.append(("ff", n))
        self.i = n


def test_resume_fast_forwards_consumed_batches(tmp_path):
    """SpmdTrainer.fit(resume_from=...) must not re-train on batches
    the crashed run already consumed: step i trains on batch i, so a
    resume at start_step seeks the iterator there (via the
    fast_forward hook when the iterator has one)."""
    log1 = []
    cfg = SpmdTrainerConfig(model="llama-debug", mesh=MeshSpec(),
                            total_steps=4, log_every=2, warmup_steps=1,
                            checkpoint_every=2, device="cpu")
    tr = SpmdTrainer(cfg, lambda: _RecordingIter(log1),
                     run_config=RunConfig(name="ff1",
                                          storage_path=str(tmp_path)))
    res = tr.fit()
    assert res.metrics["step"] == 4

    log2 = []
    cfg2 = SpmdTrainerConfig(model="llama-debug", mesh=MeshSpec(),
                             total_steps=6, log_every=2, warmup_steps=1,
                             device="cpu")
    tr2 = SpmdTrainer(cfg2, lambda: _RecordingIter(log2),
                      run_config=RunConfig(name="ff2",
                                           storage_path=str(tmp_path)))
    res2 = tr2.fit(resume_from=res.checkpoint.path)
    assert res2.metrics["step"] == 6
    # batch 0 drawn for init, then the hook seeks to start_step=4 and
    # steps 4..5 train on batches 4 and 5 (the loader prefetches more,
    # never trained): batches 1..3 — consumed by the crashed run — are
    # NEVER re-drawn
    assert log2[0] == 0
    assert ("ff", 4) in log2
    drawn = [x for x in log2 if isinstance(x, int) and x > 0]
    assert drawn[:2] == [4, 5] and all(x >= 4 for x in drawn), log2


@pytest.mark.parametrize("spec,n", [
    (dict(dp=2, fsdp=2), 4), (dict(dp=2, fsdp=2), 2),
    (dict(dp=4, tp=2), 4), (dict(fsdp=2, tp=2), 8),
    (dict(dp=2, tp=4), 6), (dict(tp=4), 2), (dict(dp=8), 3)])
def test_reshard_mesh_spec_matches_jax(spec, n):
    """reshard_mesh_spec scales dp only, as the reference's; a world
    the other axes do not fit raises in both."""
    from ray_tpu.train.elastic import reshard_mesh_spec as j_reshard
    from ray_tpu_torch.train import reshard_mesh_spec
    try:
        want = j_reshard(JMeshSpec(**spec), n).axis_sizes()
    except ValueError:
        with pytest.raises(ValueError, match="cannot reshard"):
            reshard_mesh_spec(MeshSpec(**spec), n)
        return
    got = reshard_mesh_spec(MeshSpec(**spec), n)
    assert got.axis_sizes() == want and got.size == n
