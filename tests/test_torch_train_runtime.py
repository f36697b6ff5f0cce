"""Training over the port's runtime, on the CPU (counterpart of
tests/test_train.py, test_multihost_spmd.py and test_train_ft.py):

* TorchTrainer against JaxTrainer: one rank actor runs the port's
  make_train_step on a 2-layer Llama whose weights are the JAX params
  (models/convert.py); the JAX run (its own runtime, in a subprocess)
  takes the same batches through the JAX step. Losses to rtol 1e-4, the
  tolerance tests/test_torch_train.py states for adamw.
* FailureConfig(max_failures=1): a rank that exits before step 4
  restarts from the step-3 checkpoint and finishes; two rank actors
  join one gloo process group before their loop runs.
* MultiHostSpmd: a gloo world of 2 rank actors all-reduces; run_sharded
  hands each rank its own shard.
* ElasticSpmdTrainer: a rank of a 2-rank gloo gang is killed mid-fit;
  the gang reforms at full size, restores the last committed checkpoint,
  and each step's loss after the resume equals an uninterrupted run's
  (the same fit in one process; rtol 1e-4: dp 2 against one device sums
  in another order).
"""
import functools
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.models import Llama, LlamaConfig, llama_params_from_flax
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import (CheckpointManager, ElasticSpmdTrainer,
                                 FailureConfig, MultiHostSpmd, RunConfig,
                                 ScalingConfig, SpmdTrainer,
                                 SpmdTrainerConfig, TorchTrainer)
from ray_tpu_torch.train import _testing
from ray_tpu_torch.train.checkpoint import is_committed
from ray_tpu_torch.util import state as state_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=64)
STEPS = 6
LR = 1e-2

JAX_RUN = r'''
import json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
import ray_tpu
from ray_tpu.models import Llama, LlamaConfig
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import (JaxTrainer, ScalingConfig, RunConfig,
                           make_optimizer, make_train_step, report)

WIDTHS, STEPS, LR, OUT = json.loads(sys.argv[1])

def batches():
    return [{"tokens": np.random.RandomState(10 + i).randint(
        0, WIDTHS["vocab_size"], (4, 17)).astype(np.int32)}
        for i in range(STEPS)]

def loop(config):
    jm = Llama(LlamaConfig(**WIDTHS, dtype=jnp.float32))
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    init = make_train_step(jm, make_optimizer("adamw", learning_rate=LR),
                           mesh, donate_state=False)
    bs = batches()
    state, step = init(jax.random.PRNGKey(0), bs[0])
    with open(OUT, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, state.params), f)
    for b in bs:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        report({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})

ray_tpu.init(num_cpus=2)
res = JaxTrainer(loop, scaling_config=ScalingConfig(use_tpu=False),
                 run_config=RunConfig(name="jax", storage_path=OUT + ".d")
                 ).fit()
ray_tpu.shutdown()
print("RESULT " + json.dumps([m["loss"] for m in res.metrics_history]))
'''


@pytest.fixture(scope="module")
def cluster():
    handle = rt.init(num_cpus=4)
    yield handle
    rt.shutdown()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JaxTrainer's per-step losses and its initial params, from the
    reference runtime in a process of its own."""
    out = str(tmp_path_factory.mktemp("jax") / "params.pkl")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN, json.dumps([WIDTHS, STEPS, LR, out])],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stderr[-3000:]
    with open(out, "rb") as f:
        params = pickle.load(f)
    return json.loads(lines[-1][len("RESULT "):]), params


def _loop_config(params, run_config, steps, **extra):
    batches = [{"tokens": np.random.RandomState(10 + i).randint(
        0, WIDTHS["vocab_size"], (4, 17)).astype(np.int32)}
        for i in range(steps)]
    return dict(widths=WIDTHS, state_dict=llama_params_from_flax(params),
                optimizer="adamw", lr=LR, batches=batches,
                ckpt_root=os.path.join(run_config.run_dir(), "checkpoints"),
                **extra)


def test_torch_trainer_matches_jax_trainer(cluster, jax_run, tmp_path):
    want, params = jax_run
    run_config = RunConfig(name="t3", storage_path=str(tmp_path))
    res = TorchTrainer(
        _testing.llama_loop,
        train_loop_config=_loop_config(params, run_config, 3),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=run_config).fit()
    assert res.error is None
    assert [m["step"] for m in res.metrics_history] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for m in res.metrics_history],
                               want[:3], rtol=1e-4)
    assert res.checkpoint.metadata()["step"] == 3


def test_failure_config_restarts_from_the_last_checkpoint(cluster, jax_run,
                                                          tmp_path):
    want, params = jax_run
    run_config = RunConfig(name="crash", storage_path=str(tmp_path),
                           failure_config=FailureConfig(max_failures=1))
    cfg = _loop_config(params, run_config, STEPS, crash_at=4,
                       crash_marker=str(tmp_path / "crashed"))
    res = TorchTrainer(_testing.llama_loop, train_loop_config=cfg,
                       scaling_config=ScalingConfig(use_gpu=False),
                       run_config=run_config).fit()
    assert os.path.exists(cfg["crash_marker"])      # the first run died
    assert res.error is None
    # steps 1-3 ran once, then the restart resumed at step 4
    assert [m["step"] for m in res.metrics_history] == list(range(1, 7))
    np.testing.assert_allclose([m["loss"] for m in res.metrics_history],
                               want, rtol=1e-4)
    assert res.checkpoint.metadata()["step"] == STEPS


def test_torch_trainer_joins_its_ranks_into_one_group(cluster, tmp_path):
    """Two rank actors: a gloo process group of 2 before the loop runs."""
    res = TorchTrainer(
        _testing.allreduce_loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="world2", storage_path=str(tmp_path))).fit()
    assert res.error is None
    got = sorted((m["rank"], m["world"], m["group"], m["sum"])
                 for m in res.metrics_history)
    assert got == [(0, 2, 2, 3.0), (1, 2, 2, 3.0)]


def test_multihost_gloo_world(cluster):
    gang = MultiHostSpmd(2, resources_per_host={"CPU": 1})
    try:
        assert gang.world_size == 2 and gang.world_devices == 2
        out = gang.run(_testing.allreduce_rank)
        assert [o["sum"] for o in out] == [3.0, 3.0]
        assert [(o["rank"], o["world"], o["backend"]) for o in out] == [
            (0, 2, "gloo"), (1, 2, "gloo")]
        shards = [np.full((20_000,), float(r + 1)) for r in range(2)]
        assert gang.run_sharded(_testing.shard_sum, shards) == [
            20_000.0, 40_000.0]
        with pytest.raises(ValueError, match="one shard per rank"):
            gang.run_sharded(_testing.shard_sum, shards[:1])
    finally:
        gang.shutdown()


def _rank_pids():
    """{actor_id: worker pid} of the ALIVE _SpmdHost ranks."""
    rows = state_api.list_actors(
        filters=[("class_name", "=", "_SpmdHost"), ("state", "=", "ALIVE")],
        limit=100)
    by_wid = {w["worker_id"]: w["pid"]
              for w in state_api.list_workers(limit=1000)}
    return {r["actor_id"]: by_wid[r["worker_id"]] for r in rows
            if r["worker_id"] in by_wid}


def _wait_commit(root, step, box, timeout=120.0):
    deadline = time.time() + timeout
    name = f"checkpoint_{step:09d}"
    while time.time() < deadline:
        if "err" in box:
            raise box["err"]
        if is_committed(os.path.join(root, name)):
            return
        time.sleep(0.05)
    raise AssertionError(f"{name} was never committed")


def _debug_model():
    return Llama(LlamaConfig.debug(dtype=torch.float32,
                                   param_dtype=torch.float32),
                 device="cpu", seed=0)


def test_elastic_rank_kill_reforms_and_restores(cluster, tmp_path):
    total, every = 8, 2
    data = functools.partial(_testing.debug_batches, delay_s=0.3)

    def config():
        return SpmdTrainerConfig(model=_debug_model(), mesh=MeshSpec(dp=2),
                                 optimizer="adamw", learning_rate=1e-3,
                                 warmup_steps=1, total_steps=total,
                                 log_every=1, checkpoint_every=every,
                                 device="cpu")

    run_config = RunConfig(name="elastic", storage_path=str(tmp_path))
    trace = str(tmp_path / "trace")
    tr = ElasticSpmdTrainer(config(), data, num_hosts=2,
                            resources_per_host={"CPU": 1},
                            env_per_host={"RAY_TPU_ELASTIC_TRACE": trace},
                            run_config=run_config)
    box = {}

    def run():
        try:
            box["res"] = tr.fit()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    _wait_commit(os.path.join(run_config.run_dir(), "checkpoints"),
                 2 * every, box)
    pids = _rank_pids()
    assert len(pids) == 2
    os.kill(sorted(pids.values())[-1], signal.SIGKILL)
    th.join(240)
    assert not th.is_alive(), "elastic fit never finished after the kill"
    assert "err" not in box, box.get("err")
    res = box["res"]
    assert res.config["failures"] == 1
    assert res.config["final_world"] == 2           # replaced, not resharded
    assert res.config["generations"] == 1
    hist = res.metrics_history
    first = hist[0]["step"]
    assert first - 1 >= 2 * every and (first - 1) % every == 0
    assert [m["step"] for m in hist] == list(range(first, total + 1))
    assert all(m["generation"] == 1 and m["world"] == 2 for m in hist)
    assert CheckpointManager(os.path.join(
        run_config.run_dir(), "checkpoints")).latest().metadata()[
        "step"] == total
    # the uninterrupted run: the same fit in this process, one device
    ref = SpmdTrainer(config(), data, run_config=RunConfig(
        name="plain", storage_path=str(tmp_path))).fit()
    want = {m["step"]: m["loss"] for m in ref.metrics_history}
    np.testing.assert_allclose([m["loss"] for m in hist],
                               [want[m["step"]] for m in hist], rtol=1e-4)
    # the event chain on the driver
    cluster.drain_local_events()
    types = [r["type"] for r in cluster.cluster_events.query(
        types=["train.gang.rank_death", "train.gang.reform",
               "train.restore"], limit=200)[0]]
    assert {"train.gang.rank_death", "train.gang.reform",
            "train.restore"} <= set(types)
    # RAY_TPU_ELASTIC_TRACE: each rank's <path>.r<rank> holds, for each
    # generation, its enter line, then init, the logged steps and, for
    # the generation that finished, done
    for rank in (0, 1):
        lines = [ln.split(" ", 2) for ln in
                 open(f"{trace}.r{rank}").read().splitlines()]
        assert all(float(t) > 0 for t, _, _ in lines)
        by_gen = {}
        for _, gen, msg in lines:
            by_gen.setdefault(gen, []).append(msg)
        assert sorted(by_gen) == ["g0", "g1"]
        for gen, msgs in by_gen.items():
            assert msgs[0].startswith("enter world=2 pid="), msgs
            assert msgs[1] == "init start"
        assert by_gen["g1"][2:] == [f"step {i}" for i in range(
            first - 1, total)] + ["done"]
        assert "done" not in by_gen["g0"]
