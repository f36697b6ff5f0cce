"""The port's Tune (ray_tpu_torch.tune) against the reference's
(ray_tpu.tune):

* the schedulers (FIFO, ASHA, MedianStopping, HyperBand, PBT) fed the
  same metric sequences make the same decisions, PBT the same config
  swaps;
* generate_variants, BasicVariantGenerator and TPESampler with one seed
  give the same configs;
* the stoppers decide alike, and the loggers write the same files;
* one Tuner program (a grid, ASHA, with_parameters, a class Trainable, a
  stop dict with the loggers) runs under each package, each in a
  subprocess of its own, with the same trial configs, statuses, metrics
  and best result;
* with_resources({"GPU": 1}) reserves num_gpus=1: on a runtime declared
  with RAY_TPU_GPUS=1, three such trials each see card [0], one at a time,
  and leave no trial actor; "TPU" and a fraction of a card raise.
"""
import json
import os
import subprocess
import sys

import pytest

from ray_tpu import tune as ref_tune
from ray_tpu.tune import search as ref_search
from ray_tpu.tune import stoppers as ref_stoppers
from ray_tpu_torch import tune as port_tune
from ray_tpu_torch.tune import search as port_search
from ray_tpu_torch.tune import stoppers as port_stoppers
from ray_tpu_torch.tune import tuner as port_tuner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _curves(n_trials, n_iters, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return {f"t{i}": np.cumsum(rng.rand(n_iters) * (i + 1)).tolist()
            for i in range(n_trials)}


def _feed(sched, curves):
    """Decisions of `sched` over the trials' curves, reported round
    robin (one iteration of every live trial at a time)."""
    out = []
    live = sorted(curves)
    n = len(next(iter(curves.values())))
    for it in range(1, n + 1):
        for t in list(live):
            d = sched.on_result(t, it, curves[t][it - 1])
            out.append([t, it, d])
            if d == "STOP":
                live.remove(t)
                sched.on_complete(t)
    return out


def s_fifo(tune):
    return _feed(tune.FIFOScheduler(), _curves(3, 5, 0))


def s_asha(tune):
    return _feed(tune.ASHAScheduler(grace_period=1, reduction_factor=2,
                                    max_t=8), _curves(6, 8, 1))


def s_asha_min(tune):
    return _feed(tune.ASHAScheduler(mode="min", grace_period=2,
                                    reduction_factor=3, max_t=9),
                 _curves(5, 9, 2))


def s_median(tune):
    return _feed(tune.MedianStoppingRule(grace_period=2, min_samples=3),
                 _curves(6, 6, 3))


def s_hyperband(tune):
    hb = tune.HyperBandScheduler(grace_period=1, reduction_factor=2,
                                 max_t=16, brackets=3)
    return [hb.bracket_grace, _feed(hb, _curves(7, 16, 4))]


def s_pbt(tune):
    pbt = tune.PopulationBasedTraining(
        perturbation_interval=2, quantile=0.34, seed=5,
        hyperparam_mutations={"lr": [0.1, 0.2, 0.3], "wd": None})
    curves = _curves(5, 6, 5)
    for i, t in enumerate(sorted(curves)):
        pbt.register(t, {"lr": 0.1 * (i + 1), "wd": 0.01 * (i + 1)})
    swaps = []
    for it in range(1, 7):
        for t in sorted(curves):
            pbt.on_result(t, it, curves[t][it - 1])
            swaps.append([t, it, pbt.take_pending_config(t)])
    return swaps


SCHEDULES = {n[2:]: f for n, f in sorted(globals().items())
             if n.startswith("s_")}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_decisions_match_the_reference(name):
    ref = SCHEDULES[name](ref_tune)
    port = SCHEDULES[name](port_tune)
    assert port == ref
    if name not in ("fifo", "pbt"):
        # the cases stop someone, so the comparison has teeth
        assert "STOP" in json.dumps(port)


def _space(tune):
    return {"lr": tune.loguniform(1e-4, 1e-1), "wd": tune.uniform(0, 0.1),
            "q": tune.quniform(0, 10, 2.5), "n": tune.randint(1, 9),
            "act": tune.choice(["relu", "gelu", "silu"]),
            "bs": tune.grid_search([16, 32]), "fixed": 7}


def test_generate_variants_match_the_reference():
    for seed in (0, 3):
        ref = ref_tune.generate_variants(_space(ref_tune), 3, seed)
        port = port_tune.generate_variants(_space(port_tune), 3, seed)
        assert port == ref and len(port) == 6


def test_basic_variant_generator_matches_the_reference():
    out = []
    for tune, search in ((ref_tune, ref_search), (port_tune, port_search)):
        g = search.BasicVariantGenerator(seed=2)
        g.set_search_properties("score", "max", _space(tune))
        out.append([g.suggest(f"t{i}") for i in range(5)])
    assert out[1] == out[0]


def test_tpe_sampler_matches_the_reference():
    """20 suggestions, the first 8 random, each scored by a fixed bowl
    and reported back before the next: the same configs."""
    out = []
    for tune in (ref_tune, port_tune):
        s = tune.TPESampler(n_startup=8, seed=1)
        s.set_search_properties("score", "max", {
            "x": tune.uniform(0.0, 1.0), "lr": tune.loguniform(1e-4, 1e-1),
            "act": tune.choice(["a", "b", "c"])})
        got = []
        for i in range(20):
            cfg = s.suggest(f"t{i}")
            got.append(cfg)
            s.on_trial_complete(f"t{i}", {"score": -(cfg["x"] - 0.7) ** 2})
        out.append(got)
    assert out[1] == out[0]


def _stop_run(stoppers):
    out = []
    s = stoppers.MaximumIterationStopper(3)
    out.append([s("t", {}) for _ in range(4)])
    p = stoppers.TrialPlateauStopper("loss", std=0.01, num_results=3,
                                     grace_period=3)
    out.append([p("t", {"loss": v}) for v in (5.0, 4.0, 3.0, 3.0, 3.001)])
    e = stoppers.ExperimentPlateauStopper("score", mode="max", patience=2,
                                          top=2)
    out.append([[e(f"t{i % 3}", {"score": v}), e.stop_all()]
                for i, v in enumerate([1, 5, 3, 5, 4, 2, 1, 0, 1])])
    c = stoppers.CombinedStopper(stoppers.MaximumIterationStopper(2),
                                 stoppers.TimeoutStopper(1e9))
    out.append([c("t", {"x": 1}), c("t", {"x": 1}), c.stop_all()])
    f = stoppers.FunctionStopper(lambda tid, r: r["x"] > 2)
    out.append([f("t", {"x": x}) for x in (1, 3)])
    m = stoppers.make_stopper({"training_iteration": 5, "loss": 0.5})
    out.append([m("t", {"training_iteration": 4, "loss": 1.0}),
                m("t", {"training_iteration": 5}),
                m("t", {"loss": 0.4})])
    out.append(stoppers.make_stopper(None))
    return out


def test_stoppers_match_the_reference():
    assert _stop_run(port_stoppers) == _stop_run(ref_stoppers)


def test_loggers_write_the_reference_files(tmp_path):
    files = []
    for tune in (ref_tune, port_tune):
        d = tmp_path / tune.__name__
        cbs = [tune.CSVLoggerCallback(str(d)), tune.JsonLoggerCallback(str(d))]
        for cb in cbs:
            cb.on_trial_start("t0", {"lr": 0.1})
            cb.on_trial_result("t0", {"score": 1, "it": 1})
            cb.on_trial_result("t0", {"score": 2, "it": 2, "extra": "x",
                                      "skip": [1]})
            cb.on_trial_complete("t0")
            cb.on_experiment_end([])
        files.append({f: (d / "t0" / f).read_text()
                      for f in sorted(os.listdir(d / "t0"))})
    assert files[1] == files[0]
    assert sorted(files[1]) == ["params.json", "progress.csv", "result.json"]


def test_with_resources_maps_gpu_and_refuses_tpu_and_fractions():
    def f(config):
        pass

    g = port_tune.with_resources(f, {"CPU": 2, "GPU": 1})
    assert g._tune_resources == {"CPU": 2, "GPU": 1}
    wrapped = port_tune.with_parameters(g)   # no runtime: nothing to put
    assert wrapped._tune_resources == {"CPU": 2, "GPU": 1}
    opts = port_tune.Tuner(g)._trial_actor_options()
    assert opts == {"num_cpus": 2, "num_gpus": 1}
    assert port_tune.Tuner(lambda c: None)._trial_actor_options() == {
        "num_cpus": 1}
    with pytest.raises(ValueError, match='"GPU"'):
        port_tune.with_resources(f, {"TPU": 1})
    # a share of one card is a request Ray takes (two 0.5 trials run on
    # one card: tests/test_torch_fractional_gpus.py); 1.5 names neither
    # a share nor whole cards
    half = port_tune.with_resources(lambda c: None, {"CPU": 1, "GPU": 0.5})
    assert port_tune.Tuner(half)._trial_actor_options() == {
        "num_cpus": 1, "num_gpus": 0.5}
    with pytest.raises(ValueError, match="whole number"):
        port_tune.with_resources(f, {"GPU": 1.5})
    assert port_tuner.Tuner(port_tune.with_resources(
        f, {"CPU": 1, "custom": 2}))._trial_actor_options() == {
            "num_cpus": 1, "resources": {"custom": 2}}


TUNER_PROGRAM = r'''
import json, os, sys, tempfile
import numpy as np
from importlib import import_module
pkg = sys.argv[1]
rt = import_module(pkg)
tune = import_module(pkg + ".tune")
RunConfig = import_module(pkg + ".train.config").RunConfig
rt.init(num_cpus=4)
root = tempfile.mkdtemp()
out = {}


def trials(grid):
    return [[t.config, t.status, t.iteration, t.last_metrics]
            for t in grid.trials]


def best(grid):
    b = grid.get_best_result()
    return [b.metrics, b.config, len(b.metrics_history)]


def objective(config):
    score = 0.0
    for i in range(5):
        score += config["lr"] * 10
        tune.report({"score": score, "step": i})


grid = tune.Tuner(objective, param_space={
    "lr": tune.grid_search([0.1, 0.5, 1.0])},
    tune_config=tune.TuneConfig(metric="score", mode="max",
                                max_concurrent_trials=3),
    run_config=RunConfig(name="grid", storage_path=root)).fit()
out["grid"] = [trials(grid), best(grid), len(grid),
               sorted(grid.dataframe().columns)]


def objective_long(config):
    for i in range(1, 11):
        tune.report({"score": config["lr"] * i})


grid = tune.Tuner(objective_long, param_space={
    "lr": tune.grid_search([1.0, 0.01])},
    tune_config=tune.TuneConfig(
        metric="score", mode="max", max_concurrent_trials=1,
        scheduler=tune.ASHAScheduler(grace_period=2, reduction_factor=2,
                                     max_t=100)),
    run_config=RunConfig(name="asha", storage_path=root)).fit()
out["asha"] = [trials(grid), best(grid)]

big = np.arange(5000)


def train_fn(config, data=None):
    tune.report({"total": float(data.sum()) + config["x"]})


grid = tune.Tuner(tune.with_parameters(train_fn, data=big),
                  param_space={"x": tune.grid_search([1.0, 2.0])},
                  tune_config=tune.TuneConfig(metric="total", mode="max"),
                  run_config=RunConfig(name="params",
                                       storage_path=root)).fit()
out["with_parameters"] = [trials(grid), best(grid)]


class MyTrainable(tune.Trainable):
    def setup(self, config):
        self.x = config["start"]

    def step(self):
        self.x += 1
        return {"score": self.x, "done": self.x >= self.config["until"]}


grid = tune.Tuner(MyTrainable, param_space={
    "start": tune.grid_search([0, 10]), "until": 13},
    tune_config=tune.TuneConfig(metric="score", mode="max"),
    run_config=RunConfig(name="cls", storage_path=root)).fit()
out["class_trainable"] = [trials(grid), best(grid)]


def endless(config):
    for i in range(100):
        tune.report({"score": i * config["lr"], "training_iteration": i + 1})


grid = tune.Tuner(endless, param_space={"lr": tune.choice([0.1, 0.2])},
                  tune_config=tune.TuneConfig(metric="score", mode="max",
                                              num_samples=2, seed=4),
                  run_config=RunConfig(name="stop", storage_path=root,
                                       stop={"training_iteration": 5})
                  ).fit()
d = os.path.join(root, "stop", grid.trials[0].trial_id)
with open(os.path.join(d, "progress.csv")) as f:
    csv_text = f.read()
with open(os.path.join(root, "stop", "experiment_state.json")) as f:
    state = json.load(f)
out["stop_and_loggers"] = [trials(grid), best(grid), sorted(os.listdir(d)),
                           csv_text, [[s["config"], s["status"],
                                       s["iterations"]] for s in state]]
rt.shutdown()
print("RESULT " + json.dumps(out))
'''


def _run(program, *runs):
    """Run `program` once per (module, extra environment) in `runs` (a
    run of three names its own program first), the processes side by
    side; their RESULT objects, in order."""
    procs = []
    runs = [r if len(r) == 3 else (program, *r) for r in runs]
    for prog, module, extra in runs:
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", prog, module], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for (_, module, _), proc in zip(runs, procs):
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
def tuner_runs():
    """The Tuner program under each package, and the GPU program on the
    port's runtime declared with one card, all three side by side."""
    return _run(TUNER_PROGRAM, ("ray_tpu", {}), ("ray_tpu_torch", {}),
                (GPU_PROGRAM, "ray_tpu_torch", {"RAY_TPU_GPUS": "1"}))


@pytest.mark.parametrize("case", ["grid", "asha", "with_parameters",
                                  "class_trainable", "stop_and_loggers"])
def test_tuner_program_matches_the_reference(tuner_runs, case):
    ref, port, _ = tuner_runs
    assert port[case] == ref[case]


def test_tuner_outcomes(tuner_runs):
    _, port, _ = tuner_runs
    assert port["grid"][1][1] == {"lr": 1.0}
    assert port["grid"][1][0]["score"] == pytest.approx(50.0)
    statuses = {t[0]["lr"]: t[1] for t in port["asha"][0]}
    assert statuses[1.0] == "TERMINATED" and statuses[0.01] == "STOPPED"
    assert port["with_parameters"][1][0]["total"] == 5000 * 4999 / 2 + 2
    assert port["class_trainable"][1][0]["score"] == 13
    assert [t[2] for t in port["stop_and_loggers"][0]] == [5, 5]


GPU_PROGRAM = r'''
import json, os, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.util import state


def trial(config):
    t0 = time.time()
    time.sleep(0.5)
    tune.report({"score": config["x"], "gpus": rt.get_gpu_ids(),
                 "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "start": t0, "end": time.time(), "pid": os.getpid()})


rt.init(num_cpus=4)
grid = tune.Tuner(tune.with_resources(trial, {"CPU": 1, "GPU": 1}),
                  param_space={"x": tune.grid_search([1, 2, 3])},
                  tune_config=tune.TuneConfig(metric="score", mode="max"),
                  ).fit()
left = [a for a in state.list_actors(filters=[("state", "=", "ALIVE")],
                                     limit=100)
        if a["class_name"] == "_TrialActor"]
out = {"trials": [[t.status, t.last_metrics] for t in grid.trials],
       "best": grid.get_best_result().metrics["score"],
       "cluster_gpus": rt.cluster_resources().get("GPU"),
       "left": len(left)}
rt.shutdown()
print("RESULT " + json.dumps(out))
'''


def test_gpu_trials_take_the_card_one_at_a_time(tuner_runs):
    got = tuner_runs[2]
    assert got["cluster_gpus"] == 1
    metrics = [m for _, m in got["trials"]]
    assert [s for s, _ in got["trials"]] == ["TERMINATED"] * 3
    assert all(m["gpus"] == [0] and m["visible"] == "0" for m in metrics)
    spans = sorted((m["start"], m["end"]) for m in metrics)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans
    # each trial ran in a fresh process, started after the last had exited
    assert len({m["pid"] for m in metrics}) == 3
    assert got["best"] == 3 and got["left"] == 0
