"""Tuner: hyperparameter search over trial actors (counterpart of
ray_tpu/tune/tuner.py).

Reference parity: python/ray/tune/tuner.py + tune/execution/tune_controller
(trial lifecycle, max-concurrency, scheduler integration) + tune/tune.py.

Execution model: each trial is a function trainable running inside a
dedicated actor. `tune.report(...)` inside the trial synchronously asks the
driver-side scheduler CONTINUE/STOP (reference does this async + actor
kill; synchronous decisions make ASHA/PBT deterministic and testable, and
stopped trials unwind cooperatively via _StopTrial). PBT config swaps are
delivered in the report reply.

Deliberate differences: a trial reserves cards with `{"GPU": n}` (the
reference's `{"TPU": n}`, which raises here), a whole number of cards
or a share of one (`{"GPU": 0.5}`: two such trials run on a card at
once), and the Tuner starts no more GPU trials at once than the
cluster's cards hold. A finished GPU trial's process must have exited,
its card memory freed, before the next trial starts: the runtime hands
the card (or its share) to a queued actor as soon as the old one is
killed, before its process has let go of the memory.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core import runtime as runtime_mod
from ..train.config import RunConfig
from ..train.multihost import _wait_exited
from ..train.result import Result
from .schedulers import (CONTINUE, STOP, FIFOScheduler, TrialScheduler,
                         PopulationBasedTraining)
from .space import generate_variants

_tuner_ids = itertools.count()


def with_resources(trainable: Callable,
                   resources: Dict[str, float]) -> Callable:
    """Attach a per-trial resource request to a trainable (reference:
    python/ray/tune/trainable/util.py tune.with_resources). Keys: "CPU",
    "GPU" (a whole number of cards or a share of one), or any custom
    node resource; the Tuner reserves them for each trial's actor, so
    e.g. {"GPU": 1} trials take turns on the cards and {"GPU": 0.5}
    trials run two to a card. "TPU" raises: a GPU host has no such
    resource, and a trial that asked for it would wait forever."""
    _check_resources(resources)
    try:
        trainable._tune_resources = dict(resources)
        return trainable
    except (AttributeError, TypeError):
        def wrapped(*a, **kw):
            return trainable(*a, **kw)
        wrapped._tune_resources = dict(resources)
        return wrapped


def _check_resources(resources: Dict[str, float]) -> None:
    for key in ("TPU", "tpu"):
        if key in resources:
            raise ValueError(
                f"with_resources: {key!r} names no resource of this "
                f"runtime; ask for cards with \"GPU\"")
    gpus = resources.get("GPU", resources.get("gpu", 0))
    if gpus < 0 or (gpus >= 1 and gpus != int(gpus)):
        raise ValueError(
            f"with_resources: \"GPU\" must be a share of one card (below "
            f"1) or a whole number of cards, got {gpus!r}")


def with_parameters(trainable: Callable, **params) -> Callable:
    """Bind large constant objects to a trainable via the object store
    (reference: tune.with_parameters): the values are put() ONCE and
    each trial actor fetches them zero-copy from shm instead of
    re-pickling them into every trial's closure."""
    refs = {k: api.put(v) for k, v in params.items()}

    def wrapped(config, *a, **kw):
        fetched = {k: api.get(r) for k, r in refs.items()}
        return trainable(config, *a, **fetched, **kw)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


class TuneConfig:
    def __init__(self, *, metric: str = "score", mode: str = "max",
                 num_samples: int = 1, max_concurrent_trials: int = 4,
                 scheduler: Optional[TrialScheduler] = None,
                 search_alg: Optional[Any] = None, seed: int = 0):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_concurrent_trials = max_concurrent_trials
        self.scheduler = scheduler or FIFOScheduler()
        self.search_alg = search_alg
        self.seed = seed


class _TrialActor:
    """Hosts one trial's function trainable."""

    def __init__(self, trial_id: str, channel: str):
        self.trial_id = trial_id
        self.channel = channel

    def pid(self) -> int:
        return os.getpid()

    def run(self, fn: Callable, config: Dict[str, Any]) -> str:
        from ..core import runtime as rt_mod
        from ..tune import session as tune_session
        rt = rt_mod.get_runtime()

        def sync_report(payload):
            payload = dict(payload, trial_id=self.trial_id)
            reply = rt.report_sync(self.channel, payload, timeout=60)
            return reply

        tune_session._init_trial(self.trial_id, sync_report)
        try:
            from .trainable import Trainable
            if isinstance(fn, type) and issubclass(fn, Trainable):
                trainable = fn(config)
                try:
                    while True:
                        result = trainable.train()
                        new_cfg = tune_session.report(result)
                        if new_cfg:        # PBT exploit: adopt new hparams
                            trainable.config.update(new_cfg)
                            trainable.setup(trainable.config)
                        if result.get("done"):
                            break
                finally:
                    trainable.stop()
            else:
                fn(config)
            return "COMPLETED"
        except tune_session.StopTrial:
            return "STOPPED"
        finally:
            tune_session._clear_trial()


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.trial_id = trial_id
        self.config = config
        self.status = "PENDING"
        self.iteration = 0
        self.last_metrics: Dict[str, Any] = {}
        self.best_value: Optional[float] = None
        self.history: List[Dict[str, Any]] = []
        self.actor = None
        self.pid_ref = None
        self.done_ref = None
        self.error: Optional[str] = None


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: str, mode: str):
        self.trials = trials
        self._metric = metric
        self._mode = mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        sign = 1 if mode == "max" else -1
        best = None
        for t in self.trials:
            if metric in t.last_metrics:
                v = sign * t.last_metrics[metric]
                if best is None or v > best[0]:
                    best = (v, t)
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        t = best[1]
        return Result(metrics=dict(t.last_metrics, config=t.config),
                      checkpoint=None, metrics_history=t.history,
                      config=dict(t.config))

    def dataframe(self):
        import pandas as pd
        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status,
                   "iterations": t.iteration}
            row.update({f"config/{k}": v for k, v in t.config.items()})
            row.update(t.last_metrics)
            rows.append(row)
        return pd.DataFrame(rows)

    def __len__(self):
        return len(self.trials)

    def __getitem__(self, i):
        t = self.trials[i]
        return Result(metrics=dict(t.last_metrics, config=t.config),
                      checkpoint=None, metrics_history=t.history,
                      config=dict(t.config))


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig(name="tune_run")
        self._tid = next(_tuner_ids)
        self.channel = f"tune:{self._tid}"
        self._lock = threading.Lock()
        self._trials: Dict[str, Trial] = {}

    def fit(self) -> ResultGrid:
        if not api.is_initialized():
            api.init()
        rt = runtime_mod.get_runtime()
        tc = self.tune_config
        sched = tc.scheduler
        from .stoppers import make_stopper
        from .loggers import CSVLoggerCallback, JsonLoggerCallback
        stopper = make_stopper(getattr(self.run_config, "stop", None))
        run_dir = self.run_config.run_dir()
        callbacks = list(getattr(self.run_config, "callbacks", None) or ())
        callbacks += [CSVLoggerCallback(run_dir),
                      JsonLoggerCallback(run_dir)]
        searcher = tc.search_alg
        if searcher is not None:
            searcher.set_search_properties(tc.metric, tc.mode,
                                           self.param_space)
            variants = []          # generated lazily via suggest()
        else:
            variants = generate_variants(self.param_space, tc.num_samples,
                                         tc.seed)
        trials: List[Trial] = []
        self._stop_all = False

        def add_trial(cfg) -> Trial:
            t = Trial(f"trial_{self._tid}_{len(trials):04d}", cfg)
            trials.append(t)
            self._trials[t.trial_id] = t
            if isinstance(sched, PopulationBasedTraining):
                sched.register(t.trial_id, t.config)
            for cb in callbacks:
                try:
                    cb.on_trial_start(t.trial_id, t.config)
                except Exception:
                    traceback.print_exc()
            return t

        def on_report(worker_id, payload):
            with self._lock:
                trial = self._trials.get(payload["trial_id"])
                if trial is None:
                    return {"decision": CONTINUE}
                trial.iteration = payload.get("iteration", trial.iteration)
                metrics = payload.get("metrics", {})
                trial.last_metrics = metrics
                trial.history.append(metrics)
                for cb in callbacks:
                    try:
                        cb.on_trial_result(trial.trial_id, metrics)
                    except Exception:
                        traceback.print_exc()   # never break scheduling
                value = metrics.get(tc.metric)
                decision = CONTINUE
                if self._stop_all:
                    decision = STOP
                elif stopper is not None and (
                        stopper(trial.trial_id, metrics)
                        or stopper.stop_all()):
                    decision = STOP
                    if stopper.stop_all():
                        self._stop_all = True
                elif value is not None:
                    decision = sched.on_result(trial.trial_id,
                                               trial.iteration, float(value))
                reply = {"decision": decision}
                if isinstance(sched, PopulationBasedTraining):
                    new_cfg = sched.take_pending_config(trial.trial_id)
                    if new_cfg:
                        reply["new_config"] = new_cfg
                return reply

        rt.register_report_handler(self.channel, on_report)

        pending = list(variants)       # configs (searcher=None) only
        issued = 0
        running: List[Trial] = []
        finished: List[Trial] = []

        def next_config():
            nonlocal issued
            if self._stop_all:
                return None
            if searcher is not None:
                if issued >= tc.num_samples:
                    return None
                cfg = searcher.suggest(f"trial_{self._tid}_{issued:04d}")
                issued += 1
                return cfg
            return pending.pop(0) if pending else None

        opts = self._trial_actor_options()
        max_running = self._max_running(opts)
        while True:
            while len(running) < max_running:
                cfg = next_config()
                if cfg is None:
                    break
                t = add_trial(cfg)
                t.status = "RUNNING"
                actor_cls = api.remote(**opts)(_TrialActor)
                t.actor = actor_cls.remote(t.trial_id, self.channel)
                if opts.get("num_gpus"):
                    t.pid_ref = t.actor.pid.remote()
                t.done_ref = t.actor.run.remote(self._trainable, t.config)
                running.append(t)
            if not running:
                break
            done_refs = [t.done_ref for t in running]
            ready, _ = api.wait(done_refs, num_returns=1, timeout=300.0)
            still = []
            exiting = []
            for t in running:
                if t.done_ref in ready:
                    try:
                        outcome = api.get(t.done_ref)
                        t.status = ("TERMINATED" if outcome == "COMPLETED"
                                    else "STOPPED")
                        for cb in callbacks:
                            try:
                                cb.on_trial_complete(t.trial_id)
                            except Exception:
                                traceback.print_exc()
                    except Exception as e:  # noqa: BLE001
                        t.status = "ERROR"
                        t.error = repr(e)
                        for cb in callbacks:
                            try:
                                cb.on_trial_error(t.trial_id, t.error)
                            except Exception:
                                traceback.print_exc()
                    sched.on_complete(t.trial_id)
                    if searcher is not None:
                        searcher.on_trial_complete(t.trial_id,
                                                   t.last_metrics)
                    if t.pid_ref is not None:
                        try:
                            exiting.append(api.get(t.pid_ref, timeout=30))
                        except Exception:  # noqa: BLE001 - died early
                            pass
                    try:
                        api.kill(t.actor)
                    except Exception:
                        pass
                    finished.append(t)
                else:
                    still.append(t)
            running = still
            # a finished GPU trial's card memory is free only once its
            # process has exited: the next trial starts after that
            _wait_exited(exiting, time.monotonic() + 60)

        for cb in callbacks:
            try:
                cb.on_experiment_end(trials)
            except Exception:
                traceback.print_exc()
        self._write_experiment_state(trials)
        return ResultGrid(trials, tc.metric, tc.mode)

    def _trial_actor_options(self) -> Dict[str, Any]:
        """Per-trial resource request, from tune.with_resources(...) —
        a GPU-marked trial reserves cards so trials queue against real
        accelerator capacity instead of all racing num_cpus=1."""
        res = dict(getattr(self._trainable, "_tune_resources", None)
                   or {"CPU": 1})
        _check_resources(res)
        num_cpus = res.pop("CPU", res.pop("cpu", 1))
        num_gpus = res.pop("GPU", res.pop("gpu", 0))
        opts: Dict[str, Any] = {"num_cpus": num_cpus}
        if num_gpus:
            opts["num_gpus"] = num_gpus
        if res:
            opts["resources"] = res
        return opts

    def _max_running(self, opts: Dict[str, Any]) -> int:
        """max_concurrent_trials, cut to the trials the cluster's cards
        hold at once when a trial reserves cards."""
        n = self.tune_config.max_concurrent_trials
        gpus = opts.get("num_gpus", 0)
        if gpus:
            have = int(api.cluster_resources().get("GPU", 0))
            if have < gpus:
                raise ValueError(
                    f"each trial asks for {gpus} GPU(s); the cluster "
                    f"has {have}")
            # shares of a card do not span two cards
            n = min(n, have // int(gpus) if gpus >= 1
                    else have * int(1 / gpus + 1e-9))
        return n

    def _write_experiment_state(self, trials: List[Trial]):
        state = [{"trial_id": t.trial_id, "config": t.config,
                  "status": t.status, "iterations": t.iteration,
                  "last_metrics": t.last_metrics, "error": t.error}
                 for t in trials]
        path = os.path.join(self.run_config.run_dir(),
                            "experiment_state.json")
        with open(path, "w") as f:
            json.dump(state, f, indent=1, default=str)

    @staticmethod
    def restore(path: str) -> List[Dict[str, Any]]:
        with open(os.path.join(path, "experiment_state.json")) as f:
            return json.load(f)
