"""The port's ``Tuner`` end to end against the reference's, on the CPU.

The reference's Tuner runs on a ``ray_tpu`` cluster (``ray_start_shared``)
with its trials as actors; the port's runs each trial in a process of its
own, in a thread of this process meanwhile. Both run the same
deterministic module-level trainables (``tests/_torch_tune_apps.py``) one
trial at a time: a grid with the file tracker and the JSON and CSV
loggers, ASHA, the class API, checkpoints and ``Tuner.restore``, and a
failure retried under ``max_failures``; then ``Tuner(TorchTrainer)`` on
CPU gloo gangs against ``Tuner(JaxTrainer)``. Trials are matched by
config; their statuses, last iterations, metric histories (timing keys
left out), checkpoints and the best config must be equal.

One trial at a time is ``max_concurrent_trials=1`` over a
``ConcurrencyLimiter(BasicVariantGenerator(space), 1)`` with
``num_samples`` the grid's size, in both packages: the reference, given
``max_concurrent_trials`` alone, caps the trials at ``num_samples`` and so
cuts a grid short, where the port runs the whole grid (ROADMAP Queue C
item 14; the grid test holds both behaviours).
"""

import concurrent.futures
import csv
import glob
import json
import os

import _torch_tune_apps as apps
import ray_tpu
from ray_tpu import air as ref_air
from ray_tpu import tune as ref_tune
from ray_tpu.tune import logger as ref_logger
from ray_tpu.tune.search import basic_variant as ref_bv
from ray_tpu.tune.search import searcher as ref_searcher
from ray_tpu_torch import air as port_air
from ray_tpu_torch import tune as port_tune
from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.tune import logger as port_logger
from ray_tpu_torch.tune.search import basic_variant as port_bv
from ray_tpu_torch.tune.search import searcher as port_searcher

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

TIMING = {"time_total_s", "timestamp", "ts"}

SIDES = {
    "ref": dict(tune=ref_tune, bv=ref_bv, searcher=ref_searcher, logger=ref_logger,
                air=ref_air, run_config=ray_tpu.train.RunConfig,
                failure_config=ray_tpu.train.FailureConfig),
    "port": dict(tune=port_tune, bv=port_bv, searcher=port_searcher, logger=port_logger,
                 air=port_air, run_config=RunConfig, failure_config=FailureConfig),
}


def _both(fit_ref, fit_port):
    """The reference's fit here and the port's in a thread, at once."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(fit_port)
        ref = fit_ref()
        return ref, port.result(timeout=600)


def _one_at_a_time(side: dict, space: dict, n: int, **kwargs):
    """TuneConfig for one trial at a time over the n variants of space."""
    limiter = side["searcher"].ConcurrencyLimiter(side["bv"].BasicVariantGenerator(space), 1)
    return side["tune"].TuneConfig(search_alg=limiter, num_samples=n, max_concurrent_trials=1,
                                   **kwargs)


def _summary(results, keys=None) -> dict:
    """By config: status, error or not, last iteration, metric history
    without timing keys (only ``keys`` where given), checkpoint."""
    out = {}
    for trial, r in zip(results._trials, results):
        history = [{k: v for k, v in m.items()
                    if k not in TIMING and (keys is None or k in keys)}
                   for m in r.metrics_history]
        out[json.dumps(r.config, sort_keys=True)] = {
            "status": trial.status, "error": r.error is not None,
            "last": r.metrics.get("training_iteration"), "history": history,
            "checkpoint": r.checkpoint}
    return out


def _tracker_runs(root) -> dict:
    runs = {}
    for run_file in sorted(glob.glob(os.path.join(root, "*", "run.json"))):
        run_dir = os.path.dirname(run_file)
        with open(run_file) as f:
            status = json.load(f)["status"]
        with open(os.path.join(run_dir, "params.json")) as f:
            params = json.load(f)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [{k: v for k, v in json.loads(line).items() if k not in TIMING}
                    for line in f]
        runs[os.path.basename(run_dir)] = (status, params, rows)
    return runs


def _trial_files(exp_dir, name) -> dict:
    """Each trial directory's result.json rows (timing keys left out) and
    progress.csv header."""
    out = {}
    for path in sorted(glob.glob(os.path.join(exp_dir, "*", name))):
        with open(path) as f:
            if name.endswith(".json"):
                rows = [json.loads(line) for line in f]
                out[os.path.basename(os.path.dirname(path))] = [
                    {k: v for k, v in row.items() if k not in TIMING} for row in rows]
            else:
                out[os.path.basename(os.path.dirname(path))] = next(csv.reader(f))
    return out


def test_grid_with_trackers_and_loggers(ray_start_shared, tmp_path):
    def fit(name, plain_limit=False):
        side = SIDES[name]
        tune = side["tune"]
        space = {"slope": tune.grid_search([1.0, 2.0, 3.0])}
        config = (tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=1)
                  if plain_limit else _one_at_a_time(side, space, 3, metric="score", mode="max"))
        callbacks = [side["air"].FileTrackerCallback(str(tmp_path / name / "tracker")),
                     side["logger"].JsonLoggerCallback(), side["logger"].CSVLoggerCallback()]
        return tune.Tuner(apps.slope, param_space=space, tune_config=config,
                          run_config=side["run_config"](
                              name="grid", storage_path=str(tmp_path / name),
                              callbacks=callbacks)).fit()

    ref, port = _both(lambda: fit("ref"), lambda: fit("port", plain_limit=True))
    assert len(port) == 3 and _summary(port) == _summary(ref)
    assert port.get_best_result().config == ref.get_best_result().config == {"slope": 3.0}
    runs = {name: _tracker_runs(tmp_path / name / "tracker") for name in SIDES}
    assert runs["port"] == runs["ref"] and len(runs["port"]) == 3
    assert all(status == "FINISHED" for status, _, _ in runs["port"].values())
    for name in ("result.json", "progress.csv"):
        files = {side: _trial_files(tmp_path / side / "grid", name) for side in SIDES}
        assert files["port"] == files["ref"] and len(files["port"]) == 3
    # The reference, given max_concurrent_trials alone, runs num_samples
    # trials of the grid (one); the port runs the whole grid (above).
    assert len(fit("ref", plain_limit=True)) == 1


def test_asha(ray_start_shared, tmp_path):
    def fit(name):
        side = SIDES[name]
        tune = side["tune"]
        space = {"quality": tune.grid_search([2.0, 0.1, 1.0])}
        scheduler = tune.schedulers.ASHAScheduler(metric="score", mode="max", grace_period=2,
                                                  max_t=6, reduction_factor=2)
        return tune.Tuner(apps.quality, param_space=space,
                          tune_config=_one_at_a_time(side, space, 3, metric="score",
                                                     mode="max", scheduler=scheduler),
                          run_config=side["run_config"](name="asha",
                                                        storage_path=str(tmp_path / name))).fit()

    ref, port = _both(lambda: fit("ref"), lambda: fit("port"))
    summary = _summary(port)
    assert summary == _summary(ref)
    assert sorted(s["last"] for s in summary.values()) == [2, 2, 6]
    assert port.get_best_result().config == ref.get_best_result().config == {"quality": 2.0}


def test_class_api(ray_start_shared, tmp_path):
    def fit(name, trainable):
        side = SIDES[name]
        tune = side["tune"]
        space = {"step_size": tune.grid_search([1, 5])}
        limiter = side["searcher"].ConcurrencyLimiter(side["bv"].BasicVariantGenerator(space), 1)
        return tune.run(trainable, config=space, metric="count", mode="max", num_samples=2,
                        search_alg=limiter, max_concurrent_trials=1,
                        storage_path=str(tmp_path / name), name="class_api")

    ref, port = _both(lambda: fit("ref", apps.RefCounter), lambda: fit("port", apps.PortCounter))
    summary = _summary(port)
    assert summary == _summary(ref)
    assert {s["last"] for s in summary.values()} == {10}
    assert [s["checkpoint"] for s in summary.values()] == [{"count": 10}, {"count": 50}]
    assert port.get_best_result().config == ref.get_best_result().config == {"step_size": 5}


def test_checkpoint_and_restore(ray_start_shared, tmp_path):
    def fit(name):
        side = SIDES[name]
        tune = side["tune"]
        space = {"x": tune.grid_search([1, 2])}
        first = tune.Tuner(apps.checkpointed, param_space=space,
                           tune_config=_one_at_a_time(side, space, 2, metric="step_done",
                                                      mode="max"),
                           run_config=side["run_config"](name="ckpt",
                                                         storage_path=str(tmp_path / name))).fit()
        exp_dir = str(tmp_path / name / "ckpt")
        assert tune.Tuner.can_restore(exp_dir)
        return first, tune.Tuner.restore(exp_dir, apps.checkpointed).fit()

    (ref, ref_again), (port, port_again) = _both(lambda: fit("ref"), lambda: fit("port"))
    assert _summary(port) == _summary(ref)
    assert all(r.metrics["step_done"] == 3 and r.checkpoint == {"step": 3} for r in port)
    # The restored experiments: the same trials, come back terminated.
    again = {name: {json.dumps(r.config, sort_keys=True): (t.status, r.metrics, r.checkpoint)
                    for t, r in zip(res._trials, res)}
             for name, res in (("ref", ref_again), ("port", port_again))}
    for name in again:
        for value in again[name].values():
            value[1].pop("time_total_s", None)
    assert again["port"] == again["ref"] and len(again["port"]) == 2


def test_failure_retry(ray_start_shared, tmp_path):
    def fit(name):
        side = SIDES[name]
        tune = side["tune"]
        return tune.Tuner(apps.flaky, param_space={"x": 1},
                          tune_config=tune.TuneConfig(metric="step_done", mode="max",
                                                      max_concurrent_trials=1),
                          run_config=side["run_config"](
                              name="flaky", storage_path=str(tmp_path / name),
                              failure_config=side["failure_config"](max_failures=2))).fit()

    ref, port = _both(lambda: fit("ref"), lambda: fit("port"))
    assert _summary(port) == _summary(ref)
    assert port.num_errors == 0 and port[0].metrics["step_done"] == 4
    assert port._trials[0].num_failures == ref._trials[0].num_failures == 1


def test_tuner_wraps_trainer(ray_start_shared, tmp_path):
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import ScalingConfig as RefScaling

    def fit(name):
        side = SIDES[name]
        tune = side["tune"]
        if name == "ref":
            trainer = JaxTrainer(apps.trainer_loop, train_loop_config={"lr_scale": 1.0},
                                 scaling_config=RefScaling(num_workers=1),
                                 run_config=side["run_config"](
                                     name="inner", storage_path=str(tmp_path / name / "in")))
        else:
            trainer = TorchTrainer(apps.trainer_loop, train_loop_config={"lr_scale": 1.0},
                                   scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
                                   run_config=RunConfig(name="inner",
                                                        storage_path=str(tmp_path / name / "in")))
        return tune.Tuner(trainer,
                          param_space={"train_loop_config": {
                              "lr_scale": tune.grid_search([1.0, 4.0])}},
                          tune_config=tune.TuneConfig(metric="loss", mode="min"),
                          run_config=side["run_config"](name="trainer_sweep",
                                                        storage_path=str(tmp_path / name))).fit()

    ref, port = _both(lambda: fit("ref"), lambda: fit("port"))
    keys = {"loss", "training_iteration"}
    summary = _summary(port, keys)
    assert len(port) == 2 and summary == _summary(ref, keys)
    for s in summary.values():
        assert [m["training_iteration"] for m in s["history"]] == [1, 2]
    assert (port.get_best_result().config == ref.get_best_result().config
            == {"train_loop_config": {"lr_scale": 4.0}})
