"""The port's Tune (``ray_tpu_torch/tune/``) against the JAX package's
(``ray_tpu/tune/``): search, TPE, schedulers and searcher state, the
trial processes, trainer trials, and BASELINE config 3's trainable.

Search and scheduling are plain Python over ``random.Random`` in both
packages, so the checks are exact: the same seeds give the same variants
in the same order (nested spaces, ``sample_from`` and the global-random
``randn`` included), TPE fed the same results makes the same
suggestions, and one result stream fed to each package's ASHA,
HyperBand, median stopping, PBT and ``ConcurrencyLimiter`` gives equal
decisions (PBT's transplants and explored configs too). The trial
actors, on one cluster the module boots (``ray_tpu_torch.init``): a
``<locals>`` trainable is refused; a checkpoint holding a tensor restores
after the actor that saved it was killed; a stopped trainer trial, and one
killed hard, leave no actor, process or placement group behind. Trials
wait for their resources on the node agent: three asking for {"CPU": 1,
"TPU": 8} on a cluster declaring 8 TPUs run one at a time, in the order
the reference's controller runs them on its cluster, and {"GPU": 1}
trials see only their card. Config 3's
trainable (``chip_smoke.asha_resnet_run``) on the CPU against the release
script's JAX step from the same weights: its first two reports within
``tests/test_torch_cnn.py``'s f32 bounds.
"""

import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_runtime as runtime
import _torch_tune_apps as apps
import chip_smoke
import ray_tpu_torch as rt
from ray_tpu.models import cnn as jc
from ray_tpu.tune import schedulers as ref_sched
from ray_tpu.tune.search import basic_variant as ref_bv
from ray_tpu.tune.search import sample as ref_sample
from ray_tpu.tune.search import searcher as ref_searcher
from ray_tpu.tune.search import tpe as ref_tpe
from ray_tpu_torch import tune
from ray_tpu_torch.models.convert import conv_params_from_numpy
from ray_tpu_torch.train import (
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig, TorchTrainer,
)
from ray_tpu_torch.tune import schedulers as port_sched
from ray_tpu_torch.tune.execution import tune_controller
from ray_tpu_torch.tune.search import basic_variant as port_bv
from ray_tpu_torch.tune.search import optuna as port_optuna
from ray_tpu_torch.tune.search import sample as port_sample
from ray_tpu_torch.tune.search import searcher as port_searcher
from ray_tpu_torch.tune.search import tpe as port_tpe

PACKAGES = {
    "ref": (ref_sample, ref_bv, ref_searcher, ref_tpe, ref_sched),
    "port": (port_sample, port_bv, port_searcher, port_tpe, port_sched),
}
# tests/test_torch_cnn.py's bound on an f32 loss against JAX's.
F32_TOL = 2e-5
# The module's cluster: 8 TPUs for the held trials, one (declared) card.
CLUSTER = dict(num_cpus=8, num_gpus=1, resources={"TPU": 8})
cluster = runtime.cluster_fixture(**CLUSTER)


# ---------------------------------------------------------------- search
def _space(s, kind: str) -> dict:
    """One search space built from sample module ``s``."""
    if kind == "flat":
        return {"lr": s.loguniform(1e-5, 1e-1), "width": s.choice([8, 16, 32]),
                "depth": s.randint(1, 5), "drop": s.uniform(0.0, 0.5),
                "q": s.quniform(0.0, 1.0, 0.25), "units": s.lograndint(16, 512),
                "grid": s.grid_search(["a", "b"])}
    if kind == "nested":
        return {"optim": {"lr": s.loguniform(1e-4, 1e-2), "beta": s.grid_search([0.9, 0.99])},
                "model": {"width": s.grid_search([8, 16]), "act": s.choice(["relu", "gelu"]),
                          "double": s.sample_from(lambda spec: spec.config["model"]["width"] * 2)},
                "noise": s.randn(0.0, 2.0), "fixed": 3}
    return {"lr": s.grid_search([1e-2, 1e-3, 1e-4]), "width": s.grid_search([8, 16])}


@pytest.mark.parametrize("kind", ["flat", "nested", "config3"])
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_variants_match(kind, seed):
    out = {}
    for name, (s, bv, *_) in PACKAGES.items():
        random.seed(seed)  # randn draws from the global random, in both
        rng = random.Random(seed)
        out[name] = [list(bv.generate_variants(_space(s, kind), rng)) for _ in range(2)]
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == {"flat": 2, "nested": 4, "config3": 6}[kind]


@pytest.mark.parametrize("kind", ["flat", "nested"])
def test_basic_variant_generator_matches(kind):
    out = {}
    for name, (s, bv, *_) in PACKAGES.items():
        random.seed(3)
        gen = bv.BasicVariantGenerator(_space(s, kind), num_samples=3, random_state=11,
                                       points_to_evaluate=[{"lr": 0.5}])
        out[name] = (gen.total_samples,
                     [gen.suggest(f"t{i}") for i in range(gen.total_samples + 1)])
    assert out["port"] == out["ref"]
    assert out["port"][1][-1] is None


@pytest.mark.parametrize("seed", [1, 5])
def test_tpe_suggestions_match(seed):
    out = {}
    for name, (s, _, _, tpe, _) in PACKAGES.items():
        space = {"x": s.uniform(-2.0, 2.0), "lr": s.loguniform(1e-4, 1.0),
                 "n": s.randint(1, 20), "act": s.choice(["relu", "gelu", "tanh"]),
                 "q": s.quniform(0.0, 1.0, 0.1), "fixed": 7}
        search = tpe.TPESearch(metric="score", mode="max", seed=seed, n_initial_points=6)
        search.set_search_properties("score", "max", space)
        configs = []
        for i in range(30):
            cfg = search.suggest(f"t{i}")
            configs.append(cfg)
            score = -(cfg["x"] - 0.3) ** 2 - abs(np.log10(cfg["lr"]) + 2) + cfg["n"] / 20
            search.on_trial_complete(f"t{i}", {"score": score + (cfg["act"] == "gelu")})
        out[name] = (configs, search.save())
    assert out["port"] == out["ref"]


# ------------------------------------------------------------ searcher state
def _drain(searcher, start: int, n: int) -> list:
    return [searcher.suggest(f"t{i}") for i in range(start, start + n)]


@pytest.mark.parametrize("saver,loader", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_basic_variant_state_round_trips(saver, loader):
    def make(name):
        s, bv = PACKAGES[name][:2]
        return bv.BasicVariantGenerator(_space(s, "flat"), num_samples=4, random_state=5)

    first = make(saver)
    _drain(first, 0, 3)
    state = first.save()
    rest = _drain(first, 3, 6)
    second = make(loader)
    second.restore(state)
    assert _drain(second, 3, 6) == rest


@pytest.mark.parametrize("saver,loader", [("ref", "port"), ("port", "ref")])
def test_tpe_and_limiter_state_round_trip(saver, loader):
    def make(name):
        s, _, searcher, tpe, _ = PACKAGES[name]
        inner = tpe.TPESearch({"x": s.uniform(0.0, 1.0), "c": s.choice([1, 2, 3])},
                              metric="score", mode="min", seed=2, n_initial_points=3)
        return searcher.ConcurrencyLimiter(inner, max_concurrent=2)

    first = make(saver)
    for i in range(8):
        cfg = first.suggest(f"t{i}")
        if cfg is not None and i % 3 != 2:
            first.on_trial_complete(f"t{i}", {"score": cfg["x"] * cfg["c"]})
    state = first.save()
    second = make(loader)
    second.restore(state)
    steps = []
    for copy in (first, second):
        seq = []
        for i in range(8, 14):
            cfg = copy.suggest(f"t{i}")
            seq.append(cfg)
            copy.on_trial_complete(f"t{i}", {"score": 1.0} if cfg else None)
        steps.append(seq)
    assert steps[0] == steps[1]


def test_concurrency_limiter_matches():
    out = {}
    for name, (s, bv, searcher, *_) in PACKAGES.items():
        gen = bv.BasicVariantGenerator({"a": s.grid_search([1, 2, 3, 4, 5])}, random_state=0)
        lim = searcher.ConcurrencyLimiter(gen, max_concurrent=2)
        log = []
        for i in range(9):
            log.append(("suggest", i, lim.suggest(f"t{i}")))
            if i % 2:
                lim.on_trial_complete(f"t{i - 1}", {"m": i})
                log.append(("state", i, lim.save()))
        out[name] = log
    assert out["port"] == out["ref"]


def test_optuna_keeps_its_import_guard():
    if port_optuna._optuna is not None:
        pytest.skip("optuna is installed here")
    with pytest.raises(ImportError, match="optuna"):
        port_optuna.OptunaSearch()


# ------------------------------------------------------------- schedulers
class _FakeTrial:
    def __init__(self, trial_id, config):
        self.trial_id, self.config, self.status = trial_id, dict(config), "RUNNING"

    def is_finished(self):
        return self.status == "TERMINATED"


class _FakeController:
    def __init__(self):
        self.trials, self.transplants = [], []

    @property
    def live_trials(self):
        return [t for t in self.trials if not t.is_finished()]

    def transplant_trial(self, trial, donor, new_config):
        self.transplants.append((trial.trial_id, donor.trial_id, dict(new_config)))
        trial.config = dict(new_config)


def _stream(seed: int, trials: int = 8, horizon: int = 12) -> list:
    """(trial, iteration, score) events: each trial's scores in its own
    order, the trials interleaved at random."""
    rng = np.random.default_rng(seed)
    slopes = rng.uniform(0.2, 2.0, trials)
    left = {i: list(range(1, horizon + 1)) for i in range(trials)}
    events = []
    while left:
        i = int(rng.choice(sorted(left)))
        t = left[i].pop(0)
        events.append((f"t{i}", t, float(slopes[i] * t + rng.normal(0.0, 0.5))))
        if not left[i]:
            del left[i]
    return events


def _replay(scheduler, events, mode: str) -> tuple:
    """Feeds the events as the controller does: a STOP ends the trial
    (on_trial_complete), a PAUSE holds it out of the stream."""
    ctl = _FakeController()
    trials = {}
    for tid in sorted({e[0] for e in events}, key=lambda x: int(x[1:])):
        trial = _FakeTrial(tid, {"lr": 0.01 * (1 + int(tid[1:])), "batch": 32})
        trials[tid] = trial
        ctl.trials.append(trial)
        scheduler.on_trial_add(ctl, trial)
    decisions = []
    for tid, t, score in events:
        trial = trials[tid]
        if trial.status != "RUNNING":
            continue
        result = {"training_iteration": t, "score": score if mode == "max" else -score}
        decision = scheduler.on_trial_result(ctl, trial, result)
        decisions.append((tid, t, decision))
        if decision == "STOP":
            trial.status = "TERMINATED"
            scheduler.on_trial_complete(ctl, trial, result)
        elif decision == "PAUSE":
            trial.status = "PAUSED"
    return decisions, ctl.transplants, {tid: t.config for tid, t in trials.items()}


SCHEDULERS = {
    "asha": lambda s, m, mode: s.ASHAScheduler(metric="score", mode=mode, grace_period=1,
                                               max_t=10, reduction_factor=2),
    "asha_config3": lambda s, m, mode: s.ASHAScheduler(metric="score", mode=mode,
                                                       grace_period=2, max_t=8,
                                                       reduction_factor=2),
    "asha_3_brackets": lambda s, m, mode: s.AsyncHyperBandScheduler(
        metric="score", mode=mode, grace_period=1, max_t=9, reduction_factor=3, brackets=3),
    "hyperband": lambda s, m, mode: s.HyperBandScheduler(metric="score", mode=mode, max_t=9,
                                                         reduction_factor=3),
    "median": lambda s, m, mode: s.MedianStoppingRule(metric="score", mode=mode,
                                                      grace_period=2, min_samples_required=3),
    "median_pause": lambda s, m, mode: s.MedianStoppingRule(
        metric="score", mode=mode, grace_period=1, min_samples_required=2, hard_stop=False),
    "pbt": lambda s, m, mode: s.PopulationBasedTraining(
        metric="score", mode=mode, perturbation_interval=2, seed=4,
        hyperparam_mutations={"lr": m.uniform(1e-4, 1e-1), "batch": [16, 32, 64]}),
    "pbt_resample": lambda s, m, mode: s.PopulationBasedTraining(
        metric="score", mode=mode, perturbation_interval=3, seed=9, quantile_fraction=0.5,
        resample_probability=0.6,
        hyperparam_mutations={"lr": m.loguniform(1e-4, 1e-1), "batch": [16, 32, 64]}),
    "fifo": lambda s, m, mode: s.FIFOScheduler(),
}


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match(name, seed, mode):
    events = _stream(seed)
    out = {}
    for pkg, (s, _, _, _, sched) in PACKAGES.items():
        out[pkg] = _replay(SCHEDULERS[name](sched, s, mode), events, mode)
    assert out["port"] == out["ref"]
    decisions, transplants, _ = out["port"]
    kinds = {d for *_, d in decisions}
    if name.startswith(("asha", "hyperband", "median")):
        assert kinds - {"CONTINUE"}, "the stream should end some trials early"
    if name.startswith("pbt"):
        assert transplants


# ------------------------------------------------------- the trial processes
def test_a_locals_trainable_is_refused(cluster, tmp_path):
    def nested(config):
        tune.report({"x": 1})

    class Local(tune.Trainable):
        def step(self):
            return {"x": 1, "done": True}

    for trainable in (nested, Local):
        with pytest.raises(ValueError, match="<locals>"):
            tune.Tuner(trainable, run_config=RunConfig(storage_path=str(tmp_path))).fit()
    with pytest.raises(ValueError, match="top level"):
        tune.Tuner(lambda config: None, run_config=RunConfig(storage_path=str(tmp_path))).fit()
    with pytest.raises(ValueError, match="does not pickle"):
        tune.Tuner(tune.with_parameters(nested, a=1),
                   run_config=RunConfig(storage_path=str(tmp_path))).fit()


def test_a_tensor_checkpoint_restores_after_its_process_exited(cluster):
    ref = tune_controller.TrainableRef(apps.TensorCounter)
    actor_cls = rt.remote(tune_controller._TrialActor)
    first = actor_cls.remote(ref, {})
    assert [rt.get(first.train.remote(), timeout=120)["value"] for _ in range(2)] == [4.0, 8.0]
    checkpoint = rt.get(first.save.remote(), timeout=60)
    first_pid = rt.get(first.pid.remote(), timeout=60)
    rt.get(first.stop.remote(), timeout=5)
    rt.kill(first)
    assert runtime.gone([first_pid])
    second = actor_cls.remote(ref, {})
    try:
        rt.get(second.restore.remote(checkpoint), timeout=120)
        result = rt.get(second.train.remote(), timeout=60)
        assert result["value"] == 12.0 and result["pid"] != first_pid
    finally:
        rt.kill(second)
    assert checkpoint["state"].tolist() == [2.0] * 4


@pytest.mark.parametrize("fail", ["raise", "exit"])
def test_a_failed_trial_retries_from_a_tensor_checkpoint(cluster, tmp_path, fail):
    """The trial raises, or its process exits, at its third step; the retry
    restores the step-2 tensor saved by the process that then failed."""
    results = tune.Tuner(
        apps.TensorCounter, param_space={"fail_at_3": fail},
        tune_config=tune.TuneConfig(metric="value", mode="max"),
        run_config=RunConfig(name="retry", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1),
                             checkpoint_config=CheckpointConfig(checkpoint_frequency=1)),
    ).fit()
    (trial,) = results
    assert trial.error is None and results._trials[0].num_failures == 1
    # An exit is the actor's death (the runtime names the exit code when its
    # record of the death came before the failed call's answer).
    assert ("ActorDiedError" if fail == "exit" else "boom at 3") in \
        results._trials[0].error_message
    history = [m["value"] for m in trial.metrics_history]
    assert history == [4.0, 8.0, 12.0, 16.0, 20.0]
    pids = [m["pid"] for m in trial.metrics_history]
    assert pids[0] == pids[1] != pids[2] and runtime.gone(pids)


def test_a_transplant_moves_a_tensor_checkpoint_between_processes(cluster, tmp_path):
    """PBT's exploit through the controller: the donor's save waits behind
    its running train() (whose answer is kept for the loop), and the
    trial, which cannot reset in place, restarts in a new process from
    the donor's tensor."""
    # Steps of 0.1 s: neither trial ends before the other has reported twice.
    space = {"x": tune.grid_search([1, 2]), "stop_at": 20, "step_s": 0.1}
    controller = tune_controller.TuneController(
        apps.TensorCounter, searcher=port_bv.BasicVariantGenerator(space),
        max_concurrent_trials=2, experiment_dir=str(tmp_path))
    controller.searcher.set_search_properties(None, None, {})
    while len(controller.trials) < 2 or min(t.iteration for t in controller.trials) < 2:
        controller.step()
    trial, donor = controller.trials
    old_pid = trial.metric_history[-1]["pid"]
    assert any(t is donor for t in controller._futures.values())  # a train() in flight
    new_config = {"x": 5, "stop_at": 20, "step_s": 0.1}
    controller.transplant_trial(trial, donor, new_config)
    saved = float(donor.checkpoint["state"].sum())
    results = controller.run()
    assert [t.status for t in results] == ["TERMINATED", "TERMINATED"]
    assert trial.config == new_config and runtime.gone([old_pid])
    after = [m for m in trial.metric_history if m["pid"] != old_pid]
    assert after and after[0]["value"] == saved + 4 and after[-1]["value"] == 80
    # The donor lost no result to the save that waited behind its train().
    values = [m["value"] for m in donor.metric_history]
    assert values == [4.0 * i for i in range(1, 21)]
    assert [m["training_iteration"] for m in donor.metric_history] == list(range(1, 21))


def test_with_parameters_reaches_the_trial(cluster, tmp_path):
    results = tune.run(tune.with_parameters(apps.scaled, offset=100.0),
                       config={"x": tune.grid_search([1.0, 2.0])}, metric="score", mode="max",
                       storage_path=str(tmp_path), name="with_params",
                       max_concurrent_trials=2)
    assert sorted(r.metrics["score"] for r in results) == [103.0, 106.0]


@pytest.mark.parametrize("stall", [False, True], ids=["stopped", "killed_hard"])
def test_a_stopped_trainer_trial_leaves_no_process(cluster, tmp_path, stall):
    """TorchTrainer trials (CPU gloo gangs of one worker) whose loops would
    report 6 rounds, stopped at their second. Two trials at once, stopped by
    ASHA at max_t; or, with ``stall``, one whose loop sleeps after its
    second report, so that its trial cannot stop before the controller's
    kill, stopped by ``RunConfig.stop``. Either way no trial actor, gang
    member or placement group is left, and the cluster's resources are all
    free again."""
    loop_config = {"rounds": 6, "stall_after": 2} if stall else {"rounds": 6}
    trainer = TorchTrainer(apps.pid_loop, train_loop_config=loop_config,
                           scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
                           run_config=RunConfig(name="inner", storage_path=str(tmp_path / "in")))
    lrs = [1.0] if stall else [1.0, 2.0]
    start = time.monotonic()
    results = tune.Tuner(
        trainer, param_space={"train_loop_config": {"lr": tune.grid_search(lrs)}},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=2,
            scheduler=None if stall else port_sched.ASHAScheduler(
                metric="loss", mode="min", grace_period=2, max_t=2)),
        run_config=RunConfig(name="sweep", storage_path=str(tmp_path),
                             stop={"training_iteration": 2} if stall else None),
    ).fit()
    assert len(results) == len(lrs) and results.num_errors == 0
    for r in results:
        assert [m["training_iteration"] for m in r.metrics_history] == [1, 2]
        assert [m["loss"] for m in r.metrics_history] == [6 * r.config["train_loop_config"]["lr"],
                                                          5 * r.config["train_loop_config"]["lr"]]
        pids = {m["pid"] for m in r.metrics_history}
        assert len(pids) == 1 and runtime.gone(pids), (r.config, pids)
    trial_pids = [a["pid"] for a in runtime.actors("_TrialActor")]
    member_pids = [a["pid"] for a in runtime.actors("_GangMember")]
    assert len(trial_pids) >= len(lrs) and runtime.gone(trial_pids + member_pids)
    assert runtime.all_dead()
    assert runtime.settled(rt.cluster_resources())
    if stall:
        # The stall costs the stop's wait for the trainable's thread
        # (STOP_JOIN_S), then the group is killed.
        assert time.monotonic() - start > tune.trainable.STOP_JOIN_S


def test_trials_run_concurrently_by_default(cluster, tmp_path):
    # The default concurrency is the cluster's CPUs over the trial's.
    controller = tune_controller.TuneController(
        tune.wrap_function(apps.slope), searcher=port_bv.BasicVariantGenerator(),
        experiment_dir=str(tmp_path))
    assert controller._max_concurrent == CLUSTER["num_cpus"]


# ------------------------------------------------- trials wait for their resources
HELD_SPACE = {"name": ["a", "b", "c"], "hold_s": 0.5}


def _held_trials(controller_cls, wrap, bv, tmp_path, resources_per_trial, meet=None) -> list:
    """The three held trials; with ``meet``, each waits for that many to
    have started (``apps.held``)."""
    space = {"name": tune.grid_search(HELD_SPACE["name"]), "hold_s": HELD_SPACE["hold_s"]}
    if meet:
        (tmp_path / "meet").mkdir(parents=True)
        space.update(meet=meet, meet_dir=str(tmp_path / "meet"))
    controller = controller_cls(
        wrap(apps.held), searcher=bv.BasicVariantGenerator(space),
        experiment_dir=str(tmp_path), resources_per_trial=resources_per_trial)
    controller.searcher.set_search_properties(None, None, {})
    return controller.run()


def _order(trials) -> tuple:
    """(names by start, names by end, whether each trial began after the
    one before it ended): one trial at a time when the last is True."""
    starts = sorted(trials, key=lambda t: t.last_result["began"])
    ends = sorted(trials, key=lambda t: t.last_result["ended"])
    serial = all(b.last_result["began"] >= a.last_result["ended"]
                 for a, b in zip(starts, starts[1:]))
    return [t.config["name"] for t in starts], [t.config["name"] for t in ends], serial


def test_trials_pend_for_a_declared_resource_as_the_reference(ray_start_shared, cluster,
                                                              tmp_path):
    """Three trials asking for {"CPU": 1, "TPU": 8}: the reference's
    cluster declares {"TPU": 8} (conftest), the port's cluster the same.
    Both run one trial at a time, in the same order of starts and ends,
    the others waiting until the running one frees its TPUs."""
    from ray_tpu.tune import trainable as ref_trainable
    from ray_tpu.tune.execution import tune_controller as ref_tc

    want = {"CPU": 1, "TPU": 8}
    ref = _held_trials(ref_tc.TuneController, ref_trainable.wrap_function, ref_bv,
                       tmp_path / "ref", want)
    port = _held_trials(tune_controller.TuneController, tune.wrap_function, port_bv,
                        tmp_path / "port", want)
    assert [t.status for t in ref] == [t.status for t in port] == ["TERMINATED"] * 3
    ref_starts, ref_ends, ref_serial = _order(ref)
    port_starts, port_ends, port_serial = _order(port)
    assert ref_serial and port_serial
    assert port_starts == ref_starts and port_ends == ref_ends
    assert runtime.settled(rt.cluster_resources())  # every lease went back
    assert rt.available_resources()["TPU"] == 8.0


def test_gpu_trials_see_only_their_card(cluster, tmp_path):
    """{"GPU": 1} trials on a cluster of one card: one at a time, each
    actor with CUDA_VISIBLE_DEVICES naming card 0; on a cluster of two
    cards, two at a time on cards 0 and 1."""
    trials = _held_trials(tune_controller.TuneController, tune.wrap_function, port_bv,
                          tmp_path / "one", {"CPU": 1, "GPU": 1})
    assert [t.last_result["visible"] for t in trials] == ["0", "0", "0"]
    assert _order(trials)[2]
    rt.shutdown()
    try:
        rt.init(**{**CLUSTER, "num_gpus": 2})
        trials = _held_trials(tune_controller.TuneController, tune.wrap_function, port_bv,
                              tmp_path / "two", {"CPU": 1, "GPU": 1}, meet=2)
        first_two = sorted(trials, key=lambda t: t.last_result["began"])[:2]
        assert sorted(t.last_result["visible"] for t in first_two) == ["0", "1"]
        # The first two ran at once: each saw the other start before it ended.
        assert all(t.last_result["met"] for t in first_two)
        assert not _order(first_two)[2]
        assert runtime.settled({**rt.cluster_resources()})
    finally:
        rt.shutdown()
        rt.init(**CLUSTER)


# ------------------------------------------------- BASELINE config 3's trainable
def _release_step(rc, lr):
    """release/tune_asha_resnet.py:29-37: the jitted Adam step."""
    optimizer = optax.adam(lr)

    @jax.jit
    def step(params, opt_state, images, labels):
        (loss, acc), grads = jax.value_and_grad(jc.resnet_loss, has_aux=True)(
            params, images, labels, rc)
        updates, opt_state = optimizer.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    return optimizer, step


@pytest.mark.parametrize("lr", [1e-3, 1e-2])
def test_config3_trainable_matches_the_release_script(lr):
    config = {"lr": lr, "width": 8}
    rc = jc.ResNetConfig(width=8, blocks_per_stage=(1, 1))
    params = jc.init_resnet(rc, jax.random.PRNGKey(0))
    optimizer, step = _release_step(rc, lr)
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(32, 32, 32, 3)).astype(np.float32)
    labels = (images.sum(axis=(1, 2, 3)) > 0).astype(np.int32)
    want = []
    port_params = conv_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    p = params
    for _ in range(2):
        for _ in range(chip_smoke.ASHA_STEPS):
            p, opt_state, loss, acc = step(p, opt_state, jnp.asarray(images),
                                           jnp.asarray(labels))
        want.append({"acc": float(acc), "loss": float(loss)})
    got = []
    chip_smoke.asha_resnet_run(config, port_params, "cpu", got.append, epochs=2)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) < F32_TOL * max(1.0, abs(w["loss"])), (got, want)
        assert g["acc"] == w["acc"], (got, want)
