"""StepStats on the port (``ray_tpu_torch.train.step_stats``) against the JAX
package's, and the hooks that feed it.

* ``StepRecorder`` records equal the reference's ``StepRecorder`` fed the
  same phases under one patched clock: the fwd/bwd/opt split, its clamp to
  compute, no split keys without annotations, ``comm_exposed`` against
  ``collective``, data wait, the pipeline bubble, tokens and flops.
* The port's hooks record their phases inside a session: ``checkpoint``
  (the sharded save), ``collective`` (a group op, once per op),
  ``comm_exposed`` and the ``fence.b<i>`` scopes (the overlap fence),
  ``pp_bubble``, ``fwd``, ``bwd`` and ``opt`` (the stage runner).
* ``TorchTrainer`` on 2 CPU workers with ``capture_profile(steps=2)``
  called from another thread while ``fit()`` runs: one merged trace of
  both ranks cut on the same steps, as the reference's
  ``test_e2e_cli_profile_merges_two_step_aligned_ranks``; the records in
  ``Result.step_stats``; ``hbm_stats() == {}`` in a CPU worker.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from ray_tpu._private import profiler as ref_profiler
from ray_tpu.train._internal import step_stats as ref_stats
from ray_tpu_torch._private import profiler as port_profiler
from ray_tpu_torch._private import telemetry
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.train import session, step_stats, torch_utils
from ray_tpu_torch.train.checkpoint import save_pytree
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.stage_runner import PipelineStageRunner
from ray_tpu_torch.train.step import make_optimizer
from ray_tpu_torch.train.trainer import TorchTrainer
from ray_tpu_torch.util import collective

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)

MODULES = {"reference": ref_stats, "port": step_stats}


@pytest.fixture(autouse=True)
def _reset():
    yield
    for mod in MODULES.values():
        mod.deactivate()
    for prof in (ref_profiler, port_profiler):
        prof._boundary_armed = False
        prof._capturing = False
    port_profiler._plane = None


class _Shard:
    fetch_wait_s = 0.0


class _Ctx:
    world_rank = 1
    node_id = "node-test"
    device = "cpu"

    def __init__(self):
        self.dataset_shards = {"train": _Shard()}


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


# Each step: seconds the clock advances, phases recorded, data wait added,
# metrics. The reference tests' cases and the ones around them.
STEPS = {
    "split": [(0.08, {"fwd": 0.010, "bwd": 0.020, "opt": 0.005}, 0.0, {})],
    "clamp": [(0.04, {"fwd": 10.0, "bwd": 30.0}, 0.0, {})],
    "no_annotations": [(0.01, {}, 0.0, {})],
    "comm_exposed": [(0.5, {"collective": 0.3, "comm_exposed": 0.05, "fwd": 0.1}, 0.0, {}),
                     (0.5, {"collective": 0.3}, 0.0, {})],
    "phases_past_wall": [(0.2, {"collective": 0.15, "checkpoint": 0.1, "fwd": 0.1}, 0.05, {})],
    "bubble_data_tokens": [(1.0, {"pp_bubble": 0.2, "bwd": 0.4}, 0.3,
                            {"tokens": 4096, "flops": 1e12}),
                           (0.3, {"pp_bubble": 0.5}, 0.0, {"tokens": True, "flops": "x"})],
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_records_equal_the_reference(case, monkeypatch):
    clock, wall = _Clock(), _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(time, "time", wall)
    # The device probe is held apart (the reference asks jax, the port CUDA).
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "_device_info", lambda: ("NVIDIA H100 80GB HBM3", 1))
    ctxs = {name: _Ctx() for name in MODULES}
    recorders = {}
    for name, mod in MODULES.items():
        mod.activate()
        recorders[name] = mod.StepRecorder(ctxs[name])
        recorders[name].on_report({})
    got = {name: [] for name in MODULES}
    for advance, phases, wait, metrics in STEPS[case]:
        clock.now += advance
        wall.now += advance
        for name, mod in MODULES.items():
            for phase, seconds in phases.items():
                mod.record_phase(phase, seconds)
            ctxs[name].dataset_shards["train"].fetch_wait_s += wait
            got[name].append(recorders[name].on_report(metrics))
            recorders[name].mark_resume()
    assert got["port"] == got["reference"]
    rec = got["port"][0]
    if case == "split":
        assert (rec["fwd_s"], rec["bwd_s"], rec["opt_s"]) == (0.010, 0.020, 0.005)
    if case == "clamp":
        assert rec["fwd_s"] + rec["bwd_s"] + rec["opt_s"] == pytest.approx(rec["compute_s"])
    if case == "no_annotations":
        assert not {"fwd_s", "bwd_s", "opt_s"} & set(rec)


def test_device_info_never_initialises_cuda(monkeypatch):
    assert step_stats._device_info() == ("", 1) or torch.cuda.is_initialized()
    assert telemetry.hbm_stats() == {} or torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (60 << 30, 80 << 30))
    assert step_stats._device_info() == ("NVIDIA H100 80GB HBM3", 4)
    assert telemetry.hbm_stats() == {"hbm_used": 20 << 30, "hbm_total": 80 << 30}


def test_step_annotation_times_attributes_and_scopes(monkeypatch):
    step_stats.activate()
    recorder = step_stats.StepRecorder(_Ctx())
    recorder.on_report({})
    with step_stats.step_annotation("bwd", phase="bwd"):
        time.sleep(0.02)
    with step_stats.step_annotation("grad_sync"):  # no phase: timer only
        time.sleep(0.001)
    rec = recorder.on_report({})
    assert rec["bwd_s"] >= 0.015 and "fwd_s" in rec
    # The scope is a record_function: a profiler sees its name.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with step_stats.step_annotation("fwd", phase="fwd"):
            torch.ones(3) + 1
    assert "fwd" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# the port's hooks
# ---------------------------------------------------------------------------

@pytest.fixture()
def gloo_group():
    collective.init_collective_group(1, 0, backend="gloo", group_name="stats-test")
    try:
        yield "stats-test"
    finally:
        collective.destroy_collective_group("stats-test")


def test_hooks_record_checkpoint_collective_and_comm_exposed(tmp_path, gloo_group):
    step_stats.activate()
    save_pytree(str(tmp_path / "ckpt"), {"w": torch.ones(4, 4)})
    phases = step_stats._drain_phases()
    assert set(phases) == {"checkpoint"} and phases["checkpoint"] > 0
    group = collective.get_group(gloo_group)
    group.allreduce(np.ones(3, np.float32))
    collective.barrier(gloo_group)  # barrier runs an allreduce: one op, one record
    phases = step_stats._drain_phases()
    assert set(phases) == {"collective"}
    plane = port_profiler.get_plane()
    plane.arm({"capture_id": "hooks", "start_step": None, "steps": 1, "max_s": 30,
               "host": False, "device": False, "session_dir": str(tmp_path)})
    grads = {"a": torch.ones(300), "b": torch.ones(200)}
    handle = torch_utils.begin_gradient_sync(grads, gloo_group, bucket_bytes=512)
    out = handle.result()
    assert torch.equal(out["a"], grads["a"]) and handle.stats["buckets"] == 2
    phases = step_stats._drain_phases()
    assert set(phases) == {"comm_exposed"}
    plane.abort()
    cap = plane.collect()
    assert [a["name"] for a in cap["annotations"]] == ["fence.b0", "fence.b1"]
    assert set(cap["phase_totals"]) == {"comm_exposed"}
    step_stats.deactivate()
    group.allreduce(np.ones(3, np.float32))
    assert step_stats._drain_phases() == {}  # outside a session: nothing


class _Wire:
    def recv(self, like, src):
        time.sleep(0.01)
        return like.fill_(1.0)


def test_stage_runner_records_bubble_and_scopes():
    runner = PipelineStageRunner.__new__(PipelineStageRunner)
    runner.wire, runner.device = _Wire(), torch.device("cpu")
    runner.activation_like = lambda micro: torch.zeros(2, 3)
    runner.stats = {"fwd": 0.0, "bwd": 0.0, "opt": 0.0, "pp_bubble": 0.0}
    step_stats.activate()
    assert torch.equal(runner._recv(0, None), torch.ones(2, 3))
    for phase in ("fwd", "bwd", "opt"):
        with runner._phase(phase):
            time.sleep(0.002)
    phases = step_stats._drain_phases()
    assert set(phases) == {"pp_bubble", "fwd", "bwd", "opt"}
    assert phases["pp_bubble"] >= 0.009 and runner.stats["pp_bubble"] == phases["pp_bubble"]
    assert all(runner.stats[p] >= phases[p] > 0 for p in ("fwd", "bwd", "opt"))


# ---------------------------------------------------------------------------
# TorchTrainer.capture_profile on 2 CPU workers
# ---------------------------------------------------------------------------

CAPTURE_STEPS = 6


def _batch(step: int) -> np.ndarray:
    return np.random.default_rng(1000 + step).integers(0, 256, (4, 17)).astype(np.int32)


def _profiled_loop(config):
    """Each worker's loop (module level: the gang pickles it by name): the
    tiny model's split step over the gang's group, a report a step."""
    ctx = session.get_context()
    model = pt.TransformerConfig.tiny()
    setup = torch_utils.setup_sharded_training(
        lambda device: pt.init_params(model, 0, device=device), make_optimizer,
        logical_dims=pt.param_logical_dims(model))
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], model), setup,
        group_name=ctx.collective_group)
    params, opt = setup.params, setup.opt_state
    for i in range(config["steps"]):
        params, opt, loss = step(params, opt, setup.shard_batch(torch.from_numpy(_batch(i))))
        session.report({"step": i + 1, "loss": float(loss), "tokens": 2 * 16,
                        "hbm": telemetry.hbm_stats()})


def test_trainer_capture_profile_merges_two_step_aligned_ranks(tmp_path):
    trainer = TorchTrainer(
        _profiled_loop, train_loop_config={"steps": CAPTURE_STEPS},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="profiled", storage_path=str(tmp_path)))
    out = {}
    fit = threading.Thread(target=lambda: out.update(result=trainer.fit()))
    fit.start()
    try:
        record = trainer.capture_profile(steps=2, timeout_s=240.0)
    finally:
        fit.join(300)
    assert not fit.is_alive()
    result = out["result"]
    assert result.error is None, result.error
    assert record["status"] == "ok", record
    assert record["ranks"] == [0, 1] and record["workers"] == 2
    assert record["arm_errors"] is None and record["start_step"] == 2
    assert set(record["hot_phases"]) == {"0", "1"}
    assert os.path.dirname(record["path"]) == os.path.join(result.path, "profiles",
                                                           "prof-0000-manual")
    with open(record["path"]) as f:
        trace = json.load(f)
    steps = {(e["pid"], e["args"]["step"]) for e in trace["traceEvents"]
             if e.get("cat") == "step"}
    assert steps == {(0, 2), (0, 3), (1, 2), (1, 3)}
    phases = [e for e in trace["traceEvents"] if e.get("cat") == "phase"]
    for pid in (0, 1):
        names = [e["name"] for e in phases if e["pid"] == pid]
        assert names == ["fwd", "bwd", "grad_sync", "opt"] * 2
        assert all(e["args"]["step"] in (2, 3) for e in phases if e["pid"] == pid)
    assert set(trace["metadata"]["device_trace_dirs"]) == {"0", "1"}
    for rank, path in trace["metadata"]["device_trace_dirs"].items():
        with open(os.path.join(path, port_profiler.TRACE_FILE)) as f:
            device = json.load(f)["traceEvents"]
        names = [e["name"] for e in device if e.get("cat") == "user_annotation"]
        assert names.count("fwd") == names.count("grad_sync") == 2, (rank, names)
    with open(record["folded_path"]) as f:
        folded = json.load(f)
    assert {k.split(";")[0] for k in folded} == {"rank0", "rank1"}
    # Every report's StepStats record, by rank; the split step's phases.
    assert sorted(result.step_stats) == [0, 1]
    for rank, recs in result.step_stats.items():
        assert [r["step"] for r in recs] == list(range(CAPTURE_STEPS))
        assert all(r["rank"] == rank and r["tokens"] == 32.0 for r in recs)
        assert all(r["fwd_s"] > 0 and r["collective_s"] > 0 for r in recs)
        assert "device_kind" not in recs[0]  # a CPU worker never initialised CUDA
    assert all(m["hbm"] == {} for m in result.metrics_history)


def test_capture_profile_outside_fit_and_with_no_rank_selected(tmp_path):
    trainer = TorchTrainer(
        _profiled_loop, train_loop_config={"steps": 2},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="unprofiled", storage_path=str(tmp_path)))
    pending = trainer.capture_profile(steps=1, ranks=[7], wait=False)
    assert pending == {"status": "ok", "capture_id": "prof-0000-manual"}
    result = trainer.fit()
    assert result.error is None and len(result.step_stats[0]) == 2
    request = trainer.capture_profile(steps=1, wait=True, timeout_s=0.1)
    assert request["code"] == "timeout"
    assert not os.path.exists(os.path.join(result.path, "profiles"))


# ------------------------------------------------- the flight recorder's driver half
from ray_tpu._private import workload as ref_workload  # noqa: E402
from ray_tpu_torch._private import workload as port_workload  # noqa: E402

RECORDER_RANKS, RECORDER_ROUNDS, SLOW_RANK = 4, 20, 2


def _rounds(seed: int, device_kind: str | None = None) -> list:
    """Rounds of per-rank StepStats records made with numpy: rank
    SLOW_RANK a quarter slower from round 3 on, jitter on every wall, some
    ranks with a fwd/bwd/opt split, a replayed round (the aggregator's
    chaos guard drops it) and one negative phase (clamped)."""
    rng = np.random.default_rng(seed)
    rounds = []
    for step in range(RECORDER_ROUNDS):
        round_ = []
        for rank in range(RECORDER_RANKS):
            wall = 0.2 + float(rng.uniform(0, 0.004))
            if rank == SLOW_RANK and step >= 3:
                wall *= 1.25
            rec = {"step": step, "rank": rank, "node_id": f"node{rank}", "ts": 100.0 + step,
                   "wall_s": wall, "data_wait_s": float(rng.uniform(0, 0.01)),
                   "collective_s": float(rng.uniform(0, 0.03)),
                   "checkpoint_s": float(rng.uniform(0, 0.02)) if step % 5 == 4 else 0.0,
                   "pp_bubble_s": 0.0, "comm_exposed_s": 0.0,
                   "compute_s": wall * 0.7, "tokens": 4096.0, "flops": 3e12}
            if rank % 2:
                rec.update(fwd_s=wall * 0.2, bwd_s=wall * 0.4, opt_s=wall * 0.1)
            if device_kind:
                rec.update(device_kind=device_kind, devices=1)
            round_.append({"metrics": {}, "step_stats": rec})
        rounds.append(round_)
    rounds[6][1]["step_stats"]["collective_s"] = -0.5
    rounds.insert(9, rounds[8])  # a replayed round
    return rounds


class _RecorderClock:
    """time.monotonic and time.time for both recorders: each round is half
    a second, so a summary is cut every other round."""

    def __init__(self):
        self.now = 50.0

    def monotonic(self):
        return self.now

    def time(self):
        return 0.0


class _Controller:
    """The reference recorder's controller: its calls, kept."""

    def __init__(self):
        self.calls = []

    def call(self, method, payload, timeout=None):
        self.calls.append((method, payload))


class _Io:
    @staticmethod
    def spawn(coro):
        coro.close()

    @staticmethod
    def run(coro):
        coro.close()


def test_aggregator_matches_the_reference():
    ref, port = ref_workload.StepStatsAggregator(), port_workload.StepStatsAggregator()
    ref_rounds, port_rounds = _rounds(1, "TPU v4"), _rounds(1, "NVIDIA H100 80GB HBM3")
    for ref_round, port_round in zip(ref_rounds, port_rounds):
        for a, b in zip(ref_round, port_round):
            assert ref.add(dict(a["step_stats"])) == port.add(dict(b["step_stats"]))
    ref_summary, port_summary = ref.summary(), port.summary()
    ref_mfu, port_mfu = ref_summary.pop("mfu"), port_summary.pop("mfu")
    assert port_summary == ref_summary
    assert port_summary["dropped_stale"] == RECORDER_RANKS and port_summary["clamped_negative"] == 1
    # The same FLOPs over the same walls: the MFUs stand as the peaks do
    # (the H100's dense bf16 989e12, the v4's 275e12).
    assert port_mfu == pytest.approx(ref_mfu * 275e12 / 989e12, rel=1e-12)
    assert port.straggler_report() == ref.straggler_report()
    assert [s["rank"] for s in port.straggler_report()] == [SLOW_RANK]
    for args in ((10.0, 1.0, 2.0, 3.0), (1.0, 0.5, 0.8, 0.1), (0.0,)):
        assert port_workload.goodput_buckets(*args) == ref_workload.goodput_buckets(*args)


def test_flight_recorder_matches_the_reference(monkeypatch):
    """Both recorders fed the same rounds under one patched clock: the
    summaries each round, the stragglers, the auto-capture requests
    (debounced over RAY_TPU_PROFILE_AUTO_CONSECUTIVE cuts and spaced by
    the cooldown), the samples the reference pushes and the port keeps,
    and the goodput buckets."""
    from ray_tpu._private import worker as ref_worker

    clock = _RecorderClock()
    for mod in (ref_stats, step_stats):
        monkeypatch.setattr(mod, "time", clock)
    controller = _Controller()
    monkeypatch.setattr(ref_worker, "get_global_context",
                        lambda: types.SimpleNamespace(controller=controller, io=_Io))
    monkeypatch.setenv("RAY_TPU_PROFILE_AUTO_CONSECUTIVE", "2")
    monkeypatch.setenv("RAY_TPU_PROFILE_AUTO_COOLDOWN_S", "1.0")
    requests = []
    ref = ref_stats.FlightRecorder("exp", enabled_=True)
    port = step_stats.FlightRecorder("exp", request_capture=lambda **kw: requests.append(kw))
    for rec in (ref, port):
        rec.note_restart(1.5)
    for i, round_ in enumerate(_rounds(2)):
        clock.now += 0.5
        assert port.on_round(round_) == ref.on_round(round_), i
        assert port.stragglers == ref.stragglers, i
        if i == 7:  # a death 0.3 s after the last committed round
            clock.now += 0.3
            for rec in (ref, port):
                rec.note_checkpoint(0.25)
                rec.note_stalled_since_progress()
                rec.note_restart(0.75)
    clock.now += 0.25
    assert port.finalize() == ref.finalize()
    assert port.buckets == ref.buckets and port.buckets["stalled_s"] > 0
    captures = [payload for method, payload in controller.calls if method == "profile_capture"]
    assert len(captures) >= 2 and requests == captures
    assert all(c["ranks"] == [SLOW_RANK] and c["reason"] == "straggler" for c in captures)
    # Every sample the reference pushed (and the last it still holds) the
    # port keeps, in order; the gang samples' ts is the wall clock's.
    pushed = {}
    for method, payload in controller.calls:
        if method == "workload_ingest":
            for series in payload["series"]:
                pushed.setdefault(series["key"], []).extend(series["samples"])
    for key, samples in ref._pending.items():
        pushed.setdefault(key, []).extend(samples)
    assert port.samples == pushed
    assert sorted(pushed) == ["train/exp", "train/exp/goodput"] + [
        f"train/exp/rank{r}" for r in range(RECORDER_RANKS)]


def test_auto_capture_reaches_the_trainers_queue(tmp_path):
    """The recorder's request lands in the trainer's capture queue with
    the reason the reference's controller records."""
    trainer = TorchTrainer(_profiled_loop, scaling_config=ScalingConfig(num_workers=2,
                                                                        use_gpu=False),
                           run_config=RunConfig(name="auto", storage_path=str(tmp_path)))
    request = trainer._queue_capture(steps=3, ranks=[1], reason="straggler")
    assert request.capture_id == "prof-0000-straggler" and request.ranks == [1]
    assert trainer._profile_queue == [request]
