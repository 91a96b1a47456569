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
