"""The port's step profiler (``ray_tpu_torch._private.profiler`` and
``profile_merge``) against the JAX package's.

* ``ProfilePlane`` driven through the reference tests' sequences
  (tests/test_profiler.py: two planes cut on identical edges, typed errors
  and abort, the timer leak guard, a plane with no step stream) beside the
  reference's own planes: the same states, boundaries' steps, phase totals
  and codes.
* ``merge_captures``, ``merge_folded``, ``folded_text``,
  ``flamegraph_tree`` and ``hot_phase`` give byte-identical JSON on the
  reference tests' payloads and on a seeded random set.
* A CPU capture of 3 steps of ``TransformerConfig.tiny()`` through the
  split step on a one-rank gloo group: the exported ``trace.json`` holds
  one ``ProfilerStep`` range a step and the fwd, bwd, grad_sync and opt
  scopes with aten ops inside.
* The manual ``start_trace`` / ``stop_trace`` typed codes, and a capture
  ended from another thread (the leak guard's timer), whose trace the
  owner thread writes at its next boundary.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu._private import profile_merge as ref_merge
from ray_tpu._private import profiler as ref_profiler
from ray_tpu_torch._private import profile_merge as port_merge
from ray_tpu_torch._private import profiler as port_profiler
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.train import step_stats, torch_utils
from ray_tpu_torch.train.step import make_optimizer
from ray_tpu_torch.util import collective

MODULES = {"reference": ref_profiler, "port": port_profiler}


@pytest.fixture(autouse=True)
def _reset_plane_globals():
    """Standalone planes flip the modules' fast flags; the process-wide
    plane and traces must not leak across tests either."""
    yield
    for mod in MODULES.values():
        mod._boundary_armed = False
        mod._capturing = False
    port_profiler.release_device_trace()
    port_profiler._plane = None
    port_profiler._pending = None
    port_profiler._manual = None
    step_stats.deactivate()


def _arm(plane, tmp_path, capture_id="cap", start_step=5, steps=2, max_s=30, host=False):
    return plane.arm({"capture_id": capture_id, "start_step": start_step, "steps": steps,
                      "max_s": max_s, "host": host, "device": False,
                      "session_dir": str(tmp_path)})


def _two_planes(mod, tmp_path):
    planes = []
    for rank in range(2):
        p = mod.ProfilePlane()
        p.set_meta(rank=rank, node_id=f"n{rank}", worker_id=f"w{rank}")
        assert _arm(p, tmp_path)["status"] == "ok"
        planes.append(p)
    states = []
    for step in range(2, 8):
        planes[0].on_step_boundary(step)
        states.append(planes[0].state)
    for step in range(3, 8):
        planes[1].on_step_boundary(step)
    out = []
    for p in planes:
        res = p.collect()
        out.append((res["status"], res["aborted"], [b["step"] for b in res["boundaries"]],
                    p.state))
    return states, out


def _typed_errors(mod, tmp_path):
    p = mod.ProfilePlane()
    p.set_meta(rank=0)
    codes = [p.collect()["code"], _arm(p, tmp_path)["status"],
             _arm(p, tmp_path, capture_id="dup")["code"], p.collect()["code"],
             p.abort()["status"]]
    res = p.collect()
    return codes + [res["status"], res["aborted"], p.status()["state"]]


def _timer_leak(mod, tmp_path):
    p = mod.ProfilePlane()
    p.set_meta(rank=0)
    assert _arm(p, tmp_path, start_step=10_000, max_s=0.1)["status"] == "ok"
    deadline = time.time() + 5.0
    while p.status()["state"] != "done" and time.time() < deadline:
        time.sleep(0.02)
    res = p.collect()
    return res["status"], res["timed_out"], res["boundaries"], res["aborted"]


def _no_step_stream(mod, tmp_path):
    p = mod.ProfilePlane()
    p.set_meta(rank=None, worker_id="w-aux")
    res = p.arm({"capture_id": "c", "start_step": None, "steps": 1, "max_s": 30,
                 "host": False, "device": False, "session_dir": str(tmp_path)})
    state = p.status()["state"]
    p.note_annotation("aux_work", 1000.0, 0.01)
    p.note_phase("fwd", 0.25)
    p.note_phase("fwd", 0.5)
    p.abort()
    collected = p.collect()
    return (res["status"], state, [a["name"] for a in collected["annotations"]],
            collected["phase_totals"], collected["aborted"])


@pytest.mark.parametrize("sequence", [_two_planes, _typed_errors, _timer_leak,
                                      _no_step_stream],
                         ids=["identical_edges", "typed_errors", "timer_leak", "no_step_stream"])
def test_plane_sequences_match_the_reference(sequence, tmp_path, monkeypatch):
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "_TIMER_GRACE_S", 0.05)
    got = {name: sequence(mod, tmp_path / name) for name, mod in MODULES.items()}
    assert got["port"] == got["reference"]


def test_two_planes_cut_the_reference_tests_steps(tmp_path):
    states, out = _two_planes(port_profiler, tmp_path)
    assert [o[2] for o in out] == [[4, 5, 6], [4, 5, 6]]
    assert states == ["armed", "armed", "capturing", "capturing", "done", "done"]


# ---------------------------------------------------------------------------
# merge: byte-identical JSON
# ---------------------------------------------------------------------------

def _capture(rank, t0=1000.0, *, trace_id=None, folded=None, phases=None):
    """tests/test_profiler.py's payload."""
    bounds = []
    for i, step in enumerate((4, 5, 6)):
        mark = {"step": step, "ts": t0 + 0.1 * i}
        if trace_id:
            mark["trace_id"] = trace_id
            mark["span_id"] = f"{rank}{i}"
        bounds.append(mark)
    return {
        "capture_id": "cap", "rank": rank, "worker_id": f"worker-{rank}", "node_id": "n0",
        "aborted": False, "timed_out": False, "boundaries": bounds,
        "annotations": [{"name": "bwd", "ts": t0 + 0.15, "dur_s": 0.04},
                        {"name": "fwd", "ts": t0 + 0.11, "dur_s": 0.02}],
        "phase_totals": dict(phases or {"fwd": 0.02, "bwd": 0.04}),
        "host": {"folded": dict(folded or {}), "samples": 7, "dropped": 0},
        "device_trace_dir": f"/sess/profiles/cap/rank{rank}-device",
    }


def _random_captures(seed: int) -> list:
    """Captures with distinct ranks (one of them None at times: the merge
    orders equal ranks as it finds them), steps, annotations, folded stacks
    and phase totals drawn from a seeded generator, repeated stacks and
    tied phase totals included."""
    rng = np.random.default_rng(seed)
    frames = ["main (t.py:1)", "step (t.py:9)", "fwd (m.py:2)", "bwd (m.py:7)", "opt (o.py:3)"]
    caps = []
    ranks = [int(r) for r in rng.permutation(8)[:int(rng.integers(2, 6))]]
    if rng.random() < 0.5:
        ranks[0] = None
    for i, rank in enumerate(ranks):
        t0 = 1000.0 + float(rng.random())
        first = int(rng.integers(0, 50))
        bounds = [{"step": first + k, "ts": t0 + 0.05 * k + float(rng.random()) * 1e-3}
                  for k in range(int(rng.integers(0, 5)))]
        if bounds and rng.random() < 0.5:
            bounds[-1]["trace_id"] = f"t{int(rng.integers(0, 4))}"
            bounds[-1]["span_id"] = f"s{i}"
        anns = [{"name": str(rng.choice(["fwd", "bwd", "opt", "grad_sync", "fence.b0"])),
                 "ts": t0 + float(rng.random()) * 0.3, "dur_s": float(rng.random()) * 0.01}
                for _ in range(int(rng.integers(0, 8)))]
        folded = {}
        for _ in range(int(rng.integers(0, 6))):
            depth = int(rng.integers(1, len(frames) + 1))
            key = "MainThread;" + ";".join(frames[:depth])
            folded[key] = folded.get(key, 0) + int(rng.integers(1, 20))
        phases = {p: float(rng.choice([0.0, 0.5, float(rng.random())]))
                  for p in ("fwd", "bwd", "opt", "collective", "comm_exposed")
                  if rng.random() < 0.6}
        caps.append({"capture_id": "r", "rank": rank,
                     "worker_id": "" if rng.random() < 0.3 else f"worker-{i:016d}",
                     "boundaries": bounds, "annotations": anns, "phase_totals": phases,
                     "host": {"folded": folded, "samples": int(rng.integers(0, 3))},
                     "device_trace_dir": f"/d/rank{rank}-device" if rng.random() < 0.7 else None})
    return caps


PAYLOADS = {
    "reference_tests": lambda: [_capture(1, trace_id="tid-b"),
                                _capture(0, trace_id="tid-a",
                                         folded={"MainThread;step (t.py:9);fwd (t.py:2)": 5,
                                                 "MainThread;step (t.py:9)": 2})],
    "no_trace_ids": lambda: [_capture(0, folded={"MainThread;f (x.py:1)": 3}), _capture(1)],
    **{f"seed{seed}": (lambda seed=seed: _random_captures(seed)) for seed in range(4)},
}


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_merge_is_byte_identical_to_the_reference(payload):
    caps = PAYLOADS[payload]()
    meta = {"reason": "manual", "start_step": 4}
    assert json.dumps(port_merge.merge_captures(caps, "cap", meta=meta)) == \
        json.dumps(ref_merge.merge_captures(caps, "cap", meta=meta))
    assert json.dumps(port_merge.merge_captures(caps[::-1], "cap")) == \
        json.dumps(ref_merge.merge_captures(caps, "cap"))
    folded = port_merge.merge_folded(caps)
    assert json.dumps(folded) == json.dumps(ref_merge.merge_folded(caps))
    assert port_merge.folded_text(folded) == ref_merge.folded_text(folded)
    assert json.dumps(port_merge.flamegraph_tree(folded)) == \
        json.dumps(ref_merge.flamegraph_tree(folded))
    for cap in caps:
        assert port_merge.hot_phase(cap.get("phase_totals")) == \
            ref_merge.hot_phase(cap.get("phase_totals"))


# ---------------------------------------------------------------------------
# a CPU capture of the split step
# ---------------------------------------------------------------------------

class _Ctx:
    world_rank = 0
    node_id = "n0"
    device = "cpu"


@pytest.fixture()
def gloo_group():
    collective.init_collective_group(1, 0, backend="gloo", group_name="profile-test")
    try:
        yield "profile-test"
    finally:
        collective.destroy_collective_group("profile-test")


def _events(trace_dir):
    with open(os.path.join(trace_dir, port_profiler.TRACE_FILE)) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _inside(event, scope) -> bool:
    return scope["ts"] <= event["ts"] and event["ts"] + event["dur"] <= scope["ts"] + scope["dur"]


def test_cpu_capture_of_the_split_step(tmp_path, gloo_group):
    config = pt.TransformerConfig.tiny()
    mesh = MeshSpec({"dp": 1}).build("cpu")
    setup = torch_utils.setup_sharded_training(
        lambda device: pt.init_params(config, 0, device=device), make_optimizer, mesh=mesh)
    step = torch_utils._split_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], config), setup, gloo_group,
        lambda x: x.to_local())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 17)))
    step_stats.activate()
    recorder = step_stats.StepRecorder(_Ctx())
    plane = port_profiler.get_plane()
    recorder.on_report({})  # step 0
    assert plane.arm({"capture_id": "cpu", "start_step": 2, "steps": 3, "max_s": 60,
                      "session_dir": str(tmp_path)})["status"] == "ok"
    params, opt = setup.params, setup.opt_state
    for _ in range(5):
        params, opt, loss = step(params, opt, setup.shard_batch(tokens))
        recorder.on_report({})
    assert np.isfinite(float(loss))
    cap = plane.collect()
    assert cap["status"] == "ok" and cap["device_error"] is None
    assert [b["step"] for b in cap["boundaries"]] == [1, 2, 3, 4]
    assert [a["name"] for a in cap["annotations"]] == ["fwd", "bwd", "grad_sync", "opt"] * 3
    assert set(cap["phase_totals"]) == {"fwd", "bwd", "opt"}
    events = _events(cap["device_trace_dir"])
    steps = [e for e in events if e["name"].startswith("ProfilerStep#")]
    assert [e["name"] for e in steps] == ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
    scopes = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] in ("fwd", "bwd", "grad_sync", "opt")]
    assert [e["name"] for e in scopes] == ["fwd", "bwd", "grad_sync", "opt"] * 3
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    for name in ("fwd", "bwd", "opt"):
        inside = [op for op in ops for s in scopes if s["name"] == name and _inside(op, s)]
        assert inside, f"no aten op inside {name}"
    assert all(any(_inside(s, st) for st in steps) for s in scopes)


# ---------------------------------------------------------------------------
# manual traces and stops from another thread
# ---------------------------------------------------------------------------

def test_manual_trace_typed_codes(tmp_path):
    assert port_profiler.stop_trace()["code"] == "not_started"
    if not torch.cuda.is_available():
        # The entry point runs on the card unless asked for the CPU.
        assert port_profiler.start_trace(str(tmp_path / "x"))["code"] == "start_failed"
    started = port_profiler.start_trace(str(tmp_path / "m"), device="cpu")
    assert started == {"status": "ok", "log_dir": str(tmp_path / "m")}
    assert port_profiler.start_trace(str(tmp_path / "n"), device="cpu")["code"] == \
        "already_started"
    torch.ones(4).sum()
    stopped = port_profiler.stop_trace()
    assert stopped == {"status": "ok", "log_dir": str(tmp_path / "m"), "deferred": False}
    assert os.path.exists(tmp_path / "m" / port_profiler.TRACE_FILE)
    plane = port_profiler.get_plane()
    _arm(plane, tmp_path)
    assert port_profiler.start_trace(str(tmp_path / "p"), device="cpu")["code"] == \
        "plane_active"
    plane.abort()


def test_capture_while_a_manual_trace_runs_is_host_only(tmp_path):
    """As the reference's plane downgrades when a manual trace owns the
    profiler: the capture proceeds and says why it has no device trace."""
    assert port_profiler.start_trace(str(tmp_path / "m"), device="cpu")["status"] == "ok"
    plane = port_profiler.ProfilePlane()
    plane.set_meta(rank=0, device="cpu")
    plane.arm({"capture_id": "c", "start_step": 1, "steps": 1, "max_s": 30, "host": False,
               "session_dir": str(tmp_path)})
    plane.on_step_boundary(0)
    plane.on_step_boundary(1)
    cap = plane.collect()
    assert cap["device_trace_dir"] is None and "already running" in cap["device_error"]
    assert port_profiler.stop_trace()["status"] == "ok"


def test_a_stop_from_another_thread_is_written_by_the_owner(tmp_path, monkeypatch):
    """The leak guard's timer ends the capture on its own thread; the trace
    (started on this thread) is stopped and exported at this thread's next
    boundary."""
    monkeypatch.setattr(port_profiler, "_TIMER_GRACE_S", 0.05)
    plane = port_profiler.get_plane()
    plane.set_meta(rank=3, device="cpu")
    plane.arm({"capture_id": "t", "start_step": 1, "steps": 100, "max_s": 0.2,
               "host": False, "session_dir": str(tmp_path)})
    port_profiler.on_step_boundary(0)
    assert plane.state == "capturing"
    deadline = time.time() + 5.0
    while plane.status()["state"] != "done" and time.time() < deadline:
        time.sleep(0.02)
    cap = plane.collect()
    assert cap["timed_out"] and cap["device_error"] is None
    trace = os.path.join(cap["device_trace_dir"], port_profiler.TRACE_FILE)
    assert not os.path.exists(trace) and port_profiler._pending is not None
    port_profiler.on_step_boundary(1)
    assert os.path.exists(trace) and port_profiler._pending is None
    # And the manual stop from another thread is deferred the same way.
    port_profiler.start_trace(str(tmp_path / "m"), device="cpu")
    answers = []
    stopper = threading.Thread(target=lambda: answers.append(port_profiler.stop_trace()))
    stopper.start()
    stopper.join(10)
    assert answers == [{"status": "ok", "log_dir": str(tmp_path / "m"), "deferred": True}]
    # The next boundary writes it before a capture armed meanwhile starts,
    # which then owns the profiler.
    plane.arm({"capture_id": "next", "start_step": 6, "steps": 1, "max_s": 30,
               "host": False, "session_dir": str(tmp_path)})
    port_profiler.on_step_boundary(5)
    assert os.path.exists(tmp_path / "m" / port_profiler.TRACE_FILE)
    assert plane.state == "capturing"
    port_profiler.on_step_boundary(6)
    cap = plane.collect()
    assert cap["device_error"] is None and not cap["aborted"]
    assert os.path.exists(os.path.join(cap["device_trace_dir"], port_profiler.TRACE_FILE))
