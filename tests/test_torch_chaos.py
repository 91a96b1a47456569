"""The port's chaos plane (``ray_tpu_torch/_private/chaos.py``,
``ray_tpu_torch/util/chaos.py``) against the JAX package's.

Both packages' injectors get one schedule and one seeded sequence of about
a thousand decision calls (``_roll``, ``failpoint`` with count and
windowed budgets, ``latency_delay`` in its float and windowed forms,
``partitioned``, ``effective_timeout``, ``max_attempts`` and the three
transport hooks), on one patched clock: every decision and every event-log
line must be the same, exactly. Then the schedule's JSON across packages,
the environment forms and the legacy delay alias (the reference's
``tests/test_chaos.py``), ``install``/``reset``/``set_identity``, and
``read_event_log`` over both packages' logs.
"""

import asyncio
import json
import time

import numpy as np
import pytest
from ray_tpu._private import chaos as ref_chaos
from ray_tpu._private import config as ref_config
from ray_tpu.util import chaos as ref_util_chaos

from ray_tpu_torch._private import chaos as port_chaos
from ray_tpu_torch._private import config as port_config
from ray_tpu_torch.util import chaos as port_util_chaos

PACKAGES = {"ref": ref_chaos, "port": port_chaos}
ENV = ("RAY_TPU_chaos", "RAY_TPU_chaos_identity", "RAY_TPU_chaos_log_dir")
EPOCH = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _clean_chaos_state(monkeypatch):
    """Every test starts and ends with no injector and no chaos env in
    either package."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    for mod in PACKAGES.values():
        mod.reset()
    yield
    for mod in PACKAGES.values():
        mod.reset()


def _schedule(mod, **overrides):
    kwargs = dict(
        seed=1234, drop_request=0.2, drop_reply=0.15, dup_request=0.1, dup_reply=0.25,
        reorder=0.3, reorder_ms=0.0, methods=[], exclude_methods=["push_*", "stream_next"],
        partitions=[{"src": "node:*", "dst": "controller", "start_s": 2.0, "duration_s": 3.0},
                    {"src": "node:a", "dst": "node:b", "start_s": 0.0, "duration_s": 9.0,
                     "symmetric": True}],
        slow=[{"match": "node:z*", "extra_ms": 0.0}],
        fail_points={"p.count": 3, "p.forever": -1, "p.zero": 0,
                     "p.window": {"count": 2, "start_s": 1.0, "duration_s": 2.0},
                     "p.window_all": {"start_s": 4.0, "duration_s": 1.5}},
        latency_points={"l.float": 12.5, "l.zero": 0.0,
                        "l.window": {"extra_ms": 40.0, "start_s": 1.5, "duration_s": 2.5}},
        kills=[{"at_s": 3, "target": "worker", "index": 0}],
        call_timeout_s=0.7, max_call_attempts=5, epoch=EPOCH)
    kwargs.update(overrides)
    return mod.FaultSchedule(**kwargs)


POINTS = ["drop_request", "delay", "reorder", "custom"]
METHODS = ["echo", "push_task", "push_actor_task", "kv_put", "stream_next", "heartbeat"]
FAILS = ["p.count", "p.forever", "p.zero", "p.window", "p.window_all", "p.unarmed"]
LATENCIES = ["l.float", "l.zero", "l.window", "l.unarmed"]
PEERS = ["controller", "node:b", "node:a", None, "node:c"]
IDENTITIES = ["node:a", "node:b", "driver"]


def _calls(n=1000, seed=0):
    """A seeded sequence of (clock offset, call) pairs, the same for both
    packages."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.uniform(0.0, 0.02))
        kind = int(rng.integers(0, 10))
        if kind == 0:
            call = ("roll", POINTS[rng.integers(len(POINTS))], METHODS[rng.integers(len(METHODS))])
        elif kind == 1:
            call = ("failpoint", FAILS[rng.integers(len(FAILS))])
        elif kind == 2:
            call = ("latency", LATENCIES[rng.integers(len(LATENCIES))])
        elif kind == 3:
            call = ("partitioned", PEERS[rng.integers(len(PEERS))])
        elif kind == 4:
            call = ("timeout", METHODS[rng.integers(len(METHODS))],
                    [None, 30.0, 0.5][rng.integers(3)])
        elif kind == 5:
            call = ("attempts", METHODS[rng.integers(len(METHODS))])
        elif kind == 6:
            call = ("send", METHODS[rng.integers(len(METHODS))], PEERS[rng.integers(len(PEERS))])
        elif kind == 7:
            call = ("server_request", METHODS[rng.integers(len(METHODS))])
        elif kind == 8:
            call = ("server_reply", METHODS[rng.integers(len(METHODS))])
        else:
            call = ("identity", IDENTITIES[rng.integers(len(IDENTITIES))])
        out.append((t, call))
    return out


def _drive(mod, schedule, log_dir, calls, monkeypatch):
    """Runs ``calls`` through one injector of ``mod`` on a patched clock;
    returns each call's outcome and the injector's in-memory events."""
    clock = {"now": EPOCH}
    injector = mod.ChaosInjector(schedule, identity="node:a", log_dir=log_dir)
    results = []

    async def run():
        for t, call in calls:
            clock["now"] = EPOCH + t
            kind = call[0]
            if kind == "roll":
                results.append(injector._roll(call[1], call[2]))
            elif kind == "failpoint":
                try:
                    injector.failpoint(call[1])
                    results.append("pass")
                except mod.ChaosFault as exc:
                    results.append(("fault", str(exc)))
            elif kind == "latency":
                results.append(injector.latency_delay(call[1]))
            elif kind == "partitioned":
                results.append(injector.partitioned(call[1]))
            elif kind == "timeout":
                results.append(injector.effective_timeout(call[1], call[2]))
            elif kind == "attempts":
                results.append(injector.max_attempts(call[1]))
            elif kind == "send":
                results.append(await injector.on_client_send(call[1], call[2]))
            elif kind == "server_request":
                results.append(await injector.on_server_request(call[1]))
            elif kind == "server_reply":
                results.append(await injector.on_server_reply(call[1]))
            else:
                injector.identity = call[1]
                results.append(("identity", call[1]))

    try:
        with monkeypatch.context() as patch:
            patch.setattr(time, "time", lambda: clock["now"])
            asyncio.run(run())
    finally:
        injector.close()
    return results, injector.events


def test_a_thousand_decisions_and_their_event_log_match_the_reference(tmp_path, monkeypatch):
    calls = _calls()
    out = {}
    for name, mod in PACKAGES.items():
        log_dir = tmp_path / name
        results, events = _drive(mod, _schedule(mod), str(log_dir), calls, monkeypatch)
        (log,) = sorted(log_dir.iterdir())
        out[name] = (results, events, log.name, log.read_bytes())
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]  # chaos-<identity>-<pid>.jsonl
    assert port[3] == ref[3]
    # The sequence exercised every fault family and both budget forms.
    actions = {(e["point"], e["action"]) for e in ref[1]}
    for want in [("partition", "partition"), ("drop_request", "drop"), ("reorder", "reorder"),
                 ("dup_request", "dup"), ("drop_reply", "drop"), ("dup_reply", "dup")]:
        assert want in actions, want
    failed = {e["method"] for e in ref[1] if e["point"] == "failpoint"}
    assert failed == {"p.count", "p.forever", "p.window", "p.window_all"}
    delayed = {e["method"] for e in ref[1] if e["point"] == "latency_point"}
    assert delayed == {"l.float", "l.window"}
    assert sum(r == ("fault", "injected fault at p.count (hit 3)") for r in ref[0]) == 1
    assert 0.04 in ref[0] and 0.0125 in ref[0]


@pytest.mark.parametrize("seed", [7, 99])
def test_roll_streams_are_the_references(seed):
    for point, method in [("drop_request", "m"), ("dup_reply", "kv_put"), ("x", "")]:
        a = port_chaos.ChaosInjector(port_chaos.FaultSchedule(seed=seed), identity="x")
        b = ref_chaos.ChaosInjector(ref_chaos.FaultSchedule(seed=seed), identity="x")
        assert [a._roll(point, method) for _ in range(200)] == \
               [b._roll(point, method) for _ in range(200)]


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_schedule_json_crosses_packages(src, dst):
    made = _schedule(PACKAGES[src])
    clone = PACKAGES[dst].FaultSchedule.from_json(made.to_json())
    assert vars(clone) == vars(made)
    assert clone.to_json() == made.to_json()
    # A key from a newer writer is ignored, not fatal.
    raw = json.loads(made.to_json())
    raw["from_the_future"] = True
    assert PACKAGES[dst].FaultSchedule.from_json(json.dumps(raw)).seed == 1234
    assert clone.lossy() and clone.message_faults_enabled()
    assert [clone.targets(m) for m in METHODS] == [made.targets(m) for m in METHODS]


def test_delay_only_schedule_keeps_caller_timeouts():
    for mod in PACKAGES.values():
        injector = mod.ChaosInjector(mod.FaultSchedule(seed=0, delay_ms=5.0), identity="t")
        assert injector.effective_timeout("anything", None) is None
        assert injector.effective_timeout("anything", 30.0) == 30.0
        assert injector.max_attempts("anything") == 1
        lossy = mod.ChaosInjector(mod.FaultSchedule(seed=0, drop_request=0.1,
                                                    call_timeout_s=2.0), identity="t")
        assert lossy.effective_timeout("m", None) == 2.0
        assert lossy.effective_timeout("m", 30.0) == 2.0
        assert lossy.max_attempts("m") == 6
        assert lossy.max_attempts("push_actor_task") == 1


@pytest.mark.parametrize("form", ["json", "file"])
def test_the_environment_form_gives_both_packages_one_schedule(form, tmp_path, monkeypatch):
    raw = _schedule(port_chaos).to_json()
    if form == "file":
        path = tmp_path / "schedule.json"
        path.write_text(raw)
        raw = f"@{path}"
    monkeypatch.setenv("RAY_TPU_chaos", raw)
    monkeypatch.setenv("RAY_TPU_chaos_identity", "node:q")
    got = {}
    for name, mod in PACKAGES.items():
        mod.reset()
        injector = mod.get_injector()
        assert injector.active and injector.identity == "node:q"
        got[name] = vars(injector.schedule)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("raw", ["{not json", "@/nonexistent/schedule.json"])
def test_a_bad_environment_schedule_installs_nothing(raw, monkeypatch):
    monkeypatch.setenv("RAY_TPU_chaos", raw)
    for mod in PACKAGES.values():
        mod.reset()
        assert not mod.get_injector().active
        mod.failpoint("anything")
        assert mod.latency_delay("anything") == 0.0


def test_the_legacy_delay_alias_is_a_delay_only_schedule(monkeypatch):
    for cfg_mod, mod in ((ref_config, ref_chaos), (port_config, port_chaos)):
        monkeypatch.setattr(cfg_mod.global_config(), "testing_rpc_delay_ms", 7)
        mod.reset()
        injector = mod.get_injector()
        assert injector.active
        assert injector.schedule.delay_ms == 7.0
        assert not injector.schedule.lossy()
        assert injector.effective_timeout("m", None) is None


def test_install_exports_and_reset_forgets(tmp_path, monkeypatch):
    import os

    for mod in PACKAGES.values():
        sched = _schedule(mod, fail_points={"x": 1})
        injector = mod.install(sched, identity="driver", log_dir=str(tmp_path / "logs"))
        assert os.environ["RAY_TPU_chaos"] == sched.to_json()
        assert os.environ["RAY_TPU_chaos_log_dir"] == str(tmp_path / "logs")
        assert mod.get_injector() is injector
        with pytest.raises(mod.ChaosFault):
            mod.failpoint("x")
        mod.failpoint("x")  # budget spent
        mod.set_identity("node:new")
        assert os.environ["RAY_TPU_chaos_identity"] == "node:new"
        assert mod.get_injector().identity == "node:new"
        mod.install(None)
        assert "RAY_TPU_chaos" not in os.environ and "RAY_TPU_chaos_log_dir" not in os.environ
        assert not mod.get_injector().active
        quiet = mod.install(sched, export_env=False)
        assert "RAY_TPU_chaos" not in os.environ and quiet.active
        mod.reset()
        monkeypatch.delenv("RAY_TPU_chaos_identity", raising=False)
        assert not mod.get_injector().active


def test_read_event_log_reads_both_packages_logs(tmp_path, monkeypatch):
    calls = _calls(300, seed=5)
    log_dir = str(tmp_path / "both")
    for mod in PACKAGES.values():
        _drive(mod, _schedule(mod), log_dir, calls, monkeypatch)
    port_events = port_util_chaos.read_event_log(log_dir)
    ref_events = ref_util_chaos.read_event_log(log_dir)
    assert port_events == ref_events
    # Two packages, one identity and one pid: every decision twice.
    assert len(port_events) % 2 == 0 and port_events
    assert all("t" not in e for e in port_events)
    assert port_util_chaos.read_event_log(str(tmp_path / "missing")) == []


def test_util_chaos_reexports_the_core():
    for name in ("ChaosFault", "ChaosInjector", "FaultSchedule", "failpoint", "get_injector",
                 "install", "reset", "set_identity"):
        assert getattr(port_util_chaos, name) is getattr(port_chaos, name)
        assert name in port_util_chaos.__all__
    assert "ChaosMonkey" in port_util_chaos.__doc__  # named as left out
